// Fused LayerNorm -> GEGLU feed-forward -> residual on Hopper (sm_90a):
//   y = x + (a * gelu_tanh(g)) W2^T + b2,  [a || g] = LN(x) W1^T + b1,
// on x (M = B*N rows, C) bf16, W1 (2F, C) (the value half's F rows first),
// W2 (C, F), LN weight / bias, b1, b2 in bf16. This is the third sub-block of
// every SD transformer block, `x + ff(norm3(x))`.
//
// Replaces the TPU kernel benchmarks/research/fused_ff.py `_ff_kernel`
// (pallas_call in `fused_ln_geglu_ff`). Numerics follow it: LN statistics in
// fp32 with var = E[x^2] - mu^2, the normalised row rounded to bf16, both
// products with bf16 operands and fp32 accumulation (mma.sync m16n8k16),
// b1 added and the tanh GELU applied in fp32, the GEGLU product rounded to
// bf16 before the second product, b2 and the residual added in fp32, the
// result rounded to bf16 once.
//
// What bounds it on the H100: 2*M*3*C*F flops (F = 4C) against reading x and
// the weights once and writing y, so the tensor cores (at ds1, B 16, 4096
// tokens, C 320: 1.61e11 flops, 0.163 ms). The TPU kernel held both weight
// matrices and a 256-row tile in VMEM and never wrote the (M, 2F) GEGLU
// intermediate to HBM. A block here has 227 KB of shared memory and a 64 x C
// fp32 output tile does not fit one block's registers at C 1280, so a block
// takes 64 rows and one 320-column slab of the output (blockIdx.y): it
// normalises its rows once into shared memory (64 x C bf16), then for each
// 32-wide chunk of F computes the value and gate chunks of LN(x) W1^T over
// 64-deep W1 tiles staged in shared memory, applies GEGLU in registers,
// rounds the 64 x 32 chunk to bf16 in shared memory, and accumulates its
// product with the staged W2 slab into the 64 x 320 fp32 output tile held
// in registers (8 warps: 4 row groups x 2 column halves, 80 floats a
// thread). Neither intermediate reaches HBM. At C 640 and 1280 each slab
// block recomputes the first product (2x and 4x its flops): the simple plan,
// not the fast one; no loads are pipelined.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;     // rows per block
constexpr int CS = 320;    // output columns per block
constexpr int FC = 32;     // F columns per chunk (value and gate each)
constexpr int KC = 64;     // depth of a staged W1 tile
constexpr int PAD = 8;     // bf16 padding per shared row (bank spread)
constexpr int THREADS = 256;
constexpr int LDU = FC + PAD;
constexpr int LDW1 = KC + PAD;
constexpr int LDW2 = FC + PAD;
constexpr int NT2 = CS / 2 / 8;   // n-tiles of 8 output columns per warp
constexpr int MAX_C = 1280;       // the normalised tile's shared-memory cap

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return v * (0.5f * (1.f + tanhf(inner)));
}

__global__ void __launch_bounds__(THREADS) fused_ff_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_w,
    const __nv_bfloat16* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out, int m,
    int c, int f, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float mean_s[BM], rstd_s[BM];
  const int ldh = c + PAD;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BM x ldh
  __nv_bfloat16* us = hs + BM * ldh;                                // BM x LDU
  __nv_bfloat16* w1s = us + BM * LDU;                               // 2FC x LDW1
  __nv_bfloat16* w2s = w1s + 2 * FC * LDW1;                         // CS x LDW2

  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // LayerNorm statistics in fp32: warp w takes rows w, w + 8, ...
  for (int r = warp; r < BM; r += THREADS / 32) {
    float s = 0.f, s2 = 0.f;
    if (row0 + r < m) {
      const __nv_bfloat16* xr = x + (size_t)(row0 + r) * c;
      for (int i = lane * 8; i < c; i += 256) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = bf(e[j]);
          s += v;
          s2 += v * v;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      const float mu = s / c;
      mean_s[r] = mu;
      rstd_s[r] = rsqrtf(s2 / c - mu * mu + eps);
    }
  }
  __syncthreads();

  // The normalised tile (x - mu) * rstd * w + b, rounded to bf16; rows past
  // m are zero and never stored.
  const int vpr = c / 8;
  for (int i = tid; i < BM * vpr; i += THREADS) {
    const int r = i / vpr, cv = (i % vpr) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row0 + r < m) {
      const uint4 rx = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * c + cv);
      const uint4 rw = *reinterpret_cast<const uint4*>(ln_w + cv);
      const uint4 rb = *reinterpret_cast<const uint4*>(ln_b + cv);
      const __nv_bfloat16* ex = reinterpret_cast<const __nv_bfloat16*>(&rx);
      const __nv_bfloat16* ew = reinterpret_cast<const __nv_bfloat16*>(&rw);
      const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&rb);
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
      const float mu = mean_s[r], rstd = rstd_s[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16((bf(ex[j]) - mu) * rstd * bf(ew[j]) + bf(eb[j]));
    }
    *reinterpret_cast<uint4*>(hs + r * ldh + cv) = packed;
  }

  const int wr = (warp & 3) * 16;   // this warp's 16 rows, in both products
  const int wc = warp >> 2;         // its column half
  float acc[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int f0 = 0; f0 < f; f0 += FC) {
    // [a || g] chunk: n-tiles 0, 1 are value columns f0 + wc*16 + {0, 8},
    // n-tiles 2, 3 the gate columns F + the same.
    float ga[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ga[j][0] = ga[j][1] = ga[j][2] = ga[j][3] = 0.f;
    for (int k0 = 0; k0 < c; k0 += KC) {
      __syncthreads();  // w1s is free; at f0 = 0 also hs is complete
      for (int i = tid; i < 2 * FC * (KC / 8); i += THREADS) {
        const int lr = i / (KC / 8), cv = (i % (KC / 8)) * 8;
        const int grow = lr < FC ? f0 + lr : f + f0 + (lr - FC);
        *reinterpret_cast<uint4*>(w1s + lr * LDW1 + cv) =
            *reinterpret_cast<const uint4*>(w1 + (size_t)grow * c + k0 + cv);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const __nv_bfloat16* ha = hs + (wr + g) * ldh + k0 + kk + 2 * t;
        const uint32_t a[4] = {ld32(ha), ld32(ha + 8 * ldh), ld32(ha + 8),
                               ld32(ha + 8 * ldh + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lrow = (j < 2 ? 0 : FC) + wc * 16 + (j & 1) * 8 + g;
          const __nv_bfloat16* bp = w1s + lrow * LDW1 + kk + 2 * t;
          mma_bf16(ga[j], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
    // GEGLU in fp32, rounded to bf16 into the chunk tile. A thread holds
    // rows wr+g (registers 0, 1) and wr+g+8 (2, 3), columns 2t, 2t+1.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int lc = wc * 16 + j * 8 + 2 * t;
      const float bv0 = bf(b1[f0 + lc]), bv1 = bf(b1[f0 + lc + 1]);
      const float bg0 = bf(b1[f + f0 + lc]), bg1 = bf(b1[f + f0 + lc + 1]);
      *reinterpret_cast<uint32_t*>(us + (wr + g) * LDU + lc) =
          pack_bf16((ga[j][0] + bv0) * gelu_tanh(ga[j + 2][0] + bg0),
                    (ga[j][1] + bv1) * gelu_tanh(ga[j + 2][1] + bg1));
      *reinterpret_cast<uint32_t*>(us + (wr + g + 8) * LDU + lc) =
          pack_bf16((ga[j][2] + bv0) * gelu_tanh(ga[j + 2][2] + bg0),
                    (ga[j][3] + bv1) * gelu_tanh(ga[j + 2][3] + bg1));
    }
    // The W2 slab: output columns col0 .. col0 + CS, depth f0 .. f0 + FC.
    for (int i = tid; i < CS * (FC / 8); i += THREADS) {
      const int r = i / (FC / 8), cv = (i % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * LDW2 + cv) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)(col0 + r) * f + f0 + cv);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      const __nv_bfloat16* ua = us + (wr + g) * LDU + kk + 2 * t;
      const uint32_t a[4] = {ld32(ua), ld32(ua + 8 * LDU), ld32(ua + 8),
                             ld32(ua + 8 * LDU + 8)};
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const __nv_bfloat16* bp = w2s + (wc * (CS / 2) + n * 8 + g) * LDW2 + kk + 2 * t;
        mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
      }
    }
    // the next chunk's first __syncthreads orders these reads of us and w2s
    // before their next writes
  }

  // Epilogue: x + (acc + b2), rounded to bf16 once.
  const int r0 = row0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NT2; ++n) {
    const int cc = col0 + wc * (CS / 2) + n * 8 + 2 * t;
    const float bb0 = bf(b2[cc]), bb1 = bf(b2[cc + 1]);
    if (r0 < m) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r0 * c + cc);
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * c + cc) =
          pack_bf16(bf(xv.x) + (acc[n][0] + bb0), bf(xv.y) + (acc[n][1] + bb1));
    }
    if (r1 < m) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r1 * c + cc);
      *reinterpret_cast<uint32_t*>(out + (size_t)r1 * c + cc) =
          pack_bf16(bf(xv.x) + (acc[n][2] + bb0), bf(xv.y) + (acc[n][3] + bb1));
    }
  }
}

}  // namespace

// x, out: (m, c); ln_w, ln_b, b2: (c,); w1: (2f, c); b1: (2f,); w2: (c, f).
// All bf16, contiguous. Requires c % 320 == 0, c <= 1280, f % 32 == 0.
extern "C" int mdt_fused_ff(const void* x, const void* ln_w, const void* ln_b,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int m, int c, int f,
                            float eps, void* stream) {
  if (m < 1 || c % CS || c > MAX_C || f % FC) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)BM * (c + PAD) + BM * LDU + 2 * FC * LDW1 + CS * LDW2) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + BM - 1) / BM, c / CS);
  fused_ff_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln_w),
      static_cast<const __nv_bfloat16*>(ln_b), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(out), m, c, f,
      eps);
  return (int)cudaGetLastError();
}
