// Heads-packed attention for Hopper (sm_90a): softmax(scale * Q K^T) V on
// packed (B, N, C = heads * D) bf16 tensors, head h being the column slice
// [h*D, (h+1)*D). No head transpose is ever materialised.
//
// Replaces the TPU kernel minddiffusion_tpu/ops/flash_attention.py
// `_packed_kernel` (pallas_call in `flash_attention_packed`).
//
// What bounds it on the H100: at the UNet sites (D = 64, 1024-4096 keys) the
// QK^T and PV products are 4*N*N*D flops against 6*N*C bytes, far above the
// card's ~295 flop/byte ridge, so the tensor cores and the fp32 softmax
// (one exp per score) are the limit, not HBM. The TPU kernel held all of K
// and V for a batch element in VMEM; 4096 x 320 bf16 does not fit in a
// block's 227 KB of shared memory, so here one block takes (batch, head,
// 64-row q tile) and sweeps 64-key tiles with an online softmax: a running
// row max (exact mode) and row sum stay in fp32 registers.
//
// Numerics follow the TPU kernel: q is scaled in fp32 and rounded to bf16
// before QK^T; both products take bf16 operands with fp32 accumulation
// (mma.sync m16n8k16); P is rounded to bf16 before PV while the row sum uses
// the fp32 P. exact=0 is the raw exp(s) mode with no max subtraction (valid
// for logits below 88, fp32 exp overflow); it needs no rescale.
//
// Tile plans, dispatched on D at launch: 4 warps x 16 q rows; each warp
// keeps its S tile (16 x 64) and output accumulator (16 x DV) in registers.
// The UNet head widths (D = 64 for SD2; 40, 80 and 160 for SD1's 8 heads at
// C 320, 640 and 1280) take the whole head per block (DV = D: 20 to 80
// accumulator registers a thread). mma.sync m16n8k16 steps QK^T by 16
// columns, so Q and K sit in shared memory zero-filled to DK = D rounded up
// to 16 (48 for D = 40); PV and the stores stay at D columns. Every head
// offset (h * D * 2 bytes: 80, 128, 160, 320) stays 16-byte aligned for the
// vector loads. D = 512 (the VAE's single head) would need 16 x 512 fp32
// accumulators per warp, beyond the register file, so its output columns are
// split into chunks of DV = 128 over blockIdx.y: each chunk block recomputes
// S (QK^T over all 512 columns) and accumulates only its 128 output columns.
// That spends 2.5x the minimal flops at a site that runs once per decode; it
// is the simple plan, not the fast one. The ragged q edge is masked (zero
// rows, no stores); Nk must be a multiple of 64.
//
// At D = 40 the fp32 exp (one per score, 16 per clock per SM on the MUFU
// units) takes longer than the QK^T and PV products on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per block (16 per warp)
constexpr int BK = 64;   // keys per k tile
constexpr int PAD = 8;   // bf16 padding per shared-memory row (bank spread)
constexpr int THREADS = 128;

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

template <int D, int DV>
__global__ void __launch_bounds__(THREADS) packed_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int nq, int nk, int c, float scale, int exact) {
  constexpr int DK = (D + 15) / 16 * 16;  // QK^T depth, zero-filled past D
  constexpr int LDQ = DK + PAD;   // Q and K tiles: one row per token
  constexpr int LDV = BK + PAD;   // V tile transposed: one row per V column
  constexpr int VPR = DK / 8;     // 16-byte vectors per Q/K shared row
  constexpr int VPRV = DV / 8;    // 16-byte vectors per V row chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LDQ;
  __nv_bfloat16* vts = ks + BK * LDQ;

  constexpr int nchunk = D / DV;
  const int h = blockIdx.y / nchunk;
  const int dv0 = (blockIdx.y % nchunk) * DV;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const size_t col0 = (size_t)h * D;
  const __nv_bfloat16* qb = q + (size_t)b * nq * c + col0;
  const __nv_bfloat16* kb = k + (size_t)b * nk * c + col0;
  const __nv_bfloat16* vb = v + (size_t)b * nk * c + col0 + dv0;

  // Q tile, scaled in fp32 then rounded to bf16; rows past nq and columns
  // past D are zero.
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, cv = (i % VPR) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (q0 + r < nq && cv < D) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * c + cv);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(qs + r * LDQ + cv) = packed;
  }

  const int wr = warp * 16;  // this warp's first row inside the tile
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int kt = 0; kt < nk; kt += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, cv = (i % VPR) * 8;
      *reinterpret_cast<uint4*>(ks + r * LDQ + cv) =
          cv < D ? *reinterpret_cast<const uint4*>(kb + (size_t)(kt + r) * c + cv)
                 : make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < BK * VPRV; i += THREADS) {
      const int r = i / VPRV, cv = (i % VPRV) * 8;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(vb + (size_t)(kt + r) * c + cv);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(cv + j) * LDV + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x BK keys for this warp, fp32 in registers.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DK; kk += 16) {
      const __nv_bfloat16* qa = qs + (wr + g) * LDQ + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LDQ), ld32(qa + 8),
                             ld32(qa + 8 * LDQ + 8)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * LDQ + kk + 2 * t;
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // Softmax numerators. Each thread holds rows g and g+8 of the warp's 16.
    if (exact) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float alpha0 = __expf(m_run[0] - mx[0]);
      const float alpha1 = __expf(m_run[1] - mx[1]);
      m_run[0] = mx[0];
      m_run[1] = mx[1];
      l_run[0] *= alpha0;
      l_run[1] *= alpha1;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = __expf(s[j][0] - mx[0]);
        s[j][1] = __expf(s[j][1] - mx[0]);
        s[j][2] = __expf(s[j][2] - mx[1]);
        s[j][3] = __expf(s[j][3] - mx[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = __expf(s[j][0]);
        s[j][1] = __expf(s[j][1]);
        s[j][2] = __expf(s[j][2]);
        s[j][3] = __expf(s[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }

    // O += bf16(P) V: the S accumulators are reused as A fragments.
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      const uint32_t a[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                             pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                             pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                             pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const __nv_bfloat16* vp = vts + (n * 8 + g) * LDV + jj * 16 + 2 * t;
        mma_bf16(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)b * nq * c + col0 + dv0;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int cc = n * 8 + 2 * t;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * c + cc) =
          pack_bf16(acc[n][0] / l_run[0], acc[n][1] / l_run[0]);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * c + cc) =
          pack_bf16(acc[n][2] / l_run[1], acc[n][3] / l_run[1]);
  }
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bsz, int nq, int nk, int c, int heads, float scale,
                   int exact, cudaStream_t stream) {
  constexpr int DK = (D + 15) / 16 * 16;
  const size_t smem =
      (size_t)(BQ * (DK + PAD) + BK * (DK + PAD) + DV * (BK + PAD)) *
      sizeof(__nv_bfloat16);
  auto kern = packed_attention_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, heads * (D / DV), bsz);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq,
      nk, c, scale, exact);
  return cudaGetLastError();
}

}  // namespace

// q: (bsz, nq, c), k/v: (bsz, nk, c), o: (bsz, nq, c); all bf16, contiguous.
// Requires c % heads == 0, head dim in {40, 64, 80, 160, 512}, nk % 64 == 0.
extern "C" int mdt_packed_attention(const void* q, const void* k,
                                    const void* v, void* o, int bsz, int nq,
                                    int nk, int c, int heads, float scale,
                                    int exact, void* stream) {
  if (c % heads != 0 || nk % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c / heads) {
    case 40:
      return (int)launch<40, 40>(q, k, v, o, bsz, nq, nk, c, heads, scale, exact, s);
    case 80:
      return (int)launch<80, 80>(q, k, v, o, bsz, nq, nk, c, heads, scale, exact, s);
    case 160:
      return (int)launch<160, 160>(q, k, v, o, bsz, nq, nk, c, heads, scale, exact, s);
    case 64:
      return (int)launch<64, 64>(q, k, v, o, bsz, nq, nk, c, heads, scale, exact, s);
    case 512:
      return (int)launch<512, 128>(q, k, v, o, bsz, nq, nk, c, heads, scale, exact, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
