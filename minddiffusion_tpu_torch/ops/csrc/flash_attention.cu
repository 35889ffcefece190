// Head-split online-softmax attention for Hopper (sm_90a):
// softmax(scale * Q K^T) V per (batch, head) on (B, N, H, D) bf16 tensors,
// read in place through strides (token stride H*D), so no head transpose is
// ever materialised. Nq and Nk are arbitrary: rows past Nq are neither read
// nor written, keys past Nk are zero-filled and masked to -inf before the
// softmax, so no padded key enters the sum.
//
// Replaces the TPU kernel minddiffusion_tpu/ops/flash_attention.py
// `_attn_kernel` (pallas_call in `_flash_bhnd`), which needed the (B*H, N, D)
// transpose only because Mosaic cannot block a middle axis.
//
// Numerics follow the TPU kernel: q is scaled in fp32 and rounded to bf16;
// QK^T and PV take bf16 operands with fp32 accumulation (mma.sync
// m16n8k16); running max and sum are fp32; P is rounded to bf16 before PV
// while the row sum adds the fp32 P; the fp32 accumulator is divided by the
// fp32 row sum at the end. exact=1 keeps an online row max and rescales;
// exact=0 is the static-shift softmax exp(s - 20) (`_FAST_SHIFT`), no max.
//
// What bounds it on the H100: 4*N^2*D flops against ~6*N*D bytes per head;
// at the SD sites (N >= 2304) that is far above the card's ~295 flop/byte
// ridge, so the tensor cores (and one exp per score) are the limit.
//
// Two tile plans, chosen by D at launch:
//  * D in {40, 64, 80, 160} (UNet heads: SD2's 64, SD1's 8 heads at C 320,
//    640, 1280): 4 warps x 16 q rows = 64-row q tile; S (16 x 64 per warp)
//    and the 16 x D fp32 output accumulator stay in registers (80 a thread
//    at D = 160), and so do the Q fragments up to D = 80; 64-key K/V tiles
//    are double-buffered in shared memory with cp.async and read with
//    ldmatrix (V with .trans). mma.sync steps QK^T by 16 columns, so Q and
//    K rows are zero-filled in shared memory from D to D rounded up to 16
//    (48 at D = 40); PV and the stores stay at D columns. At D = 40 the
//    fp32 exp, not the tensor cores, is the floor of the kernel.
//  * D = 512 (the VAE's single head): a 64 x 512 fp32 accumulator is 128 KB,
//    beyond one warp's registers, so D is split across 8 warps (each owns 64
//    output columns of all 64 rows: 128 fp32 registers a thread). QK^T is
//    computed once per tile (each warp a 16 x 32 piece over all 512
//    columns) into fp32 S in shared memory; a row pass does the softmax and
//    writes bf16 P and the rescale factor; then every warp multiplies P by
//    its V columns. K for the next tile loads during the softmax and PV, V
//    for the next tile during the next QK^T (cp.async groups). Shared
//    memory: Q, K, V tiles 3 x 65 KB + S 17 KB + P 9 KB = 227,072 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float FAST_SHIFT = 20.0f;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per k tile
constexpr int PAD = 8;   // bf16 padding per shared row (ldmatrix bank spread)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// 16-byte async copy; `valid` false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x D bf16 tile from a strided token array into shared memory (row
// stride LD); rows at or past `limit` are zero-filled.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
    int limit, size_t stride, int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, cv = (i % VPR) * 8;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* s = ok ? src + (size_t)(row0 + r) * stride + cv : src;
    cp_async16(dst + r * LD + cv, s, ok);
  }
}

// Q tile scaled in fp32 and rounded to bf16; rows past nq are zero.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_q_scaled(
    __nv_bfloat16* dst, const __nv_bfloat16* src, int q0, int nq,
    size_t stride, float scale, int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, cv = (i % VPR) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (q0 + r < nq) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)(q0 + r) * stride + cv);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cv) = packed;
  }
}

// ------------------------------------------------- D = 40, 64, 80, 160 --

constexpr int T64 = 128;  // 4 warps

// Shared memory of the small-D plan: the Q tile and two buffers each of K
// and V, rows of DK + PAD bf16 (DK = D rounded up to 16).
constexpr size_t small_smem(int d) {
  return (size_t)(BQ + 4 * BK) * ((d + 15) / 16 * 16 + PAD) * 2;
}

template <int D>
__global__ void __launch_bounds__(T64) flash_small_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int nq, int nk, int heads, float scale, int exact) {
  constexpr int DK = (D + 15) / 16 * 16;  // QK^T depth; columns D..DK-1 are 0
  constexpr int LD = DK + PAD;
  constexpr int TILE = BK * LD;
  // Q fragments stay in registers up to DK = 96; at D = 160 (80 accumulator
  // registers a thread) they are re-read from shared memory every tile.
  constexpr bool QREG = DK <= 96;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;  // 2 buffers
  __nv_bfloat16* vs = ks + 2 * TILE;  // 2 buffers

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t stride = (size_t)heads * D;
  const __nv_bfloat16* qb = q + ((size_t)b * nq * heads + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * nk * heads + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * nk * heads + h) * D;
  const int ntiles = (nk + BK - 1) / BK;

  if constexpr (DK != D) {  // zero the QK^T padding of Q and both K buffers
    constexpr int PV_ = (DK - D) / 8;
    for (int i = tid; i < (BQ + 2 * BK) * PV_; i += T64) {
      const int r = i / PV_, cv = D + (i % PV_) * 8;
      __nv_bfloat16* row = r < BQ ? qs + r * LD : ks + (r - BQ) * LD;
      *reinterpret_cast<uint4*>(row + cv) = make_uint4(0, 0, 0, 0);
    }
  }
  load_tile_async<D, LD, T64>(ks, kb, 0, BK, nk, stride, tid);
  load_tile_async<D, LD, T64>(vs, vb, 0, BK, nk, stride, tid);
  cp_commit();
  load_q_scaled<D, LD, T64>(qs, qb, q0, nq, stride, scale, tid);
  __syncthreads();

  const int wr = warp * 16;
  const __nv_bfloat16* qa =
      qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  uint32_t qf[QREG ? DK / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks_ = 0; ks_ < DK / 16; ++ks_) ldsm_x4(qf[ks_], qa + ks_ * 16);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int j = 0; j < ntiles; ++j) {
    const int kt = j * BK;
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_tile_async<D, LD, T64>(ks + nb * TILE, kb, kt + BK, BK, nk, stride, tid);
      load_tile_async<D, LD, T64>(vs + nb * TILE, vb, kt + BK, BK, nk, stride, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt_s = ks + (j & 1) * TILE;
    const __nv_bfloat16* vt_s = vs + (j & 1) * TILE;

    // S = Q K^T for this warp's 16 rows x 64 keys, fp32.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < DK / 16; ++ks_) {
      uint32_t a[4];
      if constexpr (QREG) {
        a[0] = qf[ks_][0];
        a[1] = qf[ks_][1];
        a[2] = qf[ks_][2];
        a[3] = qf[ks_][3];
      } else {
        ldsm_x4(a, qa + ks_ * 16);
      }
#pragma unroll
      for (int p = 0; p < BK / 16; ++p) {
        uint32_t kf[4];
        ldsm_x4(kf, kt_s + (16 * p + (lane & 7) + 8 * (lane >> 4)) * LD +
                        ks_ * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * p], a, kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], a, kf[2], kf[3]);
      }
    }
    if (kt + BK > nk) {  // ragged last tile: keys past nk leave the softmax
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int col = kt + 8 * n + 2 * t;
        if (col >= nk) s[n][0] = s[n][2] = -INFINITY;
        if (col + 1 >= nk) s[n][1] = s[n][3] = -INFINITY;
      }
    }

    // Softmax numerators; each thread holds rows g and g+8 of the warp's 16.
    if (exact) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
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
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[n][0] = __expf(s[n][0] - mx[0]);
        s[n][1] = __expf(s[n][1] - mx[0]);
        s[n][2] = __expf(s[n][2] - mx[1]);
        s[n][3] = __expf(s[n][3] - mx[1]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - FAST_SHIFT);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      l_run[0] += s[n][0] + s[n][1];
      l_run[1] += s[n][2] + s[n][3];
    }

    // O += bf16(P) V over D columns: pairs of 8-column blocks through
    // ldmatrix.x4.trans, an odd last block (D = 40) through .x2.trans.
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      const uint32_t a[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                             pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                             pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                             pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
      const __nv_bfloat16* vrow =
          vt_s + (16 * jj + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD;
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vrow + 16 * p + 8 * (lane >> 4));
        mma_bf16(acc[2 * p], a, vf[0], vf[1]);
        mma_bf16(acc[2 * p + 1], a, vf[2], vf[3]);
      }
      if constexpr (D % 16) {
        uint32_t vf[2];
        ldsm_x2_t(vf, vrow + D - 8);
        mma_bf16(acc[D / 8 - 1], a, vf[0], vf[1]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + ((size_t)b * nq * heads + h) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int cc = n * 8 + 2 * t;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * stride + cc) =
          pack_bf16(acc[n][0] / l_run[0], acc[n][1] / l_run[0]);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * stride + cc) =
          pack_bf16(acc[n][2] / l_run[1], acc[n][3] / l_run[1]);
  }
}

// --------------------------------------------------------------- D = 512 --

constexpr int TW = 256;      // 8 warps
constexpr int WD = 512;      // head dim of this plan
constexpr int LDW = WD + PAD;
constexpr int LDS = BK + 4;  // fp32 S row
constexpr int LDP = BK + PAD;
constexpr size_t WIDE_SMEM =
    (size_t)(BQ + 2 * BK) * LDW * 2 + (size_t)BQ * LDS * 4 +
    (size_t)BQ * LDP * 2 + (size_t)3 * BQ * 4;

__global__ void __launch_bounds__(TW, 1) flash_d512_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int nq, int nk, int heads, float scale, int exact) {
  constexpr int D = WD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LDW;
  __nv_bfloat16* vs = ks + BK * LDW;
  float* ss = reinterpret_cast<float*>(vs + BK * LDW);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + BQ * LDS);
  float* row_m = reinterpret_cast<float*>(ps + BQ * LDP);
  float* row_l = row_m + BQ;
  float* row_alpha = row_l + BQ;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t stride = (size_t)heads * D;
  const __nv_bfloat16* qb = q + ((size_t)b * nq * heads + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * nk * heads + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * nk * heads + h) * D;
  const int ntiles = (nk + BK - 1) / BK;

  // cp.async groups stay in the order K_j, V_j, K_j+1, V_j+1, ...
  load_tile_async<D, LDW, TW>(ks, kb, 0, BK, nk, stride, tid);
  cp_commit();
  load_tile_async<D, LDW, TW>(vs, vb, 0, BK, nk, stride, tid);
  cp_commit();
  load_q_scaled<D, LDW, TW>(qs, qb, q0, nq, stride, scale, tid);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // QK^T piece of this warp: rows 16*mt.., keys 32*nh..
  const int mt = warp >> 1, nh = warp & 1;
  // PV columns of this warp: 64*warp..
  const int c0 = warp * 64;
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int kt = j * BK;
    cp_wait<1>();  // K_j has landed (V_j may still be in flight)
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, qs + (16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDW +
                     kk + 8 * (lane >> 4));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t kf[4];
        ldsm_x4(kf, ks + (32 * nh + 16 * p + (lane & 7) + 8 * (lane >> 4)) * LDW +
                        kk + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * p], a, kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], a, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = 32 * nh + 8 * n + 2 * t;
      const int row = 16 * mt + g;
      const float x0 = kt + col < nk ? s[n][0] : -INFINITY;
      const float x1 = kt + col + 1 < nk ? s[n][1] : -INFINITY;
      const float x2 = kt + col < nk ? s[n][2] : -INFINITY;
      const float x3 = kt + col + 1 < nk ? s[n][3] : -INFINITY;
      *reinterpret_cast<float2*>(ss + row * LDS + col) = make_float2(x0, x1);
      *reinterpret_cast<float2*>(ss + (row + 8) * LDS + col) = make_float2(x2, x3);
    }
    __syncthreads();  // S is complete; K_j is no longer read

    if (j + 1 < ntiles)
      load_tile_async<D, LDW, TW>(ks, kb, kt + BK, BK, nk, stride, tid);
    cp_commit();  // K_j+1 (an empty group on the last tile)

    // Row pass: 4 threads a row, 16 columns each.
    {
      const int r = tid >> 2, c = (tid & 3) * 16;
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        const float4 f = *reinterpret_cast<const float4*>(ss + r * LDS + c + e);
        x[e] = f.x;
        x[e + 1] = f.y;
        x[e + 2] = f.z;
        x[e + 3] = f.w;
      }
      const float m_old = row_m[r];
      float m_new = m_old, alpha = 1.f, shift = FAST_SHIFT;
      if (exact) {
#pragma unroll
        for (int e = 0; e < 16; ++e) m_new = fmaxf(m_new, x[e]);
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
        alpha = __expf(m_old - m_new);
        shift = m_new;
      }
      float sum = 0.f;
      uint32_t packed[8];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const float p0 = __expf(x[e] - shift), p1 = __expf(x[e + 1] - shift);
        sum += p0 + p1;
        packed[e / 2] = pack_bf16(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      *reinterpret_cast<uint4*>(ps + r * LDP + c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(ps + r * LDP + c + 8) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
      if ((tid & 3) == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_alpha[r] = alpha;
      }
    }
    cp_wait<1>();  // V_j has landed (K_j+1 may still be in flight)
    __syncthreads();

    if (exact) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a0 = row_alpha[16 * i + g], a1 = row_alpha[16 * i + g + 8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[i][n][0] *= a0;
          acc[i][n][1] *= a0;
          acc[i][n][2] *= a1;
          acc[i][n][3] *= a1;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t vf[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ldsm_x4_t(vf[p], vs + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDW +
                             c0 + 16 * p + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(a, ps + (16 * i + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDP +
                       kk + 8 * (lane >> 4));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          mma_bf16(acc[i][2 * p], a, vf[p][0], vf[p][1]);
          mma_bf16(acc[i][2 * p + 1], a, vf[p][2], vf[p][3]);
        }
      }
    }
    __syncthreads();  // V_j and P are no longer read

    if (j + 1 < ntiles)
      load_tile_async<D, LDW, TW>(vs, vb, kt + BK, BK, nk, stride, tid);
    cp_commit();  // V_j+1 (an empty group on the last tile)
  }
  cp_wait<0>();

  __nv_bfloat16* ob = o + ((size_t)b * nq * heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl0 = 16 * i + g, rl1 = rl0 + 8;
    const float inv0 = 1.f / row_l[rl0], inv1 = 1.f / row_l[rl1];
    const int r0 = q0 + rl0, r1 = q0 + rl1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int cc = c0 + 8 * n + 2 * t;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * stride + cc) =
            pack_bf16(acc[i][n][0] * inv0, acc[i][n][1] * inv0);
      if (r1 < nq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * stride + cc) =
            pack_bf16(acc[i][n][2] * inv1, acc[i][n][3] * inv1);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kern, int threads, size_t smem, const void* q,
                   const void* k, const void* v, void* o, int bsz, int nq,
                   int nk, int heads, float scale, int exact,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bsz * heads);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq,
      nk, heads, scale, exact);
  return cudaGetLastError();
}

}  // namespace

// q: (bsz, nq, heads, d), k/v: (bsz, nk, heads, d), o: (bsz, nq, heads, d);
// all bf16, contiguous. d in {40, 64, 80, 160, 512}; nq, nk >= 1, any length.
extern "C" int mdt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int bsz, int nq, int nk, int heads,
                                   int d, float scale, int exact, void* stream) {
  if (nq < 1 || nk < 1 || bsz * heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40:
      return (int)launch(flash_small_kernel<40>, T64, small_smem(40), q, k, v, o,
                         bsz, nq, nk, heads, scale, exact, s);
    case 64:
      return (int)launch(flash_small_kernel<64>, T64, small_smem(64), q, k, v, o,
                         bsz, nq, nk, heads, scale, exact, s);
    case 80:
      return (int)launch(flash_small_kernel<80>, T64, small_smem(80), q, k, v, o,
                         bsz, nq, nk, heads, scale, exact, s);
    case 160:
      return (int)launch(flash_small_kernel<160>, T64, small_smem(160), q, k, v, o,
                         bsz, nq, nk, heads, scale, exact, s);
    case 512:
      return (int)launch(flash_d512_kernel, TW, WIDE_SMEM, q, k, v, o, bsz, nq,
                         nk, heads, scale, exact, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
