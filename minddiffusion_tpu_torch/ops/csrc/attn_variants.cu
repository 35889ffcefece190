// Four variants of the heads-packed attention kernel for Hopper (sm_90a), on
// packed (B, N, C = heads * 64) bf16 tensors, head h being the column slice
// [64h, 64h + 64). They replace the TPU kernels of
// benchmarks/research/attn_variants.py (K10) and benchmarks/bench_attention.py
// (K11):
//
//  * mdt_attn_ones, ones_mode 1: `flash_attention_packed_ones`
//    (`_packed_ones_kernel`, pallas_call :86) and `ones_attention`
//    (`_ones_kernel`, bench_attention.py:76), whose bodies are the same. V
//    arrives augmented per head to 128 columns, [v_h | 1 | 0 ...] (the
//    wrapper builds it, as the JAX functions do outside their pallas_call),
//    and the PV product yields the softmax row sum in the ones column.
//  * mdt_attn_ones, ones_mode 2: `flash_attention_packed_fold`
//    (`_packed_fold_kernel`, :183). The same fold with plain V: the ones
//    column is written into shared memory as each V tile lands.
//  * mdt_attn_out with wq == NULL: `flash_attention_packed_out`
//    (`_packed_out_kernel`, :386), attention(q, k, v) @ Wo + bo with the
//    output projection in the epilogue.
//  * mdt_kv_proj, then mdt_attn_out with wq: `flash_attention_packed_proj`
//    (`_packed_proj_kernel`, :292), to_out(attention(x Wq*scale, x Wk, x Wv))
//    + bo. The TPU kernel built K' = x Wk and V' = x Wv into VMEM at grid
//    step 0 and reused them for every q tile, relying on the grid running in
//    order. Blocks here run in no order, and N x C (2.6 MB at the 64^2 site)
//    fits no block, so the first launch writes K' and V' (rounded to bf16,
//    as the TPU kernel rounds its scratch) to a workspace with a 64 x 64
//    tile GEMM, and the second projects each q tile, attends, and runs the
//    Wo epilogue. Both launches are this kernel; no library GEMM is called.
//
// The TPU kernels hold a whole row of K (Nk up to ~4096) in VMEM and take a
// plain softmax over it. A block's 227 KB of shared memory does not hold
// that, so every kernel here runs an online softmax over 64-key tiles: one
// block per (64-row q tile, head, batch) for the ones kernels, per (64-row q
// tile, batch) for the out kernels, 4 warps of 16 rows, mma.sync m16n8k16
// with bf16 operands and fp32 accumulators, K tiles by cp.async, V tiles
// transposed through registers. Keys past Nk are zero-filled and masked to
// -inf, rows past Nq are zero and not stored, so any Nq and Nk >= 1 work.
//
// The ones column: the PV product runs over 9 column tiles of 8 instead of
// 8, the ninth being [1 0 ... 0] (the first 8 columns of the augmented
// half), so l comes out of the tensor cores (1/8 more PV work, no row-sum
// pass). exact=1 rescales the accumulators, the l column with them, at each
// new row max; exact=0 is exp(s - 20) (`_FAST_SHIFT`) with no rescale.
// Because P is rounded to bf16 before PV, l is the sum of the rounded P, as
// on the TPU.
//
// The out kernels keep the q tile (64 x C bf16) in shared memory. Head h's
// output o_h, rounded to bf16 as the TPU kernel rounds it, overwrites q_h
// (each warp its own rows) once head h is done, so after the last head the
// buffer holds the concatenated heads and the epilogue computes
// o (64 x C) @ Wo (C x C_out) in 64-column chunks, Wo streamed through
// shared memory in 64 x 64 tiles: the sum over heads accumulates in fp32
// inside the product. + bo in fp32, one rounding to bf16. Their softmax is
// the TPU kernels': exact=1 the row max, exact=0 raw exp(s) with no shift
// (fp32 overflow above logit ~88), l the fp32 sum of the unrounded P.
// Shared memory 64 x (C + 8) x 2 B + 36 KB: C up to 1280.
//
// What bounds them on the H100: at the UNet sites (D = 64, 1024-4096 keys)
// 4 Nq Nk D flops per head against 6 N C bytes, far above the ~295
// flop/byte ridge; the tensor cores and one fp32 exp per score (16 a clock
// per SM) set the floor, and the projections of the out kernels add
// 2 N C C_out (K10d) or 8 N C^2 (K10c) flops. This is the simple plan:
// single-stage tiles, no warp specialisation, one block of 128 threads per
// SM for the out kernels at C 640 (their shared q tile).
#include "mma.cuh"

#include <math.h>

namespace {

constexpr float FAST_SHIFT = 20.0f;
constexpr int D = 64;              // head dim every entry point takes
constexpr int BQ = 64;             // q rows per block, 16 per warp
constexpr int BK = 64;             // keys per tile
constexpr int AP = 8;              // bf16 padding per shared row (bank spread)
constexpr int LDH = D + AP;        // a row of a Q, K, A or transposed W tile
constexpr int LDT = BK + AP;       // a row of a transposed V tile
constexpr int NT = D / 8;          // 8-column output tiles of one head
constexpr int THREADS = 128;
constexpr int MAX_C = 1280;        // the out kernels' shared q tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows x 64 columns of a bf16 row-major matrix into a [64][LDH] shared
// tile, the fp32 `scale` applied and the result rounded to bf16 when
// scale != 1; rows past `rows` are zero.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ldd,
                                          const __nv_bfloat16* src, size_t lds,
                                          int rows, float scale) {
  for (int i = threadIdx.x; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      val = *reinterpret_cast<const uint4*>(src + r * lds + cv);
      if (scale != 1.f) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ldd + cv) = val;
  }
}

// W[k0:k0+64, n0:n0+64] of a row-major (kdim x ndim) bf16 matrix into a
// [64 n][LDH] shared tile, transposed (the mma B operand wants k
// contiguous); zero outside the matrix. ndim % 8 == 0.
__device__ __forceinline__ void load_w_t(__nv_bfloat16* wts, const __nv_bfloat16* w,
                                         int ldw, int k0, int kdim, int n0, int ndim) {
  for (int i = threadIdx.x; i < 64 * 8; i += THREADS) {
    const int r = i / 8, cv = (i % 8) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (k0 + r < kdim && n0 + cv < ndim)
      raw = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ldw + n0 + cv);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) wts[(cv + j) * LDH + r] = e[j];
  }
}

// acc (this warp's 16 rows x 64 columns, fp32) += A (16 x 64, shared, row
// stride lda, starting at the warp's first row) @ the tile in wts.
__device__ __forceinline__ void mma_16x64(float (&acc)[NT][4], const __nv_bfloat16* a,
                                          int lda, const __nv_bfloat16* wts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    const __nv_bfloat16* ap = a + g * lda + kk + 2 * t;
    const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8), ld32(ap + 8 * lda + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = wts + (n * 8 + g) * LDH + kk + 2 * t;
      mma_bf16(acc[n], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// One head's attention for this warp's 16 q rows over all nk keys. Q sits
// in shared memory at qs (row stride ldq, the warp's rows at warp*16). K
// and V rows of this head start at kb / vb with token strides ks_ / vs_.
// NO = NT output tiles, + 1 for the ones column (ones_mode 1: the
// augmented V's columns D..D+7 from memory; 2: [1 0 ... 0] built here).
// Leaves the unnormalised accumulators in acc and, where there is no ones
// column, the fp32 row sums of the unrounded P (rows g and g+8) in l_run.
template <int NO>
__device__ __forceinline__ void attend(float (&acc)[NO][4], float (&l_run)[2],
                                       const __nv_bfloat16* qs, int ldq,
                                       __nv_bfloat16* ks, __nv_bfloat16* vts,
                                       const __nv_bfloat16* kb, int ks_,
                                       const __nv_bfloat16* vb, int vs_, int ones_mode,
                                       int nk, int exact, float shift) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  l_run[0] = l_run[1] = 0.f;

  for (int kt = 0; kt < nk; kt += BK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BK * (D / 8); i += THREADS) {
      const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
      const bool ok = kt + r < nk;
      cp_async16(ks + r * LDH + cv, kb + (size_t)(ok ? kt + r : 0) * ks_ + cv, ok);
    }
    for (int i = tid; i < BK * NO; i += THREADS) {
      const int r = i / NO, cv = (i % NO) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (kt + r < nk) {
        if (cv < D || ones_mode == 1)
          raw = *reinterpret_cast<const uint4*>(vb + (size_t)(kt + r) * vs_ + cv);
        else
          raw.x = 0x3F80u;  // bf16 1.0 in element 0, zeros after it
      }
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(cv + j) * LDT + r] = e[j];
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys for this warp, fp32 in registers.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = qs + (wr + g) * ldq + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ldq), ld32(qa + 8), ld32(qa + 8 * ldq + 8)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * LDH + kk + 2 * t;
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }
    if (kt + BK > nk) {  // keys past nk leave the softmax
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = kt + j * 8 + 2 * t;
        if (col >= nk) s[j][0] = s[j][2] = -INFINITY;
        if (col + 1 >= nk) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // Softmax numerators; each thread holds rows g and g+8 of the warp's 16.
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
      for (int n = 0; n < NO; ++n) {
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
        s[j][0] = __expf(s[j][0] - shift);
        s[j][1] = __expf(s[j][1] - shift);
        s[j][2] = __expf(s[j][2] - shift);
        s[j][3] = __expf(s[j][3] - shift);
      }
    }
    if (NO == NT) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        l_run[0] += s[j][0] + s[j][1];
        l_run[1] += s[j][2] + s[j][3];
      }
    }

    // acc += bf16(P) V: the S accumulators are reused as A fragments.
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      const uint32_t a[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                             pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                             pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                             pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vp = vts + (n * 8 + g) * LDT + jj * 16 + 2 * t;
        mma_bf16(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
}

// K10a / K11 (ones_mode 1, v = the augmented V, v_cols = 2c) and K10b
// (ones_mode 2, v plain, v_cols = c). Grid (ceil(nq / 64), heads, bsz).
__global__ void __launch_bounds__(THREADS) attn_ones_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int nq, int nk,
    int c, int v_cols, int ones_mode, float scale, int exact) {
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDH];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDH];
  __shared__ __align__(16) __nv_bfloat16 vts[(D + 8) * LDT];
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const size_t vcol = (size_t)h * (ones_mode == 1 ? 2 * D : D);

  load_rows(qs, LDH, q + ((size_t)b * nq + q0) * c + h * D, c, nq - q0, scale);
  float acc[NT + 1][4], l_unused[2];
  attend<NT + 1>(acc, l_unused, qs, LDH, ks, vts, k + (size_t)b * nk * c + h * D, c,
                 v + (size_t)b * nk * v_cols + vcol, v_cols, ones_mode, nk, exact,
                 FAST_SHIFT);
  // l is column 0 of the ones tile: held by the quad's t = 0 thread
  const float l0 = __shfl_sync(0xffffffffu, acc[NT][0], lane & ~3);
  const float l1 = __shfl_sync(0xffffffffu, acc[NT][2], lane & ~3);
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)b * nq * c + h * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int cc = n * 8 + 2 * t;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * c + cc) =
          pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * c + cc) =
          pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
}

// K10d (wq == NULL: qx is q, scaled here) and K10c's second launch (qx is
// x, projected here by wq = Wq * scale). Grid (ceil(nq / 64), bsz); dynamic
// shared memory: the q/o tile, then the K, V, A and W tiles.
__global__ void __launch_bounds__(THREADS) attn_out_kernel(
    const __nv_bfloat16* __restrict__ qx, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ wq,
    const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
    __nv_bfloat16* __restrict__ o, int nq, int nk, int c, int c_out, int heads,
    float scale, int exact) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = c + AP;
  __nv_bfloat16* qo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qo + BQ * ldq;
  __nv_bfloat16* vts = ks + BK * LDH;
  __nv_bfloat16* at = vts + D * LDT;
  __nv_bfloat16* wts = at + BQ * LDH;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const __nv_bfloat16* qxb = qx + ((size_t)b * nq + q0) * c;
  float acc[NT][4];

  if (wq == nullptr) {
    for (int c0 = 0; c0 < c; c0 += D) load_rows(qo + c0, ldq, qxb + c0, c, nq - q0, scale);
  } else {
    for (int n0 = 0; n0 < c; n0 += 64) {  // q = bf16(x Wq'), 64 columns at a time
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int k0 = 0; k0 < c; k0 += 64) {
        __syncthreads();
        load_rows(at, LDH, qxb + k0, c, nq - q0, 1.f);
        load_w_t(wts, wq, c, k0, c, n0, c);
        __syncthreads();
        mma_16x64(acc, at + wr * LDH, LDH, wts);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        __nv_bfloat16* dst = qo + (wr + g) * ldq + n0 + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[n][0], acc[n][1]);
        *reinterpret_cast<uint32_t*>(dst + 8 * ldq) = pack_bf16(acc[n][2], acc[n][3]);
      }
    }
  }

  for (int h = 0; h < heads; ++h) {
    float l_run[2];
    attend<NT>(acc, l_run, qo + h * D, ldq, ks, vts, k + (size_t)b * nk * c + h * D, c,
               v + (size_t)b * nk * c + h * D, c, 0, nk, exact, 0.f);
    __syncwarp();
    // o_h, rounded to bf16, over q_h: the warp's own rows, read by no other warp
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      __nv_bfloat16* dst = qo + (wr + g) * ldq + h * D + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[n][0] / l_run[0], acc[n][1] / l_run[0]);
      *reinterpret_cast<uint32_t*>(dst + 8 * ldq) =
          pack_bf16(acc[n][2] / l_run[1], acc[n][3] / l_run[1]);
    }
  }

  // out = o (64 x c) @ Wo (c x c_out) + bo, 64 output columns at a time
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)b * nq * c_out;
  for (int n0 = 0; n0 < c_out; n0 += 64) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int k0 = 0; k0 < c; k0 += 64) {
      __syncthreads();
      load_w_t(wts, wo, c_out, k0, c, n0, c_out);
      __syncthreads();
      mma_16x64(acc, qo + wr * ldq + k0, ldq, wts);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int cc = n0 + n * 8 + 2 * t;
      if (cc >= c_out) continue;
      const float b0 = bo[cc], b1 = bo[cc + 1];
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * c_out + cc) =
            pack_bf16(acc[n][0] + b0, acc[n][1] + b1);
      if (r1 < nq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * c_out + cc) =
            pack_bf16(acc[n][2] + b0, acc[n][3] + b1);
    }
  }
}

// K10c's first launch: kout = bf16(x Wk), vout = bf16(x Wv) over m = B*N
// rows (blockIdx.z picks the pair). Grid (c / 64, ceil(m / 64), 2).
__global__ void __launch_bounds__(THREADS) kv_proj_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
    const __nv_bfloat16* __restrict__ wv, __nv_bfloat16* __restrict__ kout,
    __nv_bfloat16* __restrict__ vout, int m, int c) {
  __shared__ __align__(16) __nv_bfloat16 at[BQ * LDH];
  __shared__ __align__(16) __nv_bfloat16 wts[64 * LDH];
  const __nv_bfloat16* w = blockIdx.z ? wv : wk;
  __nv_bfloat16* out = blockIdx.z ? vout : kout;
  const int r0 = blockIdx.y * BQ, n0 = blockIdx.x * 64;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < c; k0 += 64) {
    __syncthreads();
    load_rows(at, LDH, x + (size_t)r0 * c + k0, c, m - r0, 1.f);
    load_w_t(wts, w, c, k0, c, n0, c);
    __syncthreads();
    mma_16x64(acc, at + wr * LDH, LDH, wts);
  }
  const int ra = r0 + wr + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int cc = n0 + n * 8 + 2 * t;
    if (ra < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * c + cc) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * c + cc) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

}  // namespace

// q: (bsz, nq, c), k: (bsz, nk, c), v: (bsz, nk, v_cols), o: (bsz, nq, c);
// bf16, contiguous. c = heads * 64; ones_mode 1 takes the augmented V
// (v_cols = 2c), 2 plain V (v_cols = c). nq, nk >= 1.
extern "C" int mdt_attn_ones(const void* q, const void* k, const void* v, void* o,
                             int bsz, int nq, int nk, int c, int heads, int v_cols,
                             int ones_mode, float scale, int exact, void* stream) {
  if (c != heads * D || nq < 1 || nk < 1 || (ones_mode != 1 && ones_mode != 2) ||
      v_cols != (ones_mode == 1 ? 2 * c : c))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + BQ - 1) / BQ, heads, bsz);
  attn_ones_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq, nk, c,
      v_cols, ones_mode, scale, exact);
  return (int)cudaGetLastError();
}

// qx: (bsz, nq, c) q (wq NULL) or x; k, v: (bsz, nk, c); wq: (c, c) or NULL;
// wo: (c, c_out); all bf16, contiguous; bo: (c_out,) fp32; o: (bsz, nq,
// c_out) bf16. c = heads * 64 <= 1280, c_out % 8 == 0.
extern "C" int mdt_attn_out(const void* qx, const void* k, const void* v, const void* wq,
                            const void* wo, const void* bo, void* o, int bsz, int nq,
                            int nk, int c, int c_out, int heads, float scale, int exact,
                            void* stream) {
  if (c != heads * D || c > MAX_C || c_out < 8 || c_out % 8 || nq < 1 || nk < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(BQ * (c + AP) + BK * LDH + D * LDT + BQ * LDH + 64 * LDH) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BQ - 1) / BQ, bsz);
  attn_out_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qx), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
      static_cast<__nv_bfloat16*>(o), nq, nk, c, c_out, heads, scale, exact);
  return (int)cudaGetLastError();
}

// x: (m, c); wk, wv: (c, c); kout, vout: (m, c); bf16, contiguous; c % 64 == 0.
extern "C" int mdt_kv_proj(const void* x, const void* wk, const void* wv, void* kout,
                           void* vout, int m, int c, void* stream) {
  if (c % 64 || m < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(c / 64, (m + BQ - 1) / BQ, 2);
  kv_proj_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(wv), static_cast<__nv_bfloat16*>(kout),
      static_cast<__nv_bfloat16*>(vout), m, c);
  return (int)cudaGetLastError();
}
