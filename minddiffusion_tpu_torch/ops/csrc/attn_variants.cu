// Variants of the heads-packed attention kernel for Hopper (sm_90a), on
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
//  * mdt_attn_out: `flash_attention_packed_out` (`_packed_out_kernel`,
//    :386), attention(q, k, v) @ Wo + bo with the output projection in the
//    epilogue.
//  * mdt_qkv_proj, then mdt_attn_out at scale 1: `flash_attention_packed_proj`
//    (`_packed_proj_kernel`, :292), to_out(attention(x Wq*scale, x Wk,
//    x Wv)) + bo. The TPU kernel built K' = x Wk and V' = x Wv into VMEM at
//    grid step 0 and reused them for every q tile, relying on the grid
//    running in order. Blocks here run in no order, and N x C (2.6 MB at the
//    64^2 site) fits no block, so the first launch writes q, K' and V'
//    (each rounded to bf16, as the TPU kernel rounds its scratch) to a
//    (B N, 3C) workspace in one GEMM, x @ [Wq*scale | Wk | Wv], and the
//    second is K10d's kernel reading them with a row stride of 3C. The
//    round trip of q costs 4 B N C bytes (25 us at ds1 at 3.35 TB/s).
//
// The ones kernels (attn_ones_kernel, `attend`): the TPU kernels hold a
// whole row of K in VMEM and take a plain softmax over it; here an online
// softmax over 64-key tiles, one block per (64-row q tile, head, batch), 4
// warps of 16 rows, mma.sync m16n8k16 with bf16 operands and fp32
// accumulators, K tiles by cp.async, V tiles transposed through registers.
// Keys past Nk are zero-filled and masked to -inf, rows past Nq are zero
// and not stored. The ones column: the PV product runs over 9 column tiles
// of 8 instead of 8, the ninth being [1 0 ... 0], so l comes out of the
// tensor cores. exact=1 rescales the accumulators, the l column with them,
// at each new row max; exact=0 is exp(s - 20) (`_FAST_SHIFT`) with no
// rescale. l is the sum of the rounded P, as on the TPU.
//
// The out kernel (attn_out_kernel) and the projection (qkv_proj_kernel) are
// Hopper designs, the out kernel's attention being the core it shares with
// K1 (attn_core.cuh): TMA into 128-byte swizzled tiles, full / empty mbarriers,
// warpgroup 0 the producer (one thread issues every load), the other
// warpgroups wgmma consumers; no mma.sync, and no thread moves an element
// of K, V or a weight.
//  * CTA tile (a template parameter): 64 q rows per consumer warpgroup of
//    one batch element, the q / o tile (rows x C bf16) held for the whole
//    CTA. 192 rows (3 consumer warpgroups) up to C 448 where Nq >= 2048:
//    at ds1 (16, 4096, 320) the third warpgroup hides more of the exps'
//    and barriers' latency than the 128-row tier
//    (scripts/attn_variants_ablate.py, `tiles_128`), while at Nq 1024 its
//    coarser last wave lost. Else 128 rows (2) up to C 640, whose 160 KB
//    tile still leaves 4 stages, else 64 (1) up to 1280.
//    The q tile arrives by TMA as one box per head.
//  * The ring: 8 KB K and V tiles of one 64-key tile of one head, by TMA
//    from the (B, N, C) tensors at column 64 h, head after head, so the
//    pipeline does not drain between heads; then Wo in 64-row x 128-column
//    stages. K and V have a full and an empty barrier each: K is released
//    once S is done, V once PV is. Up to 8 stages of 16 KB.
//  * Per key tile, each consumer warpgroup: S = q_h K^T by wgmma m64n64k16
//    with q_h in registers (loaded from the swizzled tile once a head,
//    scaled in fp32 and rounded to bf16 there) and K as a K-major B; the
//    softmax numerators in registers while PV of the previous tile runs;
//    then S of the next tile and O += P V by wgmma, P from registers (S's
//    accumulators packed to bf16 are the next product's A fragments) and V
//    as an MN-major B, as it lies in memory. The other warpgroups' products
//    run under one's exps (one fp32 ex2 per score, 16 a clock per SM: as
//    long as the products at D 64); all of them read the same K and V
//    stage.
//    Accumulators are written only while no wgmma runs: ptxas otherwise
//    serializes every wgmma (its C7515 warning).
//  * At a head's last tile o_h / l, rounded to bf16, overwrites q_h in the
//    tile (stored at the next tile, once PV is done), in TMA's swizzle
//    (byte (r, chunk j) at r 128 + 16 (j ^ r % 8)), so after the last head
//    the tile holds the concatenated heads as a K-major A. The epilogue:
//    out = o (rows x C) @ Wo by wgmma m64n128k16, Wo an MN-major B (two
//    64-column boxes, 8 KB apart), the sum over heads in the fp32
//    accumulators; + bo in fp32, one rounding to bf16, stores clipped at Nq
//    and C_out. A Wo box wholly past C_out is not loaded.
//  * Keys past Nk and rows past Nq are TMA's zero fill: keys are masked to
//    -inf, rows are not stored, so any Nq, Nk >= 1 work.
//  * Waves, one CTA an SM (the q tile): ds1 22 x 16 = 352 CTAs of 192 rows,
//    2.67 waves on 132 SMs; ds2 (16, 1024, 640) 8 x 16 = 128 CTAs, 0.97;
//    ds4 (16, 256, 1280) 4 x 16 = 64 CTAs of 64 rows, half the card. Not
//    persistent: the next tile's q cannot land in a tile the epilogue
//    still reads.
//  * Tried and dropped, as they did not move ds1 or ds2: products issued
//    in turns between the warpgroups (named barriers), 2-CTA clusters
//    multicasting K and V (half the L2 reads), fewer stages (3 against 8).
//    What the time is spent on: scripts/attn_variants_ablate.py.
//  * qkv_proj_kernel: 128 x 128 output tiles, K 64 a stage, 5 stages of 32
//    KB, two consumer warpgroups of 64 rows on wgmma m64n128k16 (x K-major,
//    the weights MN-major as stored); persistent, one CTA an SM, tiles
//    columns first, so the next tile's loads run under this tile's stores,
//    which go through shared memory and TMA (whole lines, asynchronous):
//    stored from registers they took about half of the kernel's time.
//
// Softmax, as the TPU kernels have it: exact=1 the row max, exact=0 raw
// exp(s) with no shift (fp32 overflow above logit ~88); P rounded to bf16
// before PV, l the fp32 sum of the unrounded P.
//
// What bounds them on the H100: at the UNet sites (D = 64, 1024-4096 keys)
// 4 Nq Nk D flops per head against 6 N C bytes, far above the ~295
// flop/byte ridge; the tensor cores and one fp32 exp per score set the
// floor (ds1: 0.347 ms of products, 0.321 ms of exps), and the projections
// add 2 N C C_out (K10d) or 8 N C^2 (K10c) flops.
#include "attn_core.cuh"
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
constexpr int MAX_C = 1280;        // the out kernel's q / o tile: 64 rows above C 640

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

}  // namespace

// ---- K10c / K10d: warp-specialised attention with the Wo epilogue ----------

namespace {

constexpr int KT = 64;                  // keys per tile
constexpr int BOX = 64 * 128;           // 64 rows of one 64-column swizzled box: 8 KB
constexpr int STAGE_BYTES = 2 * BOX;    // a K and a V tile, or two 64-column Wo boxes
constexpr int MAX_STAGES = 8;
constexpr int EPI_N = 128;              // output columns of one epilogue pass
// q rows of a CTA: 192 (3 consumer warpgroups) up to C 448 where Nq is long
// enough that the coarser last wave costs less than the third warpgroup
// gains, else 128 (2) up to C 640, else 64 (1)
constexpr int WIDEST_MAX_C = 448, WIDEST_MIN_NQ = 2048;
constexpr int WIDE_MAX_C = 640;

using Head64 = Head<D, KT>;   // K10d's head in the attention core (attn_core.cuh)
static_assert(Head64::STAGE == STAGE_BYTES, "a K and a V box a stage");

// K10d, and K10c's attention launch (q, k, v from its projection, scale
// 1). One CTA per (BM = 64 NWG q rows, batch); warpgroup 0 the producer,
// warpgroups 1..NWG the consumers, 64 rows each. Shared memory: the q / o
// tile (heads boxes of BM x 64), the ring, the barriers.
template <int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) attn_out_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_wo,
    const float* __restrict__ bo, __nv_bfloat16* __restrict__ out, int nq, int nk, int heads,
    int c_out, int stages, float scale, int exact) {
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qtile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring<STAGE_BYTES> ring;
  ring.init(qtile + heads * BM * 128, stages);
  const uint32_t q_full = ring.bars + 4 * 8 * stages;
  const int b = blockIdx.y, q0 = blockIdx.x * BM;
  const int nt = (nk + KT - 1) / KT;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    ring.init_barriers(NWG);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (NWG == 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, heads * BM * 128);
      for (int h = 0; h < heads; ++h)
        tma_load_3d(qtile + h * BM * 128, &tm_q, q_full, h * D, q0, b);
      // K and V tiles, head after head: the ring runs on across heads
      ring = load_heads<Head64>(ring, &tm_k, &tm_v, 0, heads, nt, b);
      // then Wo, rows 64 hh.. of each EPI_N-column pass, one stage a head; a
      // box wholly past C_out is not loaded (its columns are not stored)
      for (int n0 = 0; n0 < c_out; n0 += EPI_N)
        for (int hh = 0; hh < heads; ++hh) {
          const bool two = n0 + 64 < c_out;
          const int s = ring.stage;
          mbar_wait(ring.empty_k(s), ring.phase ^ 1);
          mbar_wait(ring.empty_v(s), ring.phase ^ 1);
          mbar_expect_tx(ring.full_k(s), two ? 2 * BOX : BOX);
          tma_load_3d(ring.slot(), &tm_wo, ring.full_k(s), n0, hh * D, 0);
          if (two) tma_load_3d(ring.slot() + BOX, &tm_wo, ring.full_k(s), n0 + 64, hh * D, 0);
          ring.advance();
        }
    }
  } else {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if constexpr (NWG == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int ci = wg - 1, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, g = lane / 4, t = lane % 4, r0 = (t128 / 32) * 16 + g;
    const uint32_t slab = qtile + ci * 64 * 128;   // this warpgroup's rows of head box 0
    ring = attend_heads<Head64>(ring, q_full, slab, BM * 128, heads, nk, r0, t, t128, scale,
                                exact);

    // out = o (BM x C, heads boxes) @ Wo + bo: every o_h of this warpgroup's
    // rows is in shared memory once its own threads' stores are visible to
    // wgmma.
    fence_proxy_async();
    named_barrier_sync(1 + ci, 128);
    const int row0 = q0 + ci * 64 + r0, row1 = row0 + 8;
    __nv_bfloat16* ob = out + (size_t)b * nq * c_out;
    for (int n0 = 0; n0 < c_out; n0 += EPI_N) {
      float acc[64];
      int pend = -1;
      for (int hh = 0; hh < heads; ++hh) {
        mbar_wait(ring.full_k(ring.stage), ring.phase);
        const uint32_t a = slab + hh * BM * 128;
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n128k16<1>(acc, smem_desc(a + kk * 32, 16, 1024),
                                 smem_desc(ring.slot() + kk * 2048, BOX, 1024), hh | kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operand(acc);
        if (t128 == 0 && pend >= 0) {
          mbar_arrive(ring.empty_k(pend));
          mbar_arrive(ring.empty_v(pend));
        }
        pend = ring.stage;
        ring.advance();
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (t128 == 0) {
        mbar_arrive(ring.empty_k(pend));
        mbar_arrive(ring.empty_v(pend));
      }
#pragma unroll
      for (int j = 0; j < EPI_N / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= c_out) continue;
        const float b0 = bo[col], b1 = bo[col + 1];
        if (row0 < nq)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * c_out + col) =
              pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (row1 < nq)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * c_out + col) =
              pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
  }
}

// K10c's first launch: y (m x 3c) = x (m x c) @ [Wq scale | Wk | Wv] (c x 3c),
// fp32 sums rounded to bf16. Persistent: each CTA walks tiles of G_BM x
// EPI_N (columns first, so the CTAs resident together share x's rows in
// L2), and the loads of the next tile run under this tile's stores.
// Warpgroup 0 the producer, 1 and 2 the consumers of 64 rows each; a stage
// holds an x slice (K-major) and two 64-column boxes of the weight that
// holds those columns (MN-major, as stored: c % 64 == 0, so no box spans
// two weights). The output goes through shared memory and TMA stores, so
// its writes are whole lines and the consumers go on to the next tile.
constexpr int G_BM = 128, G_STAGES = 5;
constexpr int G_A_BYTES = G_BM * 128;
constexpr int G_STAGE = G_A_BYTES + 2 * BOX;
constexpr int G_OUT = 2 * 2 * BOX;   // each consumer's 64 x 128 output tile
constexpr int G_SMEM = 1024 + G_STAGES * G_STAGE + G_OUT + 2 * 8 * G_STAGES;

__global__ void __launch_bounds__(384, 1) qkv_proj_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wq,
    const __grid_constant__ CUtensorMap tm_wk, const __grid_constant__ CUtensorMap tm_wv,
    const __grid_constant__ CUtensorMap tm_y, int m, int c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_tiles = base + G_STAGES * G_STAGE;
  const uint32_t full = out_tiles + G_OUT, empty = full + 8 * G_STAGES;
  const int n_cols = 3 * c, k_chunks = c / 64;
  const int tiles_n = (n_cols + EPI_N - 1) / EPI_N;
  const int tiles = (m + G_BM - 1) / G_BM * tiles_n;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    if (threadIdx.x == 0) {
      const CUtensorMap* w[3] = {&tm_wq, &tm_wk, &tm_wv};
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * G_BM, n0 = tile % tiles_n * EPI_N;
        const bool two = n0 + 64 < n_cols;
        for (int kc = 0; kc < k_chunks; ++kc) {
          const uint32_t sb = base + stage * G_STAGE, bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, G_A_BYTES + (two ? 2 * BOX : BOX));
          tma_load_3d(sb, &tm_x, bar, kc * 64, m0, 0);
          for (int j = 0; j < (two ? 2 : 1); ++j) {
            const int col = n0 + 64 * j, which = col / c;
            tma_load_3d(sb + G_A_BYTES + j * BOX, w[which], bar, col - which * c, kc * 64, 0);
          }
          if (++stage == G_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    const int ci = wg - 1, t128 = threadIdx.x % 128, lane = t128 % 32, t = lane % 4;
    const int r0 = (t128 / 32) * 16 + lane / 4;   // row in this warpgroup's 64
    const uint32_t out_tile = out_tiles + ci * 2 * BOX;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * G_BM, n0 = tile % tiles_n * EPI_N;
      float acc[64];
      int pend = -1;
      for (int kc = 0; kc < k_chunks; ++kc) {
        const uint32_t sb = base + stage * G_STAGE;
        mbar_wait(full + 8 * stage, phase);
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n128k16<1>(acc, smem_desc(sb + ci * 64 * 128 + kk * 32, 16, 1024),
                                 smem_desc(sb + G_A_BYTES + kk * 2048, BOX, 1024), kc | kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operand(acc);
        if (t128 == 0 && pend >= 0) mbar_arrive(empty + 8 * pend);
        pend = stage;
        if (++stage == G_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (t128 == 0) {
        mbar_arrive(empty + 8 * pend);
        tma_store_wait<0, true>();   // the last tile's stores have read out_tile
      }
      named_barrier_sync(1 + ci, 128);
#pragma unroll
      for (int j = 0; j < EPI_N / 8; ++j) {
        const uint32_t box = out_tile + (j / 8) * BOX;
        const int col = (8 * j) % 64 + 2 * t;
        sts32(box + swizzle128(r0, col), pack_bf16(acc[4 * j], acc[4 * j + 1]));
        sts32(box + swizzle128(r0 + 8, col), pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
      }
      fence_proxy_async();
      named_barrier_sync(1 + ci, 128);
      if (t128 == 0) {
        tma_store_3d(&tm_y, out_tile, n0, m0 + ci * 64, 0);
        if (n0 + 64 < n_cols) tma_store_3d(&tm_y, out_tile + BOX, n0 + 64, m0 + ci * 64, 0);
        tma_store_commit();
      }
    }
    if (t128 == 0) tma_store_wait<0, false>();
  }
}

int out_tile_rows(int c, int nq) {
  return c <= WIDEST_MAX_C && nq >= WIDEST_MIN_NQ ? 192 : c <= WIDE_MAX_C ? 128 : 64;
}

template <int NWG>
cudaError_t launch_attn_out(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const CUtensorMap& tm_wo, const float* bo,
                            __nv_bfloat16* o, int bsz, int nq, int nk, int heads, int c_out,
                            float scale, int exact, cudaStream_t s, int* ctas) {
  const int q_bytes = heads * 64 * NWG * 128;
  const int fit = (SMEM_MAX - SMEM_SLACK - q_bytes) / STAGE_BYTES;
  const int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  if (stages < 3) return cudaErrorInvalidValue;   // a consumer holds 3 stages at once
  const int smem = SMEM_SLACK + q_bytes + stages * STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(attn_out_kernel<NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 64 * NWG - 1) / (64 * NWG), bsz);
  if (ctas) *ctas = (int)(grid.x * grid.y);
  attn_out_kernel<NWG><<<grid, 128 * (NWG + 1), smem, s>>>(tm_q, tm_k, tm_v, tm_wo, bo, o, nq,
                                                           nk, heads, c_out, stages, scale,
                                                           exact);
  return cudaGetLastError();
}

}  // namespace

// Every entry below writes the CTAs it launches to `ctas` (may be NULL).

// q: (bsz, nq, c), k: (bsz, nk, c), v: (bsz, nk, v_cols), o: (bsz, nq, c);
// bf16, contiguous. c = heads * 64; ones_mode 1 takes the augmented V
// (v_cols = 2c), 2 plain V (v_cols = c). nq, nk >= 1.
extern "C" int mdt_attn_ones(const void* q, const void* k, const void* v, void* o,
                             int bsz, int nq, int nk, int c, int heads, int v_cols,
                             int ones_mode, float scale, int exact, void* stream, int* ctas) {
  if (c != heads * D || nq < 1 || nk < 1 || (ones_mode != 1 && ones_mode != 2) ||
      v_cols != (ones_mode == 1 ? 2 * c : c))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + BQ - 1) / BQ, heads, bsz);
  if (ctas) *ctas = (int)(grid.x * grid.y * grid.z);
  attn_ones_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), nq, nk, c,
      v_cols, ones_mode, scale, exact);
  return (int)cudaGetLastError();
}

// q: (bsz, nq, c), k, v: (bsz, nk, c), each row `ld` elements after the last
// (c for separate tensors, 3c for K10c's projection); wo: (c, c_out); all
// bf16, 16-byte aligned; bo: (c_out,) fp32; o: (bsz, nq, c_out) bf16.
// c = heads * 64 <= 1280, c_out % 8 == 0, ld % 8 == 0.
extern "C" int mdt_attn_out(const void* q, const void* k, const void* v, const void* wo,
                            const void* bo, void* o, int bsz, int nq, int nk, int c, int c_out,
                            int heads, int ld, float scale, int exact, void* stream,
                            int* ctas) {
  if (c != heads * D || c > MAX_C || c_out < 8 || c_out % 8 || nq < 1 || nk < 1 || ld < c ||
      ld % 8)
    return (int)cudaErrorInvalidValue;
  const int bm = out_tile_rows(c, nq);
  CUtensorMap tm_q, tm_k, tm_v, tm_wo;
  if (!make_map(&tm_q, q, bsz, nq, c, 64, bm, ld) || !make_map(&tm_k, k, bsz, nk, c, 64, KT, ld) ||
      !make_map(&tm_v, v, bsz, nk, c, 64, KT, ld) || !make_map(&tm_wo, wo, 1, c, c_out, 64, 64))
    return (int)cudaErrorInvalidValue;
  const float* bias = static_cast<const float*>(bo);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 192)
    return (int)launch_attn_out<3>(tm_q, tm_k, tm_v, tm_wo, bias, out, bsz, nq, nk, heads, c_out,
                                   scale, exact, s, ctas);
  if (bm == 128)
    return (int)launch_attn_out<2>(tm_q, tm_k, tm_v, tm_wo, bias, out, bsz, nq, nk, heads, c_out,
                                   scale, exact, s, ctas);
  return (int)launch_attn_out<1>(tm_q, tm_k, tm_v, tm_wo, bias, out, bsz, nq, nk, heads, c_out,
                                 scale, exact, s, ctas);
}

// x: (m, c); wq (already scaled), wk, wv: (c, c); y: (m, 3c) = x @ [wq | wk |
// wv]; bf16, 16-byte aligned; c % 64 == 0.
extern "C" int mdt_qkv_proj(const void* x, const void* wq, const void* wk, const void* wv,
                            void* y, int m, int c, void* stream, int* ctas) {
  if (c < 64 || c % 64 || m < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_wq, tm_wk, tm_wv, tm_y;
  if (!make_map(&tm_x, x, 1, m, c, 64, G_BM) || !make_map(&tm_wq, wq, 1, c, c, 64, 64) ||
      !make_map(&tm_wk, wk, 1, c, c, 64, 64) || !make_map(&tm_wv, wv, 1, c, c, 64, 64) ||
      !make_map(&tm_y, y, 1, m, 3 * c, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qkv_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)((m + G_BM - 1) / G_BM) * ((3 * c + EPI_N - 1) / EPI_N);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (ctas) *ctas = grid;
  qkv_proj_kernel<<<grid, 384, G_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_wq, tm_wk, tm_wv, tm_y, m, c);
  return (int)cudaGetLastError();
}
