// The attention core of the Hopper (sm_90a) heads-packed attention kernels:
// K10d / K10c's `attn_out_kernel` (attn_variants.cu, with the Wo epilogue),
// K1's `packed_attn_kernel` (packed_attention.cu, no epilogue), the ones
// kernels of K10a / K10b / K11 (`attn_ones_kernel`, attn_variants.cu) and
// K12's ablation modes (`diag_kernel`, attn_diag.cu), on packed (B, N, C =
// heads * D) bf16 tensors, head h being the column slice [D h, D h + D).
// Templated on the head (`Head<D, KT, DV, MODE, K_MN>`: head dim, keys per
// tile, PV width, what the loop computes, K's layout); at D 64, KT 64 in
// mode ATTN (K10d) every piece below reduces to the code it had as K10d's
// own, and each other mode cuts, changes or widens a stage of that loop at
// compile time (`if constexpr`), with no branch added to it at run time.
//
//  * The q / o tile: rows x the CTA's columns (all of C, or in K1 a group
//    of heads' columns) in bf16, as boxes of 64 columns (128 bytes, TMA's
//    128-byte swizzle), each box `box_bytes` = rows x 128 apart, a consumer
//    warpgroup's 64 rows at its `slab` inside each. Column c of the CTA's
//    head h is the tile's column D h + c: box (D h + c) / 64, so a head may
//    start inside a box (D 40, 80, 160). At a head's end o_h / l, rounded
//    to bf16, overwrites q_h there, so after the last head the tile holds
//    the concatenated heads.
//  * The ring: stages of a K and a V tile of one key tile of one head, by
//    TMA from column col0 + D h (col0: the CTA's first), head after head
//    (the pipeline does not drain between heads); each tile as ceil(DK /
//    64) (K) and ceil(DV / 64) (V) boxes of KT rows x 64 columns, 64 KT
//    bytes apart. Columns past the head (the next head's, or TMA's zero
//    fill past C) are loaded and not read, or read against zeros. K and V
//    have a full and an empty barrier each: K is released once S is done,
//    V once PV is. The modes that take no V have stages of a K tile only.
//  * S = q_h K^T by wgmma m64nKTk16, q_h in registers (from the tile once
//    a head, scaled in fp32 and rounded to bf16 there) and K K-major, DK =
//    D rounded up to 16 deep: at D 40 q_h's columns 40..47 are zero in
//    registers, so the next head's 8 columns (or the zero fill) add
//    nothing. K_MN: K arrives transposed, (B, C, N), and its tile (D rows
//    of KT keys) is an MN-major B as it lies, V's layout for PV, so no
//    thread transposes it. O += P V by wgmma m64nDVk16, P from registers
//    (S's accumulators packed to bf16 are the A fragments) and V MN-major
//    as it lies in memory: the leading offset steps to the next 64-column
//    box, and a product narrower than its last box (D 40, 80, 160, DV 72)
//    reads only its columns.
//  * Per tile: the softmax numerators while PV of the previous tile runs,
//    then S of the next tile and PV of this one. Accumulators are written
//    only while no wgmma runs: ptxas otherwise serializes every wgmma (its
//    C7515 warning); the mbarrier waits spin in one asm block (hopper.cuh).
//  * Keys past Nk come from TMA's zero fill and are masked to -inf.
//
// Softmax, as the TPU kernels have it: exact=1 the running row max (alpha
// rescales o and l at each new max), exact=0 raw exp(s) with no shift
// (fp32 overflow above logit ~88); P rounded to bf16 before PV, l the fp32
// sum of the unrounded P.
#pragma once

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int SMEM_MAX = 232448;        // a block's shared memory on the H100 (opt-in)
constexpr int SMEM_SLACK = 1024 + 512;  // 1024-byte alignment of the tiles, the barriers
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx: 2 ulp; 0 at -inf, +inf above 128).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The fp32 values of the two bf16 halves of x (low, high): by shifts.
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// A 32-bit word as a bf16 pair, and back.
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(bf16(s0)), exp(bf16(s1)) rounded to bf16, packed (K12's bf16s).
// PACKED: ex2.approx.ftz.bf16x2 (one MUFU op per two scores), the
// counterpart of the TPU mode's bf16 exp on its vector unit, with every
// step in packed bf16 arithmetic. Its argument is bf16, whose 8-bit
// mantissa would cost up to 9% at s ~ 40 if it took bf16(s log2 e) whole;
// so with log2 e = L_hi + L_lo (both bf16, L_hi rounded down) the exponent
// t = b log2 e of b = bf16(s) is split as hi = bf16(b L_hi) and lo = (b
// L_hi - hi) + b L_lo (the first term exact in a bf16 fma), |lo| under
// 3/4; 2^hi comes from the packed exp (0 below 2^-126, ftz; inf from 2^128
// on), 2^lo from its cubic Taylor polynomial in lo ln2. b is clamped to
// [-100, 100] first, beyond which the result is 0 or inf all the same.
// Within 1% of torch.exp at every bf16 input where that is a normal bf16
// (chip_smoke.py checks the kernel's own table). Else the fp32 exp of the
// bf16-rounded score, rounded to bf16.
template <bool PACKED>
__device__ __forceinline__ uint32_t exp_bf16x2(float s0, float s1) {
  const uint32_t sb = pack_bf16(s0, s1);
  if constexpr (PACKED) {
    // bf16 words, twice: -100, 100; L_hi, L_lo; 1 and ln2, ln2^2 / 2, ln2^3 / 6
    constexpr uint32_t LO = 0xC2C8C2C8u, HI = 0x42C842C8u, L_HI = 0x3FB83FB8u,
                       L_LO = 0x3BAA3BAAu, ONE = 0x3F803F80u, C1 = 0x3F313F31u,
                       C2 = 0x3E763E76u, C3 = 0x3D633D63u;
    const __nv_bfloat162 b = __hmin2(__hmax2(as_bf2(sb), as_bf2(LO)), as_bf2(HI));
    const __nv_bfloat162 hi = __hmul2(b, as_bf2(L_HI));
    const __nv_bfloat162 lo = __hfma2(b, as_bf2(L_LO), __hfma2(b, as_bf2(L_HI), __hneg2(hi)));
    uint32_t e;
    asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(e) : "r"(bits(hi)));
    const __nv_bfloat162 q = __hfma2(
        lo, __hfma2(lo, __hfma2(lo, as_bf2(C3), as_bf2(C2)), as_bf2(C1)), as_bf2(ONE));
    return bits(__hmul2(as_bf2(e), q));
  } else {
    return pack_bf16(__expf(bf16_lo(sb)), __expf(bf16_hi(sb)));
  }
}

// What the loop computes (`Head`'s MODE). s = q_h K_h^T in fp32 throughout;
// the modes other than ATTN and ONES apply no scale and no max, as the TPU
// ablation modes do, so their exps overflow above logit ~88.72.
enum CoreMode {
  ATTN,        // softmax(q K^T) V, o / l (K1, K10d; K12 full and kt_full at scale 1, raw)
  ONES,        // ATTN with PV 72 wide over V's head tile [v_h | 1 | 0 ...]: l = o's
               // column 64, the fp32 tensor-core sum of the rounded P (K10a, K10b, K11);
               // exact=0 takes exp(s - FAST_SHIFT)
  ROWSUM_S,    // the fp32 row sum of s, broadcast over the head's columns (qk, kt_qk)
  ROWSUM_EXP,  // the fp32 row sum of exp(s), broadcast (exp)
  SLICE_S,     // s against keys 0..KT-1 (slice); every tile's S computed all the same
  SLICE_EXP,   // exp(s) against keys 0..KT-1 (expslice); every tile's exps computed
  NOSM,        // bf16(s) V, not normalised (nosm)
  BF16S,       // p = exp_bf16x2<false>, l = the fp32 sum of the rounded p, (p V) / l
  BF16S_EX2,   // the same with the packed exp (bf16s_ex2)
  FP32PV,      // exp(s) V, P in fp32 on TF32 wgmma, not normalised (fp32pv)
};
constexpr float FAST_SHIFT = 20.0f;   // ONES' static shift at exact=0 (`_FAST_SHIFT`)

// One head's shapes: head dim D, KT keys a tile, PV DV columns wide, the
// mode, and K_MN: K given transposed, (B, C, N).
template <int D_, int KT_, int DV_ = D_, int MODE_ = ATTN, bool K_MN_ = false>
struct Head {
  static constexpr int D = D_, KT = KT_, DV = DV_, MODE = MODE_;
  static constexpr bool K_MN = K_MN_;
  static constexpr bool TF32_PV = MODE == FP32PV;
  static constexpr bool USES_V = MODE == ATTN || MODE == ONES || MODE == NOSM ||
                                 MODE == BF16S || MODE == BF16S_EX2 || TF32_PV;
  static constexpr int DK = (D + 15) / 16 * 16;      // QK^T depth
  static constexpr int QS = DK / 16;                 // k16 slices of q_h and K
  static constexpr int PS = TF32_PV ? KT / 8 : KT / 16;   // k16 (TF32: k8) slices of P
  static constexpr int KBOX = (DK + 63) / 64;        // 64-column boxes of a K tile
  // of a V tile; TF32: V^T in fp32, 32 keys (128 bytes) x D channel rows a box
  static constexpr int VBOX = TF32_PV ? KT / 32 : (DV + 63) / 64;
  static constexpr int BOX = KT * 128;               // bytes of one box
  static constexpr int K_BYTES = KBOX * BOX, V_BYTES = USES_V ? VBOX * BOX : 0;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int SR = KT / 2, OR = DV / 2;     // S and o accumulators a thread
  static_assert(D % 8 == 0 && KT % 16 == 0 && DV % 8 == 0, "wgmma widths");
  static_assert((!K_MN && !TF32_PV) || (D == 64 && KT == 64 && DV == 64),
                "K^T and V^T tiles: one 64 x 64 head tile");
  static_assert(MODE != ONES || DV == D + 8, "the ones column: 8 columns past the head");
};

// A ring of stages in shared memory, each a K and a V slot with a full and
// an empty barrier apiece, which the producer and every consumer warpgroup
// walk in the same order. Barriers: full K, full V, empty K, empty V,
// `stages` each.
template <int STAGE>
struct Ring {
  uint32_t base, bars;
  int stage, stages;
  uint32_t phase;
  __device__ __forceinline__ uint32_t slot() const { return base + stage * STAGE; }
  __device__ __forceinline__ uint32_t bar(int kind, int s) const {
    return bars + 8 * (kind * stages + s);
  }
  __device__ __forceinline__ uint32_t full_k(int s) const { return bar(0, s); }
  __device__ __forceinline__ uint32_t full_v(int s) const { return bar(1, s); }
  __device__ __forceinline__ uint32_t empty_k(int s) const { return bar(2, s); }
  __device__ __forceinline__ uint32_t empty_v(int s) const { return bar(3, s); }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // `n` stages at `slots`, their barriers right after them.
  __device__ __forceinline__ void init(uint32_t slots, int n) {
    base = slots;
    bars = slots + n * STAGE;
    stage = 0;
    stages = n;
    phase = 0;
  }
  // Full barriers armed by the producer's one thread, empty ones released
  // by `consumers` warpgroups.
  __device__ __forceinline__ void init_barriers(int consumers) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), consumers);
      mbar_init(empty_v(s), consumers);
    }
  }
};

// Where head h of a warpgroup's rows of the q / o tile (its slab; 64-column
// boxes box_bytes apart) is found: at D 64 its own box, else the slab, the
// head's columns counted from the tile's first (`head_at`).
template <class H>
__device__ __forceinline__ uint32_t head_base(uint32_t slab, int h, int box_bytes) {
  if constexpr (H::D == 64)
    return slab + h * box_bytes;
  else
    return slab;
}

// Shared address of row r, column c of head h, from head_base's address.
template <class H>
__device__ __forceinline__ uint32_t head_at(uint32_t base, int h, int c, int r, int box_bytes) {
  if constexpr (H::D == 64) {
    return base + swizzle128(r, c);
  } else {
    const int col = h * H::D + c;
    return base + (col >> 6) * box_bytes + swizzle128(r, col & 63);
  }
}

// This warp's rows of q_h (head_base's `base`) as wgmma A fragments (QS k16
// slices of 4 registers), scaled in fp32 and rounded to bf16 when scale !=
// 1; depth past D is zero. r0 = 16 w + g.
template <class H>
__device__ __forceinline__ void load_q(uint32_t (&qf)[H::QS][4], uint32_t base, int h,
                                       int box_bytes, int r0, int t, float scale) {
#pragma unroll
  for (int kk = 0; kk < H::QS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (16 * kk + 8 * (i >> 1) >= H::D) {
        qf[kk][i] = 0u;
        continue;
      }
      uint32_t raw = lds32(head_at<H>(base, h, 16 * kk + 8 * (i >> 1) + 2 * t, r0 + 8 * (i & 1),
                                      box_bytes));
      if (scale != 1.f) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        raw = pack_bf16(f.x * scale, f.y * scale);
      }
      qf[kk][i] = raw;
    }
}

// s = q_h K^T for one key tile: K K-major in its swizzled boxes, or (K_MN)
// the K^T tile MN-major, its k16 slice kk the 16 channel rows from 2048 kk.
template <class H>
__device__ __forceinline__ void issue_s(float (&s)[H::SR], const uint32_t (&qf)[H::QS][4],
                                        uint32_t kslot) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H::QS; ++kk)
    if constexpr (H::K_MN)
      wgmma_rs<H::KT, 1>(s, qf[kk], smem_desc(kslot + kk * 2048, 1024, 1024), kk);
    else
      wgmma_rs<H::KT, 0>(s, qf[kk],
                         smem_desc(kslot + (kk / 4) * H::BOX + (kk % 4) * 32, 16, 1024), kk);
  wgmma_commit();
}

// o (+)= P V for one key tile: P from registers, V MN-major as it lies in
// memory (keys x DV values, 64-column boxes BOX apart), so no thread moves
// an element of V; a head's first tile overwrites o (accumulate 0). TF32:
// P in fp32 (its k8 slices), V^T K-major (the V^T tile: channel rows of 32
// keys a box, the k8 slice kk 32 bytes into box kk / 4), each 8-key chunk
// in the order of `fp32pv_key`.
template <class H>
__device__ __forceinline__ void issue_pv(float (&o)[H::OR], const uint32_t (&p)[H::PS][4],
                                         uint32_t vslot, int accumulate) {
  wgmma_fence();
  if constexpr (H::TF32_PV) {
#pragma unroll
    for (int kk = 0; kk < H::PS; ++kk)
      wgmma_tf32_rs_m64n64k8(o, p[kk],
                             smem_desc(vslot + (kk / 4) * H::BOX + (kk % 4) * 32, 16, 1024),
                             accumulate | kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < H::PS; ++kk)
      wgmma_rs<H::DV, 1>(o, p[kk],
                         smem_desc(vslot + kk * 2048, H::VBOX > 1 ? H::BOX : 1024, 1024),
                         accumulate | kk);
  }
  wgmma_commit();
}

// Key position p of an 8-key chunk of FP32PV's V^T holds the chunk's key
// fp32pv_key(p), (0, 2, 4, 6, 1, 3, 5, 7): S's accumulators (keys 2t, 2t +
// 1 of each chunk) are then the TF32 A fragment's (t, t + 4) as they lie.
__device__ __forceinline__ int fp32pv_key(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// Softmax numerators of one tile in place, rows g and g + 8 of the warp's
// 16: keys from `valid` on are masked; exact: exp(s - running max), alpha
// the factor for the sums so far; otherwise raw exp(s) (ONES: exp(s -
// FAST_SHIFT)). l = l alpha + the fp32 row sums of the unrounded numerators
// (this thread's columns). The cut modes: ROWSUM_S sums s itself, SLICE_S,
// NOSM and BF16S leave s as it is (BF16S takes its exps as it packs P),
// SLICE_EXP and FP32PV take raw exp(s) and no sum.
template <class H>
__device__ __forceinline__ void numerators(float (&s)[H::SR], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], int valid, int t, int exact) {
  constexpr int MODE = H::MODE;
  if (valid < H::KT) {
#pragma unroll
    for (int j = 0; j < H::KT / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= valid) s[4 * j] = s[4 * j + 2] = -INFINITY;
      if (col + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    }
  }
  float neg[2] = {0.f, 0.f};
  alpha[0] = alpha[1] = 1.f;
  float sum[2] = {0.f, 0.f};
  if constexpr (MODE == ROWSUM_S) {
#pragma unroll
    for (int j = 0; j < H::KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += s[4 * j + e];
  } else if constexpr (MODE != SLICE_S && MODE != NOSM && MODE != BF16S && MODE != BF16S_EX2) {
    if constexpr (MODE == ONES) neg[0] = neg[1] = -FAST_SHIFT * LOG2E;
    if constexpr (MODE == ATTN || MODE == ONES) {
      if (exact) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < H::KT / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = ex2((m[r] - mx[r]) * LOG2E);
          m[r] = mx[r];
          neg[r] = -mx[r] * LOG2E;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H::KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], LOG2E, neg[e >> 1]));
        if constexpr (MODE == ATTN || MODE == ROWSUM_EXP) sum[e >> 1] += s[4 * j + e];
      }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Columns 0..D-1 of x (laid out as an accumulator: rows r0 and r0 + 8 of
// this warp, columns 8 j + 2 t, + 1), divided by d0 and d1 and rounded to
// bf16, over head h's columns of the tile (head_base's `base`).
template <class H, int N>
__device__ __forceinline__ void put_head(const float (&x)[N], float d0, float d1, uint32_t base,
                                         int h, int box_bytes, int r0, int t) {
#pragma unroll
  for (int j = 0; j < H::D / 8; ++j) {
    sts32(head_at<H>(base, h, 8 * j + 2 * t, r0, box_bytes),
          pack_bf16(x[4 * j] / d0, x[4 * j + 1] / d0));
    sts32(head_at<H>(base, h, 8 * j + 2 * t, r0 + 8, box_bytes),
          pack_bf16(x[4 * j + 2] / d1, x[4 * j + 3] / d1));
  }
}

// Head h's output over this warp's rows of q_h in the tile (head_base's
// `base`): o / l (ONES: l is o's column 64, which the quad's t = 0 lane
// holds; NOSM, FP32PV: o itself), or the fp32 row sums l broadcast over the
// head's columns (ROWSUM); SLICE put its output there at the head's first
// tile.
template <class H>
__device__ __forceinline__ void store_head(const float (&o)[H::OR], float (&l)[2], uint32_t base,
                                           int h, int box_bytes, int r0, int t) {
  constexpr int MODE = H::MODE;
  if constexpr (MODE == ONES) {
    const int quad = threadIdx.x & 28;   // lane 4 g: t = 0 of this thread's quad
    put_head<H>(o, __shfl_sync(0xffffffffu, o[H::D / 2], quad),
                __shfl_sync(0xffffffffu, o[H::D / 2 + 2], quad), base, h, box_bytes, r0, t);
  } else if constexpr (MODE == NOSM || MODE == FP32PV) {
    put_head<H>(o, 1.f, 1.f, base, h, box_bytes, r0, t);
  } else if constexpr (MODE != SLICE_S && MODE != SLICE_EXP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (MODE == ROWSUM_S || MODE == ROWSUM_EXP) {
#pragma unroll
      for (int j = 0; j < H::D / 8; ++j) {
        sts32(head_at<H>(base, h, 8 * j + 2 * t, r0, box_bytes), pack_bf16(l[0], l[0]));
        sts32(head_at<H>(base, h, 8 * j + 2 * t, r0 + 8, box_bytes), pack_bf16(l[1], l[1]));
      }
    } else {
      put_head<H>(o, l[0], l[1], base, h, box_bytes, r0, t);
    }
  }
}

// The consumer's walk over the (head, key tile) sequence.
template <class H>
struct AttnState {
  Ring<H::STAGE> ring;          // the stage of tile i
  int i = 0, h = 0, kt = 0, prev = -1;
  int nt, last_valid, head_bytes, r0, t, exact;
  uint32_t slab;
  float scale;
  float l_done[2];              // l of the head whose o is stored at the next tile
  float keep = 0.f;             // SLICE_EXP: the sum of the exps no tile stores
  bool signaller;
};

// Tile i begins with S_i done (in sc) and PV of tile i - 1 running: the
// numerators; then, PV i - 1 done, the previous head's o / l over its q
// where tile i starts a head, o rescaled, P packed. Accumulators are only
// written here while no wgmma runs, so the compiler keeps them in flight.
// SLICE puts tile 0's s (or exp(s)) over q_h, which is in registers by
// then. The modes without V have no PV: where another tile follows (NEXT),
// S of tile i + 1 is issued into sp, the other S buffer, first (q of the
// next head loaded first at a head's end) and runs under this tile's
// numerators.
template <class H, bool NEXT = true>
__device__ __forceinline__ void attn_begin(AttnState<H>& st, float (&sc)[H::SR],
                                           float (&sp)[H::SR], float (&o)[H::OR],
                                           uint32_t (&p)[H::PS][4], uint32_t (&qf)[H::QS][4],
                                           float (&m)[2], float (&l)[2]) {
  const bool head_end = st.kt == st.nt - 1;
  if constexpr (!H::USES_V && NEXT) {
    if (head_end)
      load_q<H>(qf, head_base<H>(st.slab, st.h + 1, st.head_bytes), st.h + 1, st.head_bytes,
                st.r0, st.t, st.scale);
    Ring<H::STAGE> nxt = st.ring;
    nxt.advance();
    mbar_wait(nxt.full_k(nxt.stage), nxt.phase);
    issue_s<H>(sp, qf, nxt.slot());
  }
  float alpha[2];
  numerators<H>(sc, m, l, alpha, head_end ? st.last_valid : H::KT, st.t, st.exact);
  if constexpr (H::USES_V) {
    wgmma_wait<0>();   // PV of tile i - 1
    fence_operand(o);
    fence_operand(p);
  }
  if (st.kt == 0 && st.i > 0)
    store_head<H>(o, st.l_done, head_base<H>(st.slab, st.h - 1, st.head_bytes), st.h - 1,
                  st.head_bytes, st.r0, st.t);
  if constexpr (H::MODE == SLICE_S || H::MODE == SLICE_EXP) {
    if (st.kt == 0) {
      put_head<H>(sc, 1.f, 1.f, head_base<H>(st.slab, st.h, st.head_bytes), st.h, st.head_bytes,
                  st.r0, st.t);
    } else if constexpr (H::MODE == SLICE_EXP) {
#pragma unroll
      for (int j = 0; j < H::SR; ++j) st.keep += sc[j];
    }
  }
  if constexpr (H::USES_V) {
    if (st.signaller && st.prev >= 0) mbar_arrive(st.ring.empty_v(st.prev));
    if constexpr (H::MODE == ATTN || H::MODE == ONES) {
      if (st.exact) {   // at a head's first tile alpha is 0 and PV overwrites o
#pragma unroll
        for (int j = 0; j < H::DV / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
    }
    if constexpr (H::MODE == BF16S || H::MODE == BF16S_EX2) {
      // P = exp(bf16(s)) packed straight into the A fragments (a copy of S's
      // registers there made ptxas serialize the products), l the fp32 sum
      // of the rounded p: fragment word q holds row g (q even) or g + 8
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < H::PS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p[kk][q] = exp_bf16x2<H::MODE == BF16S_EX2>(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
          sum[q & 1] += bf16_lo(p[kk][q]) + bf16_hi(p[kk][q]);
        }
      l[0] += sum[0];
      l[1] += sum[1];
    } else if constexpr (H::TF32_PV) {
      // the A fragments of keys (2t, 2t + 1) of chunk kk: S's values as the
      // tensor cores read them, top 19 bits (a copy by bit cast alone made
      // ptxas serialize the products)
#pragma unroll
      for (int kk = 0; kk < H::PS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[kk][q] = __float_as_uint(sc[4 * kk + (q >> 1) + 2 * (q & 1)]) & 0xFFFFE000u;
    } else {
#pragma unroll
      for (int kk = 0; kk < H::PS; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    }
  }
  if (head_end) {
    st.l_done[0] = l[0];
    st.l_done[1] = l[1];
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
}

// The rest of a tile that another follows: S of tile i + 1 into sn (q of
// the next head loaded first at a head's end), then PV of tile i; S i + 1
// is waited for, PV i runs on under the next tile's numerators. Without V,
// S i + 1 was issued in attn_begin.
template <class H>
__device__ __forceinline__ void attn_next(AttnState<H>& st, float (&sn)[H::SR],
                                          float (&o)[H::OR], const uint32_t (&p)[H::PS][4],
                                          uint32_t (&qf)[H::QS][4]) {
  const bool head_end = st.kt == st.nt - 1;
  Ring<H::STAGE> nxt = st.ring;
  nxt.advance();
  if constexpr (H::USES_V) {
    if (head_end)
      load_q<H>(qf, head_base<H>(st.slab, st.h + 1, st.head_bytes), st.h + 1, st.head_bytes,
                st.r0, st.t, st.scale);
    mbar_wait(nxt.full_k(nxt.stage), nxt.phase);
    mbar_wait(st.ring.full_v(st.ring.stage), st.ring.phase);
    issue_s<H>(sn, qf, nxt.slot());
    issue_pv<H>(o, p, st.ring.slot() + H::K_BYTES, st.kt != 0);
    wgmma_wait<1>();   // S of tile i + 1
  } else {
    wgmma_wait<0>();
  }
  fence_operand(sn);
  fence_operand(qf);
  if (st.signaller) mbar_arrive(nxt.empty_k(nxt.stage));
  st.prev = st.ring.stage;
  st.ring = nxt;
  ++st.i;
  if (head_end) {
    ++st.h;
    st.kt = 0;
  } else {
    ++st.kt;
  }
}

// The last tile of the last head; leaves the ring at the next stage.
template <class H>
__device__ __forceinline__ void attn_last(AttnState<H>& st, float (&sc)[H::SR],
                                          float (&o)[H::OR], uint32_t (&p)[H::PS][4],
                                          uint32_t (&qf)[H::QS][4], float (&m)[2],
                                          float (&l)[2]) {
  attn_begin<H, false>(st, sc, sc, o, p, qf, m, l);   // no next tile: no other S buffer
  if constexpr (H::USES_V) {
    mbar_wait(st.ring.full_v(st.ring.stage), st.ring.phase);
    issue_pv<H>(o, p, st.ring.slot() + H::K_BYTES, st.kt != 0);
    wgmma_wait<0>();
    fence_operand(o);
    fence_operand(p);
  }
  const uint32_t base = head_base<H>(st.slab, st.h, st.head_bytes);
  store_head<H>(o, st.l_done, base, st.h, st.head_bytes, st.r0, st.t);
  if constexpr (H::USES_V) {
    if (st.signaller) mbar_arrive(st.ring.empty_v(st.ring.stage));
  }
  if constexpr (H::MODE == SLICE_EXP) {
    if (st.keep == -1.f)   // never (exps are >= 0): it keeps the unstored tiles' exps
      sts32(head_at<H>(base, st.h, 0, st.r0, st.head_bytes), pack_bf16(st.keep, st.keep));
  }
  st.ring.advance();
}

// The producer's K and V loads, head after head (the first at column
// col0), from batch element b: K_MN takes head h's K^T tile at channel row
// col0 + D h, TF32 V^T's two 32-key boxes there; else V's head h is
// `vboxes` boxes from column vcol0 + vstep h. Returns the ring at the stage
// after the last.
template <class H>
__device__ __forceinline__ Ring<H::STAGE> load_heads(Ring<H::STAGE> ring, const CUtensorMap* tm_k,
                                                     const CUtensorMap* tm_v, int col0, int heads,
                                                     int nt, int b, int vcol0, int vstep,
                                                     int vboxes) {
  for (int h = 0; h < heads; ++h)
    for (int kt = 0; kt < nt; ++kt) {
      const int s = ring.stage;
      mbar_wait(ring.empty_k(s), ring.phase ^ 1);
      mbar_expect_tx(ring.full_k(s), H::K_BYTES);
      if constexpr (H::K_MN) {
        tma_load_3d(ring.slot(), tm_k, ring.full_k(s), kt * H::KT, col0 + h * H::D, b);
      } else {
#pragma unroll
        for (int j = 0; j < H::KBOX; ++j)
          tma_load_3d(ring.slot() + j * H::BOX, tm_k, ring.full_k(s), col0 + h * H::D + 64 * j,
                      kt * H::KT, b);
      }
      if constexpr (H::USES_V) {
        mbar_wait(ring.empty_v(s), ring.phase ^ 1);
        if constexpr (H::TF32_PV) {
          mbar_expect_tx(ring.full_v(s), H::V_BYTES);
#pragma unroll
          for (int j = 0; j < H::VBOX; ++j)
            tma_load_3d(ring.slot() + H::K_BYTES + j * H::BOX, tm_v, ring.full_v(s),
                        kt * H::KT + 32 * j, col0 + h * H::D, b);
        } else {
          mbar_expect_tx(ring.full_v(s), vboxes * H::BOX);
#pragma unroll
          for (int j = 0; j < vboxes; ++j)
            tma_load_3d(ring.slot() + H::K_BYTES + j * H::BOX, tm_v, ring.full_v(s),
                        vcol0 + h * vstep + 64 * j, kt * H::KT, b);
        }
      }
      ring.advance();
    }
  return ring;
}

// A consumer warpgroup's attention over every head for its 64 rows (slab:
// its rows of box 0; the q tile has landed on q_full): on return o_h / l of
// every head is in the tile (this warpgroup's stores), and the ring is at
// the stage after the last tile.
template <class H>
__device__ __forceinline__ Ring<H::STAGE> attend_heads(Ring<H::STAGE> ring, uint32_t q_full,
                                                       uint32_t slab, int box_bytes, int heads,
                                                       int nk, int r0, int t, int t128,
                                                       float scale, int exact) {
  const int nt = (nk + H::KT - 1) / H::KT;
  float s0[H::SR], s1[H::SR], o[H::OR], m[2], l[2];   // o: written by a head's first PV
  uint32_t qf[H::QS][4], p[H::PS][4];
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  AttnState<H> st;
  mbar_wait(q_full, 0);
  load_q<H>(qf, slab, 0, box_bytes, r0, t, scale);
  mbar_wait(ring.full_k(0), 0);
  issue_s<H>(s0, qf, ring.slot());
  wgmma_wait<0>();
  fence_operand(s0);
  fence_operand(qf);
  if (t128 == 0) mbar_arrive(ring.empty_k(0));

  st.ring = ring;
  st.nt = nt;
  st.last_valid = nk - (nt - 1) * H::KT;
  st.slab = slab;
  st.head_bytes = box_bytes;
  st.r0 = r0;
  st.t = t;
  st.scale = scale;
  st.exact = exact;
  st.signaller = t128 == 0;
  int steps = heads * nt - 1;   // tiles that another follows
  for (; steps >= 2; steps -= 2) {
    attn_begin<H>(st, s0, s1, o, p, qf, m, l);
    attn_next<H>(st, s1, o, p, qf);
    attn_begin<H>(st, s1, s0, o, p, qf, m, l);
    attn_next<H>(st, s0, o, p, qf);
  }
  if (steps == 1) {
    attn_begin<H>(st, s0, s1, o, p, qf, m, l);
    attn_next<H>(st, s1, o, p, qf);
    attn_last<H>(st, s1, o, p, qf, m, l);
  } else {
    attn_last<H>(st, s0, o, p, qf, m, l);
  }
  return st.ring;
}

// One CTA of a kernel on the core, of BM = 64 NWG q rows (a launch plan's
// `rows`): batch element blockIdx.y, rows from blockIdx.x * BM, `heads`
// heads from column blockIdx.z * heads * D. Warpgroup 0 is the producer
// (one thread issues every TMA load), 1..NWG the consumers of 64 rows each;
// after the last head each consumer stores its rows of the tile by TMA,
// clipped at Nq and C. Shared memory: the q / o tile (`boxes` 64-column
// boxes of BM rows), the ring of `stages` stages, the barriers. ONES reads
// V' (B, Nk, 2C), head h's [v_h | 1 | 0 ...] 2 D columns from 2 D h
// (ones_mode 1), or plain V (2), each stage's second V box then the
// constant [1, 0 ... 0] tile written here once, which no load overwrites.
template <class H, int NWG>
__device__ __forceinline__ void attn_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_o, int nk,
                                         int heads, int boxes, int stages, float scale, int exact,
                                         int ones_mode) {
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qtile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring<H::STAGE> ring;
  ring.init(qtile + boxes * BM * 128, stages);
  const uint32_t q_full = ring.bars + 4 * 8 * stages;
  const int b = blockIdx.y, q0 = blockIdx.x * BM, col0 = blockIdx.z * heads * H::D;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    ring.init_barriers(NWG);
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  if constexpr (H::MODE == ONES) {
    if (ones_mode == 2) {   // bf16 1.0 at (key r, column 0) of each box, zeros elsewhere
      for (int w = threadIdx.x; w < stages * H::BOX / 4; w += blockDim.x) {
        const int off = 4 * (w % (H::BOX / 4));
        sts32(ring.base + (w / (H::BOX / 4)) * H::STAGE + H::K_BYTES + H::BOX + off,
              off == (int)swizzle128(off / 128, 0) ? 0x3F80u : 0u);
      }
      fence_proxy_async();
    }
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (NWG == 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, boxes * BM * 128);
      for (int j = 0; j < boxes; ++j)
        tma_load_3d(qtile + j * BM * 128, tm_q, q_full, col0 + 64 * j, q0, b);
      const int nt = (nk + H::KT - 1) / H::KT;
      if constexpr (H::MODE == ONES) {
        if (ones_mode == 1)
          load_heads<H>(ring, tm_k, tm_v, col0, heads, nt, b, 2 * col0, 2 * H::D, 2);
        else
          load_heads<H>(ring, tm_k, tm_v, col0, heads, nt, b, col0, H::D, 1);
      } else {
        load_heads<H>(ring, tm_k, tm_v, col0, heads, nt, b, col0, H::D, H::VBOX);
      }
    }
  } else {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if constexpr (NWG == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int ci = wg - 1, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, t = lane % 4, r0 = (t128 / 32) * 16 + lane / 4;
    const uint32_t slab = qtile + ci * 64 * 128;   // this warpgroup's rows of box 0
    attend_heads<H>(ring, q_full, slab, BM * 128, heads, nk, r0, t, t128, scale, exact);
    // every o_h of this warpgroup's rows is in the tile once its threads'
    // stores are visible to TMA
    fence_proxy_async();
    named_barrier_sync(1 + ci, 128);
    if (t128 == 0) {
      for (int j = 0; j < boxes; ++j)
        tma_store_3d(tm_o, slab + j * BM * 128, col0 + 64 * j, q0 + 64 * ci, b);
      tma_store_commit();
      tma_store_wait<0, true>();   // the tile stays until TMA has read it
    }
  }
}

// ---- host side -------------------------------------------------------------

constexpr int MAX_STAGES = 8;

// Opt kernel Kern in to a block's whole shared memory on the current
// device, once a device and process (the call costs host time a launch).
template <auto Kern>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Dynamic shared memory of a core CTA of H with `rows` q rows, `boxes`
// 64-column boxes and `stages` stages; 0 where that plan does not fit.
template <class H>
int cta_smem(int rows, int boxes, int stages) {
  const int smem = SMEM_SLACK + boxes * rows * 128 + stages * H::STAGE;
  return stages < 2 || stages > MAX_STAGES || smem > SMEM_MAX ? 0 : smem;
}

}  // namespace
