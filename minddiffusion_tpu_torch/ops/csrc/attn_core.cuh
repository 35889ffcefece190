// The attention core of the Hopper (sm_90a) heads-packed attention kernels:
// K10d / K10c's `attn_out_kernel` (attn_variants.cu, with the Wo epilogue)
// and K1's `packed_attn_kernel` (packed_attention.cu, no epilogue), on
// packed (B, N, C = heads * D) bf16 tensors, head h being the column slice
// [D h, D h + D). Templated on the head (`Head<D, KT>`: head dim, keys per
// tile); at D 64, KT 64 (K10d) every piece below reduces to the code it
// had as K10d's own.
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
//    64) (K) and ceil(D / 64) (V) boxes of KT rows x 64 columns, 64 KT
//    bytes apart. Columns past the head (the next head's, or TMA's zero
//    fill past C) are loaded and not read, or read against zeros. K and V
//    have a full and an empty barrier each: K is released once S is done,
//    V once PV is.
//  * S = q_h K^T by wgmma m64nKTk16, q_h in registers (from the tile once
//    a head, scaled in fp32 and rounded to bf16 there) and K K-major, DK =
//    D rounded up to 16 deep: at D 40 q_h's columns 40..47 are zero in
//    registers, so the next head's 8 columns (or the zero fill) add
//    nothing. O += P V by wgmma m64nDk16, P from registers (S's
//    accumulators packed to bf16 are the A fragments) and V MN-major as it
//    lies in memory: the leading offset steps to the next 64-column box,
//    and a product narrower than its last box (D 40, 80, 160) reads only
//    its columns.
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

// One head's shapes: head dim D, KT keys a tile.
template <int D_, int KT_>
struct Head {
  static constexpr int D = D_, KT = KT_;
  static constexpr int DK = (D + 15) / 16 * 16;      // QK^T depth
  static constexpr int QS = DK / 16;                 // k16 slices of q_h and K
  static constexpr int PS = KT / 16;                 // k16 slices of P
  static constexpr int KBOX = (DK + 63) / 64;        // 64-column boxes of a K tile
  static constexpr int VBOX = (D + 63) / 64;         // of a V tile
  static constexpr int BOX = KT * 128;               // bytes of one box
  static constexpr int K_BYTES = KBOX * BOX, V_BYTES = VBOX * BOX;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int SR = KT / 2, OR = D / 2;      // S and o accumulators a thread
  static_assert(D % 8 == 0 && KT % 16 == 0, "wgmma widths");
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

// s = q_h K^T for one key tile: K K-major in its swizzled boxes.
template <class H>
__device__ __forceinline__ void issue_s(float (&s)[H::SR], const uint32_t (&qf)[H::QS][4],
                                        uint32_t kslot) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H::QS; ++kk)
    wgmma_rs<H::KT, 0>(s, qf[kk], smem_desc(kslot + (kk / 4) * H::BOX + (kk % 4) * 32, 16, 1024),
                       kk);
  wgmma_commit();
}

// o (+)= P V for one key tile: P from registers, V MN-major as it lies in
// memory (keys x D values, 64-column boxes BOX apart), so no thread moves
// an element of V; a head's first tile overwrites o (accumulate 0).
template <class H>
__device__ __forceinline__ void issue_pv(float (&o)[H::OR], const uint32_t (&p)[H::PS][4],
                                         uint32_t vslot, int accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < H::PS; ++kk)
    wgmma_rs<H::D, 1>(o, p[kk], smem_desc(vslot + kk * 2048, H::VBOX > 1 ? H::BOX : 1024, 1024),
                      accumulate | kk);
  wgmma_commit();
}

// Softmax numerators of one tile in place, rows g and g + 8 of the warp's
// 16: keys from `valid` on are masked; exact: exp(s - running max), alpha
// the factor for the sums so far; otherwise raw exp(s). l = l alpha + the
// fp32 row sums of the unrounded numerators (this thread's columns).
template <class H>
__device__ __forceinline__ void numerators(float (&s)[H::SR], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], int valid, int t, int exact) {
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < H::KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], LOG2E, neg[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// o_h / l, rounded to bf16, over this warp's rows of q_h in the tile
// (head_base's `base`).
template <class H>
__device__ __forceinline__ void store_head(const float (&o)[H::OR], float (&l)[2], uint32_t base,
                                           int h, int box_bytes, int r0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < H::D / 8; ++j) {
    sts32(head_at<H>(base, h, 8 * j + 2 * t, r0, box_bytes),
          pack_bf16(o[4 * j] / l[0], o[4 * j + 1] / l[0]));
    sts32(head_at<H>(base, h, 8 * j + 2 * t, r0 + 8, box_bytes),
          pack_bf16(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]));
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
  bool signaller;
};

// Tile i begins with S_i done (in sc) and PV of tile i - 1 running: the
// numerators; then, PV i - 1 done, the previous head's o / l over its q
// where tile i starts a head, o rescaled, P packed. Accumulators are only
// written here while no wgmma runs, so the compiler keeps them in flight.
template <class H>
__device__ __forceinline__ void attn_begin(AttnState<H>& st, float (&sc)[H::SR],
                                           float (&o)[H::OR], uint32_t (&p)[H::PS][4],
                                           float (&m)[2], float (&l)[2]) {
  const bool head_end = st.kt == st.nt - 1;
  float alpha[2];
  numerators<H>(sc, m, l, alpha, head_end ? st.last_valid : H::KT, st.t, st.exact);
  wgmma_wait<0>();   // PV of tile i - 1
  fence_operand(o);
  fence_operand(p);
  if (st.kt == 0 && st.i > 0)
    store_head<H>(o, st.l_done, head_base<H>(st.slab, st.h - 1, st.head_bytes), st.h - 1,
                  st.head_bytes, st.r0, st.t);
  if (st.signaller && st.prev >= 0) mbar_arrive(st.ring.empty_v(st.prev));
  if (st.exact) {   // at a head's first tile alpha is 0 and PV overwrites o
#pragma unroll
    for (int j = 0; j < H::D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < H::PS; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
  if (head_end) {
    st.l_done[0] = l[0];
    st.l_done[1] = l[1];
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
}

// The rest of a tile that another follows: S of tile i + 1 (q of the next
// head loaded first at a head's end), then PV of tile i; S i + 1 is waited
// for, PV i runs on under the next tile's numerators.
template <class H>
__device__ __forceinline__ void attn_next(AttnState<H>& st, float (&sn)[H::SR],
                                          float (&o)[H::OR], const uint32_t (&p)[H::PS][4],
                                          uint32_t (&qf)[H::QS][4]) {
  const bool head_end = st.kt == st.nt - 1;
  Ring<H::STAGE> nxt = st.ring;
  nxt.advance();
  if (head_end)
    load_q<H>(qf, head_base<H>(st.slab, st.h + 1, st.head_bytes), st.h + 1, st.head_bytes, st.r0,
              st.t, st.scale);
  mbar_wait(nxt.full_k(nxt.stage), nxt.phase);
  mbar_wait(st.ring.full_v(st.ring.stage), st.ring.phase);
  issue_s<H>(sn, qf, nxt.slot());
  issue_pv<H>(o, p, st.ring.slot() + H::K_BYTES, st.kt != 0);
  wgmma_wait<1>();   // S of tile i + 1
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
                                          float (&m)[2], float (&l)[2]) {
  attn_begin<H>(st, sc, o, p, m, l);
  mbar_wait(st.ring.full_v(st.ring.stage), st.ring.phase);
  issue_pv<H>(o, p, st.ring.slot() + H::K_BYTES, st.kt != 0);
  wgmma_wait<0>();
  fence_operand(o);
  fence_operand(p);
  store_head<H>(o, st.l_done, head_base<H>(st.slab, st.h, st.head_bytes), st.h, st.head_bytes,
                st.r0, st.t);
  if (st.signaller) mbar_arrive(st.ring.empty_v(st.ring.stage));
  st.ring.advance();
}

// The producer's K and V loads, head after head (the first at column
// col0), from batch element b; returns the ring at the stage after the last.
template <class H>
__device__ __forceinline__ Ring<H::STAGE> load_heads(Ring<H::STAGE> ring, const CUtensorMap* tm_k,
                                                     const CUtensorMap* tm_v, int col0, int heads,
                                                     int nt, int b) {
  for (int h = 0; h < heads; ++h)
    for (int kt = 0; kt < nt; ++kt) {
      const int s = ring.stage;
      mbar_wait(ring.empty_k(s), ring.phase ^ 1);
      mbar_expect_tx(ring.full_k(s), H::K_BYTES);
#pragma unroll
      for (int j = 0; j < H::KBOX; ++j)
        tma_load_3d(ring.slot() + j * H::BOX, tm_k, ring.full_k(s), col0 + h * H::D + 64 * j,
                    kt * H::KT, b);
      mbar_wait(ring.empty_v(s), ring.phase ^ 1);
      mbar_expect_tx(ring.full_v(s), H::V_BYTES);
#pragma unroll
      for (int j = 0; j < H::VBOX; ++j)
        tma_load_3d(ring.slot() + H::K_BYTES + j * H::BOX, tm_v, ring.full_v(s),
                    col0 + h * H::D + 64 * j, kt * H::KT, b);
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
    attn_begin<H>(st, s0, o, p, m, l);
    attn_next<H>(st, s1, o, p, qf);
    attn_begin<H>(st, s1, o, p, m, l);
    attn_next<H>(st, s0, o, p, qf);
  }
  if (steps == 1) {
    attn_begin<H>(st, s0, o, p, m, l);
    attn_next<H>(st, s1, o, p, qf);
    attn_last<H>(st, s1, o, p, m, l);
  } else {
    attn_last<H>(st, s0, o, p, m, l);
  }
  return st.ring;
}

}  // namespace
