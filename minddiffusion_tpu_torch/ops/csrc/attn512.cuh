// The D 512 attention CTA (the VAE's mid attention): K1's
// `packed_attn512_kernel` (packed_attention.cu) and K4's
// `flash_attn512_kernel` (flash_attention.cu) are this function with their
// head's softmax (K4: the static shift at exact=0), on (B, N, 512) bf16
// maps: K1's one head, or one of K4's heads (a map of its columns, the rows
// H 512 apart; a launch a head). A head index on the grid (blockIdx.z, its
// column offset live to the final store) cost ptxas a 4-byte spill at the
// 128 registers a thread that 512 threads leave.
//
// A 64 x 512 fp32 accumulator is 256 registers a thread, beyond one
// warpgroup, so three consumer warpgroups share 64 q rows and split the
// output columns, 128 / 192 / 192 (64 or 96 accumulators a thread: with the
// producer, 512 threads leave ptxas 128 registers each; two warpgroups of
// 256 columns spilled at the 168 that 384 threads leave, `setmaxnreg` or
// not). S is computed once, by the first: q (scaled in place, 64 x 512 in
// shared memory) by K, both from shared memory, 32 k16 steps; it writes P
// (64 x 64 bf16, swizzled) and the rows' rescale factors to one of two P
// slots, and all three run PV from that slot. Splitting QK^T's depth
// instead would double the hand-offs (the partial S one way, then P and the
// max back); one P hand-off a tile costs 8 KB of shared stores. 64-key
// tiles (K and V of a tile: 128 KB) in one stage beside the q tile (64 KB)
// and the P slots: the producer loads K i + 1 once S i is done and V i + 1
// once the three PVs of i are. What holds it back (1.0 ms at (8, 4096) on
// an H100 against a 0.28 ms bound): at 64 rows a CTA all of K and V cross
// L2 once per 64 rows (64 flops a byte), one stage hides little of it, and
// ptxas serializes S's chain of 32 products (its C7514 notice).
#pragma once

#include "attn_core.cuh"

namespace {

using H512 = Head<512, 64>;                 // K1's head; K and V tiles of 8 boxes: 128 KB
constexpr int Q512 = 8 * 64 * 128;          // the q / o tile: 64 rows x 512
constexpr int P_BYTES = 64 * 128;           // P: 64 rows x 64 keys bf16, one box
// output columns of consumer warpgroup 1, 2, 3: [0, 128), [128, 320), [320, 512)
__device__ __forceinline__ int col0_512(int ci) { return ci == 0 ? 0 : 128 + 192 * (ci - 1); }
// q / o tile, one ring stage, two P slots, two 64-float alpha rows and l,
// the barriers (ring 4, q full, P full 2, P empty 2)
constexpr int SMEM512 = 1024 + Q512 + H512::STAGE + 2 * P_BYTES + 3 * 256 + 9 * 8;

// s = q K^T, both K-major in shared memory (8 boxes of 64 rows each). A
// box at a time: unrolled whole, the 64 descriptors were computed ahead and
// held, and the kernel spilled.
__device__ __forceinline__ void issue_s512(float (&s)[32], uint32_t qtile, uint32_t kslot) {
  wgmma_fence();
#pragma unroll 1
  for (int box = 0; box < 8; ++box)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = box * H512::BOX + kk * 32;
      wgmma_ss_m64n64k16<0>(s, smem_desc(qtile + off, 16, 1024),
                            smem_desc(kslot + off, 16, 1024), box | kk);
    }
  wgmma_commit();
}

// o0 (128 columns) (+)= P V from V's box `vbox` on, and with WIDE o1 (the 64
// columns after them): P K-major in its slot, V MN-major as it lies.
template <bool WIDE>
__device__ __forceinline__ void issue_pv512(float (&o0)[64], float (&o1)[32], uint32_t pslot,
                                            uint32_t vbox, int accumulate) {
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = smem_desc(pslot + kk * 32, 16, 1024);
    wgmma_ss_m64n128k16<1>(o0, a, smem_desc(vbox + kk * 2048, H512::BOX, 1024), accumulate | kk);
    if constexpr (WIDE)
      wgmma_ss_m64n64k16<1>(o1, a, smem_desc(vbox + 2 * H512::BOX + kk * 2048, 1024, 1024),
                            accumulate | kk);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

// o / l, rounded to bf16, into columns c0.. of the q / o tile.
template <int N>
__device__ __forceinline__ void store512(const float (&o)[N], uint32_t qtile, int c0, int r0,
                                         int t, float l0, float l1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    const uint32_t box = qtile + (col >> 6) * H512::BOX;
    sts32(box + swizzle128(r0, col & 63), pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0));
    sts32(box + swizzle128(r0 + 8, col & 63), pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1));
  }
}

// One CTA per (64 q rows, batch element), 512 threads, the head the maps'
// columns 0..511; warpgroup 0 the producer, 1 S and output columns 0..127,
// 2 and 3 columns 128..319 and 320..511 (at most 128 registers a thread for
// 512 threads: o is 64 or 96 of them). H: the head's softmax (Head<512,
// 64>, or K4's with the static shift).
template <class H>
__device__ __forceinline__ void attn512_cta(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v, const CUtensorMap* tm_o,
                                            int nk, float scale, int exact) {
  static_assert(H::D == 512 && H::KT == 64 && H::MODE == ATTN && !H::K_MN, "H512's geometry");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qtile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t pslots = qtile + Q512 + H512::STAGE;
  const uint32_t alphas = pslots + 2 * P_BYTES, lsum = alphas + 2 * 256;
  Ring<H512::STAGE> ring;
  ring.init(qtile + Q512, 1);
  ring.bars = lsum + 256;
  const uint32_t q_full = ring.bars + 4 * 8, p_full = q_full + 8, p_empty = p_full + 2 * 8;
  const int b = blockIdx.y, q0 = blockIdx.x * 64;
  const int nt = (nk + 63) / 64, last_valid = nk - (nt - 1) * 64;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(ring.full_k(0), 1);
    mbar_init(ring.full_v(0), 1);
    mbar_init(ring.empty_k(0), 1);   // S: the first consumer only
    mbar_init(ring.empty_v(0), 3);   // PV: all three
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(p_full + 8 * s, 1);
      mbar_init(p_empty + 8 * s, 2);   // the second and third read P from the slot
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int t128 = threadIdx.x % 128, lane = t128 % 32, t = lane % 4;
  const int r0 = (t128 / 32) * 16 + lane / 4;
  if (wg == 0) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q512);
      for (int j = 0; j < 8; ++j) tma_load_3d(qtile + j * H512::BOX, tm_q, q_full, 64 * j, q0, b);
      load_heads<H512>(ring, tm_k, tm_v, 0, 1, nt, b, 0, 512, H512::VBOX);
    }
    return;
  }
  const int ci = wg - 1, c0 = col0_512(ci);
  const uint32_t vcols = H512::K_BYTES + (c0 / 64) * H512::BOX;   // this warpgroup's V, from a slot
  float o0[64], o1[32];
  if (ci == 0) {
    float s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    mbar_wait(q_full, 0);
    if (scale != 1.f) {   // q scaled in fp32 and rounded to bf16, in place
      for (int w = t128; w < 64 * 256; w += 128) {
        const int r = w >> 8, c = (w & 255) * 2;
        const uint32_t addr = qtile + (c >> 6) * H512::BOX + swizzle128(r, c & 63);
        uint32_t raw = lds32(addr);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        sts32(addr, pack_bf16(f.x * scale, f.y * scale));
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 128);
    mbar_wait(ring.full_k(0), 0);
    issue_s512(s, qtile, ring.slot());
    wgmma_wait<0>();
    fence_operand(s);
    if (t128 == 0) mbar_arrive(ring.empty_k(0));
    for (int i = 0; i < nt; ++i) {
      // S_i done, PV_{i-1} running: the numerators; then P_i to its slot
      numerators<H>(s, m, l, alpha, i == nt - 1 ? last_valid : 64, t, exact);
      wgmma_wait<0>();
      fence_operand(o0);
      if (t128 == 0 && i > 0) mbar_arrive(ring.empty_v(0));
      if (exact && i > 0) rescale(o0, alpha[0], alpha[1]);
      const int ps = i & 1;
      const uint32_t pslot = pslots + ps * P_BYTES;
      mbar_wait(p_empty + 8 * ps, ((i >> 1) & 1) ^ 1);   // the others' PV of tile i - 2
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sts32(pslot + swizzle128(r0, 8 * j + 2 * t), pack_bf16(s[4 * j], s[4 * j + 1]));
        sts32(pslot + swizzle128(r0 + 8, 8 * j + 2 * t), pack_bf16(s[4 * j + 2], s[4 * j + 3]));
      }
      if (t == 0) {
        sts32(alphas + ps * 256 + 4 * r0, __float_as_uint(alpha[0]));
        sts32(alphas + ps * 256 + 4 * (r0 + 8), __float_as_uint(alpha[1]));
      }
      fence_proxy_async();
      named_barrier_sync(1, 128);
      if (t128 == 0) mbar_arrive(p_full + 8 * ps);
      // S_{i+1} (K of tile i + 1 lands in the stage's K half), then PV_i
      Ring<H512::STAGE> nxt = ring;
      nxt.advance();
      if (i + 1 < nt) {
        mbar_wait(nxt.full_k(0), nxt.phase);
        issue_s512(s, qtile, nxt.slot());
      }
      mbar_wait(ring.full_v(0), ring.phase);
      issue_pv512<false>(o0, o1, pslot, ring.slot() + vcols, i != 0);
      if (i + 1 < nt) {
        wgmma_wait<1>();
        fence_operand(s);
        if (t128 == 0) mbar_arrive(nxt.empty_k(0));
      }
      ring = nxt;
    }
    wgmma_wait<0>();
    fence_operand(o0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (t == 0) {
      sts32(lsum + 4 * r0, __float_as_uint(l[0]));
      sts32(lsum + 4 * (r0 + 8), __float_as_uint(l[1]));
    }
  } else {
    for (int i = 0; i < nt; ++i) {
      const int ps = i & 1;
      mbar_wait(p_full + 8 * ps, (i >> 1) & 1);
      if (exact && i > 0) {
        const float a0 = __uint_as_float(lds32(alphas + ps * 256 + 4 * r0));
        const float a1 = __uint_as_float(lds32(alphas + ps * 256 + 4 * (r0 + 8)));
        rescale(o0, a0, a1);
        rescale(o1, a0, a1);
      }
      mbar_wait(ring.full_v(0), ring.phase);
      issue_pv512<true>(o0, o1, pslots + ps * P_BYTES, ring.slot() + vcols, i != 0);
      wgmma_wait<0>();
      fence_operand(o0);
      fence_operand(o1);
      if (t128 == 0) {
        mbar_arrive(ring.empty_v(0));
        mbar_arrive(p_empty + 8 * ps);
      }
      ring.advance();
    }
  }
  // l from the first consumer; then o / l over q (S is done) and TMA out
  named_barrier_sync(2, 384);
  const float l0 = __uint_as_float(lds32(lsum + 4 * r0));
  const float l1 = __uint_as_float(lds32(lsum + 4 * (r0 + 8)));
  store512(o0, qtile, c0, r0, t, l0, l1);
  if (ci > 0) store512(o1, qtile, c0 + 128, r0, t, l0, l1);
  fence_proxy_async();
  named_barrier_sync(2, 384);
  if (threadIdx.x == 128) {
    for (int j = 0; j < 8; ++j) tma_store_3d(tm_o, qtile + j * H512::BOX, 64 * j, q0, b);
    tma_store_commit();
    tma_store_wait<0, true>();
  }
}

}  // namespace
