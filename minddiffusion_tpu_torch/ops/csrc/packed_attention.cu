// Heads-packed attention for Hopper (sm_90a): softmax(scale * Q K^T) V on
// packed (B, N, C = heads * D) bf16 tensors, head h being the column slice
// [D h, D h + D). No head transpose is ever materialised.
//
// Replaces the TPU kernel minddiffusion_tpu/ops/flash_attention.py
// `_packed_kernel` (pallas_call in `flash_attention_packed`, K1).
//
// What bounds it on the H100: at the UNet sites (1024-4096 keys) 4 Nq Nk D
// flops a head against 6 N C bytes, far above the ~295 flop/byte ridge: the
// tensor cores and one fp32 exp a score set the floor (SD2 ds1, D 64: 0.35
// ms of products, 0.32 of exps; SD1 ds1, D 40: the exps, 0.26 ms). The TPU
// kernel held all of K and V for a batch element in VMEM; here a CTA holds
// its q rows for every head and sweeps key tiles through a ring with an
// online softmax.
//
// D 40, 64, 80, 160: `packed_attn_kernel`, the attention core of
// attn_core.cuh (K10d's, without its Wo epilogue): warpgroup 0 the TMA
// producer, 1..3 wgmma consumers of 64 q rows each, q_h in registers, S and
// PV by wgmma with V MN-major as it lies in memory. After the last head the
// q / o tile holds the concatenated heads in TMA's swizzle, and each
// consumer stores its rows of it by TMA, clipped at Nq and C.
//  * Head groups: where B x the row blocks leave most SMs idle (B 8 at Nq
//    1024: 64 CTAs on 132 SMs), `groups` CTAs split a row block's heads,
//    each group's columns whole 64-column boxes (D 64: any split; D 80 and
//    160: 320 columns a group), so their stores never share a box; K and V
//    cross L2 no more often than before (each CTA reads its heads' only).
//  * Row tiers (`packed_plan` in ops/flash_attention.py chooses; the entry
//    checks): 192 rows at D 64 up to C 448 where Nq >= 2048 (K10d's tier,
//    SD2 ds1), 128 up to C 640 at D 40 / 64 / 80, else 64. At SD1's ds1 (D
//    40, exact) 128 rows ran in 0.7352 ms on the device against 0.9156 at
//    192 (scripts/attn_variants_ablate.py, H100).
//    Stages: as many 8 KB-box stages as the q tile leaves room for, at most
//    8; the C 640 tile at D 80 (160 KB) leaves 2, which the ring runs on (K
//    is released once S is done, so the producer loads tile i + 2's K while
//    PV i runs).
//  * D 80 and D 160 are wider than one 128-byte swizzle span: K and V
//    tiles load as 2 or 3 boxes of 64 columns (the last partly the next
//    head's, not read), PV is wgmma m64n80k16 / m64n160k16 over them (40 /
//    80 accumulators a thread). D 160 takes 32-key tiles: at C 1280 the q
//    tile (64 rows, 160 KB) leaves room for 2 stages of 24 KB, not of 48.
//    That holds it back: 64 rows a CTA read all of K and V through L2 once
//    per 64 rows, with 2 stages to hide it (SD1 1024^2 ds4: 0.2587 ms on
//    an H100 against SDPA's 0.2100).
//  * D 40: QK^T depth 48 from a 64-column K box at column 40 h, q_h's
//    columns 40..47 zero in registers; PV at N 40 reads the first 40
//    columns of the V box (the MN-major SW128 layout of a 64-column box, of
//    which the product's 5 8-column groups are the first). The exps bound
//    it.
//
// D 512 (the VAE's mid attention, one head): `packed_attn512_kernel`. A 64 x
// 512 fp32 accumulator is 256 registers a thread, beyond one warpgroup, so
// three consumer warpgroups share 64 q rows and split the output columns,
// 128 / 192 / 192 (64 or 96 accumulators a thread: with the producer, 512
// threads leave ptxas 128 registers each; two warpgroups of 256 columns
// spilled at the 168 that 384 threads leave, `setmaxnreg` or not). S is
// computed once, by the first: q (scaled in place, 64 x 512 in shared
// memory) by K, both from shared memory, 32 k16 steps; it writes P (64 x
// 64 bf16, swizzled) and the rows' rescale factors to one of two P slots,
// and all three run PV from that slot. Splitting QK^T's depth instead would
// double the hand-offs (the partial S one way, then P and the max back);
// one P hand-off a tile costs 8 KB of shared stores. 64-key tiles (K and V
// of a tile: 128 KB) in one stage beside the q tile (64 KB) and the P
// slots: the producer loads K i + 1 once S i is done and V i + 1 once the
// three PVs of i are. What holds it back (1.0 ms at (8, 4096) on an H100
// against a 0.28 ms bound; K4 1.5): at 64 rows a CTA all of K and V cross
// L2 once per 64 rows (64 flops a byte), one stage hides little of it, and
// ptxas serializes S's chain of 32 products (its C7514 notice).
//
// Numerics follow the TPU kernel: q is scaled in fp32 and rounded to bf16
// before QK^T; both products take bf16 operands with fp32 accumulation; P
// is rounded to bf16 before PV while the row sum uses the fp32 P. exact=0
// is the raw exp(s) mode with no max subtraction (valid for logits below
// 88, fp32 exp overflow). Keys past Nk come from TMA's zero fill and are
// masked to -inf, rows past Nq are not stored, so any Nq, Nk >= 1 work.
#include "attn_core.cuh"

namespace {

constexpr int MAX_STAGES = 8;

// D 40 / 64 / 80 / 160. One CTA per (BM = 64 NWG q rows, batch element,
// group of `heads` heads, starting at column blockIdx.z * heads * D);
// shared memory: the q / o tile (`boxes` 64-column boxes of BM rows), the
// ring, the barriers.
template <int D, int KT, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) packed_attn_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    int heads, int boxes, int stages, float scale, int exact) {
  using H = Head<D, KT>;
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qtile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring<H::STAGE> ring;
  ring.init(qtile + boxes * BM * 128, stages);
  const uint32_t q_full = ring.bars + 4 * 8 * stages;
  const int b = blockIdx.y, q0 = blockIdx.x * BM, col0 = blockIdx.z * heads * D;
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
      mbar_expect_tx(q_full, boxes * BM * 128);
      for (int j = 0; j < boxes; ++j)
        tma_load_3d(qtile + j * BM * 128, &tm_q, q_full, col0 + 64 * j, q0, b);
      load_heads<H>(ring, &tm_k, &tm_v, col0, heads, (nk + KT - 1) / KT, b);
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
        tma_store_3d(&tm_o, slab + j * BM * 128, col0 + 64 * j, q0 + 64 * ci, b);
      tma_store_commit();
      tma_store_wait<0, true>();   // the tile stays until TMA has read it
    }
  }
}

// ---- D 512 -----------------------------------------------------------------

using H512 = Head<512, 64>;                 // K and V tiles of 8 boxes each: 128 KB
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

// One CTA per (64 q rows, batch element); warpgroup 0 the producer, 1 S and
// output columns 0..127, 2 and 3 columns 128..319 and 320..511 (at most 128
// registers a thread for 512 threads: o is 64 or 96 of them).
__global__ void __launch_bounds__(512, 1) packed_attn512_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    float scale, int exact) {
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
      for (int j = 0; j < 8; ++j) tma_load_3d(qtile + j * H512::BOX, &tm_q, q_full, 64 * j, q0, b);
      load_heads<H512>(ring, &tm_k, &tm_v, 0, 1, nt, b);
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
      numerators<H512>(s, m, l, alpha, i == nt - 1 ? last_valid : 64, t, exact);
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
    for (int j = 0; j < 8; ++j) tma_store_3d(&tm_o, qtile + j * H512::BOX, 64 * j, q0, b);
    tma_store_commit();
    tma_store_wait<0, true>();
  }
}

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

template <int D, int KT, int NWG>
cudaError_t launch_tile(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                        const CUtensorMap& tm_o, int bsz, int nq, int nk, int heads, int groups,
                        int stages, float scale, int exact, cudaStream_t s, int* ctas) {
  using H = Head<D, KT>;
  const int hpc = heads / groups, boxes = (hpc * D + 63) / 64;
  const int smem = SMEM_SLACK + boxes * 64 * NWG * 128 + stages * H::STAGE;
  if (stages < 2 || stages > MAX_STAGES || smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = packed_attn_kernel<D, KT, NWG>;
  cudaError_t err = allow_smem<packed_attn_kernel<D, KT, NWG>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 64 * NWG - 1) / (64 * NWG), bsz, groups);
  if (ctas) *ctas = (int)(grid.x * grid.y * grid.z);
  kern<<<grid, 128 * (NWG + 1), smem, s>>>(tm_q, tm_k, tm_v, tm_o, nk, hpc, boxes, stages, scale,
                                           exact);
  return cudaGetLastError();
}

}  // namespace

// q: (bsz, nq, c), k / v: (bsz, nk, c), o: (bsz, nq, c); bf16, contiguous,
// 16-byte aligned; nq, nk >= 1. The plan (rows of a CTA, keys of a tile,
// ring stages, head groups) is `packed_plan`'s in ops/flash_attention.py:
// rows 64 / 128 / 192 and keys 64 at D 64, 64 / 128 and 64 at D 40 and 80,
// 64 and 32 at D 160; `groups` CTAs split the heads of a row block where
// each group's columns are whole 64-column boxes; D 512 takes one head, 64
// rows, 64 keys, one stage and one group. Writes the CTAs it launches to
// `ctas` (may be NULL).
extern "C" int mdt_packed_attention(const void* q, const void* k, const void* v, void* o,
                                    int bsz, int nq, int nk, int c, int heads, float scale,
                                    int exact, int rows, int key_tile, int stages, int groups,
                                    void* stream, int* ctas) {
  if (heads < 1 || c % heads != 0 || c % 8 != 0 || nq < 1 || nk < 1 || bsz < 1 || groups < 1 ||
      heads % groups != 0 || (groups > 1 && (c / groups) % 64 != 0))
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  const bool d512 =
      d == 512 && heads == 1 && rows == 64 && key_tile == 64 && stages == 1 && groups == 1;
  const int map_rows = d512 ? 64 : rows;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (map_rows < 64 || map_rows > 192 || key_tile < 16 ||
      !make_map(&tm_q, q, bsz, nq, c, 64, map_rows) ||
      !make_map(&tm_k, k, bsz, nk, c, 64, key_tile) ||
      !make_map(&tm_v, v, bsz, nk, c, 64, key_tile) || !make_map(&tm_o, o, bsz, nq, c, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d512) {
    cudaError_t err = allow_smem<packed_attn512_kernel>();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nq + 63) / 64, bsz);
    if (ctas) *ctas = (int)(grid.x * grid.y);
    packed_attn512_kernel<<<grid, 512, SMEM512, s>>>(tm_q, tm_k, tm_v, tm_o, nk, scale, exact);
    return (int)cudaGetLastError();
  }
#define MDT_TILE(D_, KT_, NWG_)                                                                  \
  if (d == D_ && key_tile == KT_ && rows == 64 * NWG_)                                          \
    return (int)launch_tile<D_, KT_, NWG_>(tm_q, tm_k, tm_v, tm_o, bsz, nq, nk, heads, groups,  \
                                           stages, scale, exact, s, ctas);
  MDT_TILE(64, 64, 3)
  MDT_TILE(64, 64, 2)
  MDT_TILE(64, 64, 1)
  MDT_TILE(40, 64, 2)
  MDT_TILE(40, 64, 1)
  MDT_TILE(80, 64, 2)
  MDT_TILE(80, 64, 1)
  MDT_TILE(160, 32, 1)
#undef MDT_TILE
  return (int)cudaErrorInvalidValue;
}
