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
// D 512 (the VAE's mid attention, one head): `packed_attn512_kernel`, the
// D 512 CTA of attn512.cuh (three consumer warpgroups split the 512 output
// columns and share one S; its design and limits are in that header), which
// K4 shares. 1.0 ms at (8, 4096) on an H100 against a 0.28 ms bound.
//
// Numerics follow the TPU kernel: q is scaled in fp32 and rounded to bf16
// before QK^T; both products take bf16 operands with fp32 accumulation; P
// is rounded to bf16 before PV while the row sum uses the fp32 P. exact=0
// is the raw exp(s) mode with no max subtraction (valid for logits below
// 88, fp32 exp overflow). Keys past Nk come from TMA's zero fill and are
// masked to -inf, rows past Nq are not stored, so any Nq, Nk >= 1 work.
#include "attn512.cuh"

namespace {

// D 40 / 64 / 80 / 160: the core's CTA (`attn_cta`) of BM = 64 NWG q
// rows, a batch element and a group of `heads` heads.
template <int D, int KT, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) packed_attn_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    int heads, int boxes, int stages, float scale, int exact) {
  attn_cta<Head<D, KT>, NWG>(&tm_q, &tm_k, &tm_v, &tm_o, nk, heads, boxes, stages, scale, exact,
                             0);
}

// ---- D 512 -----------------------------------------------------------------

// The VAE mid's one head: the D 512 CTA of attn512.cuh, raw exp at exact=0.
__global__ void __launch_bounds__(512, 1) packed_attn512_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    float scale, int exact) {
  attn512_cta<H512>(&tm_q, &tm_k, &tm_v, &tm_o, nk, scale, exact);
}

template <int D, int KT, int NWG>
cudaError_t launch_tile(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                        const CUtensorMap& tm_o, int bsz, int nq, int nk, int heads, int groups,
                        int stages, float scale, int exact, cudaStream_t s, int* ctas) {
  const int hpc = heads / groups, boxes = (hpc * D + 63) / 64;
  const int smem = cta_smem<Head<D, KT>>(64 * NWG, boxes, stages);
  if (smem == 0) return cudaErrorInvalidValue;
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
