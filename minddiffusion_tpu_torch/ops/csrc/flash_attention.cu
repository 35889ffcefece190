// Head-split attention for Hopper (sm_90a): softmax(scale * Q K^T) V per
// (batch, head) on (B, N, H, D) bf16 tensors, D 40, 64, 80, 160 or 512, any
// Nq, Nk >= 1, in exact (online row max) or static-shift (exp(s - 20))
// softmax.
//
// Replaces the TPU kernel minddiffusion_tpu/ops/flash_attention.py
// `_attn_kernel` (pallas_call in `_flash_bhnd`, K4), which needed the
// (B*H, N, D) transpose only because Mosaic cannot block a middle axis.
//
// A contiguous (B, N, H, D) tensor is, byte for byte, the packed (B, N, C =
// H D) tensor of K1 (packed_attention.cu), head h the column slice [D h,
// D h + D): the TMA maps here read it as that, so no copy and no transpose
// is made, and K4 runs K1's kernels with its own softmax:
//  * D 40 / 64 / 80 / 160: `flash_attn_kernel<D, KT, NWG>`, the attention
//    core of attn_core.cuh (`attn_cta`): warpgroup 0 the TMA producer, 1..3
//    wgmma consumers of 64 q rows each, a ring of K / V tiles across the
//    CTA's heads, q_h in registers, V read MN-major as it lies, the output
//    stored by TMA. Rows, keys a tile, stages and head groups are K1's plan
//    (`flash_plan` in ops/flash_attention.py); at the 768x1024 ds1 site (8,
//    12288, 5 x 64) 192 rows, 64 keys, 6 stages: 512 CTAs, 3.9 waves.
//  * D 512 (the VAE mid, one head): `flash_attn512_kernel`, the D 512 CTA
//    of attn512.cuh (three consumer warpgroups split the output columns and
//    share one S); with several heads, a launch a head, its maps over the
//    head's 512 columns (rows H 512 apart).
// The one difference from K1 is exact=0: K4's head has the core's SHIFT,
// so the numerators' exponent starts at -20 log2 e (`FAST_SHIFT`), a
// compile-time constant of the head, not a branch in the loop; exact=1 is
// the same running max as K1's.
//
// Numerics follow the TPU kernel: q is scaled in fp32 and rounded to bf16;
// QK^T and PV take bf16 operands with fp32 accumulation (wgmma); the
// running max and sum are fp32; P is rounded to bf16 before PV while the
// row sum adds the fp32 P; the fp32 accumulator is divided by the fp32 row
// sum at the end. Keys past Nk come from TMA's zero fill and are masked to
// -inf, rows past Nq are not stored.
//
// What bounds it on the H100: 4 Nq Nk D flops a head against ~6 N D bytes;
// at the long sites (N >= 9216) the tensor cores (D 64, 512) or one fp32 exp
// a score (D 40) set the floor.
#include "attn512.cuh"

namespace {

// K4's head: K1's with the static shift at exact=0.
template <int D, int KT>
using FlashHead = Head<D, KT, D, ATTN, false, true>;

// D 40 / 64 / 80 / 160: the core's CTA of BM = 64 NWG q rows, a batch
// element and a group of `heads` heads.
template <int D, int KT, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) flash_attn_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    int heads, int boxes, int stages, float scale, int exact) {
  attn_cta<FlashHead<D, KT>, NWG>(&tm_q, &tm_k, &tm_v, &tm_o, nk, heads, boxes, stages, scale,
                                  exact, 0);
}

// D 512: 64 rows of the maps' head, batch element blockIdx.y.
__global__ void __launch_bounds__(512, 1) flash_attn512_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int nk,
    float scale, int exact) {
  attn512_cta<FlashHead<512, 64>>(&tm_q, &tm_k, &tm_v, &tm_o, nk, scale, exact);
}

// One launch of the D 512 kernel a head: maps over head h's 512 columns of
// the (bsz, n, heads * 512) tensors.
cudaError_t launch_512(const void* q, const void* k, const void* v, void* o, int bsz, int nq,
                       int nk, int heads, float scale, int exact, cudaStream_t s, int* ctas) {
  cudaError_t err = allow_smem<flash_attn512_kernel>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 63) / 64, bsz);
  if (ctas) *ctas = (int)(grid.x * grid.y) * heads;
  const long long ld = 512LL * heads;
  for (int h = 0; h < heads; ++h) {
    const auto at = [h](const void* p) { return static_cast<const __nv_bfloat16*>(p) + 512 * h; };
    CUtensorMap tm_q, tm_k, tm_v, tm_o;
    if (!make_map(&tm_q, at(q), bsz, nq, 512, 64, 64, ld) ||
        !make_map(&tm_k, at(k), bsz, nk, 512, 64, 64, ld) ||
        !make_map(&tm_v, at(v), bsz, nk, 512, 64, 64, ld) ||
        !make_map(&tm_o, at(o), bsz, nq, 512, 64, 64, ld))
      return cudaErrorInvalidValue;
    flash_attn512_kernel<<<grid, 512, SMEM512, s>>>(tm_q, tm_k, tm_v, tm_o, nk, scale, exact);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D, int KT, int NWG>
cudaError_t launch_tile(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                        const CUtensorMap& tm_o, int bsz, int nq, int nk, int heads, int groups,
                        int stages, float scale, int exact, cudaStream_t s, int* ctas) {
  const int hpc = heads / groups, boxes = (hpc * D + 63) / 64;
  const int smem = cta_smem<FlashHead<D, KT>>(64 * NWG, boxes, stages);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<flash_attn_kernel<D, KT, NWG>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + 64 * NWG - 1) / (64 * NWG), bsz, groups);
  if (ctas) *ctas = (int)(grid.x * grid.y * grid.z);
  flash_attn_kernel<D, KT, NWG><<<grid, 128 * (NWG + 1), smem, s>>>(
      tm_q, tm_k, tm_v, tm_o, nk, hpc, boxes, stages, scale, exact);
  return cudaGetLastError();
}

}  // namespace

// q: (bsz, nq, heads, d), k / v: (bsz, nk, heads, d), o: (bsz, nq, heads,
// d); bf16, contiguous, 16-byte aligned; d in {40, 64, 80, 160, 512}, nq,
// nk >= 1. The plan (rows of a CTA, keys of a tile, ring stages, head
// groups) is `flash_plan`'s in ops/flash_attention.py: K1's at D 40-160
// (`groups` CTAs split a row block's heads, each group's columns whole
// 64-column boxes); at D 512 64 rows, 64 keys, one stage and a group (a
// launch) a head. Writes the CTAs it launches to `ctas` (may be NULL).
extern "C" int mdt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bsz, int nq, int nk, int heads, int d, float scale,
                                   int exact, int rows, int key_tile, int stages, int groups,
                                   void* stream, int* ctas) {
  if (heads < 1 || nq < 1 || nk < 1 || bsz < 1 || groups < 1 || heads % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 512)
    return rows == 64 && key_tile == 64 && stages == 1 && groups == heads
               ? (int)launch_512(q, k, v, o, bsz, nq, nk, heads, scale, exact, s, ctas)
               : (int)cudaErrorInvalidValue;
  const long long c = (long long)heads * d;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if ((groups > 1 && (c / groups) % 64 != 0) || rows < 64 || rows > 192 || key_tile < 16 ||
      !make_map(&tm_q, q, bsz, nq, c, 64, rows) ||
      !make_map(&tm_k, k, bsz, nk, c, 64, key_tile) ||
      !make_map(&tm_v, v, bsz, nk, c, 64, key_tile) || !make_map(&tm_o, o, bsz, nq, c, 64, 64))
    return (int)cudaErrorInvalidValue;
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
