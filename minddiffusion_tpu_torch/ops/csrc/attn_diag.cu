// The ds1 attention ablations (K12) for Hopper (sm_90a), on packed
// (B, N, C = heads * 64) bf16 tensors, head h being the column slice
// [64h, 64h + 64). They replace the four diagnostic TPU kernels of
// benchmarks/bench_attn_ds1.py, each of which cuts stages out of the packed
// attention kernel to time what is left:
//
//  * mdt_diag (`_diag_kernel`, pallas_call :137), one mode a call:
//      qk      sum_j s_ij, broadcast over the head's 64 columns
//      exp     sum_j exp(s_ij), broadcast
//      nosm    bf16(s) @ v, not normalised
//      fp32pv  exp(s) @ v with P kept in fp32, not normalised
//      full    bf16(exp(s)) @ v / sum_j exp(s_ij) (fp32 row sum)
//  * mdt_diag_kt (`_diag_kt_kernel`, :183): qk and full with K given
//    transposed, (B, C, N); the wrapper transposes, as the TPU function does
//    inside its timed call.
//  * mdt_diag_slice (`_diag_slice_kernel`, :218): s[:, :64] or
//    exp(s)[:, :64], the scores against keys 0-63 only. The TPU kernel
//    computed the whole S row and kept its first 64 columns; so does this
//    one: it sweeps every key tile and stores only the first. The exps of
//    the other tiles are summed into a register whose store is guarded by a
//    condition that never holds, so the compiler keeps that work.
//  * mdt_diag_bf16s (`_diag_bf16s_kernel`, :266): p = exp(bf16(s)) in bf16,
//    l = the fp32 sum of p, (p @ v) / l; the exp the fp32 one or the packed
//    bf16 one (`exp_bf16x2` in attn_core.cuh). The packed exp's value is a
//    function of the 16 bits of bf16(s): mdt_exp_bf16x2_table evaluates the
//    kernel's own device function at all 65536 of them, which is how the
//    plain version and the tests read it.
// s = q_h k_h^T raw: no kernel applies a scale or subtracts a row max, as on
// the TPU, so exp overflows fp32 above logit ~88.72 and those rows come out
// inf (exp, fp32pv) or NaN (full, bf16s: inf / inf), as the TPU modes do.
//
// Every mode is `diag_kernel<MODE, K_MN, NWG>`, the attention core of K1
// and K10d (attn_core.cuh) with a stage cut, changed or added at compile
// time: K1's producer warpgroup and TMA ring, S and PV on wgmma with q_h
// and P in registers and V MN-major as it lies, K1's row tiers and launch
// plan (`packed_plan`: 192 rows at ds1, 352 CTAs, 2.67 waves on 132 SMs),
// the q / o tile stored by TMA after the last head. `full` is K1's raw-exp
// loop at scale 1; the modes that read no V (qk, exp, slice, expslice)
// have a ring of K tiles only, so more stages of it. No thread moves an
// element of K or V in the loop:
//  * kt: the K^T tile (64 channel rows of 64 keys, 128 bytes a row) is an
//    MN-major B for S as it lies, the layout V has for PV, loaded by TMA.
//  * fp32pv: P stays fp32, so PV runs on TF32 wgmma (m64n64k8, A from
//    registers), V widened from bf16 (exact in TF32); the tensor cores read
//    P's top 19 bits (fp32's largest values stay finite). TF32 wgmma takes
//    its B K-major only, and V lies MN-major, so one pass inside the call
//    (`vt_fp32_kernel`) writes V^T in fp32, (B, C, N), with each 8-key
//    chunk in the order (0, 2, 4, 6, 1, 3, 5, 7) (`fp32pv_key`): S's
//    accumulators, keys (2t, 2t + 1) of a chunk, are then the A fragment's
//    (t, t + 4) as they lie. The pass reads 2 and writes 4 bytes an element
//    of V (42 + 84 MB at ds1, ~38 us at 3.35 TB/s), where a transpose of
//    each tile in shared memory by the producer's threads would hold the
//    ring back by its stores. Its plan stops at 128 rows: the 192-row
//    kernel (128 registers a thread) spilled.
// What bounds them on the H100 at ds1 (16, 4096, 320): QK^T is 2 N^2 D
// flops a head and PV another 2 N^2 D, against 2 bytes per element of q, k,
// v and out; every mode is far above the ~295 flop/byte ridge, so the
// tensor cores (QK^T: 0.17 ms; with PV: 0.35 ms; fp32pv's TF32 PV: +0.35
// ms) or one fp32 exp per score on the MUFU units (16 a clock per SM: 0.32
// ms; the packed bf16 exp, one MUFU op per two scores: 0.16 ms) set the
// floor. The slice modes' function needs only keys 0-63, which HBM bounds
// (0.025 ms); the kernels do the TPU mode's whole-row work, whose floor is
// its products (slice: 0.17 ms) or its exps (expslice: 0.32 ms).
#include "attn_core.cuh"

namespace {

constexpr int D = 64;    // head dim
constexpr int KT = 64;   // keys a tile

template <int MODE, bool K_MN>
using DiagHead = Head<D, KT, D, MODE, K_MN>;

// One CTA of mode MODE: BM = 64 NWG q rows of a batch element and a group
// of `heads` heads (`attn_cta`), scale 1, raw exp.
template <int MODE, bool K_MN, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) diag_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int n,
    int heads, int boxes, int stages) {
  attn_cta<DiagHead<MODE, K_MN>, NWG>(&tm_q, &tm_k, &tm_v, &tm_o, n, heads, boxes, stages, 1.f, 0,
                                      0);
}

// fp32pv's V^T: vt[b, c, 8 (j / 8) + p] = v[b, 8 (j / 8) + fp32pv_key(p), c]
// in fp32, through 32 x 32 tiles in shared memory. n, c % 32 == 0.
__global__ void vt_fp32_kernel(const __nv_bfloat16* __restrict__ v, float* __restrict__ vt,
                               int n, int c) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, n0 = blockIdx.x * 32, c0 = blockIdx.y * 32, x = threadIdx.x;
  for (int y = threadIdx.y; y < 32; y += 8)
    tile[y][x] = __bfloat162float(v[((size_t)b * n + n0 + y) * c + c0 + x]);
  __syncthreads();
  const int key = (x & ~7) | fp32pv_key(x & 7);
  for (int y = threadIdx.y; y < 32; y += 8)
    vt[((size_t)b * c + c0 + y) * n + n0 + x] = tile[key][y];
}

// One call's arguments, as every entry takes them.
struct Call {
  const void *q, *k, *v;
  void *o, *work;
  int bsz, n, c, heads, rows, stages, groups;
  void* stream;
  int* ctas;
};

template <int MODE, bool K_MN, int NWG>
cudaError_t launch_tile(const Call& a, const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                        const CUtensorMap& tm_v, const CUtensorMap& tm_o) {
  const int hpc = a.heads / a.groups;   // a 64-column box a head
  const int smem = cta_smem<DiagHead<MODE, K_MN>>(64 * NWG, hpc, a.stages);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<diag_kernel<MODE, K_MN, NWG>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 64 * NWG - 1) / (64 * NWG), a.bsz, a.groups);
  if (a.ctas) *a.ctas = (int)(grid.x * grid.y * grid.z);
  diag_kernel<MODE, K_MN, NWG><<<grid, 128 * (NWG + 1), smem,
                                 static_cast<cudaStream_t>(a.stream)>>>(
      tm_q, tm_k, tm_v, tm_o, a.n, hpc, hpc, a.stages);
  return cudaGetLastError();
}

template <int MODE, bool K_MN>
int launch(const Call& a) {
  constexpr bool tf32 = DiagHead<MODE, K_MN>::TF32_PV;
  if (a.bsz < 1 || a.heads < 1 || a.c != a.heads * D || a.n < KT || a.n % KT || a.groups < 1 ||
      a.heads % a.groups || a.rows < 64 || a.rows > (tf32 ? 128 : 192) || a.rows % 64 ||
      (tf32 && !a.work))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const bool maps =
      make_map(&tm_q, a.q, a.bsz, a.n, a.c, 64, a.rows) &&
      (K_MN ? make_map(&tm_k, a.k, a.bsz, a.c, a.n, 64, D)
            : make_map(&tm_k, a.k, a.bsz, a.n, a.c, 64, KT)) &&
      (tf32 ? make_map(&tm_v, a.work, a.bsz, a.c, a.n, 32, D, 0, 0, true)
            : make_map(&tm_v, a.v, a.bsz, a.n, a.c, 64, KT)) &&
      make_map(&tm_o, a.o, a.bsz, a.n, a.c, 64, 64);
  if (!maps) return (int)cudaErrorInvalidValue;
  if constexpr (tf32) {
    vt_fp32_kernel<<<dim3(a.n / 32, a.c / 32, a.bsz), dim3(32, 8), 0,
                     static_cast<cudaStream_t>(a.stream)>>>(
        static_cast<const __nv_bfloat16*>(a.v), static_cast<float*>(a.work), a.n, a.c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (!tf32)   // fp32pv: at most 128 rows (at 192, 128 registers a thread spill)
    if (a.rows == 192) return (int)launch_tile<MODE, K_MN, 3>(a, tm_q, tm_k, tm_v, tm_o);
  if (a.rows == 128) return (int)launch_tile<MODE, K_MN, 2>(a, tm_q, tm_k, tm_v, tm_o);
  return (int)launch_tile<MODE, K_MN, 1>(a, tm_q, tm_k, tm_v, tm_o);
}

}  // namespace

// Every entry: q, k, v, o (bsz, n, c) bf16, contiguous, 16-byte aligned
// (mdt_diag_kt: k (bsz, c, n)); c = heads * 64, n % 64 == 0. rows (64 /
// 128 / 192), stages, groups: `diag_plan`'s in ops/attn_diag.py. Writes
// the CTAs it launches to `ctas` (may be NULL).
#define MDT_CALL Call{q, k, v, o, work, bsz, n, c, heads, rows, stages, groups, stream, ctas}

// mode: 0 qk, 1 exp, 2 nosm, 3 fp32pv, 4 full. work: fp32pv's V^T, (bsz, c,
// n) fp32; not read by the other modes.
extern "C" int mdt_diag(const void* q, const void* k, const void* v, void* o, void* work,
                        int bsz, int n, int c, int heads, int mode, int rows, int stages,
                        int groups, void* stream, int* ctas) {
  switch (mode) {
    case 0: return launch<ROWSUM_S, false>(MDT_CALL);
    case 1: return launch<ROWSUM_EXP, false>(MDT_CALL);
    case 2: return launch<NOSM, false>(MDT_CALL);
    case 3: return launch<FP32PV, false>(MDT_CALL);
    case 4: return launch<ATTN, false>(MDT_CALL);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k: (bsz, c, n), K transposed. mode: 0 qk, 4 full.
extern "C" int mdt_diag_kt(const void* q, const void* k, const void* v, void* o, void* work,
                           int bsz, int n, int c, int heads, int mode, int rows, int stages,
                           int groups, void* stream, int* ctas) {
  switch (mode) {
    case 0: return launch<ROWSUM_S, true>(MDT_CALL);
    case 4: return launch<ATTN, true>(MDT_CALL);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode: 5 slice, 6 expslice; v is not read.
extern "C" int mdt_diag_slice(const void* q, const void* k, const void* v, void* o, void* work,
                              int bsz, int n, int c, int heads, int mode, int rows, int stages,
                              int groups, void* stream, int* ctas) {
  switch (mode) {
    case 5: return launch<SLICE_S, false>(MDT_CALL);
    case 6: return launch<SLICE_EXP, false>(MDT_CALL);
    default: return (int)cudaErrorInvalidValue;
  }
}

// packed_exp (in the mode's place): 0 the fp32 exp, 1 the packed bf16 exp.
extern "C" int mdt_diag_bf16s(const void* q, const void* k, const void* v, void* o, void* work,
                              int bsz, int n, int c, int heads, int packed_exp, int rows,
                              int stages, int groups, void* stream, int* ctas) {
  if (packed_exp) return launch<BF16S_EX2, false>(MDT_CALL);
  return launch<BF16S, false>(MDT_CALL);
}

#undef MDT_CALL

namespace {

// out[i] = the packed bf16 exp of the bf16 whose bits are i, for all 65536 i.
__global__ void exp_table_kernel(__nv_bfloat16* out) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  *reinterpret_cast<uint32_t*>(out + i) =
      exp_bf16x2<true>(bf16_lo((uint32_t)i), bf16_lo((uint32_t)(i + 1)));
}

}  // namespace

// out: 65536 bf16, the packed bf16 exp of mdt_diag_bf16s at every bf16 input.
extern "C" int mdt_exp_bf16x2_table(void* out, void* stream) {
  exp_table_kernel<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
