// Per-channel spatial sums for GroupNorm statistics on Hopper (sm_90a):
// s1[b, c] = sum over (h, w) of x, s2[b, c] = sum of x^2, fp32, from a
// bf16 activation, in either memory order:
//   (B, H, W, C)   B matrices of (H*W, C): plane stride H*W*C, row stride C;
//   (H, W, B, C)   one matrix of (H*W, B*C), row stride B*C, whose column
//                  b*C + c is s[b, c].
// Both are a sum over the rows of `planes` matrices with contiguous columns,
// and in both the flat index plane * cols + col is the output's (b, c). One
// kernel takes them as (planes, rows, cols, row stride, plane stride).
//
// Replaces the TPU kernels benchmarks/research/gn_stats.py
// `channel_sums_pallas` (`_stats_kernel`) and `channel_sums_pallas_t`
// (`_stats_kernel_t`).
//
// What bounds it on the H100: a pure reduction, 3 flops per 2 bytes read,
// so HBM: the least time is reading x once (B*H*W*C*2 bytes over 3.35
// TB/s, 0.0125 ms at (16, 64, 64, 320)). The TPU kernel carried its sums
// across a sequential grid axis in VMEM; here CTAs run in no order. Design:
//  * A CTA reduces 64 columns over a slab of rows. With rows 16-byte
//    aligned (cols and both strides multiples of 8 elements) each thread
//    loads 8 columns with one 16-byte load, 8 threads a row (128 bytes),
//    32 rows a step, and keeps UNROLL = 4 rows' loads in flight: 16 KB a
//    CTA, and the plan (ops/gn_stats.py `stats_plan`) puts about 4 CTAs on
//    an SM, ~64 KB in flight, which is what HBM's rate times its latency
//    asks of an SM. Rows that are only 4-byte aligned (C even, e.g. C 10)
//    take the same loop with 4-byte loads, 32 threads a row.
//  * The slabs of one column block are the CTAs of one thread-block
//    cluster (at most 8). Each CTA adds its threads' partials in a fixed
//    order (shuffles within a warp, then the warps through shared memory),
//    then rank 0 adds the cluster's partials through distributed shared
//    memory in rank order and writes s1 and s2: one launch, no scratch in
//    global memory, no atomics, so reruns are bitwise equal. Where there
//    are two column blocks an SM or more, a CTA takes a whole column block
//    and the launch has no cluster.
//  * Where the time goes (device ms on an H100 SXM, 700 W;
//    scripts/tail_ablate.py): (16, 64, 64, 320) 0.0152-0.0157 in either
//    order, 80% of the bound, ~0.0052 of it the launch, the clusters and
//    the reductions with no rows read; 8 loads in flight a thread take
//    0.019-0.020 (fewer CTAs resident). At (16, 16, 16, 1280) 0.0043, the
//    plain launch 0.0023 of it; clusters there cost ~1.3 us more. The first
//    port (a partials kernel and a second launch for the slabs) took
//    ~0.019 at (16, 64, 64, 320) for its two launches. A call's CUDA-event
//    time is the wrapper's host time (~40-100 us), not the device's.
// The C entry takes the plan (vec, columns a CTA, slabs, rows a CTA, CTAs)
// and refuses one whose numbers are not this file's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CB = 64;           // columns a CTA
constexpr int UNROLL = 4;        // rows whose loads a thread keeps in flight
constexpr int MAX_CLUSTER = 8;   // the portable cluster size: slabs of a column block

template <int VEC>
struct Load;
template <>
struct Load<8> {   // 16 bytes, streamed past L1
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, uint32_t (&w)[4]) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "l"(p));
  }
};
template <>
struct Load<2> {   // 4 bytes
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, uint32_t (&w)[1]) {
    asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n" : "=r"(w[0]) : "l"(p));
  }
};

__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  float v;
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n"
      "}\n"
      : "=f"(v)
      : "r"(addr), "r"(rank)
      : "memory");
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// Grid (slabs, column blocks, planes), clusters of `slabs` CTAs along x;
// s holds s1 (planes * cols) then s2.
template <int VEC>
__global__ void __launch_bounds__(THREADS) channel_sums_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ s, int rows, int cols,
    long long row_stride, long long plane_stride, int rows_per_cta) {
  constexpr int LANES = CB / VEC;          // threads a row
  constexpr int ROWG = THREADS / LANES;    // rows a step
  constexpr int WORDS = VEC / 2;           // 32-bit words a load
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[WARPS][2][CB];
  __shared__ float part[2][CB];
  const int slab = blockIdx.x, plane = blockIdx.z;
  const int tl = threadIdx.x % LANES, tr = threadIdx.x / LANES;
  const int col = blockIdx.y * CB + tl * VEC;   // cols % VEC == 0: a load is in or out whole
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) a1[j] = a2[j] = 0.f;
  if (col < cols) {
    const __nv_bfloat16* base = x + plane * plane_stride + col;
    const int r_end = min(rows, (slab + 1) * rows_per_cta);
#pragma unroll 1
    for (int r = slab * rows_per_cta + tr; r < r_end; r += ROWG * UNROLL) {
      uint32_t w[UNROLL][WORDS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * ROWG < r_end) {
          Load<VEC>::run(base + (long long)(r + u * ROWG) * row_stride, w[u]);
        } else {
#pragma unroll
          for (int q = 0; q < WORDS; ++q) w[u][q] = 0u;   // adds exact zeros
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int q = 0; q < WORDS; ++q) {
          const float lo = __uint_as_float(w[u][q] << 16);
          const float hi = __uint_as_float(w[u][q] & 0xffff0000u);
          a1[2 * q] += lo;
          a1[2 * q + 1] += hi;
          a2[2 * q] = fmaf(lo, lo, a2[2 * q]);
          a2[2 * q + 1] = fmaf(hi, hi, a2[2 * q + 1]);
        }
    }
  }
  // the row groups of a warp (LANES apart) by shuffles, a fixed tree: all
  // lanes of a column end up with the warp's sum
#pragma unroll
  for (int off = LANES; off < 32; off *= 2)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a1[j] += __shfl_xor_sync(0xffffffffu, a1[j], off);
      a2[j] += __shfl_xor_sync(0xffffffffu, a2[j], off);
    }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < LANES) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[warp][0][tl * VEC + j] = a1[j];
      red[warp][1][tl * VEC + j] = a2[j];
    }
  }
  __syncthreads();
  const int which = threadIdx.x / CB, cc = threadIdx.x % CB;   // threads < 2 CB
  if (threadIdx.x < 2 * CB) {
    float v[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v[w] = red[w][which][cc];
    float acc = v[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) acc += v[w];
    part[which][cc] = acc;
  }
  const int slabs = gridDim.x;
  if (slabs > 1) cluster_sync();   // every CTA's partials are in its shared memory
  else __syncthreads();
  if (slab == 0 && threadIdx.x < 2 * CB) {
    const int c = blockIdx.y * CB + cc;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(&part[which][cc]));
    float v[MAX_CLUSTER];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r) v[r] = r < slabs ? ld_cluster(addr, r) : 0.f;
    float acc = part[which][cc];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)   // in rank order
      if (r < slabs) acc += v[r];
    if (c < cols) s[(size_t)which * gridDim.z * cols + (size_t)plane * cols + c] = acc;
  }
  if (slabs > 1) cluster_sync();   // rank 0 has read the others' partials
}

template <int VEC>
cudaError_t launch(const void* x, void* s, int planes, int rows, int cols, long long row_stride,
                   long long plane_stride, int slabs, int rows_per_cta, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, (cols + CB - 1) / CB, planes);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = slabs > 1 ? 1 : 0;   // one slab: a plain launch
  return cudaLaunchKernelEx(&cfg, channel_sums_kernel<VEC>,
                            static_cast<const __nv_bfloat16*>(x), static_cast<float*>(s), rows,
                            cols, row_stride, plane_stride, rows_per_cta);
}

}  // namespace

// x: bf16, `planes` matrices of (rows, cols) with the given strides
// (elements); s: fp32 (2, planes * cols), s1 then s2. The plan: vec (8:
// 16-byte loads, which need cols, both strides and x 16-byte aligned; 2:
// 4-byte loads, which need cols even and x 4-byte aligned), cb (columns a
// CTA), slabs (1..8, a cluster), rows_per_cta (ceil(rows / slabs)), ctas.
extern "C" int mdt_channel_sums(const void* x, void* s, int planes, int rows, int cols,
                                long long row_stride, long long plane_stride, int vec, int cb,
                                int slabs, int rows_per_cta, int ctas, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const bool aligned16 = addr % 16 == 0 && cols % 8 == 0 && row_stride % 8 == 0 &&
                         plane_stride % 8 == 0;
  const bool aligned4 = addr % 4 == 0 && cols % 2 == 0 && row_stride % 2 == 0 &&
                        plane_stride % 2 == 0;
  if (planes < 1 || rows < 1 || cols < 2 || cb != CB || slabs < 1 || slabs > MAX_CLUSTER ||
      rows_per_cta != (rows + slabs - 1) / slabs ||
      (long long)ctas != (long long)slabs * ((cols + CB - 1) / CB) * planes ||
      !(vec == 8 ? aligned16 : vec == 2 && aligned4 && !aligned16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec == 8 ? launch<8>(x, s, planes, rows, cols, row_stride, plane_stride, slabs,
                                    rows_per_cta, st)
                        : launch<2>(x, s, planes, rows, cols, row_stride, plane_stride, slabs,
                                    rows_per_cta, st));
}
