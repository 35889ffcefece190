// Per-channel spatial sums for GroupNorm statistics on Hopper (sm_90a):
// s1[b, c] = sum over (h, w) of x, s2[b, c] = sum of x^2, fp32, from a
// bf16 activation, in either memory order:
//   (B, H, W, C)   batch stride H*W*C, spatial-row stride C;
//   (H, W, B, C)   batch stride C,     spatial-row stride B*C.
//
// Replaces the TPU kernels benchmarks/research/gn_stats.py
// `channel_sums_pallas` (`_stats_kernel`) and `channel_sums_pallas_t`
// (`_stats_kernel_t`): one kernel here, the two layouts passed as strides.
//
// What bounds it on the H100: a pure reduction, 2 flops per byte read, so
// HBM: the least time is reading x once (B*H*W*C*2 bytes over 3.35 TB/s).
// The TPU kernel carried its sums across a sequential grid axis in VMEM; on
// the card blocks run in no order, so each block reduces one slab of up to
// 256 spatial rows for a run of 64 channels (a warp's 32 lanes read 2
// channels each: 128 contiguous bytes of one row), the 8 warps of a block
// take every 8th row, and the block adds its warps' partials in shared
// memory in a fixed order. A second launch adds the slabs' partials in slab
// order. No float atomics: reruns are bitwise identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 64;          // channels per block (2 per lane)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLAB_ROWS = 256;  // spatial rows per block

__global__ void __launch_bounds__(THREADS) channel_partials_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ part1,
    float* __restrict__ part2, int hw, int c, long long batch_stride,
    long long row_stride, int n_slabs) {
  __shared__ float red[2][WARPS][CB];
  const int cblk = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = cblk * CB + 2 * lane;
  float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;
  if (c0 < c) {  // c is even, so c0 + 1 < c too
    const __nv_bfloat16* base = x + (long long)b * batch_stride + c0;
    const int r_end = min(hw, (slab + 1) * SLAB_ROWS);
    for (int r = slab * SLAB_ROWS + warp; r < r_end; r += WARPS) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(base + (long long)r * row_stride));
      s1a += f.x;
      s1b += f.y;
      s2a += f.x * f.x;
      s2b += f.y * f.y;
    }
  }
  red[0][warp][2 * lane] = s1a;
  red[0][warp][2 * lane + 1] = s1b;
  red[1][warp][2 * lane] = s2a;
  red[1][warp][2 * lane + 1] = s2b;
  __syncthreads();
  if (threadIdx.x < 2 * CB) {
    const int which = threadIdx.x / CB, cc = threadIdx.x % CB;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red[which][w][cc];
    const int ch = cblk * CB + cc;
    if (ch < c) (which ? part2 : part1)[((size_t)b * n_slabs + slab) * c + ch] = acc;
  }
}

__global__ void channel_finish_kernel(const float* __restrict__ part1,
                                      const float* __restrict__ part2,
                                      float* __restrict__ s1, float* __restrict__ s2,
                                      int bsz, int c, int n_slabs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bsz * c) return;
  const int b = i / c, ch = i % c;
  float a1 = 0.f, a2 = 0.f;
  for (int s = 0; s < n_slabs; ++s) {
    const size_t o = ((size_t)b * n_slabs + s) * c + ch;
    a1 += part1[o];
    a2 += part2[o];
  }
  s1[i] = a1;
  s2[i] = a2;
}

}  // namespace

// x: bf16 with the given strides (elements); part1/part2: fp32 scratch of
// bsz * n_slabs * c, n_slabs = ceil(hw / 256); s1/s2: fp32 (bsz, c).
// Requires c even and every row start 4-byte aligned.
extern "C" int mdt_channel_sums(const void* x, void* part1, void* part2, void* s1,
                                void* s2, int bsz, int hw, int c,
                                long long batch_stride, long long row_stride,
                                int n_slabs, void* stream) {
  if (c % 2 || bsz < 1 || hw < 1 || n_slabs != (hw + SLAB_ROWS - 1) / SLAB_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + CB - 1) / CB, n_slabs, bsz);
  channel_partials_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(part1),
      static_cast<float*>(part2), hw, c, batch_stride, row_stride, n_slabs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = bsz * c;
  channel_finish_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      static_cast<float*>(s1), static_cast<float*>(s2), bsz, c, n_slabs);
  return (int)cudaGetLastError();
}
