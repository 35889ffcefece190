// Shared pieces of the mma.sync kernels (winograd43.cu, conv3x3.cu,
// attn_diag.cu and attn_variants.cu's ones kernel): the bf16 m16n8k16
// tensor-core product with fp32 accumulation, 32-bit shared-memory fragment
// loads, cp.async with zero fill, and the batched GEMM the Winograd
// F(4x4, 3x3) kernel runs between its input and output transforms. The
// wgmma kernels' pieces are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (the source
// is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

constexpr int GBM = 128, GBN = 128, GBK = 32, GPAD = 8, GTHREADS = 256;

// mbuf[z] (m x n, fp32) = vbuf[z] (m x kd, bf16) @ u[z] (kd x n, bf16), z =
// blockIdx.z. Requires kd % 8 == 0 and n % 8 == 0; ragged m and the last K
// step are masked. 128 x 128 block tile, 8 warps of 64 x 32, a 32-deep K
// step through shared memory, no pipelining.
__global__ void __launch_bounds__(GTHREADS) wino_gemm_kernel(
    const __nv_bfloat16* __restrict__ vbuf, const __nv_bfloat16* __restrict__ u,
    float* __restrict__ mbuf, int m, int n, int kd) {
  __shared__ __align__(16) __nv_bfloat16 as[GBM][GBK + GPAD];
  __shared__ __align__(16) __nv_bfloat16 bts[GBN][GBK + GPAD];  // U tile, transposed
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const __nv_bfloat16* A = vbuf + (size_t)z * m * kd;
  const __nv_bfloat16* B = u + (size_t)z * kd * n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < kd; k0 += GBK) {
    __syncthreads();
    // A tile: 128 rows x 32 columns = 512 vectors of 8.
    for (int i = tid; i < GBM * GBK / 8; i += GTHREADS) {
      const int r = i / (GBK / 8), cv = (i % (GBK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m && k0 + cv < kd)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * kd + k0 + cv);
      *reinterpret_cast<uint4*>(&as[r][cv]) = val;
    }
    // B tile: 32 rows (k) x 128 columns (n), stored transposed.
    for (int i = tid; i < GBK * GBN / 8; i += GTHREADS) {
      const int r = i / (GBN / 8), cv = (i % (GBN / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < kd && n0 + cv < n)
        val = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * n + n0 + cv);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) bts[cv + j][r] = e[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* ap = &as[wm + mi * 16 + g][kk + 2 * t];
        a[mi][0] = ld32(ap);
        a[mi][1] = ld32(ap + 8 * (GBK + GPAD));
        a[mi][2] = ld32(ap + 8);
        a[mi][3] = ld32(ap + 8 * (GBK + GPAD) + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* bp = &bts[wn + ni * 8 + g][kk + 2 * t];
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }

  float* C = mbuf + (size_t)z * m * n;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r0 = m0 + wm + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cc = n0 + wn + ni * 8 + 2 * t;
      if (cc >= n) continue;
      if (r0 < m)
        *reinterpret_cast<float2*>(C + (size_t)r0 * n + cc) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (r0 + 8 < m)
        *reinterpret_cast<float2*>(C + (size_t)(r0 + 8) * n + cc) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// The batched GEMM above over `batches` planes, on stream s.
cudaError_t launch_batched_gemm(const void* vbuf, const void* u, void* mbuf,
                                long long m, int n, int kd, int batches,
                                cudaStream_t s) {
  const dim3 grid((n + GBN - 1) / GBN, (unsigned)((m + GBM - 1) / GBM), batches);
  wino_gemm_kernel<<<grid, GTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(vbuf), static_cast<const __nv_bfloat16*>(u),
      static_cast<float*>(mbuf), (int)m, n, kd);
  return cudaGetLastError();
}

}  // namespace
