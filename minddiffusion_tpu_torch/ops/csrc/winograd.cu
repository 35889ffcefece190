// Winograd F(2x2, 3x3) conv for Hopper (sm_90a): a 3x3 stride-1 same-pad
// convolution on NHWC bf16, with an optional fused GroupNorm+SiLU prologue.
//
// Two entry points:
//  * mdt_winograd_conv3x3 (K2) replaces the TPU kernels
//    minddiffusion_tpu/ops/winograd.py `_wino_kernel_dma_gn` and
//    `_wino_kernel_dma` (both through `_wino_compute`; pallas_call in
//    `_wino_pallas_dma`): it reads the NHWC activation itself, halo and
//    padding included, with the optional GN+SiLU prologue.
//  * mdt_winograd_conv3x3_gathered (K3) replaces `_wino_kernel` (pallas_call
//    in `_wino_pallas`, the MDT_WINO_TUNE=dma=0 path): it reads a
//    host-gathered halo-tile array (B, n_tiles, bh+2, W+4, C_in), zero
//    padding already in place and GN+SiLU already applied, so its input
//    transform has no bounds checks and no prologue. Both share the GEMM and
//    the output transform.
//
// Math, as on the TPU: for every 2x2 output tile, the 4x4 input patch d
// (after the prologue silu(x * mult + add) on interior pixels only; the
// zero padding stays exactly zero) is transformed V = B^T d B in fp32 and
// rounded to bf16; 16 GEMMs M[a] = V[a] U[a] with U = G k G^T
// (16, C_in, C_out) bf16 accumulate in fp32; the output tile is
// Y = A^T M A + bias in fp32, stored as bf16.
//
// What bounds it on the H100: at the UNet sites (16^2 and 32^2, C 640-2560,
// batch 16) the GEMMs are 16 x (P x C_in x C_out) with P = 1024-4096 tiles:
// 20-100 GFLOP per conv, compute-bound on the tensor cores. The TPU kernel
// kept V and M in VMEM inside one program; this first Hopper version runs
// three launches (input transform -> batched GEMM -> output transform) with
// V (bf16) and M (fp32) in device memory. The round trip of M costs
// 16 * P * C_out * 8 bytes per conv, which the fused version (GEMM epilogue
// doing the output transform) removes later. The GEMM is a plain
// mma.sync m16n8k16 kernel: 128 x 128 block tile, 8 warps of 64 x 32, a
// 32-deep K step through shared memory, no pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

// One thread per (tile, input channel). vbuf: (16, P, cin), P = bsz*(h/2)*(w/2).
__global__ void wino_input_kernel(const __nv_bfloat16* __restrict__ x,
                                  const float* __restrict__ mult,
                                  const float* __restrict__ add,
                                  __nv_bfloat16* __restrict__ vbuf, int bsz,
                                  int h, int w, int cin) {
  const int th = h / 2, tw = w / 2;
  const long long p_total = (long long)bsz * th * tw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_total * cin) return;
  const int ch = (int)(idx % cin);
  const long long p = idx / cin;
  const int tx = (int)(p % tw);
  const int ty = (int)((p / tw) % th);
  const int b = (int)(p / ((long long)tw * th));
  const bool gn = mult != nullptr;
  const float mu = gn ? mult[(size_t)b * cin + ch] : 1.f;
  const float ad = gn ? add[(size_t)b * cin + ch] : 0.f;

  float d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = 2 * ty - 1 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xx = 2 * tx - 1 + j;
      float val = 0.f;
      if (y >= 0 && y < h && xx >= 0 && xx < w) {
        val = __bfloat162float(x[(((size_t)b * h + y) * w + xx) * cin + ch]);
        if (gn) val = silu(val * mu + ad);
      }
      d[i][j] = val;
    }
  }
  // B^T on the columns, then on the rows: V[a][b].
  float cb[4][4];  // cb[i][b]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cb[i][0] = d[i][0] - d[i][2];
    cb[i][1] = d[i][1] + d[i][2];
    cb[i][2] = d[i][2] - d[i][1];
    cb[i][3] = d[i][1] - d[i][3];
  }
  const size_t plane = (size_t)p_total * cin;
  __nv_bfloat16* out = vbuf + (size_t)p * cin + ch;
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    const float va[4] = {cb[0][bb] - cb[2][bb], cb[1][bb] + cb[2][bb],
                         cb[2][bb] - cb[1][bb], cb[1][bb] - cb[3][bb]};
#pragma unroll
    for (int a = 0; a < 4; ++a) out[(a * 4 + bb) * plane] = __float2bfloat16(va[a]);
  }
}

// K3's input transform. One thread per (tile, input channel). tiles:
// (bsz * n_tiles, bh + 2, w + 4, cin), tile row 0 / column 0 being padded
// row t * bh / column -1 of the image; vbuf: (16, P, cin) with
// P = bsz * n_tiles * (bh/2) * (w/2) in (batch, tile, row, column) order,
// which is the (batch, row, column) order of the stacked padded height
// n_tiles * bh that the output transform writes.
__global__ void wino_gathered_input_kernel(const __nv_bfloat16* __restrict__ tiles,
                                           __nv_bfloat16* __restrict__ vbuf,
                                           long long p_total, int bh, int w,
                                           int cin) {
  const int th = bh / 2, tw = w / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_total * cin) return;
  const int ch = (int)(idx % cin);
  const long long p = idx / cin;
  const int tx = (int)(p % tw);
  const int ty = (int)((p / tw) % th);
  const long long tile = p / ((long long)tw * th);
  const __nv_bfloat16* src =
      tiles + ((tile * (bh + 2) + 2 * ty) * (size_t)(w + 4) + 2 * tx) * cin + ch;

  float d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[i][j] = __bfloat162float(src[((size_t)i * (w + 4) + j) * cin]);
  float cb[4][4];  // cb[i][b]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cb[i][0] = d[i][0] - d[i][2];
    cb[i][1] = d[i][1] + d[i][2];
    cb[i][2] = d[i][2] - d[i][1];
    cb[i][3] = d[i][1] - d[i][3];
  }
  const size_t plane = (size_t)p_total * cin;
  __nv_bfloat16* out = vbuf + (size_t)p * cin + ch;
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    const float va[4] = {cb[0][bb] - cb[2][bb], cb[1][bb] + cb[2][bb],
                         cb[2][bb] - cb[1][bb], cb[1][bb] - cb[3][bb]};
#pragma unroll
    for (int a = 0; a < 4; ++a) out[(a * 4 + bb) * plane] = __float2bfloat16(va[a]);
  }
}

constexpr int GBM = 128, GBN = 128, GBK = 32, GPAD = 8, GTHREADS = 256;

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

// mbuf[z] (m x n, fp32) = vbuf[z] (m x kd, bf16) @ u[z] (kd x n, bf16), z = 0..15.
// Requires kd % 8 == 0 and n % 8 == 0; ragged m and the last K step are masked.
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

// One thread per (tile, output channel): Y = A^T M A + bias -> 2x2 outputs.
__global__ void wino_output_kernel(const float* __restrict__ mbuf,
                                   const float* __restrict__ bias,
                                   __nv_bfloat16* __restrict__ y, int bsz, int h,
                                   int w, int cout) {
  const int th = h / 2, tw = w / 2;
  const long long p_total = (long long)bsz * th * tw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_total * cout) return;
  const int co = (int)(idx % cout);
  const long long p = idx / cout;
  const int tx = (int)(p % tw);
  const int ty = (int)((p / tw) % th);
  const int b = (int)(p / ((long long)tw * th));
  const size_t plane = (size_t)p_total * cout;
  const float* src = mbuf + (size_t)p * cout + co;
  float mm[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) mm[i] = src[i * plane];
  float p0[4], p1[4];
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    p0[bb] = mm[bb] + mm[4 + bb] + mm[8 + bb];
    p1[bb] = mm[4 + bb] - mm[8 + bb] - mm[12 + bb];
  }
  const float bs = bias[co];
  const float out[2][2] = {{p0[0] + p0[1] + p0[2] + bs, p0[1] - p0[2] - p0[3] + bs},
                           {p1[0] + p1[1] + p1[2] + bs, p1[1] - p1[2] - p1[3] + bs}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      y[(((size_t)b * h + 2 * ty + i) * w + 2 * tx + j) * cout + co] =
          __float2bfloat16(out[i][j]);
}

// The 16 GEMMs and the output transform, after an input transform filled
// vbuf: y (bsz, h, w, cout) from P = bsz * (h/2) * (w/2) tiles.
cudaError_t gemm_and_output(const void* vbuf, const void* u, const void* bias,
                            void* mbuf, void* y, int bsz, int h, int w,
                            int cin, int cout, cudaStream_t s) {
  const long long p_total = (long long)bsz * (h / 2) * (w / 2);
  const dim3 grid((cout + GBN - 1) / GBN, (unsigned)((p_total + GBM - 1) / GBM), 16);
  wino_gemm_kernel<<<grid, GTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(vbuf), static_cast<const __nv_bfloat16*>(u),
      static_cast<float*>(mbuf), (int)p_total, cout, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  wino_output_kernel<<<(unsigned)((p_total * cout + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(mbuf), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), bsz, h, w, cout);
  return cudaGetLastError();
}

}  // namespace

// x: (bsz, h, w, cin) bf16; u: (16, cin, cout) bf16; bias: (cout,) fp32;
// mult/add: (bsz, cin) fp32 or both null (no prologue); vbuf: (16, P, cin)
// bf16 and mbuf: (16, P, cout) fp32 scratch, P = bsz*(h/2)*(w/2);
// y: (bsz, h, w, cout) bf16. h, w even; cin % 8 == 0; cout % 8 == 0.
extern "C" int mdt_winograd_conv3x3(const void* x, const void* u,
                                    const void* bias, const void* mult,
                                    const void* add, void* vbuf, void* mbuf,
                                    void* y, int bsz, int h, int w, int cin,
                                    int cout, void* stream) {
  if (h % 2 || w % 2 || cin % 8 || cout % 8) return (int)cudaErrorInvalidValue;
  if ((mult == nullptr) != (add == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * (h / 2) * (w / 2);
  const int threads = 256;
  wino_input_kernel<<<(unsigned)((p_total * cin + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mult),
      static_cast<const float*>(add), static_cast<__nv_bfloat16*>(vbuf), bsz, h, w, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_and_output(vbuf, u, bias, mbuf, y, bsz, h, w, cin, cout, s);
}

// tiles: (bsz, n_tiles, bh + 2, w + 4, cin) bf16, the zero-padded (and, for
// a GN conv, already normalised) input gathered into overlapping row
// windows; u, bias, vbuf, mbuf as above with P = bsz*n_tiles*(bh/2)*(w/2);
// y: (bsz, n_tiles * bh, w, cout) bf16. bh, w even; cin % 8 == 0;
// cout % 8 == 0.
extern "C" int mdt_winograd_conv3x3_gathered(const void* tiles, const void* u,
                                             const void* bias, void* vbuf,
                                             void* mbuf, void* y, int bsz,
                                             int n_tiles, int bh, int w, int cin,
                                             int cout, void* stream) {
  if (bh % 2 || w % 2 || cin % 8 || cout % 8 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * n_tiles * (bh / 2) * (w / 2);
  const int threads = 256;
  wino_gathered_input_kernel<<<(unsigned)((p_total * cin + threads - 1) / threads),
                               threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(tiles), static_cast<__nv_bfloat16*>(vbuf),
      p_total, bh, w, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_and_output(vbuf, u, bias, mbuf, y, bsz, n_tiles * bh, w, cin,
                              cout, s);
}
