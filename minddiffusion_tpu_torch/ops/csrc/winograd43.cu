// Winograd F(4x4, 3x3) convolution for Hopper (sm_90a): a 3x3 stride-1
// same-pad conv on NHWC bf16, H and W multiples of 4 (K8).
//
// mdt_winograd43_conv3x3 replaces benchmarks/research/winograd43.py
// `_wino43_kernel_dma` / `_wino43_compute` (pallas_call in
// `conv3x3_winograd43`, :203). Math, as on the TPU: for every 4x4 output
// tile, the 6x6 input patch d (rows 4ty-1 .. 4ty+4, zero outside the image)
// is transformed V = B^T d B in fp32 (columns first, then rows) and rounded
// to bf16; 36 GEMMs M[a][b] = V[a][b] U[6a+b] with U = G k G^T (36, C_in,
// C_out) bf16 accumulate in fp32; the tile is Y = A^T M A + bias (rows
// first, then columns) in fp32, stored as bf16.
//
//   B^T = [[4,0,-5,0,1,0], [0,-4,-4,1,1,0], [0,4,-4,-1,1,0],
//          [0,-2,-1,2,1,0], [0,2,-1,-2,1,0], [0,4,0,-5,0,1]]
//   A^T = [[1,1,1,1,1,0], [0,1,-1,2,-2,0], [0,1,1,4,4,0], [0,1,-1,8,-8,1]]
//
// The TPU kernel merged groups of four columns into the lane axis on the
// host and fetched (bh+4)-row halo windows with double-buffered DMAs, so
// that V and M never left VMEM. This first Hopper version runs K2's three
// launches (csrc/winograd.cu): input transform -> the 36 batched GEMMs of
// mma.cuh -> output transform, with V (bf16, 36 * P * C_in) and M (fp32,
// 36 * P * C_out) in device memory, P = B * H/4 * W/4 tiles.
//
// What bounds it on the H100: the GEMMs do 2 * 36 * P * C_in * C_out flops,
// 4x fewer than the direct conv; at the VAE shapes (C 128-512, 128^2-512^2,
// batch 8) that is 20-155 GFLOP against ~0.3-1.1 GB of activations in and
// out, so the wide levels are compute-bound and 512^2 x 128 is byte-bound.
// The V and M round trips (2.25x the input and 4.5x the output in bytes,
// each written and read once) are this version's cost above that bound.
#include "mma.cuh"

namespace {

// One thread per (tile, input channel). vbuf: (36, P, cin).
__global__ void wino43_input_kernel(const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ vbuf, int bsz, int h,
                                    int w, int cin) {
  const int th = h / 4, tw = w / 4;
  const long long p_total = (long long)bsz * th * tw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_total * cin) return;
  const int ch = (int)(idx % cin);
  const long long p = idx / cin;
  const int tx = (int)(p % tw);
  const int ty = (int)((p / tw) % th);
  const int b = (int)(p / ((long long)tw * th));

  float d[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int yy = 4 * ty - 1 + i;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int xx = 4 * tx - 1 + j;
      d[i][j] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                    ? __bfloat162float(x[(((size_t)b * h + yy) * w + xx) * cin + ch])
                    : 0.f;
    }
  }
  // B^T along the columns of each row: c[i][k]
  float c[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float* g = d[i];
    c[i][0] = 4.f * g[0] - 5.f * g[2] + g[4];
    c[i][1] = -4.f * g[1] - 4.f * g[2] + g[3] + g[4];
    c[i][2] = 4.f * g[1] - 4.f * g[2] - g[3] + g[4];
    c[i][3] = -2.f * g[1] - g[2] + 2.f * g[3] + g[4];
    c[i][4] = 2.f * g[1] - g[2] - 2.f * g[3] + g[4];
    c[i][5] = 4.f * g[1] - 5.f * g[3] + g[5];
  }
  const size_t plane = (size_t)p_total * cin;
  __nv_bfloat16* out = vbuf + (size_t)p * cin + ch;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // B^T along the rows of column k: V[a][k]
    const float v[6] = {
        4.f * c[0][k] - 5.f * c[2][k] + c[4][k],
        -4.f * c[1][k] - 4.f * c[2][k] + c[3][k] + c[4][k],
        4.f * c[1][k] - 4.f * c[2][k] - c[3][k] + c[4][k],
        -2.f * c[1][k] - c[2][k] + 2.f * c[3][k] + c[4][k],
        2.f * c[1][k] - c[2][k] - 2.f * c[3][k] + c[4][k],
        4.f * c[1][k] - 5.f * c[3][k] + c[5][k]};
#pragma unroll
    for (int a = 0; a < 6; ++a) out[(a * 6 + k) * plane] = __float2bfloat16(v[a]);
  }
}

// One thread per (tile, output channel): Y = A^T M A + bias -> 4x4 outputs.
__global__ void wino43_output_kernel(const float* __restrict__ mbuf,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ y, int bsz, int h, int w,
                                     int cout) {
  const int th = h / 4, tw = w / 4;
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
  float m[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int k = 0; k < 6; ++k) m[a][k] = src[(a * 6 + k) * plane];
  const float bs = bias[co];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // A^T along the rows: p[k] = sum_a A^T[i][a] m[a][k]
    float pr[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (i == 0) pr[k] = m[0][k] + m[1][k] + m[2][k] + m[3][k] + m[4][k];
      else if (i == 1) pr[k] = m[1][k] - m[2][k] + 2.f * m[3][k] - 2.f * m[4][k];
      else if (i == 2) pr[k] = m[1][k] + m[2][k] + 4.f * m[3][k] + 4.f * m[4][k];
      else pr[k] = m[1][k] - m[2][k] + 8.f * m[3][k] - 8.f * m[4][k] + m[5][k];
    }
    // A^T along the columns
    const float o[4] = {pr[0] + pr[1] + pr[2] + pr[3] + pr[4] + bs,
                        pr[1] - pr[2] + 2.f * pr[3] - 2.f * pr[4] + bs,
                        pr[1] + pr[2] + 4.f * pr[3] + 4.f * pr[4] + bs,
                        pr[1] - pr[2] + 8.f * pr[3] - 8.f * pr[4] + pr[5] + bs};
    __nv_bfloat16* dst = y + (((size_t)b * h + 4 * ty + i) * w + 4 * tx) * cout + co;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(size_t)j * cout] = __float2bfloat16(o[j]);
  }
}

}  // namespace

// x: (bsz, h, w, cin) bf16; u: (36, cin, cout) bf16; bias: (cout,) fp32;
// vbuf: (36, P, cin) bf16 and mbuf: (36, P, cout) fp32 scratch, P =
// bsz*(h/4)*(w/4); y: (bsz, h, w, cout) bf16. h, w % 4 == 0; cin, cout % 8 == 0.
extern "C" int mdt_winograd43_conv3x3(const void* x, const void* u, const void* bias,
                                      void* vbuf, void* mbuf, void* y, int bsz, int h,
                                      int w, int cin, int cout, void* stream) {
  if (h % 4 || w % 4 || cin % 8 || cout % 8 || bsz < 1 || h < 4 || w < 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * (h / 4) * (w / 4);
  const int threads = 256;
  wino43_input_kernel<<<(unsigned)((p_total * cin + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(vbuf), bsz, h, w,
      cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_batched_gemm(vbuf, u, mbuf, p_total, cout, cin, 36, s);
  if (err != cudaSuccess) return (int)err;
  wino43_output_kernel<<<(unsigned)((p_total * cout + threads - 1) / threads), threads, 0,
                         s>>>(static_cast<const float*>(mbuf),
                              static_cast<const float*>(bias),
                              static_cast<__nv_bfloat16*>(y), bsz, h, w, cout);
  return (int)cudaGetLastError();
}
