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
// doing the output transform) removes later. The GEMM is the plain
// mma.sync m16n8k16 kernel of mma.cuh (shared with winograd43.cu).
#include "mma.cuh"

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
  cudaError_t err = launch_batched_gemm(vbuf, u, mbuf, p_total, cout, cin, 16, s);
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
