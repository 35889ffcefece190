// 3x3 stride-1 same-pad convolution as an implicit GEMM for Hopper (sm_90a):
// NHWC bf16 activations, bf16 weights, fp32 accumulation (K7).
//
// One entry point, mdt_conv3x3_gemm, over one kernel template. It replaces
// both TPU variants of benchmarks/research/conv3x3.py: `conv3x3_pallas`
// (`_kernel`, pallas_call :90), y = conv(x, k) + bias in bf16, is its case
// with no prologue, no residual and bf16 out; `conv3x3_gemm`
// (`_gemm_kernel`, pallas_call :286) is y = conv(P(x), k) + bias
// [+ residual], bf16 or fp32 out, where
//    the optional prologue P(x) = [silu](x * scale[b, c] + shift[b, c]) runs
//    in fp32 and rounds to bf16 before the product. The zero padding stays
//    zero through it (silu(0 * a + b) != 0): pixels outside the image are
//    written as zeros, never transformed. Bias and residual add in fp32.
//
// What the TPU kernels worked around, and what this one does instead. v1
// gathered overlapping (bh+2)-row tiles on the host, because BlockSpecs cut
// only disjoint blocks; v2 stacked the three dy taps along the lane axis so
// the MXU saw no sublane relayout and resolved dx after the product with
// shifted fp32 adds. Neither constraint holds on Hopper: a block loads its
// own halo tile ((8+2) rows x (16+2) columns x 32 channels) into shared
// memory, zeros outside the image, and each of the nine shifted windows is
// an address offset into that tile. The prologue runs once per halo element
// as it lands in shared memory.
//
// Block: 128 output pixels (8 rows x 16 columns of one image) x 128 output
// channels; 8 warps of 64 (4 pixel rows) x 32, mma.sync m16n8k16. Per
// 32-channel step of C_in it loads the halo tile and the nine 128 x 32
// weight slices (the wrapper lays the weights out as (9, C_out, C_in)),
// with cp.async where no prologue transforms the data, then issues
// 9 taps x 2 k16 x 16 mma per warp. Single stage, no pipelining yet.
//
// What bounds it on the H100: 2 * B*H*W * 9 * C_in * C_out flops against
// 2 * B*H*W * (C_in + C_out) bytes. At the UNet and VAE shapes (C 128-1280)
// that is 15-620 GFLOP against at most 1.1 GB: compute-bound on the tensor
// cores everywhere, the 512^2 x 128 VAE level by a factor of 2.
#include "mma.cuh"

namespace {

constexpr int TH = 8, TW = 16;            // output rows x columns of a block
constexpr int HR = TH + 2, HC = TW + 2;   // its halo tile
constexpr int BN = 128, BK = 32, KS = BK + 8;   // KS: shared row stride (bf16)
constexpr int THREADS = 256;
constexpr int HALO_ELEMS = HR * HC * KS;
constexpr int W_ELEMS = 9 * BN * KS;
constexpr int SMEM_BYTES = (HALO_ELEMS + W_ELEMS) * 2;

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// PROLOGUE: scale/shift (both or neither) and/or silu_on transform the
// halo. residual may be null. OutT: __nv_bfloat16 or float.
template <bool PROLOGUE, typename OutT>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, int silu_on,
    const __nv_bfloat16* __restrict__ residual, OutT* __restrict__ y, int h, int w,
    int cin, int cout) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* hs = smem;                 // [HR * HC][KS]: the halo tile
  __nv_bfloat16* ws = smem + HALO_ELEMS;    // [9][BN][KS]: weights, k innermost
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  long long mt = blockIdx.x;
  const int x0 = (int)(mt % tiles_x) * TW;
  mt /= tiles_x;
  const int y0 = (int)(mt % tiles_y) * TH;
  const int b = (int)(mt / tiles_y);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = (warp >> 2) * 4;   // the warp's first output row in the block
  const int wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const __nv_bfloat16* xb = x + (size_t)b * h * w * cin;
  for (int c0 = 0; c0 < cin; c0 += BK) {
    // the halo tile: HR * HC pixels x 4 vectors of 8 channels
    for (int i = tid; i < HR * HC * (BK / 8); i += THREADS) {
      const int pix = i >> 2, cv = (i & 3) * 8;
      const int yy = y0 - 1 + pix / HC, xx = x0 - 1 + pix % HC;
      const bool valid = yy >= 0 && yy < h && xx >= 0 && xx < w && c0 + cv < cin;
      const __nv_bfloat16* src = valid ? xb + ((size_t)yy * w + xx) * cin + c0 + cv : x;
      __nv_bfloat16* dst = hs + pix * KS + cv;
      if constexpr (!PROLOGUE) {
        cp_async16(dst, src, valid);
      } else {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (valid) {
          val = *reinterpret_cast<const uint4*>(src);
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
          const size_t sc = (size_t)b * cin + c0 + cv;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = __bfloat162float(e[j]);
            if (scale != nullptr) v = v * scale[sc + j] + shift[sc + j];
            if (silu_on) v = silu(v);
            e[j] = __float2bfloat16(v);
          }
        }
        *reinterpret_cast<uint4*>(dst) = val;
      }
    }
    // the nine weight slices: 9 x BN rows x 4 vectors of 8 input channels
    for (int i = tid; i < 9 * BN * (BK / 8); i += THREADS) {
      const int tap = i / (BN * 4), r = i % (BN * 4), n = r >> 2, cv = (r & 3) * 8;
      const bool valid = n0 + n < cout && c0 + cv < cin;
      const __nv_bfloat16* src =
          valid ? wt + ((size_t)tap * cout + n0 + n) * cin + c0 + cv : wt;
      cp_async16(ws + (tap * BN + n) * KS + cv, src, valid);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* wtap = ws + tap * BN * KS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          // rows g and g + 8 of the m16 tile are pixels g + dx and g + 8 + dx
          // of halo row wrow + mi + dy
          const __nv_bfloat16* ap = hs + ((wrow + mi + dy) * HC + g + dx) * KS + kk + 2 * t;
          a[mi][0] = ld32(ap);
          a[mi][1] = ld32(ap + 8 * KS);
          a[mi][2] = ld32(ap + 8);
          a[mi][3] = ld32(ap + 8 * KS + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* bp = wtap + (wn + ni * 8 + g) * KS + kk + 2 * t;
          const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int yy = y0 + wrow + mi;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int co = n0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = x0 + g + 8 * half;
        if (yy >= h || xx >= w || co >= cout) continue;
        const size_t o = (((size_t)b * h + yy) * w + xx) * cout + co;
        float v0 = acc[mi][ni][2 * half] + bias[co];
        float v1 = acc[mi][ni][2 * half + 1] + bias[co + 1];
        if (residual != nullptr) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(residual + o));
          v0 += r.x;
          v1 += r.y;
        }
        store2(y + o, v0, v1);
      }
    }
  }
}

template <bool PROLOGUE, typename OutT>
cudaError_t launch(const void* x, const void* wt, const void* bias, const void* scale,
                   const void* shift, int silu_on, const void* residual, void* y,
                   int bsz, int h, int w, int cin, int cout, cudaStream_t s) {
  auto kern = conv3x3_kernel<PROLOGUE, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long m_tiles =
      (long long)bsz * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const dim3 grid((unsigned)m_tiles, (cout + BN - 1) / BN);
  kern<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), silu_on,
      static_cast<const __nv_bfloat16*>(residual), static_cast<OutT*>(y), h, w, cin,
      cout);
  return cudaGetLastError();
}

bool bad_shape(int bsz, int h, int w, int cin, int cout) {
  return bsz < 1 || h < 1 || w < 1 || cin % 8 || cout % 8 || cin < 8 || cout < 8;
}

}  // namespace

// x: (bsz, h, w, cin) bf16; wt: (9, cout, cin) bf16, tap = 3 * dy + dx;
// bias: (cout,) fp32; scale/shift (bsz, cin) fp32, both or neither;
// silu_on 0/1; residual (bsz, h, w, cout) bf16 or null; y (bsz, h, w, cout)
// fp32 when out_f32, else bf16. cin, cout % 8 == 0.
extern "C" int mdt_conv3x3_gemm(const void* x, const void* wt, const void* bias,
                                const void* scale, const void* shift, int silu_on,
                                const void* residual, void* y, int out_f32, int bsz,
                                int h, int w, int cin, int cout, void* stream) {
  if (bad_shape(bsz, h, w, cin, cout)) return (int)cudaErrorInvalidValue;
  if ((scale == nullptr) != (shift == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pro = scale != nullptr || silu_on;
  if (pro && out_f32)
    return (int)launch<true, float>(x, wt, bias, scale, shift, silu_on, residual, y, bsz,
                                    h, w, cin, cout, s);
  if (pro)
    return (int)launch<true, __nv_bfloat16>(x, wt, bias, scale, shift, silu_on, residual,
                                            y, bsz, h, w, cin, cout, s);
  if (out_f32)
    return (int)launch<false, float>(x, wt, bias, nullptr, nullptr, 0, residual, y, bsz, h,
                                     w, cin, cout, s);
  return (int)launch<false, __nv_bfloat16>(x, wt, bias, nullptr, nullptr, 0, residual, y,
                                           bsz, h, w, cin, cout, s);
}
