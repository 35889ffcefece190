// The fused sampler tail (K9): GroupNorm affine + SiLU -> 3x3 conv to the
// eps channels -> one DDIM (eta 0) step, written straight to x_{t-1}.
//
// Replaces benchmarks/research/glide_tail.py `_tail_call` (its Pallas
// `_tail_kernel`, reached by `ddim_tail_step` and `sd_cfg_tail_step`):
//   mode 0 ("glide", the GLIDE super-res stage): x_{t-1} = sap * px0 +
//     s1map * (sr * x - px0) / srm1, px0 = clip(sr * x - srm1 * eps, -1, 1),
//     coefs = [sr, srm1, sap, s1map];
//   mode 1 ("sd"): the conv runs over the CFG-folded batch [uncond; cond]
//     (2 bx), g = u + s (c - u), x_{t-1} = cA * x + cB * g,
//     coefs = [s, cA, cB, 0].
// h (B, H, W, C) bf16 NHWC, mult / add (B, C) fp32 (silu(h * mult + add),
// rounded to bf16, is the conv input), w (3, 3, C, CO) fp32 holding bf16
// values, bias (CO) fp32, x / out (bx, H, W, CO) fp32, coefs (4) fp32 on the
// device. SAME padding: out-of-image taps contribute exactly 0 after the
// affine.
//
// What bounds it on an H100: the bytes. At the SR shape (8, 256, 256, 192)
// h is 201 MB, read once, against 5.4 GFLOP of conv (co 3), so HBM time
// (~0.06 ms at 3.35 TB/s) is the floor; the tensor cores have nothing to do
// at N = 3 and the products run on the fp32 units. Design (simple first):
// one block of 8 x 32 threads takes an 8-row x 32-column tile of one image
// and loops over 32-channel chunks; each chunk's (8+2) x (32+2) halo is
// read once from HBM (16-byte loads), normalized in fp32, rounded to bf16
// and kept in shared memory as fp32 with a padded channel stride (33, so
// the 32 pixels of a warp fall on 32 banks); all the conv weights sit in
// shared memory (9 C CO fp32, broadcast reads); each thread accumulates its
// pixel's CO outputs in fp32 over 9 taps x C and applies the sampler step
// in its epilogue. The halo costs 1.33x the tile's bytes from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32, THREADS = TH * TW;
constexpr int CHUNK = 32, CPAD = CHUNK + 1;
constexpr int HALO_W = TW + 2, HALO_PIX = (TH + 2) * HALO_W;

template <int CO, int MODE>
__global__ void __launch_bounds__(THREADS) tail_kernel(
    const __nv_bfloat16* __restrict__ h, const float* __restrict__ x,
    const float* __restrict__ mult, const float* __restrict__ add,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ coefs, float* __restrict__ out,
    int bx, int H, int W, int C) {
  extern __shared__ float smem[];
  float* ws = smem;                  // 9 * C * CO conv weights
  float* xs = smem + 9 * C * CO;     // HALO_PIX * CPAD normalized halo tile
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  for (int i = tid; i < 9 * C * CO; i += THREADS) ws[i] = w[i];

  constexpr int HALVES = MODE == 1 ? 2 : 1;
  float acc[HALVES][CO];
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[hf][o] = bias[o];

#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf) {
    const int hb = b + hf * bx;     // MODE 1: uncond row b, cond row b + bx
    const __nv_bfloat16* hbase = h + (size_t)hb * H * W * C;
    const float* mrow = mult + (size_t)hb * C;
    const float* arow = add + (size_t)hb * C;
    for (int c0 = 0; c0 < C; c0 += CHUNK) {
      const int cc = min(CHUNK, C - c0), vecs = cc / 8;
      __syncthreads();  // the previous chunk's reads of xs are done
      for (int i = tid; i < HALO_PIX * vecs; i += THREADS) {
        const int p = i / vecs, v = i % vecs;
        const int yy = y0 + p / HALO_W - 1, xx = x0 + p % HALO_W - 1;
        float* dst = xs + p * CPAD + v * 8;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          const int c = c0 + v * 8;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              hbase + ((size_t)yy * W + xx) * C + c);
          const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float y = __bfloat162float(hv[j]) * mrow[c + j] + arow[c + j];
            dst[j] = __bfloat162float(__float2bfloat16(y / (1.f + __expf(-y))));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j] = 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* xr = xs + ((ty + dy) * HALO_W + tx + dx) * CPAD;
          const float* wr = ws + ((dy * 3 + dx) * C + c0) * CO;
#pragma unroll 8
          for (int c = 0; c < cc; ++c) {
            const float a = xr[c];
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[hf][o] = fmaf(a, wr[c * CO + o], acc[hf][o]);
          }
        }
    }
  }

  const int yy = y0 + ty, xx = x0 + tx;
  if (yy >= H || xx >= W) return;
  const size_t pix = ((size_t)b * H + yy) * W + xx;
  const float* xp = x + pix * CO;
  float* op = out + pix * CO;
  if constexpr (MODE == 0) {
    const float sr = coefs[0], srm1 = coefs[1], sap = coefs[2], s1map = coefs[3];
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const float xsc = sr * xp[o];
      const float px0 = fminf(fmaxf(xsc - srm1 * acc[0][o], -1.f), 1.f);
      op[o] = sap * px0 + s1map * ((xsc - px0) / srm1);
    }
  } else {
    const float s = coefs[0], cx = coefs[1], ce = coefs[2];
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const float u = acc[0][o];
      op[o] = cx * xp[o] + ce * (u + s * (acc[HALVES - 1][o] - u));
    }
  }
}

template <int CO, int MODE>
cudaError_t launch(const void* h, const void* x, const void* mult, const void* add,
                   const void* w, const void* bias, const void* coefs, void* out,
                   int bx, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (9 * (size_t)C * CO + HALO_PIX * CPAD);
  auto kern = tail_kernel<CO, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, bx);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(x),
      static_cast<const float*>(mult), static_cast<const float*>(add),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(coefs), static_cast<float*>(out), bx, H, W, C);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int co, const void* h, const void* x, const void* mult,
                     const void* add, const void* w, const void* bias,
                     const void* coefs, void* out, int bx, int H, int W, int C,
                     cudaStream_t s) {
  switch (co) {
    case 3: return launch<3, MODE>(h, x, mult, add, w, bias, coefs, out, bx, H, W, C, s);
    case 4: return launch<4, MODE>(h, x, mult, add, w, bias, coefs, out, bx, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// h: (bh, H, W, C) bf16; mode 0: bx = bh, mode 1: bh = 2 bx. x / out:
// (bx, H, W, co) fp32; mult / add (bh, C), w (3, 3, C, co), bias (co),
// coefs (4) fp32. Requires C % 8 == 0, co in {3, 4}, 9 C co + 11,220 floats
// of shared memory (C co <= 4,900).
extern "C" int mdt_glide_tail(const void* h, const void* x, const void* mult,
                              const void* add, const void* w, const void* bias,
                              const void* coefs, void* out, int bh, int H, int W,
                              int C, int co, int mode, void* stream) {
  if (C % 8 != 0 || H < 1 || W < 1 || (mode == 1 && bh % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return (int)dispatch<0>(co, h, x, mult, add, w, bias, coefs, out, bh, H, W, C, s);
  if (mode == 1)
    return (int)dispatch<1>(co, h, x, mult, add, w, bias, coefs, out, bh / 2, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
