// The fused sampler tail (K9) on Hopper (sm_90a): GroupNorm affine + SiLU
// -> 3x3 conv to the eps channels -> one DDIM (eta 0) step, written straight
// to x_{t-1}.
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
// rounded to bf16, is the conv input), w (3, 3, C, CO) fp32, bf16 or fp16
// (rounded to bf16 here), bias (CO) in the same types (used as it is, in
// fp32), x / out (bx, H, W, CO) fp32, coefs (4) fp32 on the device. SAME
// padding: out-of-image taps contribute exactly 0 after the affine.
//
// What bounds it on an H100: the bytes. At the GLIDE SR shape (8, 256, 256,
// 192) h is 201 MB, read once, against 5.4 GFLOP of conv (co 3): 0.060 ms
// at 3.35 TB/s. The element work is the next limit: one affine and one SiLU
// for each of h's 100.7 M values (1.33x that with the halo), and the MUFU
// units do 16 ops a clock per SM (4.2e12/s): one MUFU op a value is ~0.03
// ms, two (exp and a reciprocal) would be ~0.06. Design:
//  * Tiles: a CTA's output tile is 32 x 8 pixels of one image, whose 34 x
//    10 halo box (64 channels a box, zero-filled outside the image and past
//    C) TMA brings into a ring of 2-4 stages. CTAs are persistent (one an
//    SM, walking tiles w fastest), so the weights' prologue runs once a CTA
//    and the producer warp loads the next tile's boxes under this tile's
//    epilogue. In mode 1 a tile reads the uncond row b, then the cond row b
//    + bx, so both CFG halves meet in one CTA.
//  * The element work in place: the three consumer warpgroups apply the
//    affine and SiLU to the TMA-landed box where it lies (16 bytes a thread
//    a step, each thread always on the same 8 channels of a box), write the
//    bf16 result back over it, and zero the halo pixels outside the image
//    (silu(0 * mult + add) is not 0: the padding is zero after the affine,
//    so a zero-filled box is not enough).
//  * Products on the tensor cores, taps in the rows: Z^T = W^T A^T with A
//    the normalized box (340 pixels, K-major as TMA laid it down) and W^T
//    (9 CO tap-channel rows, K-major, 128-byte swizzled), one wgmma
//    m64n120k16 per k16 slice per warpgroup (pixels 120 wg ..), issued
//    after a barrier and left running under the next box's element work.
//    The first design had the pixels as M (A from registers, the affine
//    applied on the way into the fragment, N = 32 / 40 taps): 24 small
//    products a box took more time than the bytes (0.066 of 0.156 ms
//    device at the SR shape, scripts/tail_ablate.py), and a warp waited on
//    each; here a box is 12 products of 120 columns. The cost: the box is
//    written back once (shared memory), and the 64-row M carries 27 or 36
//    useful rows.
//  * SiLU with one MUFU op a value: silu(y) = hy (1 + tanh(hy)), hy = y / 2,
//    tanh.approx.f32 (~2^-11 relative, below the bf16 rounding that
//    follows).
//  * Weights: rounded to bf16 and laid out in the CTA's prologue from the
//    (3, 3, C, CO) tensor, so the wrapper launches nothing but this kernel.
//  * Mode 1 keeps one accumulator: after the uncond half it is scaled by
//    (1 - s) / s, the cond half adds to it, and Z = s acc = (1 - s) Zu + s Zc
//    = Zu + s (Zc - Zu) (s = 0: the uncond half alone).
//  * Shift-add and step: Z^T goes to shared memory (27 or 36 rows x the
//    box's pixels), and each of 256 threads sums its output pixel's 9 taps,
//    adds the bias and applies the sampler step.
//  * Where the time goes (device ms on an H100 SXM, 700 W;
//    scripts/tail_ablate.py), the SR shape / the SD shape: 0.113 / 0.030
//    in all (57% / 43% of the byte bound; the first port took 0.579 /
//    0.238); without the element work at all 0.080 / 0.017 (the box
//    stream: ~2.5 TB/s from HBM with the halo from L2, one tile a CTA at
//    the SD shape, whose 128 tiles leave 4 SMs idle), without its
//    arithmetic 0.082 / 0.021, without the tanh 0.099 / 0.026, tanh as exp
//    and a reciprocal 0.191 / 0.045, without the products 0.104 / 0.027,
//    without the loads 0.101 / 0.024, without the weights' prologue 0.108
//    / 0.028. The element work (MUFU-bound: 16 tanh a clock an SM) and the
//    box stream overlap only in part. Tried: the SiLU as silu2 on 32-bit
//    pairs (the compiler serialized each tanh and its use): 0.153; four
//    consumer warpgroups of 88 pixels: 0.120 / 0.031; eight steps' loads in
//    flight: 0.135 / 0.032.
// The C entry takes the plan (ops/glide_tail.py `tail_plan`: tile, stages,
// CTAs and shared-memory bytes) and refuses one whose numbers are not this
// file's.
#include <cuda_fp16.h>

#include "hopper.cuh"  // mbarriers, TMA and its tensor maps, wgmma

namespace {

constexpr int SMEM_MAX = 232448;          // a block's shared memory on the H100
constexpr int SLACK = 1024;               // the 1024-byte alignment of the ring and W
constexpr int TW = 32, TH = 8;            // output pixels of a tile
constexpr int BW = TW + 2, BH = TH + 2;   // its halo box
constexpr int BOX_PIX = BW * BH;          // 340 pixels: the products' N
constexpr int STAGE_BYTES = BOX_PIX * 128;            // 64 channels a pixel
constexpr int STAGE = (STAGE_BYTES + 1023) / 1024 * 1024;
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;         // the ring's, as the plan says
constexpr int CONSUMERS = 3;              // warpgroups
constexpr int NT = 128 * CONSUMERS;       // consumer threads
constexpr int THREADS = NT + 32;          // and the producer warp
constexpr int NPIX = 120;                 // pixels (wgmma N) a consumer warpgroup
constexpr int PS = BOX_PIX + 4;           // Z^T's row stride in floats
constexpr int STEPS = BOX_PIX * 8 / NT;   // 16-byte steps every thread takes a box
constexpr int TAIL = BOX_PIX * 8 % NT;    // and the threads that take one more
static_assert(CONSUMERS * NPIX >= BOX_PIX, "the warpgroups cover the box");
static_assert(NPIX * 128 % 1024 == 0, "a warpgroup's pixels start on a swizzle period");
static_assert(NT % 8 == 0, "a thread stays on one 8-channel group of a box");
static_assert(TAIL % 32 == 0, "the extra step is whole warps'");
static_assert(TW * TH <= NT, "one thread an output pixel");

// W^T's rows a 64-channel chunk: the 9 CO tap-channel rows, padded to 8.
// The products read 64 rows from each chunk's start; rows past these are
// the next chunk's (or Z^T's) and land in Z^T rows nobody reads.
__host__ __device__ constexpr int w_rows(int co) { return co == 3 ? 32 : 40; }

// Shared-memory bytes of a launch: the ring, W^T (chunks x its rows x 128
// bytes), Z^T (9 CO rows x PS floats), the barriers.
__host__ __device__ constexpr int smem_bytes(int co, int chunks, int stages) {
  return SLACK + stages * STAGE + chunks * w_rows(co) * 128 + 9 * co * PS * 4 + 16 * stages;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float tanh_fast(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// silu(h * m + a) of the eight bf16 values of `v` (channels 2 e, 2 e + 1 in
// word e), rounded to bf16 and packed, with hm[e] = {m0, m1} / 2 and ha[e]
// = {a0, a1} / 2; zeros where !valid. Each stage runs over all eight
// values before the next, so the eight MUFU ops issue back to back.
__device__ __forceinline__ uint4 silu8(uint4 v, const float2 (&hm)[4], const float2 (&ha)[4],
                                       bool valid) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  float hy[8], th[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hy[2 * e] = fmaf(__uint_as_float(in[e] << 16), hm[e].x, ha[e].x);
    hy[2 * e + 1] = fmaf(__uint_as_float(in[e] & 0xffff0000u), hm[e].y, ha[e].y);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) th[k] = tanh_fast(hy[k]);
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    __nv_bfloat162 r = __floats2bfloat162_rn(fmaf(hy[2 * e], th[2 * e], hy[2 * e]),
                                             fmaf(hy[2 * e + 1], th[2 * e + 1], hy[2 * e + 1]));
    o[e] = valid ? *reinterpret_cast<uint32_t*>(&r) : 0u;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Element i of a weight or bias array of type dt (0 fp32, 1 bf16, 2 fp16) in fp32.
__device__ __forceinline__ float load_as_float(const void* p, int dt, size_t i) {
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W) {
  const int tx = (W + TW - 1) / TW, ty = (H + TH - 1) / TH;
  return {t / (tx * ty), t % (tx * ty) / tx * TH, t % tx * TW};
}

// tm_h: h as (C, W, H, B) with 64 x BW x BH x 1 boxes. Grid: persistent
// CTAs over ceil(W / TW) ceil(H / TH) bx tiles.
template <int CO, int MODE>
__global__ void __launch_bounds__(THREADS, 1) tail_kernel(
    const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ x,
    const float* __restrict__ mult, const float* __restrict__ add, const void* __restrict__ w,
    const void* __restrict__ bias, int wdt, int bdt, const float* __restrict__ coefs,
    float* __restrict__ out, int bx, int H, int W, int C, int stages) {
  constexpr int HALVES = MODE == 1 ? 2 : 1, WR = w_rows(CO);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int chunks = (C + 63) / 64;
  const uint32_t wsm = ring + stages * STAGE;
  const uint32_t zt = wsm + chunks * WR * 128;
  const uint32_t full = zt + 9 * CO * PS * 4, empty = full + 8 * stages;
  float* zs = reinterpret_cast<float*>(smem_raw + (zt - smem_u32(smem_raw)));
  const int tiles = (W + TW - 1) / TW * ((H + TH - 1) / TH) * bx;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);   // each consumer warpgroup, once its products are done
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform by construction, so the compiler sees each role whole
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {   // the producer warp: its loads start under the consumers' prologue
    if (tid == NT) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, H, W);
        for (int hf = 0; hf < HALVES; ++hf)
          for (int q = 0; q < chunks; ++q) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(full + 8 * stage, STAGE_BYTES);   // whole boxes: TMA counts the zero fill
            tma_load_4d(ring + stage * STAGE, &tm_h, full + 8 * stage, 64 * q, tl.x0 - 1,
                        tl.y0 - 1, tl.b + hf * bx);
            advance(stage, phase, stages);
          }
      }
    }
    return;
  }

  const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
  // W^T, chunk q: row m = tap * CO + o x 64 channels, 128-byte swizzled:
  // w read in its own order (coalesced, four values a load where aligned,
  // all of a thread's loads in flight), each value rounded to bf16 and
  // scattered to its row; rows 9 CO .. WR and channels past C are zeros.
  {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < chunks * (WR - 9 * CO) * 8; i += NT)   // the padding rows, whole
      sts128(wsm + i / ((WR - 9 * CO) * 8) * WR * 128 + (9 * CO + i / 8 % (WR - 9 * CO)) * 128 +
                 i % 8 * 16,
             zero);
    if (C % 64)   // the last chunk's 16-byte groups past C
      for (int i = tid; i < 9 * CO * 8; i += NT) {
        const int m = i / 8, k = i % 8;
        if (8 * k >= C % 64) sts128(wsm + (chunks - 1) * WR * 128 + swizzle128(m, 8 * k), zero);
      }
    const int n = 9 * C * CO;
    const bool vec = wdt == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    constexpr int WB = 8;   // groups of four values a thread in flight
    for (int g0 = tid; g0 < n / 4; g0 += NT * WB) {
      float v[WB][4];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int g = g0 + NT * u;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
        if (g < n / 4) {
          if (vec) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(w) + g);
            v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[u][e] = load_as_float(w, wdt, 4 * (size_t)g + e);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int g = g0 + NT * u;
        if (g >= n / 4) break;
        // value 4 g is (tap C + c) CO + o; the next ones step o, then c, then tap
        const int tc = 4 * g / CO;
        int o = 4 * g % CO, c = tc % C, tap = tc / C;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat16 b = __float2bfloat16_rn(v[u][e]);
          asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(wsm + c / 64 * WR * 128 +
                                                        swizzle128(tap * CO + o, c % 64)),
                       "h"(*reinterpret_cast<unsigned short*>(&b))
                       : "memory");
          if (++o == CO) {
            o = 0;
            if (++c == C) c = 0, ++tap;
          }
        }
      }
    }
  }
  fence_proxy_async();   // W^T's stores before wgmma reads them
  named_barrier_sync(1, NT);

  // The element work: thread tid takes the 16-byte chunk j = tid % 8 (its
  // channels 8 j .. 8 j + 7 of each box) of pixels tid / 8 + (NT / 8) i.
  const int j = tid % 8;
  const bool extra = tid < TAIL;   // a step past STEPS (pixels < BOX_PIX)
  float cf[4], bv[CO];             // the step's coefficients, the bias
#pragma unroll
  for (int k = 0; k < 4; ++k) cf[k] = coefs[k];
#pragma unroll
  for (int o = 0; o < CO; ++o) bv[o] = load_as_float(bias, bdt, o);
  const float s = MODE == 1 ? cf[0] : 0.f;
  float acc[NPIX / 2];
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, H, W);
    uint32_t valid = 0;   // bit i: pixel tid / 8 + (NT / 8) i is in the box and the image
#pragma unroll
    for (int i = 0; i <= STEPS; ++i) {
      const int p = tid / 8 + NT / 8 * i;
      const int yy = tl.y0 - 1 + p / BW, xx = tl.x0 - 1 + p % BW;
      if (p < BOX_PIX && yy >= 0 && yy < H && xx >= 0 && xx < W) valid |= 1u << i;
    }
    // this thread's output pixel's x, read now so the epilogue does not wait on it
    const int oy = tl.y0 + tid / TW, ox = tl.x0 + tid % TW;
    const bool writes = tid < TW * TH && oy < H && ox < W;
    const size_t pix = ((size_t)tl.b * H + oy) * W + ox;
    float xv[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) xv[o] = writes ? x[pix * CO + o] : 0.f;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      // the halved affine of this half's batch row at the thread's channels
      const float* mrow = mult + (size_t)(tl.b + hf * bx) * C;
      const float* arow = add + (size_t)(tl.b + hf * bx) * C;
      // mode 1, s == 0: g is the uncond half alone
      const bool issue = MODE == 0 || hf == 0 || s != 0.f;
#pragma unroll 1
      for (int q = 0; q < chunks; ++q) {
        const int c0 = 64 * q + 8 * j;
        float2 hm[4], ha[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = c0 + 2 * e < C;
          hm[e] = in ? make_float2(0.5f * mrow[c0 + 2 * e], 0.5f * mrow[c0 + 2 * e + 1])
                     : make_float2(0.f, 0.f);
          ha[e] = in ? make_float2(0.5f * arow[c0 + 2 * e], 0.5f * arow[c0 + 2 * e + 1])
                     : make_float2(0.f, 0.f);
        }
        mbar_wait(full + 8 * stage, phase);
        const uint32_t slot = ring + stage * STAGE;
        // in place, the loads of four 16-byte steps in flight
#pragma unroll
        for (int i0 = 0; i0 <= STEPS; i0 += 4) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u, p = tid / 8 + NT / 8 * i;
            if (i < STEPS || (i == STEPS && extra))
              v[u] = lds128(slot + p * 128 + ((j ^ (p & 7)) << 4));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u, p = tid / 8 + NT / 8 * i;
            if (i < STEPS || (i == STEPS && extra))
              sts128(slot + p * 128 + ((j ^ (p & 7)) << 4), silu8(v[u], hm, ha, valid >> i & 1u));
          }
        }
        fence_proxy_async();   // the box's stores before wgmma reads it
        named_barrier_sync(1, NT);
        // Z^T (+)= W^T A^T for this warpgroup's pixels: A K-major (16
        // channels = 32 bytes along the swizzled rows, 8-row groups 1024 B
        // apart), W^T K-major likewise
        fence_operand(acc);
        wgmma_fence();
        if (issue) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_m64n120k16(acc, smem_desc(wsm + q * WR * 128 + kk * 32, 16, 1024),
                                smem_desc(slot + wg * NPIX * 128 + kk * 32, 16, 1024),
                                (hf | q | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous box's products are done: its stage is free
        if (t128 == 0 && prev >= 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        advance(stage, phase, stages);
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (t128 == 0) mbar_arrive(empty + 8 * prev);
      prev = -1;
      if (MODE == 1 && hf == 0 && s != 0.f) {   // acc = Zu (1 - s) / s; the cond half adds Zc
        const float f = (1.f - s) / s;
#pragma unroll
        for (int r = 0; r < NPIX / 2; ++r) acc[r] *= f;
      }
    }

    // Z^T: accumulator r of m64nN is row 16 warp + lane / 4 (+ 8 for r % 4
    // >= 2), column 8 (r / 4) + 2 (lane % 4) + r % 2: tap-channel row m,
    // pixel 120 wg + column.
    const float zscale = MODE == 1 && s != 0.f ? s : 1.f;
#pragma unroll
    for (int r = 0; r < NPIX / 2; r += 2) {
      const int m = 16 * warp + lane / 4 + 8 * (r % 4 / 2);
      const int p = NPIX * wg + 8 * (r / 4) + 2 * (lane % 4);
      if (m < 9 * CO && p < BOX_PIX)   // p even, BOX_PIX even: p + 1 is in the box too
        *reinterpret_cast<float2*>(zs + m * PS + p) =
            make_float2(zscale * acc[r], zscale * acc[r + 1]);
    }
    named_barrier_sync(1, NT);

    // one output pixel a thread: eps = bias + the 9 taps' shifted Z, then the step
    if (writes) {
      const int ty = tid / TW, tx = tid % TW;
      float eps[CO];
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        float e = bv[o];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            e += zs[((dy * 3 + dx) * CO + o) * PS + (ty + dy) * BW + tx + dx];
        eps[o] = e;
      }
      float* op = out + pix * CO;
      if constexpr (MODE == 0) {
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float xsc = cf[0] * xv[o];
          const float px0 = fminf(fmaxf(xsc - cf[1] * eps[o], -1.f), 1.f);
          op[o] = cf[2] * px0 + cf[3] * ((xsc - px0) / cf[1]);
        }
      } else {
#pragma unroll
        for (int o = 0; o < CO; ++o) op[o] = cf[1] * xv[o] + cf[2] * eps[o];
      }
    }
  }
}

template <int CO, int MODE>
cudaError_t launch(const CUtensorMap& tm, const void* x, const void* mult, const void* add,
                   const void* w, const void* bias, int wdt, int bdt, const void* coefs,
                   void* out, int bx, int H, int W, int C, int stages, int ctas, int smem,
                   cudaStream_t stream) {
  auto kern = tail_kernel<CO, MODE>;
  // the shared-memory limit, raised once per device, instantiation and size
  static int raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || raised[dev] < smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = smem;
  }
  kern<<<ctas, THREADS, smem, stream>>>(
      tm, static_cast<const float*>(x), static_cast<const float*>(mult),
      static_cast<const float*>(add), w, bias, wdt, bdt, static_cast<const float*>(coefs),
      static_cast<float*>(out), bx, H, W, C, stages);
  return cudaGetLastError();
}

}  // namespace

// h: (bh, H, W, C) bf16, 16-byte aligned; mode 0: bx = bh, mode 1: bh =
// 2 bx. x / out: (bx, H, W, co) fp32; mult / add (bh, C) fp32; w (3, 3, C,
// co) and bias (co) of types wdt / bdt (0 fp32, 1 bf16, 2 fp16); coefs (4)
// fp32. C % 8 == 0, co in {3, 4}. The plan (ops/glide_tail.py `tail_plan`):
// tile_w x tile_h output pixels a tile, stages, ctas (persistent, at most
// one a tile), smem bytes.
extern "C" int mdt_glide_tail(const void* h, const void* x, const void* mult, const void* add,
                              const void* w, const void* bias, const void* coefs, void* out,
                              int bh, int H, int W, int C, int co, int mode, int wdt, int bdt,
                              int tile_w, int tile_h, int stages, int ctas, int smem,
                              void* stream) {
  if (C % 8 != 0 || C < 8 || H < 1 || W < 1 || bh < 1 || (mode != 0 && mode != 1) ||
      (mode == 1 && bh % 2 != 0) || (co != 3 && co != 4) || wdt < 0 || wdt > 2 || bdt < 0 ||
      bdt > 2)
    return (int)cudaErrorInvalidValue;
  const int bx = mode == 1 ? bh / 2 : bh, chunks = (C + 63) / 64;
  const long long tiles = (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * bx;
  if (tile_w != TW || tile_h != TH || stages < MIN_STAGES || stages > MAX_STAGES ||
      smem != smem_bytes(co, chunks, stages) || smem > SMEM_MAX || ctas < 1 || ctas > tiles ||
      tiles > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!make_map_nhwc(&tm, h, bh, H, W, C, BW, BH, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co == 3)
    return (int)(mode == 0 ? launch<3, 0>(tm, x, mult, add, w, bias, wdt, bdt, coefs, out, bx,
                                          H, W, C, stages, ctas, smem, s)
                           : launch<3, 1>(tm, x, mult, add, w, bias, wdt, bdt, coefs, out, bx,
                                          H, W, C, stages, ctas, smem, s));
  return (int)(mode == 0 ? launch<4, 0>(tm, x, mult, add, w, bias, wdt, bdt, coefs, out, bx, H,
                                        W, C, stages, ctas, smem, s)
                         : launch<4, 1>(tm, x, mult, add, w, bias, wdt, bdt, coefs, out, bx, H,
                                        W, C, stages, ctas, smem, s));
}
