// 3x3 stride-1 same-pad convolution as an implicit GEMM for Hopper (sm_90a):
// NHWC bf16 activations, bf16 weights, fp32 accumulation (K7).
//
// One entry point, mdt_conv3x3_gemm, over one GEMM kernel template. It
// replaces both TPU variants of benchmarks/research/conv3x3.py:
// `conv3x3_pallas` (`_kernel`, pallas_call :90), y = conv(x, k) + bias in
// bf16, is its case with no prologue, no residual and bf16 out;
// `conv3x3_gemm` (`_gemm_kernel`, pallas_call :286) is y = conv(P(x), k) +
// bias [+ residual], bf16 or fp32 out, where the optional prologue P(x) =
// [silu](x * scale[b, c] + shift[b, c]) runs in fp32 and rounds to bf16
// before the product. The zero padding stays zero through it (silu(0 * a +
// b) != 0): pixels outside the image are never transformed. Bias and
// residual add in fp32.
//
// What the TPU kernels worked around, and what this one does instead. v1
// gathered overlapping (bh+2)-row tiles on the host, because BlockSpecs cut
// only disjoint blocks; v2 stacked the three dy taps along the lane axis so
// the MXU saw no sublane relayout and resolved dx after the product with
// shifted fp32 adds. On Hopper a tap's A operand comes straight from a TMA
// box of the image itself, shifted by (dx - 1, dy - 1): the tensor map is
// 4-d (C, W, H, B), and TMA reads every coordinate outside the image,
// negative ones included, as zero, so the conv's padding costs no
// instruction and no thread copies an element. H is a dimension of its
// own, so a box that reaches past an image's last row reads zeros, not the
// next image.
//
// What bounds it on the H100: 2 * B*H*W * 9 * C_in * C_out flops against
// 2 * B*H*W * (C_in + C_out) bytes. At the UNet and VAE shapes (C 128-1280)
// that is 15-620 GFLOP against at most 1.1 GB: compute-bound on the tensor
// cores everywhere, the 512^2 x 128 VAE level by a factor of 2. So the
// design is a Hopper GEMM, M = B*H*W pixels, N = C_out, K = 9 taps x C_in,
// whose limit in practice is the operand traffic into the SMs (L2 to shared
// memory, then shared memory to the tensor cores):
//  * Warp specialisation: warpgroup 0 is the producer (one thread issues
//    the TMA loads; setmaxnreg 40, the consumers 232); WGS consumer
//    warpgroups each run wgmma m64nBNk16 (bf16 in, fp32 out) on 64 pixels
//    of the CTA's box x BN output channels.
//  * Two rings with their own full / empty mbarriers. The pixel ring holds
//    boxes of tw x (th + 2) pixels x 64 channels (128 bytes, swizzled),
//    K-major: one box, loaded once for each dx, serves the three dy taps,
//    whose A operands start dy pixel rows in (tw x 128 bytes, a whole
//    number of 1024-byte swizzle atoms, so tw is 8 or 16). That loads each
//    pixel 3 (th + 2) / th times a C_in slice, not 9. The weight ring holds
//    one tap's 64 input channels x BN output channels of the HWIO weights
//    as they are stored (MN-major, 64-column boxes 8 KB apart): nothing is
//    transposed, on the host or in shared memory.
//  * CTAs run in pairs (clusters of 2) over neighbouring pixel boxes of one
//    channel block: each loads half of every weight tile and multicasts it
//    to both, so a weight tile costs the L2 half as many reads. Every
//    consumer warpgroup of the pair releases a weight stage on both CTAs'
//    empty barriers; a producer stays until the last releases have landed.
//  * K runs C_in slices outer, then dx, then dy: each output element sums
//    its 9 C_in products in that fixed order. No split-K; the block shape
//    comes from H, W and C_out alone (ops/conv3x3.py `conv3x3_plan`, which
//    the entry checks), never from B, and the order of the sum does not
//    depend on the block, so a batch row's result does not depend on the
//    batch.
//  * The plan: tw 16 (W > 8) or 8; BN the width of 128 or 256 that pads
//    C_out least (ties: 256), 128 where H*W <= 256 (the UNet's 16^2 and
//    8^2 levels: twice the CTAs); WGS 1 where H*W <= 64 (two CTAs an SM),
//    else 2; three pixel boxes and up to eight weight tiles in the rings.
//  * Epilogue from registers: + bias, + residual (bf16) in fp32, bf16 or
//    fp32 out, masked at ragged H, W, B and C_out.
//  * The prologue runs once a pixel, in an elementwise pre-pass
//    (prologue_kernel, 16 bytes a thread) that writes P(x) in bf16 to a
//    scratch image the wrapper allocates; the GEMM then reads that image.
//    Redone on each of the nine taps it would put 9 exps a pixel on the
//    SFU; the pre-pass is one bf16 read and write of x (42 MB at (16, 32^2,
//    640)), the plain version's own `_prologue`.
//  * Rasterisation: the CTA index runs over the output-channel blocks
//    first, so the CTAs resident together share each pixel box in L2, and
//    the weights (7-30 MB at C 640-1280) stay in the 50 MB L2.
// On an H100 (scripts/conv_kernels_ablate.py, device time): 0.169 ms at
// (16, 32^2, 640), 714 TFLOP/s or 72% of the bf16 peak; 0.840 ms, 736
// TFLOP/s at (8, 128^2, 512); the loads alone (no products) take 0.134 and
// 0.602 ms of that, the products alone (no loads) 0.162 and 0.809.
// ptxas -v (sm_90a, nvcc 12.9; scripts/ptxas_report.py): conv_gemm_kernel
// 168 registers at launch with two consumer warpgroups (BN 128 and 256),
// 95 with one, no spills, 12 HGMMA lines each; prologue_kernel 32.
#include "hopper.cuh"  // mbarriers, TMA and its tensor maps, wgmma

namespace {

constexpr int BK = 64;                  // input channels a stage: one 128-byte swizzled row
constexpr int CLUSTER = 2;              // CTAs along M that share each weight tile
constexpr int SMEM_MAX = 232448;        // a block's shared memory on the H100
constexpr int SMEM_SLACK = 1024;        // the ring's 1024-byte alignment
constexpr int PRO_THREADS = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// P(x) = [silu](x * scale[b, c] + shift[b, c]) in fp32, rounded to bf16, 8
// channels a thread; scale / shift both or neither. vecs = B*H*W*C / 8.
__global__ void __launch_bounds__(PRO_THREADS) prologue_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, int silu_on, __nv_bfloat16* __restrict__ out,
    long long vecs, long long hw, int cin) {
  const int cv = cin / 8;
  for (long long i = (long long)blockIdx.x * PRO_THREADS + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * PRO_THREADS) {
    uint4 val = reinterpret_cast<const uint4*>(x)[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
    const size_t sc = (size_t)(i / cv / hw) * cin + (size_t)(i % cv) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = __bfloat162float(e[j]);
      if (scale != nullptr) v = v * scale[sc + j] + shift[sc + j];
      if (silu_on) v = silu(v);
      e[j] = __float2bfloat16(v);
    }
    reinterpret_cast<uint4*>(out)[i] = val;
  }
}

// Release weight stage `bar` on both CTAs of the pair (each multicasts half
// of every weight tile into both).
__device__ __forceinline__ void release_pair(uint32_t bar) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(bar, r);
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

template <int BN, int WGS>
struct Tile {
  // one tap's weights: BN / 64 boxes of 64 input channels (rows) x 64
  // output channels (128 bytes, swizzled), each CTA of the pair loading
  // BOXES of them for both
  static constexpr int B_BOX = 64 * 128, B_BYTES = BN / 64 * B_BOX;
  static constexpr int BOXES = BN / 64 / CLUSTER;
  // A slot: one dx box of tw x (th + 2) pixels (th = 64 WGS / tw output
  // rows), a 128-byte row a pixel
  static int a_bytes(int tw) { return tw * (64 * WGS / tw + 2) * 128; }
  static int smem(int tw, int a_stages, int b_stages) {
    return SMEM_SLACK + a_stages * (a_bytes(tw) + 16) + b_stages * (B_BYTES + 16);
  }
};

// y (bsz, h, w, cout) = conv(x) + bias [+ residual] over the CTA's box of
// tw x th pixels of one image (th = 64 WGS / tw; tw 8 or 16) and BN output
// channels. tm_x: the 4-d map of x (C, W, H, B) with tw x (th + 2) boxes;
// tm_w: the HWIO weights as (9, cin, cout) with 64 x 64 boxes. residual may
// be null. OutT: __nv_bfloat16 or float.
template <int BN, int WGS, typename OutT>
__global__ void __launch_bounds__(128 * (WGS + 1), WGS == 1 ? 2 : 1) conv_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ residual,
    OutT* __restrict__ y, int bsz, int h, int w, int cin, int cout, int tw, int a_stages,
    int b_stages) {
  using T = Tile<BN, WGS>;
  extern __shared__ uint8_t smem_raw[];
  const int th = 64 * WGS / tw, a_bytes = tw * (th + 2) * 128, row_bytes = tw * 128;
  const uint32_t a_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_base = a_base + a_stages * a_bytes;
  const uint32_t a_full = b_base + b_stages * T::B_BYTES, a_empty = a_full + 8 * a_stages;
  const uint32_t b_full = a_empty + 8 * a_stages, b_empty = b_full + 8 * b_stages;
  // CTA pairs (clusters) take neighbouring pixel boxes of one channel block,
  // the channel blocks first (L2); the boxes run w fastest, then h, then b.
  // A pair's box past the last (b0 >= bsz) reads zeros and stores nothing.
  const uint32_t rank = cluster_rank();
  const int n_blocks = (cout + BN - 1) / BN, pair = (int)(blockIdx.x / CLUSTER);
  const int n0 = pair % n_blocks * BN;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  int mb = pair / n_blocks * CLUSTER + (int)rank;
  const int x0 = mb % tiles_x * tw;
  mb /= tiles_x;
  const int y0 = mb % tiles_y * th, b0 = mb / tiles_y;
  const int chunks = (cin + BK - 1) / BK;
  // warp-uniform by construction (a shuffle of lane 0's value), so the
  // compiler sees each role's region whole
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a_stages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, WGS);
    }
    for (int s = 0; s < b_stages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, WGS * CLUSTER);   // every consumer warpgroup of the pair
    }
    fence_barrier_init();
  }
  cluster_sync();  // both CTAs' barriers are set up before any arrives

  if (wg == 0) {
    if constexpr (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int as = 0, bs = 0;
      uint32_t ap = 0, bp = 0;
      for (int c = 0; c < chunks; ++c)
        for (int dx = 0; dx < 3; ++dx) {
          // one box serves the three taps of this dx: tap (dy, dx) reads its
          // rows dy .. dy + th - 1
          mbar_wait(a_empty + 8 * as, ap ^ 1);
          mbar_expect_tx(a_full + 8 * as, a_bytes);   // whole boxes: TMA counts the zero fill
          tma_load_4d(a_base + as * a_bytes, &tm_x, a_full + 8 * as, c * BK, x0 + dx - 1, y0 - 1,
                      b0);
          advance(as, ap, a_stages);
          for (int dy = 0; dy < 3; ++dy) {
            mbar_wait(b_empty + 8 * bs, bp ^ 1);
            mbar_expect_tx(b_full + 8 * bs, T::B_BYTES);   // both CTAs' boxes of the tap's tile
#pragma unroll
            for (int j = 0; j < T::BOXES; ++j) {
              const int box = (int)rank * T::BOXES + j;
              tma_load_3d_multicast(b_base + bs * T::B_BYTES + box * T::B_BOX, &tm_w,
                                    b_full + 8 * bs, n0 + 64 * box, c * BK, 3 * dy + dx,
                                    (1u << CLUSTER) - 1);
            }
            advance(bs, bp, b_stages);
          }
        }
      // The CTA stays until the pair's consumers have released every weight
      // stage: their arrivals land on this CTA's barriers.
      for (int s = 0; s < b_stages; ++s) {
        mbar_wait(b_empty + 8 * bs, bp ^ 1);
        advance(bs, bp, b_stages);
      }
    }
  } else {
    if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ci = wg - 1, t = threadIdx.x % 128;
    float acc[BN / 2];
    int as = 0, bs = 0, a_pend = -1, b_pend = -1;
    uint32_t ap = 0, bp = 0;
    for (int c = 0; c < chunks; ++c)
      for (int dx = 0; dx < 3; ++dx) {
        mbar_wait(a_full + 8 * as, ap);
        // this warpgroup's 64 pixels: output rows ci th / WGS .. of the box
        const uint32_t a_slot = a_base + as * a_bytes + ci * (th / WGS) * row_bytes;
        for (int dy = 0; dy < 3; ++dy) {
          mbar_wait(b_full + 8 * bs, bp);
          const uint32_t a = a_slot + dy * row_bytes, b = b_base + bs * T::B_BYTES;
          fence_operand(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            // pixels K-major: 16 channels = 32 bytes along the swizzled rows,
            // 8-row groups 1024 B apart (a row of tw pixels: 1 or 2
            // groups); weights MN-major as stored: 16 input channels = 16
            // rows of 128 bytes, 8-row groups 1024 B apart, 64-column boxes
            // 8 KB apart (the leading offset)
            wgmma_ss<BN, 1>(acc, smem_desc(a + kk * 32, 16, 1024),
                            smem_desc(b + kk * 2048, T::B_BOX, 1024), (c | dx | dy | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_operand(acc);
          // the products before these are done: their weight stage, and at
          // a new box the last box, are free
          if (t == 0) {
            if (b_pend >= 0) release_pair(b_empty + 8 * b_pend);
            if (dy == 0 && a_pend >= 0) mbar_arrive(a_empty + 8 * a_pend);
          }
          b_pend = bs;
          advance(bs, bp, b_stages);
        }
        a_pend = as;
        advance(as, ap, a_stages);
      }
    wgmma_wait<0>();
    fence_operand(acc);
    if (t == 0) {
      release_pair(b_empty + 8 * b_pend);
      mbar_arrive(a_empty + 8 * a_pend);
    }

    // Accumulator fragment of m64nN: warp q of the warpgroup holds rows
    // 16 q + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1). Row r of the
    // CTA's box is pixel (x0 + r % tw, y0 + r / tw) of image b0.
    const int lane = t % 32;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ci * 64 + (t / 32) * 16 + lane / 4 + 8 * hh;
      const int px = x0 + r % tw, py = y0 + r / tw;
      if (px >= w || py >= h || b0 >= bsz) continue;
      const size_t o = (((size_t)b0 * h + py) * w + px) * cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * (lane % 4);
        if (co >= cout) continue;
        float v0 = acc[4 * j + 2 * hh] + bias[co];
        float v1 = acc[4 * j + 2 * hh + 1] + bias[co + 1];
        if (residual != nullptr) {
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(residual + o + co));
          v0 += rv.x;
          v1 += rv.y;
        }
        store2(y + o + co, v0, v1);
      }
    }
  }
}

// The plan's GEMM on the image xp (x, or its prologue), after the checks.
template <int BN, int WGS, typename OutT>
cudaError_t launch_gemm(const void* xp, const void* wt, const void* bias, const void* residual,
                        void* y, int bsz, int h, int w, int cin, int cout, int tw, int a_stages,
                        int b_stages, cudaStream_t s, int* ctas) {
  using T = Tile<BN, WGS>;
  const int smem = T::smem(tw, a_stages, b_stages);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int th = 64 * WGS / tw;
  CUtensorMap tm_x, tm_w;
  if (!make_map_nhwc(&tm_x, xp, bsz, h, w, cin, tw, th + 2, 1) ||
      !make_map(&tm_w, wt, 9, cin, cout, 64, BK))
    return cudaErrorInvalidValue;
  auto kern = conv_gemm_kernel<BN, WGS, OutT>;
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
  const long long boxes = (long long)((w + tw - 1) / tw) * ((h + th - 1) / th) * bsz;
  const long long grid = (boxes + CLUSTER - 1) / CLUSTER * CLUSTER * ((cout + BN - 1) / BN);
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  if (ctas) *ctas = (int)grid;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(128 * (WGS + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, tm_x, tm_w, static_cast<const float*>(bias),
                           static_cast<const __nv_bfloat16*>(residual), static_cast<OutT*>(y),
                           bsz, h, w, cin, cout, tw, a_stages, b_stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int bn, int wgs, const void* xp, const void* wt, const void* bias,
                     const void* residual, void* y, int bsz, int h, int w, int cin, int cout,
                     int tw, int a_stages, int b_stages, cudaStream_t s, int* ctas) {
  if (bn == 128 && wgs == 1)
    return launch_gemm<128, 1, OutT>(xp, wt, bias, residual, y, bsz, h, w, cin, cout, tw,
                                     a_stages, b_stages, s, ctas);
  if (bn == 128 && wgs == 2)
    return launch_gemm<128, 2, OutT>(xp, wt, bias, residual, y, bsz, h, w, cin, cout, tw,
                                     a_stages, b_stages, s, ctas);
  if (bn == 256 && wgs == 2)
    return launch_gemm<256, 2, OutT>(xp, wt, bias, residual, y, bsz, h, w, cin, cout, tw,
                                     a_stages, b_stages, s, ctas);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (bsz, h, w, cin) bf16, 16-byte aligned; wt: the HWIO weights (3, 3,
// cin, cout) bf16, tap = 3 * dy + dx, 16-byte aligned; bias: (cout,) fp32; scale/shift (bsz,
// cin) fp32, both or neither; silu_on 0/1; pbuf: (bsz, h, w, cin) bf16
// scratch for the prologue's image (used when there is a prologue);
// residual (bsz, h, w, cout) bf16 or null; y (bsz, h, w, cout) fp32 when
// out_f32, else bf16. cin, cout % 8 == 0. The plan (ops/conv3x3.py
// `conv3x3_plan`): boxes tw (8 or 16) pixels wide and 64 wgs / tw rows
// high, bn 128 or 256 output channels, wgs consumer warpgroups, a_stages
// pixel boxes and b_stages weight tiles in the rings; *ctas (if not null)
// gets the GEMM's grid.
extern "C" int mdt_conv3x3_gemm(const void* x, const void* wt, const void* bias,
                                const void* scale, const void* shift, int silu_on,
                                const void* residual, void* y, int out_f32, void* pbuf, int bsz,
                                int h, int w, int cin, int cout, int tw, int bn, int wgs,
                                int a_stages, int b_stages, void* stream, int* ctas) {
  if (bsz < 1 || h < 1 || w < 1 || cin % 8 || cout % 8 || cin < 8 || cout < 8)
    return (int)cudaErrorInvalidValue;
  if ((scale == nullptr) != (shift == nullptr)) return (int)cudaErrorInvalidValue;
  if ((tw != 8 && tw != 16) || a_stages < 2 || b_stages < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* xp = x;
  if (scale != nullptr || silu_on) {
    if (pbuf == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(pbuf) % 16)
      return (int)cudaErrorInvalidValue;
    const long long vecs = (long long)bsz * h * w * cin / 8;
    const long long blocks = (vecs + PRO_THREADS - 1) / PRO_THREADS;
    prologue_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), PRO_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), silu_on, static_cast<__nv_bfloat16*>(pbuf), vecs,
        (long long)h * w, cin);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xp = pbuf;
  }
  if (out_f32)
    return (int)dispatch<float>(bn, wgs, xp, wt, bias, residual, y, bsz, h, w, cin, cout, tw,
                                a_stages, b_stages, s, ctas);
  return (int)dispatch<__nv_bfloat16>(bn, wgs, xp, wt, bias, residual, y, bsz, h, w, cin, cout,
                                      tw, a_stages, b_stages, s, ctas);
}
