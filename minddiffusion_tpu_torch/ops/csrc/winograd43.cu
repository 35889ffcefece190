// Winograd F(4x4, 3x3) convolution for Hopper (sm_90a): a 3x3 stride-1
// same-pad conv on NHWC bf16, H and W multiples of 4 (K8).
//
// mdt_winograd43_conv3x3 replaces benchmarks/research/winograd43.py
// `_wino43_kernel_dma` / `_wino43_compute` (pallas_call in
// `conv3x3_winograd43`, :203). Math, as on the TPU: for every 4x4 output
// tile, the 6x6 input patch d (rows 4ty-1 .. 4ty+4, zero outside the image)
// is transformed V = B^T d B in fp32 (columns first, then rows) and rounded
// to bf16; 36 products M[a][b] = V[a][b] U[6a+b] with U = G k G^T (36, C_in,
// C_out) bf16 accumulate in fp32; the tile is Y = A^T M A + bias in fp32,
// stored as bf16.
//
//   B^T = [[4,0,-5,0,1,0], [0,-4,-4,1,1,0], [0,4,-4,-1,1,0],
//          [0,-2,-1,2,1,0], [0,2,-1,-2,1,0], [0,4,0,-5,0,1]]
//   A^T = [[1,1,1,1,1,0], [0,1,-1,2,-2,0], [0,1,1,4,4,0], [0,1,-1,8,-8,1]]
//
// The TPU kernel merged groups of four columns into the lane axis on the
// host and fetched (bh+4)-row halo windows with double-buffered DMAs, so
// that V and M never left VMEM.
//
// What bounds it on the H100: the products are 2 * 36 * P * C_in * C_out
// flops, P = B * H/4 * W/4 tiles, 4x fewer than the direct conv's; at the
// VAE shapes (C 128-512, 128^2-512^2, batch 8) that is 20-310 GFLOP
// against 0.3-1.1 GB of x and y, so the wide levels are bound by the
// tensor cores and 512^2 x 128 by bytes. The design is the fused plan of
// the F(2x2) kernel (winograd.cu), cut to F(4x4)'s registers; three
// launches:
//  * transpose_u_kernel writes U^T (36, C_out, C_in) bf16 from the hoisted
//    U in the JAX layout, so the fused kernel reads U K-major.
//  * wino43_input_kernel: two CTAs an SM walk work items of 2 x 4 tiles x
//    64 channels; an item's 10 x 18 input pixels (the halo zero outside
//    the image: TMA's zero fill of x's 4-d map) land in shared memory by
//    one TMA box, the next item's box in flight while this one is
//    transformed. The four warps of column k of B^T d take the 8 tiles, a
//    thread 4 channels of one tile (40 registers): the column pass over
//    the patch's six rows, then the row pass, and the six V[a][k] go out as
//    8-byte stores into V (36, P, cp) bf16, cp = C_in rounded up to 64 (the
//    channels past C_in zeros). V stays a round trip (2 x 36 P cp bytes):
//    with (a, b) outer and C_in inner, a CTA of the fused kernel could
//    rebuild V from x only by redoing the transform up to 36 times on the
//    path that feeds the tensor cores.
//  * wino43_fused_kernel: one CTA owns BM = 64 tiles x BN = 32 output
//    channels and runs all 36 products for that block, so M never leaves
//    the SM. Warpgroup 0 is the producer (one thread issues TMA loads of V
//    and U^T slices into a STAGES = 16 deep ring of BK = 64-channel slices,
//    12 KB a stage, full / empty mbarriers); warpgroups 1 and 2 (setmaxnreg
//    232; the producer drops to 40) each run wgmma m64n16k16 on the same V
//    slice and their own 16 output channels, both operands K-major and
//    128-byte swizzled by TMA; each warpgroup's 16 rows of the U^T slice
//    start on a 1024-byte atom.
//  * Why 16 channels a warpgroup: the output tile has 16 outputs a
//    channel. The products of one (a, b) land in an m64n16 accumulator (8
//    registers a thread); two of them take turns, so the fold of (a, b) - 1
//    runs while the products of (a, b) are in flight. The fold is
//    separable: along b into four row partials T[j] += A^T[j][b] M[a][b],
//    and at the end of each a into the output partials Y[i][j] +=
//    A^T[i][a] T[j]: 108 + 72 = 180 multiply-adds a (tile, channel), not
//    the direct fold's 324, for (2 + 4 + 16) x 8 = 176 accumulator
//    registers a thread. At 32 channels a warpgroup the 16 x 16 partials
//    alone would take 256.
//  * The ceiling this leaves: an m64n16k16 is 16 K multiply-adds, 8 clocks
//    of an SM's tensor cores, but on this card it takes ~55 clocks of the
//    SM whatever feeds it (A from registers measured no faster, and four
//    independent accumulator chains no faster than one:
//    scripts/conv_kernels_ablate.py), and V is read from L2 once for each
//    32 output channels. Measured (device time, H100): the products at
//    11-17% of the bf16 peak, 0.214 ms at (16, 32^2, 640) of which 0.179
//    is the loads alone and 0.179 the kernel without the fold; F(4, 3)'s
//    4x fewer products make that ~50-70% of a direct conv at peak.
//    Clusters that multicast the V slice along C_out (2 or 4 CTAs) were
//    slower: 0.255 / 0.261 ms there, against 0.250 without.
//  * Order of the sum: every output element sums its 36 products in the
//    fixed (a, b) order, each over C_in in slice order; no split-K, and the
//    block sizes are constants, so a row's result does not depend on B, P
//    or its place in the batch.
//  * Ragged edges: TMA fills rows past P, channels past C_in and C_out with
//    zeros; the epilogue (+ bias, bf16, each thread's 4x4 pixels of two
//    channel pairs stored straight from registers into NHWC y) masks tiles
//    >= P and channels >= C_out.
// ptxas -v (sm_90a, nvcc 12.9; scripts/ptxas_report.py): wino43_fused_kernel
// 168 registers at launch (the consumers raise theirs to 232 with
// setmaxnreg), no spills, 152 HGMMA lines; wino43_input_kernel 40
// registers, transpose_u_kernel 30, neither spilling.
#include "hopper.cuh"  // mbarriers, TMA and its tensor maps, wgmma

namespace {

constexpr int BM = 64, WN = 16, NCW = 2, BN = WN * NCW, BK = 64, STAGES = 16;
constexpr int A_BYTES = BM * BK * 2;              // one V slice: 64 rows of 128 B
constexpr int B_BYTES = BN * BK * 2;              // one U^T slice: 32 rows of 128 B
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + STAGES * 16 + 1024;  // + barriers, alignment
constexpr int THREADS = 128 * (NCW + 1);          // producer + the consumer warpgroups
constexpr int T_TILE = 32, T_ROWS = 8;            // U's transpose: 32 x 32 tiles, 8 rows a pass
constexpr int IN_TR = 2, IN_TC = 4, IN_CC = 64;   // input transform: tiles x channels a CTA
constexpr int IN_Q = 4;                           // channels a thread
constexpr int IN_THREADS = 6 * IN_TR * IN_TC * (IN_CC / IN_Q);   // (k, tile, 4 channels) a thread
constexpr int IN_SMEM = 2 * (4 * IN_TR + 2) * (4 * IN_TC + 2) * IN_CC * 2 + 16;   // two regions

// B^T[a][j] and A^T[i][a] as expressions (no table in memory), so that
// every coefficient of an unrolled loop is a constant.
__host__ __device__ constexpr float bt(int a, int j) {
  return a == 0   ? (j == 0 ? 4.f : j == 2 ? -5.f : j == 4 ? 1.f : 0.f)
         : a == 5 ? (j == 1 ? 4.f : j == 3 ? -5.f : j == 5 ? 1.f : 0.f)
         : j == 0 || j == 5 ? 0.f
         : j == 4           ? 1.f
         : j == 1 ? (a == 1 ? -4.f : a == 2 ? 4.f : a == 3 ? -2.f : 2.f)
         : j == 2 ? (a <= 2 ? -4.f : -1.f)
                  : (a == 1 ? 1.f : a == 2 ? -1.f : a == 3 ? 2.f : -2.f);
}
__host__ __device__ constexpr float at(int i, int a) {
  return a == 0   ? (i == 0 ? 1.f : 0.f)
         : a == 5 ? (i == 3 ? 1.f : 0.f)
         : i == 0 ? 1.f
         : a <= 2 ? (a == 1 || i == 2 ? 1.f : -1.f)
                  : (a == 3 ? 1.f : i == 2 ? 1.f : -1.f) * (i == 1 ? 2.f : i == 2 ? 4.f : 8.f);
}
static_assert(bt(0, 0) == 4 && bt(0, 2) == -5 && bt(1, 1) == -4 && bt(2, 3) == -1 &&
                  bt(3, 1) == -2 && bt(4, 3) == -2 && bt(5, 3) == -5 && bt(5, 5) == 1 &&
                  bt(3, 2) == -1 && bt(4, 4) == 1 && bt(2, 0) == 0,
              "B^T");
static_assert(at(0, 4) == 1 && at(1, 2) == -1 && at(1, 4) == -2 && at(2, 4) == 4 &&
                  at(3, 3) == 8 && at(3, 4) == -8 && at(3, 5) == 1 && at(2, 5) == 0 &&
                  at(2, 2) == 1 && at(3, 2) == -1 && at(1, 0) == 0,
              "A^T");

// ---- input transform -------------------------------------------------------

// Column K of B^T d B for one tile and IN_Q channels: the column pass
// c[i] = sum_j B^T[K][j] d[i][j] over the patch's rows (patch: the tile's
// 6 x 6 pixels in the staged region, pixel stride IN_CC channels, row
// stride rc pixels), then V[a][K] = sum_i B^T[a][i] c[i], six 8-byte stores
// `plane` apart.
template <int K>
__device__ __forceinline__ void transform_column(const __nv_bfloat16* patch, int rc,
                                                 __nv_bfloat16* out, size_t plane) {
  float c[6][IN_Q];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int e = 0; e < IN_Q; ++e) c[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (bt(K, j) == 0.f) continue;
      const uint2 raw = *reinterpret_cast<const uint2*>(patch + (i * rc + j) * IN_CC);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      const float d[IN_Q] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
      for (int e = 0; e < IN_Q; ++e) c[i][e] += bt(K, j) * d[e];
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float v[IN_Q];
#pragma unroll
    for (int e = 0; e < IN_Q; ++e) v[e] = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (bt(a, i) == 0.f) continue;
#pragma unroll
      for (int e = 0; e < IN_Q; ++e) v[e] += bt(a, i) * c[i][e];
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (a * 6 + K) * plane) = raw;
  }
}

// A work item is IN_TR x IN_TC tiles x IN_CC channels of one image: its
// (4 IN_TR + 2) x (4 IN_TC + 2) input pixels, the padding zero, land in
// shared memory as bf16 by one TMA box of x's 4-d map (unswizzled: [row]
// [column][channel]). A CTA walks items (gridDim.x apart) with two such
// regions, the next item's box in flight while it transforms this one. The
// four warps of column k = warp / 4 of B^T d (warp-uniform, so its
// coefficients are constants) take the 8 tiles, a thread IN_Q channels of
// one tile. vbuf: (36, P, cp), P = bsz*(h/4)*(w/4), cp = cin rounded up to
// 64: its channels past cin are written as zeros.
__global__ void __launch_bounds__(IN_THREADS, 2) wino43_input_kernel(
    const __grid_constant__ CUtensorMap tm_x, __nv_bfloat16* __restrict__ vbuf, int bsz, int h,
    int w, int cp) {
  constexpr int RR = 4 * IN_TR + 2, RC = 4 * IN_TC + 2;
  constexpr int REGION = RR * RC * IN_CC * 2;              // bytes of one staged region
  constexpr int PER_K = IN_TR * IN_TC * (IN_CC / IN_Q);   // threads a column k
  static_assert(PER_K == 128 && REGION % 128 == 0, "four warps a column k");
  extern __shared__ __align__(128) uint8_t in_smem[];
  const uint32_t full = smem_u32(in_smem) + 2 * REGION;   // two mbarriers
  const int th = h / 4, tw = w / 4;
  const int xb = (tw + IN_TC - 1) / IN_TC, yb = (th + IN_TR - 1) / IN_TR, cb = cp / IN_CC;
  const long long items = (long long)bsz * yb * xb * cb;
  // item -> (image, row block, column block, channel block), channels fastest
  auto corner = [&](long long item, int& b, int& ty0, int& tx0, int& c0) {
    c0 = (int)(item % cb) * IN_CC;
    item /= cb;
    tx0 = (int)(item % xb) * IN_TC;
    item /= xb;
    ty0 = (int)(item % yb) * IN_TR;
    b = (int)(item / yb);
  };
  auto issue = [&](long long item, int buf) {
    int b, ty0, tx0, c0;
    corner(item, b, ty0, tx0, c0);
    mbar_expect_tx(full + 8 * buf, REGION);   // the whole box: TMA counts the zero fill
    tma_load_4d(smem_u32(in_smem) + buf * REGION, &tm_x, full + 8 * buf, c0, 4 * tx0 - 1,
                4 * ty0 - 1, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    fence_barrier_init();
    for (int i = 0; i < 2; ++i) {
      const long long item = blockIdx.x + (long long)i * gridDim.x;
      if (item < items) issue(item, i);
    }
  }
  __syncthreads();
  const int k = threadIdx.x / PER_K, r = threadIdx.x % PER_K;
  const int t = r / (IN_CC / IN_Q), q = r % (IN_CC / IN_Q);
  const size_t plane = (size_t)bsz * th * tw * cp;
  int it = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int buf = it & 1;
    mbar_wait(full + 8 * buf, (it >> 1) & 1);
    int b, ty0, tx0, c0;
    corner(item, b, ty0, tx0, c0);
    const int ty = ty0 + t / IN_TC, tx = tx0 + t % IN_TC;
    if (ty < th && tx < tw) {
      const __nv_bfloat16* patch = reinterpret_cast<const __nv_bfloat16*>(in_smem + buf * REGION) +
                                   ((4 * (t / IN_TC)) * RC + 4 * (t % IN_TC)) * IN_CC + IN_Q * q;
      __nv_bfloat16* out = vbuf + (((size_t)b * th + ty) * tw + tx) * cp + c0 + IN_Q * q;
      switch (k) {
        case 0: transform_column<0>(patch, RC, out, plane); break;
        case 1: transform_column<1>(patch, RC, out, plane); break;
        case 2: transform_column<2>(patch, RC, out, plane); break;
        case 3: transform_column<3>(patch, RC, out, plane); break;
        case 4: transform_column<4>(patch, RC, out, plane); break;
        default: transform_column<5>(patch, RC, out, plane); break;
      }
    }
    __syncthreads();   // every thread is done reading this region
    if (threadIdx.x == 0 && item + 2LL * gridDim.x < items) {
      fence_proxy_async();   // the reads above before TMA's writes into the same bytes
      issue(item + 2LL * gridDim.x, buf);
    }
  }
}

// ---- U^T ------------------------------------------------------------------

// ut (36, cout, cin) = u (36, cin, cout) transposed, bf16, through 32 x 32
// tiles in shared memory: a CTA reads one tile row by row and writes it
// column by column, both along the contiguous dimension.
__global__ void __launch_bounds__(T_TILE * T_ROWS) transpose_u_kernel(
    const __nv_bfloat16* __restrict__ u, __nv_bfloat16* __restrict__ ut, int cin, int cout) {
  __shared__ __nv_bfloat16 tile[T_TILE][T_TILE + 2];
  const size_t plane = (size_t)cin * cout * blockIdx.z;
  const int c0 = blockIdx.x * T_TILE, r0 = blockIdx.y * T_TILE;
  const int tx = threadIdx.x % T_TILE, ty = threadIdx.x / T_TILE;
  for (int r = ty; r < T_TILE; r += T_ROWS)
    if (r0 + r < cin && c0 + tx < cout) tile[r][tx] = u[plane + (size_t)(r0 + r) * cout + c0 + tx];
  __syncthreads();
  for (int c = ty; c < T_TILE; c += T_ROWS)
    if (c0 + c < cout && r0 + tx < cin) ut[plane + (size_t)(c0 + c) * cin + r0 + tx] = tile[tx][c];
}

// ---- the fused kernel ------------------------------------------------------

// Fold M[a][b] for (a, b) = (AB / 6, AB % 6) into the row partials
// tp[j] (+)= A^T[j][b] M (the first b of a row sets them), and at the row's
// last b the row into the output partials yp[4 i + j] += A^T[i][a] tp[j].
template <int AB>
__device__ __forceinline__ void fold(const float (&m)[8], float (&tp)[4][8],
                                     float (&yp)[16][8]) {
  constexpr int ROW = AB / 6, COL = AB % 6;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float c = at(j, COL);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (COL == 0)
        tp[j][r] = c == 0.f ? 0.f : c * m[r];
      else if (c != 0.f)
        tp[j][r] += c * m[r];
    }
  }
  if constexpr (COL == 5) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = at(i, ROW);
      if (c == 0.f) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 8; ++r) yp[4 * i + j][r] += c * tp[j][r];
    }
  }
}

struct Ring {
  uint32_t a, b, full, empty;  // shared addresses: V slices, U^T slices, barriers
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One (a, b) of a consumer warpgroup: cur = V[ab] U[ab] over every C_in
// slice. The slice before the first one here was the last of (a, b) - 1:
// once it is complete (wait_group 1 after this (a, b)'s first products were
// issued), `prev` is folded while those products run. (Two groups in
// flight, the fold one slice later, measured slower.)
template <int AB>
__device__ __forceinline__ void consume_ab(float (&cur)[8], float (&prev)[8], float (&tp)[4][8],
                                           float (&yp)[16][8], Ring& ring, int k_chunks,
                                           uint32_t b_row_off, bool signaller) {
  for (int kc = 0; kc < k_chunks; ++kc) {
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t a = ring.a + ring.stage * A_BYTES;
    const uint32_t b = ring.b + ring.stage * B_BYTES + b_row_off;
    fence_operand(cur);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // V and U^T both K-major: 16 channels = 32 bytes along the swizzled
      // rows, 8-row groups 1024 B apart
      wgmma_ss_m64n16k16<0>(cur, smem_desc(a + kk * 32, 16, 1024),
                            smem_desc(b + kk * 32, 16, 1024), (kc | kk) != 0);
    wgmma_commit();
    fence_operand(cur);
    wgmma_wait<1>();
    if (kc > 0 || AB > 0) {
      const int done = ring.stage == 0 ? STAGES - 1 : ring.stage - 1;
      if (signaller) mbar_arrive(ring.empty + 8 * done);
    }
    if constexpr (AB > 0) {
      if (kc == 0) {
        fence_operand(prev);
        fold<AB - 1>(prev, tp, yp);
      }
    }
    ring.advance();
  }
}

template <int AB>
__device__ __forceinline__ void consume_from(float (&acc0)[8], float (&acc1)[8],
                                             float (&tp)[4][8], float (&yp)[16][8], Ring& ring,
                                             int k_chunks, uint32_t b_row_off, bool signaller) {
  if constexpr (AB < 36) {
    if constexpr (AB % 2 == 0)
      consume_ab<AB>(acc0, acc1, tp, yp, ring, k_chunks, b_row_off, signaller);
    else
      consume_ab<AB>(acc1, acc0, tp, yp, ring, k_chunks, b_row_off, signaller);
    consume_from<AB + 1>(acc0, acc1, tp, yp, ring, k_chunks, b_row_off, signaller);
  }
}

// V (36, P, cp) and U^T (36, cout, cin) by TMA (tm_v, tm_ut); y as the
// (bsz, h, w, cout) NHWC image of the P = bsz (h/4) (w/4) tiles.
__global__ void __launch_bounds__(THREADS, 1) wino43_fused_kernel(
    __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_ut,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int p_total, int h, int w,
    int cp, int cout) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring;
  ring.a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.b = ring.a + STAGES * A_BYTES;
  ring.full = ring.b + STAGES * B_BYTES;
  ring.empty = ring.full + STAGES * 8;
  ring.stage = 0;
  ring.phase = 0;
  // channel blocks first: the CTAs resident together share each V row block
  const int n_blocks = (cout + BN - 1) / BN;
  const int n0 = (int)(blockIdx.x % n_blocks) * BN;
  const int m0 = (int)(blockIdx.x / n_blocks) * BM;
  const int k_chunks = cp / BK;
  // warp-uniform by construction (a shuffle of lane 0's value), so the
  // compiler sees each role's region whole
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, NCW);  // each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int ab = 0; ab < 36; ++ab)
        for (int kc = 0; kc < k_chunks; ++kc) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t bar = ring.full + 8 * ring.stage;
          mbar_expect_tx(bar, STAGE_BYTES);  // whole boxes: TMA counts the zero fill too
          tma_load_3d(ring.a + ring.stage * A_BYTES, &tm_v, bar, kc * BK, m0, ab);
          tma_load_3d(ring.b + ring.stage * B_BYTES, &tm_ut, bar, kc * BK, n0, ab);
          ring.advance();
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const uint32_t b_row_off = (wg - 1) * WN * 128;
    float acc0[8], acc1[8], tp[4][8], yp[16][8];
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int r = 0; r < 8; ++r) yp[q][r] = 0.f;
    consume_from<0>(acc0, acc1, tp, yp, ring, k_chunks, b_row_off, t == 0);
    wgmma_wait<0>();
    fence_operand(acc1);
    fold<35>(acc1, tp, yp);

    // Epilogue. Accumulator fragment of m64n16: warp q of the warpgroup
    // holds rows 16 q + lane / 4 (+ 8), columns 8 jj + 2 (lane % 4) (+ 1).
    const int lane = t % 32, row0 = m0 + (t / 32) * 16 + lane / 4;
    const int th = h / 4, tw = w / 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = row0 + 8 * hh;
      if (p >= p_total) continue;
      const int tx = p % tw, ty = (p / tw) % th, bi = p / (tw * th);
      __nv_bfloat16* yb = y + (((size_t)bi * h + 4 * ty) * w + 4 * tx) * cout;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int co = n0 + (wg - 1) * WN + 8 * jj + 2 * (lane % 4);
        if (co >= cout) continue;
        const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(yp[q][4 * jj + 2 * hh] + b0,
                                                         yp[q][4 * jj + 2 * hh + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(yb + ((size_t)(q / 4) * w + q % 4) * cout + co) =
              v;
        }
      }
    }
  }
}

}  // namespace

// x: (bsz, h, w, cin) bf16, 16-byte aligned; u: (36, cin, cout) bf16, U as
// the JAX package lays it out; ut: (36, cout, cin) bf16 scratch for U^T,
// 16-byte aligned; bias: (cout,) fp32; vbuf: (36, P, cp) bf16 scratch, P =
// bsz*(h/4)*(w/4), cp = cin rounded up to 64; y: (bsz, h, w, cout) bf16.
// h, w % 4 == 0; cin, cout % 8 == 0. *ctas (if not null) gets the fused
// kernel's grid.
extern "C" int mdt_winograd43_conv3x3(const void* x, const void* u, void* ut, const void* bias,
                                      void* vbuf, void* y, int bsz, int h, int w, int cin,
                                      int cout, void* stream, int* ctas) {
  if (h % 4 || w % 4 || cin % 8 || cout % 8 || bsz < 1 || h < 4 || w < 4)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(vbuf) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * (h / 4) * (w / 4);
  if (p_total > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int cp = (cin + BK - 1) / BK * BK;
  transpose_u_kernel<<<dim3((cout + T_TILE - 1) / T_TILE, (cin + T_TILE - 1) / T_TILE, 36),
                       T_TILE * T_ROWS, 0, s>>>(static_cast<const __nv_bfloat16*>(u),
                                                static_cast<__nv_bfloat16*>(ut), cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the input transform: two CTAs an SM, each walking its work items
  CUtensorMap tm_x;
  if (!make_map_nhwc(&tm_x, x, bsz, h, w, cin, 4 * IN_TC + 2, 4 * IN_TR + 2, 1,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long in_items = (long long)bsz * ((h / 4 + IN_TR - 1) / IN_TR) *
                             ((w / 4 + IN_TC - 1) / IN_TC) * (cp / IN_CC);
  const long long in_grid = in_items < 2LL * sms ? in_items : 2LL * sms;
  wino43_input_kernel<<<(unsigned)in_grid, IN_THREADS, IN_SMEM, s>>>(
      tm_x, static_cast<__nv_bfloat16*>(vbuf), bsz, h, w, cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  CUtensorMap tm_v, tm_ut;
  if (!make_map(&tm_v, vbuf, 36, p_total, cp, BK, BM) ||
      !make_map(&tm_ut, ut, 36, cout, cin, BK, BN))
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit, raised once per device
  static bool raised[64] = {};
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(wino43_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  const long long grid = (p_total + BM - 1) / BM * ((cout + BN - 1) / BN);
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (ctas) *ctas = (int)grid;
  wino43_fused_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, s>>>(
      tm_v, tm_ut, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), (int)p_total,
      h, w, cp, cout);
  return (int)cudaGetLastError();
}
