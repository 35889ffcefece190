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
//    transform has no bounds checks and no prologue.
// The two differ only in the input transform; both then run the same fused
// kernel, the 16 products and the output transform in one launch.
//
// Math, as on the TPU: for every 2x2 output tile, the 4x4 input patch d
// (after the prologue silu(x * mult + add) on interior pixels only; the
// zero padding stays exactly zero) is transformed V = B^T d B in fp32 and
// rounded to bf16; 16 products M[a,b] = V[a,b] U[a,b] with U = G k G^T
// (16, C_in, C_out) bf16, accumulated in fp32; the output tile is
// Y = A^T M A + bias in fp32, stored as bf16.
//
// What bounds it on the H100: at the UNet sites (16^2 and 32^2, C 640-2560,
// batch 16) the products are 16 x (P x C_in x C_out), P = B (H/2) (W/2)
// tiles: at 32^2 B16 1280->1280, 215 GFLOP, 0.217 ms at 989 TFLOP/s,
// against 136 MB of x, U and y, 0.041 ms at 3.35 TB/s. So it is bound by
// the tensor cores, and the design is a Hopper GEMM whose epilogue is the
// output transform:
//  * Input transform: wino_input_kernel (K2) stages a block of 4 x 4 tiles x
//    64 channels of input in shared memory, through the prologue once a
//    pixel, and transforms it one (tile, 4 channels) a thread;
//    wino_gathered_input_kernel (K3) reads its halo tiles directly. Both
//    write V (16, P, C_in) bf16: the one round trip left in device memory
//    (2 x 16 P C_in bytes). Building V inside the GEMM's CTA instead, as the
//    TPU program does, would need either all 16 (a, b) accumulators live
//    (C_in outer; see below) or the prologue of every pixel redone for each
//    (a, b) that reads it (~36 pixels a tile, against ~6.3 here), in the
//    path that feeds the tensor cores.
//  * wino_fused_kernel: one CTA owns BM = 128 tiles x BN = 64 output
//    channels and runs all 16 products for that block, so M never leaves
//    the SM. Warp specialisation: warpgroup 0 is the producer (one thread
//    issues TMA loads of V and U into a STAGES = 6 deep ring of
//    BK = 64-channel slices, 24 KB a stage, full / empty mbarriers);
//    warpgroups 1 and 2 (setmaxnreg 232; the producer drops to 40) each run
//    wgmma m64n64k16 (bf16 in, fp32 out) on 64 of the 128 tiles. V's slice
//    is K-major (C_in contiguous), U's slice is MN-major (C_out contiguous,
//    as U is stored: wgmma's transposed-B mode): both 128-byte swizzled by
//    TMA, so nothing is transposed or stored element by element in shared
//    memory.
//  * Clusters of CLUSTER = 2 CTAs along C_out share the V slice: each loads
//    half of its rows and multicasts them to both, so a stage costs the L2
//    16 KB a CTA instead of 24. Every consumer warpgroup of the cluster
//    releases a stage on both CTAs' empty barriers; a producer stays until
//    the last releases have landed on its barriers.
//  * Loop order: (a, b) outer, C_in slices inner. Each (a, b) accumulates
//    M[a,b] for the 64 x 64 block of a warpgroup in 32 registers a thread;
//    when it completes it is folded into four fp32 output partials,
//    Y[i][j] += A^T[i,a] A^T[j,b] M[a,b] (coefficients 0 / +-1), another
//    4 x 32 registers. Two M accumulators take turns, so the fold of
//    (a, b) - 1 runs while the first products of (a, b) are in flight. The
//    other order (C_in outer) would keep 16 accumulators live, 16 x 32 KB
//    for a 128 x 64 block: four times the register file. 2 x 32 + 4 x 32 =
//    192 accumulator registers a thread is also why BN is 64: at BN 128 the
//    partials alone would take 256. What this leaves on the table: an
//    m64n64k16 reads 4 KB of shared memory for 64 K multiply-adds, and a
//    stage's 24 KB of TMA writes plus 32 KB of wgmma reads take 437 clocks
//    of the SM's 128 B/clock against 256 clocks of tensor work: at most
//    ~58% of the bf16 peak.
//  * Epilogue: + bias, bf16, each thread stores its 2x2 pixels of two
//    adjacent channels straight from registers into NHWC y.
//  * Order of the sum: every output element sums its 16 products in the
//    fixed (a, b) order, each over C_in in slice order; no split-K, and the
//    block sizes are constants, so a row's result does not depend on B, P
//    or its place in the batch.
//  * Rasterisation: the CTA index runs over the output-channel blocks
//    first, so the CTAs resident together (132 on the card) cover about 7
//    row blocks x every channel block: they share each V row block (V is
//    the larger operand, 168 MB at 32^2 1280) and all of U's columns, and
//    their working set for one (a, b), ~5 MB, sits in the 50 MB L2.
//  * Ragged edges: TMA fills rows past P, channels past C_in and columns
//    past C_out with zeros; the epilogue masks rows >= P and columns >=
//    C_out. The channel blocks are padded to whole clusters: a CTA past
//    C_out loads its half of the V slice for its partner and stores nothing.
// ptxas -v (sm_90a, nvcc 12.9; scripts/ptxas_report.py): wino_fused_kernel
// 168 registers at launch (the consumers raise theirs to 232 with
// setmaxnreg), 192 bytes stack, 1828 bytes spill stores / 1660 loads (what
// of the partials does not fit, moved at the (a, b) boundaries, and a loop
// counter), 64 HGMMA.64x64x16 lines in its SASS; wino_input_kernel 62
// registers and 25600 bytes of shared memory, wino_gathered_input_kernel 80
// registers, neither spilling.
#include "hopper.cuh"  // mbarriers, TMA and its tensor maps, wgmma

namespace {

constexpr int BM = 128, BN = 64, BK = 64, STAGES = 6;
constexpr int CLUSTER = 2;                        // CTAs along C_out that share each V slice
constexpr int A_BOX_ROWS = BM / CLUSTER;          // the rows of a V slice each of them loads
constexpr int A_BYTES = BM * BK * 2;              // one V slice: 128 rows of 128 B
constexpr int B_BYTES = BK * BN * 2;              // one U slice: 64 rows of 128 B
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + STAGES * 16 + 1024;  // + barriers, alignment
constexpr int THREADS = 384;                      // producer + two consumer warpgroups
constexpr int IN_THREADS = 256;
constexpr int IN_TR = 4, IN_TC = 4, IN_CC = 64;   // K2 input transform: tiles x channels a CTA

// In fp32 with the SFU's approximate exp and reciprocal (each within 2 ulp):
// with an IEEE division the prologue made the input transform ALU-bound.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// ---- input transforms ------------------------------------------------------

// V = B^T d B for four channels; d[i][j][c], out: vbuf + the (tile, channel)
// offset, plane = P * cin elements between the 16 (a, b) planes.
__device__ __forceinline__ void store_v(const float (&cb)[4][4][4], __nv_bfloat16* out,
                                        size_t plane) {
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    float va[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      va[0][c] = cb[0][bb][c] - cb[2][bb][c];
      va[1][c] = cb[1][bb][c] + cb[2][bb][c];
      va[2][c] = cb[2][bb][c] - cb[1][bb][c];
      va[3][c] = cb[1][bb][c] - cb[3][bb][c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(va[a][0], va[a][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(va[a][2], va[a][3]);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (a * 4 + bb) * plane) = v;
    }
  }
}

// B^T on the columns of one patch row r[j][c]: cb[bb][c].
__device__ __forceinline__ void row_transform(const float (&r)[4][4], float (&cb)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cb[0][c] = r[0][c] - r[2][c];
    cb[1][c] = r[1][c] + r[2][c];
    cb[2][c] = r[2][c] - r[1][c];
    cb[3][c] = r[1][c] - r[3][c];
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// K2's input transform. A CTA takes IN_TR x IN_TC tiles x IN_CC channels of
// one image: it loads their (2 IN_TR + 2) x (2 IN_TC + 2) input pixels once,
// through the prologue, into shared memory as fp32 (the padding as 0), and
// then each thread transforms one (tile, 4 channels). So each pixel is
// loaded and put through the prologue ~1.6 times, not 4 (once for every
// patch that holds it). vbuf: (16, P, cin), P = bsz*(h/2)*(w/2).
__global__ void __launch_bounds__(IN_THREADS) wino_input_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ mult,
    const float* __restrict__ add, __nv_bfloat16* __restrict__ vbuf, int bsz, int h, int w,
    int cin) {
  constexpr int Q = IN_CC / 4, RR = 2 * IN_TR + 2, RC = 2 * IN_TC + 2;
  static_assert(IN_TR * IN_TC * Q == IN_THREADS, "one (tile, 4 channels) a thread");
  __shared__ float4 region[RR * RC * Q];  // [row][column][channel quad]
  const int th = h / 2, tw = w / 2, row_blocks = (th + IN_TR - 1) / IN_TR;
  const int tx0 = blockIdx.x * IN_TC, ty0 = (blockIdx.y % row_blocks) * IN_TR;
  const int b = blockIdx.y / row_blocks, c0 = blockIdx.z * IN_CC;
  for (int e = threadIdx.x; e < RR * RC * Q; e += IN_THREADS) {
    const int yy = 2 * ty0 - 1 + e / (Q * RC), xx = 2 * tx0 - 1 + (e / Q) % RC;
    const int ch = c0 + 4 * (e % Q);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ch < cin && yy >= 0 && yy < h && xx >= 0 && xx < w) {
      load4(x + (((size_t)b * h + yy) * w + xx) * cin + ch, v);
      if (mult != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = silu(v[c] * mult[(size_t)b * cin + ch + c] + add[(size_t)b * cin + ch + c]);
      }
    }
    region[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  const int q = threadIdx.x % Q, t = threadIdx.x / Q;
  const int ty = ty0 + t / IN_TC, tx = tx0 + t % IN_TC, ch = c0 + 4 * q;
  if (ty >= th || tx >= tw || ch >= cin) return;
  float cb[4][4][4];  // cb[i][bb][c]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 f = region[((2 * (t / IN_TC) + i) * RC + 2 * (t % IN_TC) + jj) * Q + q];
      r[jj][0] = f.x;
      r[jj][1] = f.y;
      r[jj][2] = f.z;
      r[jj][3] = f.w;
    }
    row_transform(r, cb[i]);
  }
  const size_t p = ((size_t)b * th + ty) * tw + tx;
  store_v(cb, vbuf + p * cin + ch, (size_t)bsz * th * tw * cin);
}

// K3's input transform. One thread per (tile, 4 input channels). tiles:
// (bsz * n_tiles, bh + 2, w + 4, cin), tile row 0 / column 0 being padded
// row t * bh / column -1 of the image; vbuf: (16, P, cin) with
// P = bsz * n_tiles * (bh/2) * (w/2) in (batch, tile, row, column) order,
// which is the (batch, row, column) order of the stacked padded height
// n_tiles * bh that the fused kernel writes.
__global__ void __launch_bounds__(IN_THREADS) wino_gathered_input_kernel(
    const __nv_bfloat16* __restrict__ tiles, __nv_bfloat16* __restrict__ vbuf,
    long long p_total, int bh, int w, int cin) {
  const int th = bh / 2, tw = w / 2, c4 = cin / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_total * c4) return;
  const int ch = (int)(idx % c4) * 4;
  const long long p = idx / c4;
  const int tx = (int)(p % tw);
  const int ty = (int)((p / tw) % th);
  const long long tile = p / ((long long)tw * th);
  const __nv_bfloat16* src =
      tiles + ((tile * (bh + 2) + 2 * ty) * (size_t)(w + 4) + 2 * tx) * cin + ch;
  float cb[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(src + ((size_t)i * (w + 4) + j) * cin, r[j]);
    row_transform(r, cb[i]);
  }
  store_v(cb, vbuf + (size_t)p * cin + ch, (size_t)p_total * cin);
}

// ---- cluster release ------------------------------------------------------

// A consumer warpgroup is done with a stage: tell the producer of every CTA
// that writes into it (each multicasts its part of the V slice).
__device__ __forceinline__ void release_stage(uint32_t empty_bar) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty_bar, r);
}

// ---- the fused kernel ------------------------------------------------------

// Y[i][j] += A^T[i,a] A^T[j,b] M[a,b] for (a, b) = (AB / 4, AB % 4),
// A^T = [[1,1,1,0],[0,1,-1,-1]]; part[2 i + j].
__host__ __device__ constexpr int at_coef(int i, int a) {
  return i == 0 ? (a < 3 ? 1 : 0) : (a == 0 ? 0 : (a == 1 ? 1 : -1));
}

template <int AB>
__device__ __forceinline__ void fold(const float (&m)[32], float (&part)[4][32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = at_coef(q / 2, AB / 4) * at_coef(q % 2, AB % 4);
    if (c == 0) continue;
#pragma unroll
    for (int r = 0; r < 32; ++r) part[q][r] += c > 0 ? m[r] : -m[r];
  }
}

struct Ring {
  uint32_t a, b, full, empty;  // shared addresses: V slices, U slices, barriers
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
// issued), `prev` is folded while those products run.
template <int AB>
__device__ __forceinline__ void consume_ab(float (&cur)[32], float (&prev)[32],
                                           float (&part)[4][32], Ring& ring, int k_chunks,
                                           uint32_t a_row_off, bool signaller) {
  for (int kc = 0; kc < k_chunks; ++kc) {
    mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t a = ring.a + ring.stage * A_BYTES + a_row_off;
    const uint32_t b = ring.b + ring.stage * B_BYTES;
    fence_operand(cur);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // V: K-major, 16 channels = 32 bytes along the swizzled row; 8-row
      // groups 1024 B apart. U: MN-major, 16 channels = 16 rows of 128 B.
      // U's leading offset (the stride between 64-column swizzle atoms) is
      // unused at BN 64, so both offsets are the 8-row group's 1024 B.
      wgmma_ss_m64n64k16<1>(cur, smem_desc(a + kk * 32, 16, 1024),
                     smem_desc(b + kk * 16 * 128, 1024, 1024), (kc | kk) != 0);
    wgmma_commit();
    fence_operand(cur);
    wgmma_wait<1>();
    if (kc > 0 || AB > 0) {
      const int done = ring.stage == 0 ? STAGES - 1 : ring.stage - 1;
      if (signaller) release_stage(ring.empty + 8 * done);
    }
    if constexpr (AB > 0) {
      if (kc == 0) {
        fence_operand(prev);
        fold<AB - 1>(prev, part);
      }
    }
    ring.advance();
  }
}

template <int AB>
__device__ __forceinline__ void consume_from(float (&acc0)[32], float (&acc1)[32],
                                             float (&part)[4][32], Ring& ring, int k_chunks,
                                             uint32_t a_row_off, bool signaller) {
  if constexpr (AB < 16) {
    if constexpr (AB % 2 == 0)
      consume_ab<AB>(acc0, acc1, part, ring, k_chunks, a_row_off, signaller);
    else
      consume_ab<AB>(acc1, acc0, part, ring, k_chunks, a_row_off, signaller);
    consume_from<AB + 1>(acc0, acc1, part, ring, k_chunks, a_row_off, signaller);
  }
}

// V (16, P, cin) and U (16, cin, cout) by TMA (tm_v, tm_u); y as the
// (bsz, h, w, cout) NHWC image of the P = bsz (h/2) (w/2) tiles.
__global__ void __launch_bounds__(THREADS, 1) wino_fused_kernel(
    __grid_constant__ const CUtensorMap tm_v, __grid_constant__ const CUtensorMap tm_u,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int p_total, int h, int w,
    int cin, int cout) {
  extern __shared__ uint8_t smem_raw[];
  Ring ring;
  ring.a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.b = ring.a + STAGES * A_BYTES;
  ring.full = ring.b + STAGES * B_BYTES;
  ring.empty = ring.full + STAGES * 8;
  ring.stage = 0;
  ring.phase = 0;
  // channel blocks first (L2), padded to whole clusters; a block past
  // C_out loads its part of the V slice for the others and stores nothing
  const int n_blocks = ((cout + BN - 1) / BN + CLUSTER - 1) / CLUSTER * CLUSTER;
  const int n0 = (int)(blockIdx.x % n_blocks) * BN;
  const int m0 = (int)(blockIdx.x / n_blocks) * BM;
  const int k_chunks = (cin + BK - 1) / BK;
  // warp-uniform by construction (a shuffle of lane 0's value), so the
  // compiler sees each role's region whole
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 2 * CLUSTER);  // each consumer warpgroup of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();  // every barrier of the cluster is set up before any arrives

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const uint32_t rank = cluster_rank();
      for (int ab = 0; ab < 16; ++ab)
        for (int kc = 0; kc < k_chunks; ++kc) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t bar = ring.full + 8 * ring.stage;
          mbar_expect_tx(bar, STAGE_BYTES);  // the whole V slice and this CTA's U slice
          tma_load_3d_multicast(ring.a + ring.stage * A_BYTES + rank * A_BOX_ROWS * 128, &tm_v,
                                bar, kc * BK, m0 + rank * A_BOX_ROWS, ab, (1u << CLUSTER) - 1);
          tma_load_3d(ring.b + ring.stage * B_BYTES, &tm_u, bar, n0, kc * BK, ab);
          ring.advance();
        }
      // The CTA stays until every consumer of the cluster has released its
      // last stages: their arrivals land on this CTA's barriers.
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1);
        ring.advance();
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const uint32_t a_row_off = (wg - 1) * 64 * 128;
    float acc0[32], acc1[32], part[4][32];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 32; ++r) part[q][r] = 0.f;
    consume_from<0>(acc0, acc1, part, ring, k_chunks, a_row_off, t == 0);
    wgmma_wait<0>();
    fence_operand(acc1);
    if (t == 0) release_stage(ring.empty + 8 * (ring.stage == 0 ? STAGES - 1 : ring.stage - 1));
    fold<15>(acc1, part);

    // Epilogue. Accumulator fragment of m64nN: warp q of the warpgroup holds
    // rows 16 q + lane / 4 (+ 8), columns 8 n + 2 (lane % 4) (+ 1).
    const int lane = t % 32, row0 = m0 + (wg - 1) * 64 + (t / 32) * 16 + lane / 4;
    const int th = h / 2, tw = w / 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = row0 + 8 * hh;
      if (p >= p_total) continue;
      const int tx = p % tw, ty = (p / tw) % th, bi = p / (tw * th);
      __nv_bfloat16* yb = y + (((size_t)bi * h + 2 * ty) * w + 2 * tx) * cout;
#pragma unroll
      for (int ni = 0; ni < BN / 8; ++ni) {
        const int co = n0 + 8 * ni + 2 * (lane % 4);
        if (co >= cout) continue;
        const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(part[q][4 * ni + 2 * hh] + b0,
                                                         part[q][4 * ni + 2 * hh + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(yb + ((size_t)(q / 2) * w + q % 2) * cout + co) =
              v;
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

// The 16 products and the output transform after an input transform filled
// vbuf: y (bsz, h, w, cout) from P = bsz * (h/2) * (w/2) tiles.
cudaError_t fused_gemm_output(const void* vbuf, const void* u, const void* bias, void* y,
                              int bsz, int h, int w, int cin, int cout, cudaStream_t s) {
  const long long p_total = (long long)bsz * (h / 2) * (w / 2);
  if (p_total > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_v, tm_u;
  if (!make_map(&tm_v, vbuf, 16, p_total, cin, BK, A_BOX_ROWS) ||
      !make_map(&tm_u, u, 16, cin, cout, BN, BK))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(wino_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long n_blocks = ((cout + BN - 1) / BN + CLUSTER - 1) / CLUSTER * CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p_total + BM - 1) / BM) * n_blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wino_fused_kernel, tm_v, tm_u, static_cast<const float*>(bias),
                           static_cast<__nv_bfloat16*>(y), (int)p_total, h, w, cin, cout);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x: (bsz, h, w, cin) bf16; u: (16, cin, cout) bf16, 16-byte aligned; x 8-byte aligned; bias:
// (cout,) fp32; mult/add: (bsz, cin) fp32 or both null (no prologue); vbuf:
// (16, P, cin) bf16 scratch, P = bsz*(h/2)*(w/2); y: (bsz, h, w, cout)
// bf16. h, w even; cin % 8 == 0; cout % 8 == 0.
extern "C" int mdt_winograd_conv3x3(const void* x, const void* u, const void* bias,
                                    const void* mult, const void* add, void* vbuf, void* y,
                                    int bsz, int h, int w, int cin, int cout, void* stream) {
  if (h % 2 || w % 2 || cin % 8 || cout % 8) return (int)cudaErrorInvalidValue;
  if ((mult == nullptr) != (add == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 8) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * (h / 2) * (w / 2);
  if (p_total == 0) return 0;
  const long long row_blocks = (long long)bsz * ((h / 2 + IN_TR - 1) / IN_TR);
  if (row_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w / 2 + IN_TC - 1) / IN_TC, (unsigned)row_blocks, (cin + IN_CC - 1) / IN_CC);
  wino_input_kernel<<<grid, IN_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mult),
      static_cast<const float*>(add), static_cast<__nv_bfloat16*>(vbuf), bsz, h, w, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fused_gemm_output(vbuf, u, bias, y, bsz, h, w, cin, cout, s);
}

// tiles: (bsz, n_tiles, bh + 2, w + 4, cin) bf16, the zero-padded (and, for
// a GN conv, already normalised) input gathered into overlapping row
// windows; u, bias, vbuf as above with P = bsz*n_tiles*(bh/2)*(w/2);
// y: (bsz, n_tiles * bh, w, cout) bf16. bh, w even; cin % 8 == 0;
// cout % 8 == 0.
extern "C" int mdt_winograd_conv3x3_gathered(const void* tiles, const void* u,
                                             const void* bias, void* vbuf, void* y, int bsz,
                                             int n_tiles, int bh, int w, int cin, int cout,
                                             void* stream) {
  if (bh % 2 || w % 2 || cin % 8 || cout % 8 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tiles) % 8) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long p_total = (long long)bsz * n_tiles * (bh / 2) * (w / 2);
  if (p_total == 0) return 0;
  const long long work = p_total * (cin / 4);
  wino_gathered_input_kernel<<<(unsigned)((work + IN_THREADS - 1) / IN_THREADS), IN_THREADS,
                               0, s>>>(static_cast<const __nv_bfloat16*>(tiles),
                                       static_cast<__nv_bfloat16*>(vbuf), p_total, bh, w, cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fused_gemm_output(vbuf, u, bias, y, bsz, n_tiles * bh, w, cin, cout, s);
}
