// Fused LayerNorm -> GEGLU feed-forward -> residual on Hopper (sm_90a):
//   y = x + (a * gelu_tanh(g)) W2^T + b2,  [a || g] = LN(x) W1^T + b1,
// on x (M = B*N rows, C) bf16, W1 (2F, C) (the value half's F rows first),
// W2 (C, F), LN weight / bias, b1, b2 in bf16. This is the third sub-block of
// every SD transformer block, `x + ff(norm3(x))`.
//
// Replaces the TPU kernel benchmarks/research/fused_ff.py `_ff_kernel`
// (pallas_call in `fused_ln_geglu_ff`). Numerics follow it: LN statistics in
// fp32 with var = E[x^2] - mu^2, the normalised row rounded to bf16, both
// products with bf16 operands and fp32 accumulation (wgmma), b1 added and
// the tanh GELU applied in fp32 (tanh.approx.f32, ~2^-11 relative, below the
// bf16 rounding that follows), the GEGLU product U rounded to bf16 before
// the second product, b2 and the residual added in fp32, the result rounded
// to bf16 once. Both plans below round at the same points, so they give
// the same numbers up to the order of the fp32 sums.
//
// What bounds it on the H100: 6 M C F flops against reading x and the
// weights once and writing y, so the tensor cores (ds1, (16, 4096, 320), F
// 1280: 1.61e11 flops, 0.163 ms). The TPU kernel held both weight matrices
// and a 256-row tile in VMEM and never wrote the (M, 2F) intermediate to
// HBM. Here every CTA streams the weights through its shared memory, at
// one multiply-add a row for each byte, so the rows that share a streamed
// tile set the bytes an SM must take in per flop; TMA delivered about 30
// bytes a clock into an SM in these kernels, which at 128 rows a CTA is
// near what the tensor cores need. ops/fused_ff.py `ff_plan` picks one of
// two plans by C; both compute 6 M C F flops (no recompute).
//
// Regime F, fully fused (C 320: SD2's and Wukong's ds1), ff_fused_kernel:
//  * CTA: warpgroup 0 the producer (one thread issues TMA; setmaxnreg 40),
//    warpgroups 1 and 2 consumers of 64 rows each (setmaxnreg 232): 128
//    rows. CTAs run in 2-CTA clusters along M, and every weight box is
//    loaded by one CTA of the pair and multicast into both, so each weight
//    byte read from L2 serves 256 rows.
//  * LN: each consumer warpgroup normalises its 64 rows (a warp a row, x in
//    registers, 8 rows' loads in flight) into the 128 x 320 bf16 A tile,
//    five 64-column boxes in TMA's 128-byte swizzle (80 KB).
//  * The ring (14 slots of 10 KB, full / empty mbarriers; a slot is freed
//    by all four consumer warpgroups of the pair): for each 32-wide chunk
//    of F, five W1 stages (value rows f0.. and gate rows F + f0.., 32 each,
//    x one 64-column box of C: 8 KB) and two W2 stages (160 output rows x
//    the chunk's 32 columns, 64-byte swizzled: 10 KB).
//  * First product: wgmma m64n64k16, A the LN tile, B the W1 stage (both
//    K-major as stored), 20 k16 steps: the value and gate columns of a U
//    column land in the same thread. GEGLU in registers after the
//    product's wgmma_wait (accumulators touched under a running wgmma make
//    ptxas serialize them), U rounded to bf16 and packed straight into the
//    A fragments of the second product; U never reaches shared memory.
//  * Second product: wgmma RS m64n160k16 twice (output columns 0-159 and
//    160-319), into the 64 x 320 fp32 output tile held in registers (160 a
//    thread) across all of F, committed without a wait: it runs while the
//    next chunk's first product is issued.
//  * Why 32-wide chunks: the output tile (160) and a 64-wide chunk's first
//    accumulators (64) leave no room under 232 (or 240) registers a thread;
//    at 32 (32 + 160 + 8 for U's fragments) nothing spills. Its W2 boxes
//    are 64 bytes wide, hence the 64-byte swizzle.
//  * Epilogue: once its last first product is done, a warpgroup's rows of
//    the A tile are free; x's rows arrive there by TMA while the last GEGLU
//    and second product run, y = x + (acc + b2) overwrites them in place,
//    and TMA stores them (stores straight from registers took half of
//    qkv_proj_kernel's time, attn_variants.cu).
//  * Rows past M: LN writes zeros, TMA reads x as zeros and clips the store.
//    A cluster covers 256 rows, so the grid is 2 ceil(M / 256) CTAs.
//  * Where the time goes (device ms at ds1 on an H100 SXM, 700 W;
//    scripts/ff_ablate.py): 0.309-0.313 in all, ~520 TFLOP/s; without the
//    products 0.195-0.197 (the weight stream alone: ~27 bytes a clock into
//    an SM), without the loads 0.302-0.308, without the second product
//    0.190-0.197, without the first 0.242-0.245, GEGLU as a + g 0.282-0.284,
//    no LN 0.291-0.293, half the ring 0.309-0.313. The weight stream and
//    the product chain each take most of the time and overlap only in part.
//  * Tried and dropped (scripts/ff_ablate.py --source, in one call with
//    this kernel's 0.309): the chunk loop software-pipelined (chunk j's
//    first product issued with chunk j - 1's second, GEGLU under the
//    latter, U's fragments double-buffered, b1 as the accumulators' start,
//    setmaxnreg 240 / 24): it spills, 0.317; the second product on SS, U
//    through a shared tile: 0.319; 64-wide chunks with an m64n128 first
//    product (U through shared memory): it spills, 2.210.
//
// Regime H, U through HBM once (C 640 and 1280: ds2, ds4; the 64 x C
// output tile would not fit one warpgroup's registers): three launches.
//  * ff_ln_kernel: the normalised rows h (M, C) in bf16 (a warp a row), the
//    rounding point the fused plan has too.
//  * ff_up_kernel: U = GEGLU(h W1^T + b1), (M, F) bf16; ff_down_kernel: y =
//    x + U W2^T + b2. One persistent wgmma GEMM (gemm_cta<UP>, after
//    qkv_proj_kernel): 128-row tiles, one CTA an SM walking tiles columns
//    first (the CTAs resident together share A's rows in L2), two consumer
//    warpgroups, A and B K-major as stored. The up tile is 128 U columns:
//    B is their 128 value and 128 gate rows of W1 (m64n256k16, 4 stages of
//    48 KB), so its epilogue applies GEGLU in registers; the down tile is
//    128 output columns (m64n128k16, 6 stages of 32 KB), and its last stage
//    brings x's 128 x 128 tile, which the epilogue adds. Outputs go through
//    shared memory and TMA stores.
//  * Cost against a fused plan: U's round trip, 4 M F bytes (168 MB at ds2,
//    84 MB at ds4), against the recompute of the first product that a
//    column-split fused plan pays at C 640 and 1280 (2x and 4x).
//  * Device ms (H100 SXM, 700 W; scripts/ff_ablate.py): ds2 0.249-0.272
//    (LN 0.015, up 0.160-0.174, down 0.073-0.082), ds4 0.281 (0.010, 0.174,
//    0.097); the up tile at 128 x 128 took 0.179 and 0.194 in the same
//    call. Without the loads the up GEMM takes 0.159 / 0.145: the stream
//    of A and B into the SM.
//
// ptxas -v (sm_90a; scripts/ptxas_report.py fused_ff): ff_fused_kernel,
// ff_up_kernel and ff_down_kernel 168 registers at launch (the consumers
// raise theirs with setmaxnreg), no spills, HGMMA only; no mma.sync in
// this file. chip_smoke.py phase 18 holds both plans and prints the plan,
// the device ms and the bound.
#include "hopper.cuh"  // mbarriers, TMA and its tensor maps, wgmma

namespace {

constexpr int SMEM_MAX = 232448;        // a block's shared memory on the H100
constexpr int SLACK = 1024;             // the 1024-byte alignment of the tiles
constexpr int CLUSTER = 2;              // regime F: CTAs that share each weight box

// ---- regime F ---------------------------------------------------------------
constexpr int F_C = 320;                // the width regime F takes
constexpr int F_KB = F_C / 64;          // 64-column boxes of the LN tile
constexpr int F_ROWS = 128;             // rows a CTA: two consumer warpgroups
constexpr int FC = 32;                  // F columns a chunk (value and gate each)
constexpr int A_BOX = F_ROWS * 128;     // one 64-column box of the LN tile: 16 KB
constexpr int A_BYTES = F_KB * A_BOX;   // the LN tile: 80 KB
constexpr int W1_BOX = FC * 128;        // 32 W1 rows x 64 columns: 4 KB
constexpr int W1_STAGE = 2 * W1_BOX;    // the chunk's value and gate rows
constexpr int W2_ROWS = 160;            // output columns of a W2 stage: one m64n160 product
constexpr int W2_BOX = W2_ROWS / CLUSTER * FC * 2;   // 80 rows x 64 bytes: 5 KB
constexpr int SLOT = W2_ROWS * FC * 2;  // a W2 stage: 10 KB (a W1 stage uses 8 of it)
constexpr int F_BARS = 256;             // the ring's full / empty barriers and x's two
constexpr int F_STAGES = (SMEM_MAX - SLACK - A_BYTES - F_BARS) / SLOT;   // 14
constexpr int F_SMEM = SLACK + A_BYTES + F_STAGES * SLOT + F_BARS;
constexpr int LN_ROWS = 8;              // rows whose loads a warp keeps in flight
static_assert(2 * 8 * F_STAGES + 16 <= F_BARS, "barriers");

// ---- regime H ---------------------------------------------------------------
constexpr int G_BM = 128;               // rows of a GEMM tile
constexpr int G_BOX = 64 * 128;         // 64 rows x 64 columns: 8 KB
constexpr int G_A = G_BM * 128;         // an A box of 128 rows: 16 KB
constexpr int G_OUT = 2 * G_BOX;        // a consumer's 64 x 128 output tile
// The up GEMM's tile: 128 rows x 256 (128 value and the 128 matching gate
// columns: 128 U columns), 4 stages of 48 KB; the down GEMM's: 128 x 128
// output columns, 6 stages of 32 KB (A and B, or x's two boxes).
template <bool UP>
struct Gemm {
  static constexpr int BN = UP ? 256 : 128;
  static constexpr int STAGE = G_A + BN * 128;
  static constexpr int STAGES = UP ? 4 : 6;
  static constexpr int SMEM = SLACK + STAGES * STAGE + 2 * G_OUT + 16 * STAGES;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};
constexpr int LN_THREADS = 256;
constexpr int MAX_C = 1280;             // ff_ln_kernel: 5 16-byte chunks a lane
static_assert(F_SMEM <= SMEM_MAX, "shared memory");

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
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

// a * gelu_tanh(g), in fp32
__device__ __forceinline__ float geglu(float a, float g) {
  const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return a * (g * (0.5f * (1.f + tanh_fast(inner))));
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// The LayerNorm of one row held by a warp: this lane's 16-byte chunks q =
// lane + 32 i (i < NV) of x, and of the affine's weight and bias at the
// same columns (chunks with q >= c / 8 hold zeros). Statistics in fp32,
// var = E[x^2] - mu^2; the normalised values rounded to bf16 (zeros where
// the row is past M).
template <int NV>
__device__ __forceinline__ void layer_norm(const uint4 (&v)[NV], const uint4 (&w)[NV],
                                           const uint4 (&b)[NV], int c, float eps, bool valid,
                                           uint4 (&out)[NV]) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = bf(e[j]);
      s += f;
      s2 += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mu = s / c, rstd = rsqrtf(s2 / c - mu * mu + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[i]);
    const __nv_bfloat16* ew = reinterpret_cast<const __nv_bfloat16*>(&w[i]);
    const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&b[i]);
    uint4 o = make_uint4(0, 0, 0, 0);
    __nv_bfloat16* eo = reinterpret_cast<__nv_bfloat16*>(&o);
    if (valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) eo[j] = __float2bfloat16((bf(e[j]) - mu) * rstd * bf(ew[j]) + bf(eb[j]));
    }
    out[i] = o;
  }
}

// This lane's chunks q = lane + 32 i of the c-wide bf16 row at p (zeros
// past c / 8 or where !valid).
template <int NV>
__device__ __forceinline__ void load_chunks(const __nv_bfloat16* p, int c, int lane, bool valid,
                                            uint4 (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int q = lane + 32 * i;
    v[i] = valid && q < c / 8 ? ldg16(p + 8 * q) : make_uint4(0, 0, 0, 0);
  }
}

// Release ring stage `bar` on both CTAs of the pair (each multicast half of
// every stage into both).
__device__ __forceinline__ void release_pair(uint32_t bar) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(bar, r);
}

// ---- regime F: the fused kernel ---------------------------------------------

// tm_w1: W1 (2f, 320) with 64 x 32 boxes; tm_w2: W2 (320, f) with 32 x 80
// boxes (64-byte swizzle); tm_x, tm_y: x and y (m, 320) with 64 x 64 boxes.
__global__ void __launch_bounds__(384, 1) ff_fused_kernel(
    const __grid_constant__ CUtensorMap tm_w1, const __grid_constant__ CUtensorMap tm_w2,
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_y,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_w,
    const __nv_bfloat16* __restrict__ ln_b, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ b2, int m, int f, float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t atile = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = atile + A_BYTES;
  const uint32_t full = ring + F_STAGES * SLOT, empty = full + 8 * F_STAGES;
  const uint32_t xbar = empty + 8 * F_STAGES;
  const uint32_t rank = cluster_rank();
  const int m0 = blockIdx.x * F_ROWS, chunks = f / FC;
  // warp-uniform by construction, so the compiler sees each role whole
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * CLUSTER);   // every consumer warpgroup of the pair
    }
    mbar_init(xbar, 1);
    mbar_init(xbar + 8, 1);
    fence_barrier_init();
  }
  cluster_sync();   // both CTAs' barriers are set up before any load or arrival

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < chunks; ++j) {
        const int f0 = j * FC;
        for (int k = 0; k < F_KB; ++k) {   // rank 0 the value rows, rank 1 the gate rows
          const uint32_t bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, W1_STAGE);
          tma_load_3d_multicast(ring + stage * SLOT + rank * W1_BOX, &tm_w1, bar, 64 * k,
                                (int)rank * f + f0, 0, (1u << CLUSTER) - 1);
          advance(stage, phase, F_STAGES);
        }
        for (int h = 0; h < 2; ++h) {      // output rows 160 h + 80 rank ..
          const uint32_t bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, SLOT);
          tma_load_3d_multicast(ring + stage * SLOT + rank * W2_BOX, &tm_w2, bar, f0,
                                h * W2_ROWS + (int)rank * (W2_ROWS / CLUSTER), 0,
                                (1u << CLUSTER) - 1);
          advance(stage, phase, F_STAGES);
        }
      }
      // The CTA stays until the pair's consumers have released every stage:
      // their arrivals land on this CTA's barriers.
      for (int s = 0; s < F_STAGES; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        advance(stage, phase, F_STAGES);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ci = wg - 1, t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;   // rows r0, r0 + 8 of the 64
  const uint32_t arows = atile + ci * 64 * 128;   // this warpgroup's rows of box 0
  const int row0 = m0 + ci * 64;                  // its first row of x

  // LN of the warpgroup's 64 rows into its rows of the A tile: warp w takes
  // rows 16 w .. 16 w + 15, LN_ROWS at a time.
  {
    constexpr int NV = 2;   // 40 chunks of 8 columns a row
    uint4 w[NV], b[NV];
    load_chunks<NV>(ln_w, F_C, lane, true, w);
    load_chunks<NV>(ln_b, F_C, lane, true, b);
#pragma unroll 1
    for (int rb = 0; rb < 16; rb += LN_ROWS) {
      uint4 v[LN_ROWS][NV];
#pragma unroll
      for (int rr = 0; rr < LN_ROWS; ++rr) {
        const int row = row0 + warp * 16 + rb + rr;
        load_chunks<NV>(x + (size_t)row * F_C, F_C, lane, row < m, v[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < LN_ROWS; ++rr) {
        const int r = warp * 16 + rb + rr;
        uint4 o[NV];
        layer_norm<NV>(v[rr], w, b, F_C, eps, row0 + r < m, o);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int q = lane + 32 * i;
          if (q < F_C / 8)
            sts128(arows + (q / 8) * A_BOX + r * 128 + (((q % 8) ^ (r % 8)) << 4), o[i]);
        }
      }
    }
  }
  fence_proxy_async();   // the tile's stores before wgmma reads it
  named_barrier_sync(1 + ci, 128);

  float acc2a[80], acc2b[80];   // y's columns 0-159 and 160-319, fp32, across all of F
  float acc1[32];               // [a || g] of the chunk: value columns 0-31, gate 32-63
  uint32_t ua[2][4];            // U of the chunk, bf16: the A fragments of its two k16 slices
  int stage = 0;
  uint32_t phase = 0;
  int rel_a = -1, rel_b = -1;   // the stages of the group issued before the newest
  auto release = [&](int s) {
    if (t128 == 0 && s >= 0) release_pair(empty + 8 * s);
  };
  for (int j = 0; j < chunks; ++j) {
    const int f0 = j * FC;
    uint32_t bv[4], bg[4];   // b1 at this thread's value and gate columns of the chunk (bf16 pairs)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bv[q] = ld32(b1 + f0 + 8 * q + 2 * t);
      bg[q] = ld32(b1 + f + f0 + 8 * q + 2 * t);
    }
    // [a || g] = LN(x) W1^T over the five 64-column boxes of C
    for (int k = 0; k < F_KB; ++k) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t slot = ring + stage * SLOT;
      fence_operand(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16<0>(acc1, smem_desc(arows + k * A_BOX + kk * 32, 16, 1024),
                              smem_desc(slot + kk * 32, 16, 1024), (k | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();   // the group before it (the last W1 stage, or the last chunk's U W2) is done
      fence_operand(acc1);
      release(rel_a);
      release(rel_b);
      rel_a = stage;
      rel_b = -1;
      advance(stage, phase, F_STAGES);
    }
    wgmma_wait<0>();
    fence_operand(acc1);
    release(rel_a);
    rel_a = -1;
    if (j == chunks - 1) {
      // The warpgroup's rows of the A tile are read for the last time: x's
      // rows come there for the epilogue while the last U W2 runs.
      named_barrier_sync(1 + ci, 128);
      if (t128 == 0) {
        mbar_expect_tx(xbar + 8 * ci, F_KB * 64 * 128);
        for (int k = 0; k < F_KB; ++k)
          tma_load_3d(arows + k * A_BOX, &tm_x, xbar + 8 * ci, 64 * k, row0, 0);
      }
    }
    // U = (a + b1) * gelu(g + b1) in fp32, rounded to bf16: accumulator
    // quad q holds U's columns 8 q + 2 t, + 1 (rows r0, r0 + 8), the gate's
    // quad q + 4 the same columns; slice s of U is quads 2 s and 2 s + 1.
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int q = 2 * s + hq;
        const float2 v = unpack_bf16(bv[q]), gb = unpack_bf16(bg[q]);
        ua[s][2 * hq] = pack_bf16(geglu(acc1[4 * q] + v.x, acc1[4 * q + 16] + gb.x),
                                  geglu(acc1[4 * q + 1] + v.y, acc1[4 * q + 17] + gb.y));
        ua[s][2 * hq + 1] = pack_bf16(geglu(acc1[4 * q + 2] + v.x, acc1[4 * q + 18] + gb.x),
                                      geglu(acc1[4 * q + 3] + v.y, acc1[4 * q + 19] + gb.y));
      }
    // y += U W2^T: both W2 stages of the chunk, U from registers
    const int s0 = stage;
    mbar_wait(full + 8 * stage, phase);
    advance(stage, phase, F_STAGES);
    const int s1 = stage;
    mbar_wait(full + 8 * stage, phase);
    advance(stage, phase, F_STAGES);
    fence_operand(ua);
    fence_operand(acc2a);
    fence_operand(acc2b);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wgmma_rs_m64n160k16<0>(acc2a, ua[s], smem_desc(ring + s0 * SLOT + s * 32, 16, 512, 2),
                             (j | s) != 0);
      wgmma_rs_m64n160k16<0>(acc2b, ua[s], smem_desc(ring + s1 * SLOT + s * 32, 16, 512, 2),
                             (j | s) != 0);
    }
    wgmma_commit();
    rel_a = s0;
    rel_b = s1;
  }
  wgmma_wait<0>();
  fence_operand(acc2a);
  fence_operand(acc2b);
  fence_operand(ua);
  release(rel_a);
  release(rel_b);

  // y = x + (acc + b2), rounded once, in place of x in the tile, then TMA
  mbar_wait(xbar + 8 * ci, 0);
#pragma unroll
  for (int q = 0; q < 40; ++q) {
    const int col = 8 * q + 2 * t, box = col / 64, cb = col % 64;
    const float2 bb = ld_bf2(b2 + col);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const uint32_t addr = arows + box * A_BOX + swizzle128(r0 + 8 * hr, cb);
      const float2 xv = unpack_bf16(lds32(addr));
      const float a0 = q < 20 ? acc2a[4 * q + 2 * hr] : acc2b[4 * (q - 20) + 2 * hr];
      const float a1 = q < 20 ? acc2a[4 * q + 2 * hr + 1] : acc2b[4 * (q - 20) + 2 * hr + 1];
      sts32(addr, pack_bf16(xv.x + (a0 + bb.x), xv.y + (a1 + bb.y)));
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + ci, 128);
  if (t128 == 0 && row0 < m) {
    for (int k = 0; k < F_KB; ++k) tma_store_3d(&tm_y, arows + k * A_BOX, 64 * k, row0, 0);
    tma_store_commit();
    tma_store_wait<0, true>();   // the tile is read before the CTA's shared memory goes
  }
}

// ---- regime H: LN pass and the two GEMMs ------------------------------------

template <int NV>
__global__ void __launch_bounds__(LN_THREADS) ff_ln_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln_w,
    const __nv_bfloat16* __restrict__ ln_b, __nv_bfloat16* __restrict__ h, int m, int c,
    float eps) {
  const int lane = threadIdx.x % 32;
  uint4 w[NV], b[NV];
  load_chunks<NV>(ln_w, c, lane, true, w);
  load_chunks<NV>(ln_b, c, lane, true, b);
  const int warps = gridDim.x * (LN_THREADS / 32);
  for (int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32; row < m; row += warps) {
    uint4 v[NV], o[NV];
    load_chunks<NV>(x + (size_t)row * c, c, lane, true, v);
    layer_norm<NV>(v, w, b, c, eps, true, o);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = lane + 32 * i;
      if (q < c / 8) *reinterpret_cast<uint4*>(h + (size_t)row * c + 8 * q) = o[i];
    }
  }
}

// One persistent GEMM CTA. UP: U (m, f) = GEGLU(h (m, c) W1^T + b1), a tile
// 128 rows x 128 U columns, B the tile's 128 value and 128 gate rows of W1
// (2f, c). Else: y (m, c) = x + U (m, f) W2^T + b2, a tile 128 rows x 128
// output columns, B W2's (c, f) rows n0 .. n0 + 127, then x's tile as one
// more stage. tm_a: h or U with 64 x 128 boxes; tm_b: W1 with 64 x 128 or
// W2 with 64 x 64 boxes; tm_x: x with 64 x 128 boxes (down); tm_o: U or y
// with 64 x 64.
template <bool UP>
__device__ __forceinline__ void gemm_cta(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                         const CUtensorMap* tm_x, const CUtensorMap* tm_o,
                                         const __nv_bfloat16* __restrict__ bias, int m, int c,
                                         int f) {
  using G = Gemm<UP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_tiles = base + G::STAGES * G::STAGE;
  const uint32_t full = out_tiles + 2 * G_OUT, empty = full + 8 * G::STAGES;
  const int k_chunks = UP ? c / 64 : (f + 63) / 64;   // U's last chunk: TMA's zero fill past f
  const int tiles_n = UP ? (f + 127) / 128 : (c + 127) / 128;   // 128 output columns a tile
  const int tiles = (m + G_BM - 1) / G_BM * tiles_n;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * G_BM, n0 = tile % tiles_n * 128;
        // the down tile's second 64 columns, where they are inside c
        const bool two = UP || n0 + 64 < c;
        for (int kc = 0; kc < k_chunks; ++kc) {
          const uint32_t slot = base + stage * G::STAGE, bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          tma_load_3d(slot, tm_a, bar, 64 * kc, m0, 0);
          if constexpr (UP) {   // the value rows n0 .., then the gate rows f + n0 ..
            mbar_expect_tx(bar, G::STAGE);
            tma_load_3d(slot + G_A, tm_b, bar, 64 * kc, n0, 0);
            tma_load_3d(slot + G_A + 2 * G_BOX, tm_b, bar, 64 * kc, f + n0, 0);
          } else {
            mbar_expect_tx(bar, G_A + (two ? 2 : 1) * G_BOX);
            tma_load_3d(slot + G_A, tm_b, bar, 64 * kc, n0, 0);
            if (two) tma_load_3d(slot + G_A + G_BOX, tm_b, bar, 64 * kc, n0 + 64, 0);
          }
          advance(stage, phase, G::STAGES);
        }
        if (!UP) {
          const uint32_t slot = base + stage * G::STAGE, bar = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, (two ? 2 : 1) * G_A);
          tma_load_3d(slot, tm_x, bar, n0, m0, 0);
          if (two) tma_load_3d(slot + G_A, tm_x, bar, n0 + 64, m0, 0);
          advance(stage, phase, G::STAGES);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ci = wg - 1, t128 = threadIdx.x % 128, lane = t128 % 32, t = lane % 4;
  const int r0 = (t128 / 32) * 16 + lane / 4;   // rows r0, r0 + 8 of this warpgroup's 64
  const uint32_t out_tile = out_tiles + ci * G_OUT;
  const int n_out = UP ? f : c;   // the output's columns
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * G_BM, n0 = tile % tiles_n * 128;
    float acc[G::BN / 2];
    int pend = -1;
    for (int kc = 0; kc < k_chunks; ++kc) {
      const uint32_t slot = base + stage * G::STAGE;
      mbar_wait(full + 8 * stage, phase);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<G::BN, 0>(acc, smem_desc(slot + ci * G_BOX + kk * 32, 16, 1024),
                           smem_desc(slot + G_A + kk * 32, 16, 1024), (kc | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operand(acc);
      if (t128 == 0 && pend >= 0) mbar_arrive(empty + 8 * pend);
      pend = stage;
      advance(stage, phase, G::STAGES);
    }
    wgmma_wait<0>();
    fence_operand(acc);
    if (t128 == 0) {
      mbar_arrive(empty + 8 * pend);
      tma_store_wait<0, true>();   // the last tile's stores have read out_tile
    }
    named_barrier_sync(1 + ci, 128);
    if constexpr (UP) {
      // accumulator quad q: value columns 8 q + 2 t, + 1; quad q + 16: the gate's
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int u = 8 * q + 2 * t;
        const bool in = n0 + u < f;
        const float2 bv = in ? ld_bf2(bias + n0 + u) : make_float2(0.f, 0.f);
        const float2 bg = in ? ld_bf2(bias + f + n0 + u) : make_float2(0.f, 0.f);
        const uint32_t box = out_tile + (q / 8) * G_BOX;
        sts32(box + swizzle128(r0, u % 64),
              pack_bf16(geglu(acc[4 * q] + bv.x, acc[4 * q + 64] + bg.x),
                        geglu(acc[4 * q + 1] + bv.y, acc[4 * q + 65] + bg.y)));
        sts32(box + swizzle128(r0 + 8, u % 64),
              pack_bf16(geglu(acc[4 * q + 2] + bv.x, acc[4 * q + 66] + bg.x),
                        geglu(acc[4 * q + 3] + bv.y, acc[4 * q + 67] + bg.y)));
      }
    } else {
      // x's tile: two 64-column boxes of 128 rows in the stage after the products'
      const uint32_t xs = base + stage * G::STAGE;
      mbar_wait(full + 8 * stage, phase);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int col = 8 * q + 2 * t, box = q / 8, cb = col % 64;
        const float2 bb = n0 + col < c ? ld_bf2(bias + n0 + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          const float2 xv = unpack_bf16(lds32(xs + box * G_A + swizzle128(ci * 64 + r, cb)));
          sts32(out_tile + box * G_BOX + swizzle128(r, cb),
                pack_bf16(xv.x + (acc[4 * q + 2 * hr] + bb.x),
                          xv.y + (acc[4 * q + 2 * hr + 1] + bb.y)));
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + ci, 128);
    if (t128 == 0) {
      if (!UP) mbar_arrive(empty + 8 * stage);   // x's stage is read
      tma_store_3d(tm_o, out_tile, n0, m0 + ci * 64, 0);
      if (n0 + 64 < n_out) tma_store_3d(tm_o, out_tile + G_BOX, n0 + 64, m0 + ci * 64, 0);
      tma_store_commit();
    }
    if (!UP) advance(stage, phase, G::STAGES);
  }
  if (t128 == 0) tma_store_wait<0, false>();
}

__global__ void __launch_bounds__(384, 1) ff_up_kernel(
    const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_u, const __nv_bfloat16* __restrict__ b1, int m, int c,
    int f) {
  gemm_cta<true>(&tm_h, &tm_w1, nullptr, &tm_u, b1, m, c, f);
}

__global__ void __launch_bounds__(384, 1) ff_down_kernel(
    const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_w2,
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_y,
    const __nv_bfloat16* __restrict__ b2, int m, int c, int f) {
  gemm_cta<false>(&tm_u, &tm_w2, &tm_x, &tm_y, b2, m, c, f);
}

// ---- host side --------------------------------------------------------------

// Raise a kernel's shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kern, int bytes, int (&raised)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && raised[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) raised[dev] = bytes;
  return err;
}

cudaError_t launch_fused(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int m, int f,
                         float eps, int ctas, cudaStream_t s) {
  if (ctas % CLUSTER || (long long)ctas * F_ROWS < m) return cudaErrorInvalidValue;
  CUtensorMap tm_w1, tm_w2, tm_x, tm_y;
  if (!make_map(&tm_w1, w1, 1, 2LL * f, F_C, 64, FC) ||
      !make_map(&tm_w2, w2, 1, F_C, f, FC, W2_ROWS / CLUSTER, 0, 0, false,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&tm_x, x, 1, m, F_C, 64, 64) || !make_map(&tm_y, out, 1, m, F_C, 64, 64))
    return cudaErrorInvalidValue;
  static int raised[64] = {};
  cudaError_t err = allow_smem(ff_fused_kernel, F_SMEM, raised);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = F_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ff_fused_kernel, tm_w1, tm_w2, tm_x, tm_y,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(ln_w),
                           static_cast<const __nv_bfloat16*>(ln_b),
                           static_cast<const __nv_bfloat16*>(b1),
                           static_cast<const __nv_bfloat16*>(b2), m, f, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_ln(const void* x, const void* ln_w, const void* ln_b, void* h, int m, int c,
                      float eps, int grid, cudaStream_t s) {
  ff_ln_kernel<NV><<<grid, LN_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln_w),
      static_cast<const __nv_bfloat16*>(ln_b), static_cast<__nv_bfloat16*>(h), m, c, eps);
  return cudaGetLastError();
}

cudaError_t launch_split(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, void* h,
                         void* u, int m, int c, int f, float eps, int ln_grid, int up_grid,
                         int down_grid, cudaStream_t s) {
  if (h == nullptr || u == nullptr || ln_grid < 1 || up_grid < 1 || down_grid < 1)
    return cudaErrorInvalidValue;
  CUtensorMap tm_h, tm_w1, tm_u_out, tm_u_in, tm_w2, tm_x, tm_y;
  if (!make_map(&tm_h, h, 1, m, c, 64, G_BM) || !make_map(&tm_w1, w1, 1, 2LL * f, c, 64, 128) ||
      !make_map(&tm_u_out, u, 1, m, f, 64, 64) || !make_map(&tm_u_in, u, 1, m, f, 64, G_BM) ||
      !make_map(&tm_w2, w2, 1, c, f, 64, 64) || !make_map(&tm_x, x, 1, m, c, 64, G_BM) ||
      !make_map(&tm_y, out, 1, m, c, 64, 64))
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch ((c + 255) / 256) {
    case 1: err = launch_ln<1>(x, ln_w, ln_b, h, m, c, eps, ln_grid, s); break;
    case 2: err = launch_ln<2>(x, ln_w, ln_b, h, m, c, eps, ln_grid, s); break;
    case 3: err = launch_ln<3>(x, ln_w, ln_b, h, m, c, eps, ln_grid, s); break;
    case 4: err = launch_ln<4>(x, ln_w, ln_b, h, m, c, eps, ln_grid, s); break;
    default: err = launch_ln<5>(x, ln_w, ln_b, h, m, c, eps, ln_grid, s); break;
  }
  if (err != cudaSuccess) return err;
  static int raised_up[64] = {}, raised_down[64] = {};
  err = allow_smem(ff_up_kernel, Gemm<true>::SMEM, raised_up);
  if (err != cudaSuccess) return err;
  err = allow_smem(ff_down_kernel, Gemm<false>::SMEM, raised_down);
  if (err != cudaSuccess) return err;
  ff_up_kernel<<<up_grid, 384, Gemm<true>::SMEM, s>>>(
      tm_h, tm_w1, tm_u_out, static_cast<const __nv_bfloat16*>(b1), m, c, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_down_kernel<<<down_grid, 384, Gemm<false>::SMEM, s>>>(
      tm_u_in, tm_w2, tm_x, tm_y, static_cast<const __nv_bfloat16*>(b2), m, c, f);
  return cudaGetLastError();
}

}  // namespace

// x, out: (m, c); ln_w, ln_b, b2: (c,); w1: (2f, c); b1: (2f,); w2: (c, f).
// All bf16, contiguous, 16-byte aligned; c a multiple of 320 up to 1280, f
// % 32 == 0. The plan (ops/fused_ff.py `ff_plan`): regime 0 (F: c == 320,
// one launch of grid0 CTAs in 2-CTA clusters) or 1 (H: the LN pass on
// grid0 blocks into h (m, c), then the two persistent GEMMs on grid1 and
// grid2 CTAs, U in u (m, f); h and u bf16 scratch the caller allocates).
// rows, fc, stages0 / stages1, cluster and smem are the plan's statement of
// this file's compile-time choices: a plan that states others is refused.
extern "C" int mdt_fused_ff(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, void* h,
                            void* u, int m, int c, int f, float eps, int regime, int rows,
                            int fc, int stages0, int stages1, int cluster, int smem,
                            int grid0, int grid1, int grid2, void* stream) {
  if (m < 1 || c % F_C || c < F_C || c > MAX_C || f % 32 || f < 32 || grid0 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    if (c != F_C || rows != F_ROWS || fc != FC || stages0 != F_STAGES || stages1 != 0 ||
        cluster != CLUSTER || smem != F_SMEM)
      return (int)cudaErrorInvalidValue;
    return (int)launch_fused(x, ln_w, ln_b, w1, b1, w2, b2, out, m, f, eps, grid0, s);
  }
  constexpr int G_SMEM =
      Gemm<true>::SMEM > Gemm<false>::SMEM ? Gemm<true>::SMEM : Gemm<false>::SMEM;
  if (regime != 1 || rows != G_BM || fc != 128 || stages0 != Gemm<true>::STAGES ||
      stages1 != Gemm<false>::STAGES || cluster != 1 || smem != G_SMEM)
    return (int)cudaErrorInvalidValue;
  return (int)launch_split(x, ln_w, ln_b, w1, b1, w2, b2, out, h, u, m, c, f, eps, grid0, grid1,
                           grid2, s);
}
