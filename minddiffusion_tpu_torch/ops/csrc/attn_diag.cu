// The ds1 attention ablations (K12) for Hopper (sm_90a), on packed
// (B, N, C = heads * 64) bf16 tensors, head h being the column slice
// [64h, 64h + 64). They replace the four diagnostic TPU kernels of
// benchmarks/bench_attn_ds1.py, each of which cuts stages out of the packed
// attention kernel to time what is left:
//
//  * mdt_diag (`_diag_kernel`, pallas_call :137), one mode a call:
//      qk      sum_j s_ij, broadcast over the head's 64 columns
//      exp     sum_j exp(s_ij), broadcast
//      nosm    bf16(s) @ v, not normalised
//      fp32pv  exp(s) @ v with P kept in fp32, not normalised
//      full    bf16(exp(s)) @ v / sum_j exp(s_ij) (fp32 row sum)
//  * mdt_diag_kt (`_diag_kt_kernel`, :183): qk and full with K given
//    transposed, (B, C, N); the wrapper transposes, as the TPU function does
//    inside its timed call. Each K tile is transposed back while it is
//    written to shared memory, so the tensor-core operands are the same.
//  * mdt_diag_slice (`_diag_slice_kernel`, :218): s[:, :64] or
//    exp(s)[:, :64], the scores against keys 0-63 only. The TPU kernel
//    computed the whole S row and kept its first 64 columns; so does this
//    one: it sweeps every key tile and stores only the first. The exp of the
//    other tiles is summed into a register whose store is guarded by a
//    condition that never holds, so the compiler keeps that work.
//  * mdt_diag_bf16s (`_diag_bf16s_kernel`, :266): p = exp(bf16(s)) in bf16,
//    l = the fp32 sum of p, (p @ v) / l; the exp one of two ways (below).
// s = q_h k_h^T raw: no kernel applies a scale or subtracts a row max, as on
// the TPU, so exp overflows fp32 above logit ~88.72 and those rows come out
// inf (exp, fp32pv) or NaN (full, bf16s: inf / inf), as the TPU modes do.
//
// The plan is K1's (packed_attention.cu) with stages cut out: one block per
// (64-row q tile, head, batch), 4 warps of 16 rows, 64-key tiles through
// shared memory (K as read, V transposed through registers), S = Q K^T by
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators) with the S tile in
// registers, and every row sum accumulated over the key tiles (no S row is
// ever held whole). So each mode times one stage of K1 on this card.
//
// fp32pv: P stays fp32, so PV runs on the TF32 tensor-core path, mma.sync
// m16n8k8 .tf32 with V widened from bf16 (exact in TF32). P goes in as its
// fp32 bits, which the tensor cores read as TF32 (the low 13 mantissa bits
// dropped, so fp32's largest values stay finite). The m16n8k8 A fragment
// wants keys (t, t+4) of each 8-key chunk where the S accumulator holds keys
// (2t, 2t+1): the product runs over the chunk's keys in that permuted order,
// V's fragment read in the same order, so no shuffle is needed. Its PV
// bound is the TF32 peak (495 TFLOP/s), half the bf16 one.
//
// bf16s: p = exp(bf16(s)) rounded to bf16, summed in fp32 and fed to the
// PV product as packed bf16. Two instantiations, chosen by an argument:
//  * fp32 exp: __expf of the bf16-rounded score on the MUFU units (one MUFU
//    op per score), rounded to bf16;
//  * packed bf16 exp, ex2.approx.ftz.bf16x2 (sm_90, one MUFU op per two
//    scores), the counterpart of the TPU mode's bf16 exp on its vector unit.
//    Its argument is bf16, whose 8-bit mantissa would cost up to 9% at
//    s ~ 40 if it took bf16(s log2 e) whole; so the exponent is split in
//    fp32, s log2 e = n + f with n = floor, and only f in [0, 1) goes
//    through the packed exp (bf16(f) is within 2^-9 of f), the result
//    scaled by 2^n exactly (a bf16 power of two; 0 below 2^-126, inf from
//    2^128 on). Its value is a function of the 16 bits of bf16(s):
//    mdt_exp_bf16x2_table evaluates it at all 65536 of them, which is how
//    the plain version and the tests read it.
// What bounds them on the H100 at ds1 (16, 4096, 320): QK^T is 2 N^2 D
// flops a head and PV another 2 N^2 D, against 2 bytes per element of q, k,
// v and out; every mode is far above the ~295 flop/byte ridge, so the
// tensor cores (QK^T: 0.17 ms; with PV: 0.35 ms; fp32pv's TF32 PV: +0.35
// ms) or one fp32 exp per score on the MUFU units (16 a clock per SM: 0.32
// ms; the packed bf16 exp, one MUFU op per two scores: 0.16 ms) set the floor. The slice modes' function needs only keys 0-63, which
// HBM bounds; the kernels do the TPU mode's whole-row work.
#include "mma.cuh"

#include <math.h>

namespace {

enum Mode { QK = 0, EXP = 1, NOSM = 2, FP32PV = 3, FULL = 4, SLICE = 5, EXPSLICE = 6,
            BF16S = 7, BF16S_EX2 = 8 };

constexpr int D = 64;            // head dim
constexpr int BQ = 64;           // q rows per block, 16 per warp
constexpr int BK = 64;           // keys per tile
constexpr int PAD = 8;           // bf16 padding per shared row (bank spread)
constexpr int LDH = D + PAD;     // a row of the Q or K tile (one token)
constexpr int LDT = BK + PAD;    // a row of the transposed V tile (one column)
constexpr int NT = D / 8;        // 8-column tiles of a head, and 8-key chunks of a tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16 x 8, row) B (8 x 8, col) + C on the TF32 tensor-core path.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(bf16(s0)), exp(bf16(s1)) rounded to bf16, packed; their fp32 values
// in p0, p1. PACKED: the packed bf16 exp with the exponent split off (see
// the header); else the fp32 exp.
template <bool PACKED>
__device__ __forceinline__ uint32_t exp_bf16x2(float s0, float s1, float& p0, float& p1) {
  const float b0 = __bfloat162float(__float2bfloat16(s0));
  const float b1 = __bfloat162float(__float2bfloat16(s1));
  __nv_bfloat162 p;
  if (PACKED) {
    // s log2 e, clamped to +-256 (beyond, the result is inf or 0 all the same)
    const float t0 = fminf(fmaxf(b0 * 1.4426950408889634f, -256.f), 256.f);
    const float t1 = fminf(fmaxf(b1 * 1.4426950408889634f, -256.f), 256.f);
    const float n0 = floorf(t0), n1 = floorf(t1);
    const __nv_bfloat162 f = __floats2bfloat162_rn(t0 - n0, t1 - n1);
    uint32_t e;
    asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(e) : "r"(*reinterpret_cast<const uint32_t*>(&f)));
    // 2^n as bf16 bits: the exponent field n + 127, 0 (a zero) below, 255 (inf) above
    const int e0 = min(max((int)n0 + 127, 0), 255), e1 = min(max((int)n1 + 127, 0), 255);
    const uint32_t two_n = (uint32_t)e0 << 7 | (uint32_t)e1 << 23;
    p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&e),
                *reinterpret_cast<const __nv_bfloat162*>(&two_n));
  } else {
    p = __floats2bfloat162_rn(__expf(b0), __expf(b1));
  }
  p0 = __low2float(p);
  p1 = __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int MODE, bool KT>
__global__ void __launch_bounds__(THREADS) diag_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n, int c) {
  constexpr bool BF16_P = MODE == BF16S || MODE == BF16S_EX2;   // p = exp(bf16(s)) in bf16
  constexpr bool USES_V = MODE == NOSM || MODE == FP32PV || MODE == FULL || BF16_P;
  constexpr bool ROW_SUM = MODE == QK || MODE == EXP;   // output: the broadcast row sum
  __shared__ __align__(16) __nv_bfloat16 qs[BQ * LDH];
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LDH];
  __shared__ __align__(16) __nv_bfloat16 vts[USES_V ? D * LDT : 8];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t col0 = (size_t)h * D;
  const __nv_bfloat16* qb = q + (size_t)b * n * c + col0;
  const __nv_bfloat16* kb = KT ? k + (size_t)b * c * n + col0 * n : k + (size_t)b * n * c + col0;
  const __nv_bfloat16* vb = v + (size_t)b * n * c + col0;

  for (int i = tid; i < BQ * D / 8; i += THREADS) {   // the raw q tile
    const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(qs + r * LDH + cv) =
        *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * c + cv);
  }

  const int wr = warp * 16;   // this warp's first row inside the tile
  float acc[NT][4];
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
  float l_run[2] = {0.f, 0.f};   // per-thread partial row sums (rows g, g + 8)
  float keep = 0.f;              // expslice: the exps of the tiles not stored
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)b * n * c + col0;

  for (int kt = 0; kt < n; kt += BK) {
    __syncthreads();   // the previous tile's K / V are no longer read
    if (KT) {          // D rows of K^T, 64 keys each, written back as [key][dim]
      for (int i = tid; i < D * BK / 8; i += THREADS) {
        const int dd = i / (BK / 8), kc = (i % (BK / 8)) * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(kb + (size_t)dd * n + kt + kc);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) ks[(kc + j) * LDH + dd] = e[j];
      }
    } else {
      for (int i = tid; i < BK * D / 8; i += THREADS) {
        const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(ks + r * LDH + cv) =
            *reinterpret_cast<const uint4*>(kb + (size_t)(kt + r) * c + cv);
      }
    }
    if (USES_V) {
      for (int i = tid; i < BK * D / 8; i += THREADS) {
        const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(vb + (size_t)(kt + r) * c + cv);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) vts[(cv + j) * LDT + r] = e[j];
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys for this warp, fp32 in registers.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = qs + (wr + g) * LDH + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LDH), ld32(qa + 8), ld32(qa + 8 * LDH + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * LDH + kk + 2 * t;
        mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    if (MODE == EXP || MODE == FP32PV || MODE == FULL || MODE == EXPSLICE) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = __expf(s[j][0]);
        s[j][1] = __expf(s[j][1]);
        s[j][2] = __expf(s[j][2]);
        s[j][3] = __expf(s[j][3]);
      }
    }
    if (ROW_SUM || MODE == FULL) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        l_run[0] += s[j][0] + s[j][1];
        l_run[1] += s[j][2] + s[j][3];
      }
    }
    if (MODE == SLICE || MODE == EXPSLICE) {
      if (kt == 0) {   // keys 0-63 -> the head's 64 columns
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cc = j * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * c + cc) = pack_bf16(s[j][0], s[j][1]);
          *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * c + cc) = pack_bf16(s[j][2], s[j][3]);
        }
      } else if (MODE == EXPSLICE) {
#pragma unroll
        for (int j = 0; j < NT; ++j) keep += (s[j][0] + s[j][1]) + (s[j][2] + s[j][3]);
      }
    }
    if (MODE == FP32PV) {   // O += P V on TF32, keys of each 8-chunk in (2t, 2t + 1) order
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t a[4] = {__float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                               __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          const uint32_t w = ld32(vts + (nn * 8 + g) * LDT + j * 8 + 2 * t);
          mma_tf32(acc[nn], a, w << 16, w & 0xffff0000u);
        }
      }
    }
    if (MODE == NOSM || MODE == FULL || BF16_P) {   // O += bf16(P) V
      uint32_t pk[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (BF16_P) {
          float p0, p1, p2, p3;
          pk[j][0] = exp_bf16x2<MODE == BF16S_EX2>(s[j][0], s[j][1], p0, p1);
          pk[j][1] = exp_bf16x2<MODE == BF16S_EX2>(s[j][2], s[j][3], p2, p3);
          l_run[0] += p0 + p1;
          l_run[1] += p2 + p3;
        } else {
          pk[j][0] = pack_bf16(s[j][0], s[j][1]);
          pk[j][1] = pack_bf16(s[j][2], s[j][3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        const uint32_t a[4] = {pk[2 * jj][0], pk[2 * jj][1], pk[2 * jj + 1][0],
                               pk[2 * jj + 1][1]};
#pragma unroll
        for (int nn = 0; nn < NT; ++nn) {
          const __nv_bfloat16* vp = vts + (nn * 8 + g) * LDT + jj * 16 + 2 * t;
          mma_bf16(acc[nn], a, ld32(vp), ld32(vp + 8));
        }
      }
    }
  }

  if (MODE == SLICE) return;
  if (MODE == EXPSLICE) {
    if (keep == -1.f) ob[(size_t)r0 * c] = __float2bfloat16(keep);   // never: exps are > 0
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (ROW_SUM) {   // lane t of the quad writes columns [16t, 16t + 16) of both rows
    const uint32_t u0 = pack_bf16(l_run[0], l_run[0]), u1 = pack_bf16(l_run[1], l_run[1]);
    const uint4 w0 = make_uint4(u0, u0, u0, u0), w1 = make_uint4(u1, u1, u1, u1);
    __nv_bfloat16* p0 = ob + (size_t)r0 * c + 16 * t;
    __nv_bfloat16* p1 = ob + (size_t)r1 * c + 16 * t;
    *reinterpret_cast<uint4*>(p0) = w0;
    *reinterpret_cast<uint4*>(p0 + 8) = w0;
    *reinterpret_cast<uint4*>(p1) = w1;
    *reinterpret_cast<uint4*>(p1 + 8) = w1;
    return;
  }
  const bool norm = MODE == FULL || BF16_P;   // nosm, fp32pv: l = 1
  const float l0 = norm ? l_run[0] : 1.f, l1 = norm ? l_run[1] : 1.f;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    const int cc = nn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * c + cc) =
        pack_bf16(acc[nn][0] / l0, acc[nn][1] / l0);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * c + cc) =
        pack_bf16(acc[nn][2] / l1, acc[nn][3] / l1);
  }
}

template <int MODE, bool KT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bsz, int n,
                   int c, int heads, void* stream) {
  const dim3 grid(n / BQ, heads, bsz);
  diag_kernel<MODE, KT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, c);
  return cudaGetLastError();
}

bool shape_ok(int bsz, int n, int c, int heads) {
  return bsz >= 1 && heads >= 1 && c == heads * D && n >= BK && n % BK == 0;
}

}  // namespace

// q, k, v, o: (bsz, n, c) bf16, contiguous; c = heads * 64, n % 64 == 0.
// mode: 0 qk, 1 exp, 2 nosm, 3 fp32pv, 4 full.
extern "C" int mdt_diag(const void* q, const void* k, const void* v, void* o, int bsz, int n,
                        int c, int heads, int mode, void* stream) {
  if (!shape_ok(bsz, n, c, heads)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case QK: return (int)launch<QK, false>(q, k, v, o, bsz, n, c, heads, stream);
    case EXP: return (int)launch<EXP, false>(q, k, v, o, bsz, n, c, heads, stream);
    case NOSM: return (int)launch<NOSM, false>(q, k, v, o, bsz, n, c, heads, stream);
    case FP32PV: return (int)launch<FP32PV, false>(q, k, v, o, bsz, n, c, heads, stream);
    case FULL: return (int)launch<FULL, false>(q, k, v, o, bsz, n, c, heads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with kt: (bsz, c, n), K transposed. mode: 0 qk, 4 full.
extern "C" int mdt_diag_kt(const void* q, const void* kt, const void* v, void* o, int bsz,
                           int n, int c, int heads, int mode, void* stream) {
  if (!shape_ok(bsz, n, c, heads)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case QK: return (int)launch<QK, true>(q, kt, v, o, bsz, n, c, heads, stream);
    case FULL: return (int)launch<FULL, true>(q, kt, v, o, bsz, n, c, heads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode: 5 slice, 6 expslice; v is not read.
extern "C" int mdt_diag_slice(const void* q, const void* k, const void* v, void* o, int bsz,
                              int n, int c, int heads, int mode, void* stream) {
  if (!shape_ok(bsz, n, c, heads)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case SLICE: return (int)launch<SLICE, false>(q, k, v, o, bsz, n, c, heads, stream);
    case EXPSLICE: return (int)launch<EXPSLICE, false>(q, k, v, o, bsz, n, c, heads, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// packed_exp: 0 the fp32 exp, 1 the packed bf16 exp.
extern "C" int mdt_diag_bf16s(const void* q, const void* k, const void* v, void* o, int bsz,
                              int n, int c, int heads, int packed_exp, void* stream) {
  if (!shape_ok(bsz, n, c, heads)) return (int)cudaErrorInvalidValue;
  if (packed_exp) return (int)launch<BF16S_EX2, false>(q, k, v, o, bsz, n, c, heads, stream);
  return (int)launch<BF16S, false>(q, k, v, o, bsz, n, c, heads, stream);
}

namespace {

// out[i] = the packed bf16 exp of the bf16 whose bits are i, for all 65536 i.
__global__ void exp_table_kernel(__nv_bfloat16* out) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  float p0, p1;
  const uint32_t p = exp_bf16x2<true>(__bfloat162float(__ushort_as_bfloat16((unsigned short)i)),
                                      __bfloat162float(__ushort_as_bfloat16((unsigned short)(i + 1))),
                                      p0, p1);
  *reinterpret_cast<uint32_t*>(out + i) = p;
}

}  // namespace

// out: 65536 bf16, the packed bf16 exp of mdt_diag_bf16s at every bf16 input.
extern "C" int mdt_exp_bf16x2_table(void* out, void* stream) {
  exp_table_kernel<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
