// W8A8 int8 matrix multiply for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernel `_mm_kernel` (unified_video_action_tpu/ops/
// int8_mm.py:32-39, launched through `int8_matmul_pallas` at :65) together
// with the arithmetic of its wrapper `w8a8_matmul` (:83-107), which is also
// the function of the XLA int8 dot that the JAX package's `QuantDense` runs
// (ops/quant.py:38-55). Four kernels:
//
//   uva_quantize_rows_vector, uva_quantize_rows
//                      x (M, K) bf16 or fp32 -> x_q (M, K) s8, x_scale (M,)
//                      fp32: one warp per row takes the fp32 amax, then
//                      x_scale = max(amax * fl(1/127), 1e-12) and
//                      x_q = clip(rint(x / x_scale), -127, 127). The
//                      quotient is a true IEEE division and the rounding is
//                      half to even, as in the reference; fl(1/127) is the
//                      constant that XLA folds `amax / 127` into. The vector
//                      kernel (K % 8 == 0, x 16-byte aligned, K <= 5120 in
//                      bf16 and 1024 in fp32) reads x once: 8 elements a
//                      lane per 16-byte load (two for fp32), the row's
//                      values kept in registers from the amax to the
//                      quotient, 8 s8 a store. The scalar kernel takes any
//                      K and alignment (the denoiser's K = 2 input
//                      projection) and reads the row twice.
//   uva_int8_gemm_wgmma, uva_int8_gemm
//                      x_q (M, K) s8 row-major times the weight kept as
//                      (N, K) s8 with K contiguous (the transpose of JAX's
//                      kernel_q: both operands K-major, as s8 wgmma and the
//                      .col operand of mma.sync want them), s32
//                      accumulation, and an epilogue that computes
//                      ((acc * x_scale[m]) * w_scale[n]), casts it to the
//                      output type and then adds the bias cast to that type
//                      in that type (models/transformer.py:78-79). Either can
//                      write the raw s32 product instead (the checks use it).
//
// Every float operation of the reference is written with a _rn intrinsic,
// which the compiler never contracts into an FMA, so the kernels reproduce
// the plain PyTorch version (ops/quant.py) bit for bit; the s32 sum is exact
// in any order, so no tiling changes a bit. Do not build with
// --use_fast_math: it turns the division into an approximate one.
//
// Bound on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): the serving
// GEMMs at B=128 (M = 18,432 tokens in the MAR, 2,048 in the denoiser) are
// bound by operations: qkv (M, 768, 2304) is 65.2 G ops, 0.033 ms, against
// 101 MB of inputs and outputs, 0.030 ms. At B=1 (M = 144 and 16) and for
// the denoiser's K = 2 input projection they are bound by bytes, mostly the
// weight. The row quantization is bound by bytes (read x, write x_q).
//
// uva_int8_gemm_wgmma is the GEMM wherever TMA can read the operands (K %
// 16 == 0, 16-byte aligned): TMA into a ring of 128-byte-swizzled stages,
// wgmma m64nNk32 s8 from shared memory, one producer warpgroup, one or two
// consumer warpgroups and persistent CTAs (design notes above the kernel;
// ops/int8_mm.py's gemm_plan picks the tile). uva_int8_gemm takes what TMA
// cannot read (the denoiser's K = 2 input projection, operands not 16-byte
// aligned): 128 x 128 output tiles, 64-deep K tiles, 8 warps of 64 x 32
// each issuing mma.sync.m16n8k32 s8, two shared-memory stages filled by
// byte loads; K is zero-filled up to the tile in shared memory, so any K (2
// included) and ragged M and N are exact. Rows are padded to 80 bytes, which
// makes the 32-bit fragment loads free of bank conflicts.
//
// `faults` plants a known error for the serve checks' controls (0 in
// normal use; see kFault* below).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kFaultRoundHalfAway = 1;     // roundf instead of rintf
constexpr int kFaultReciprocalScale = 2;   // x * (127 / amax) instead of x / x_scale
constexpr int kFaultPerTensorWScale = 4;   // every column rescaled by w_scale[0]
constexpr int kFaultBiasBeforeCast = 8;    // bias added in fp32, then one cast

constexpr float kInv127 = 1.0f / 127.0f;   // folded to fl32(1/127)
constexpr float kScaleFloor = 1e-12f;

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

// ---------------------------------------------------------------- quantize

constexpr int kQuantThreads = 256;     // scalar kernel: 8 warps, one row each
constexpr int kQuantVecThreads = 128;  // vector kernel: 4 persistent warps
constexpr int kQuantUnit = 8;          // elements of one vector load

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23

// x_q of one element in the low byte of the result, given the row's scale s
// and (for the reciprocal_scale fault only) 127 / amax. clip(rint(r)) is
// computed as rint(clip(r)), which is the same for every r (NaN included:
// fmaxf takes -127), and rint of |r| <= 127 as the float sum r + 1.5 * 2^23,
// rounded half to even by the add, whose low mantissa byte is then the two's
// complement of the integer: no quarter-rate rint or float-to-int conversion.
template <bool kFaults>
__device__ __forceinline__ uint32_t quantize_one(float v, float s, float inv, int faults) {
  if (kFaults && (faults & kFaultRoundHalfAway)) {
    const float r = (faults & kFaultReciprocalScale) ? __fmul_rn(v, inv) : __fdiv_rn(v, s);
    return (uint32_t)(uint8_t)(int8_t)__float2int_rn(fminf(fmaxf(roundf(r), -127.f), 127.f));
  }
  const float r = (kFaults && (faults & kFaultReciprocalScale)) ? __fmul_rn(v, inv) : __fdiv_rn(v, s);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(r, -127.f), 127.f), kRoundMagic));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ x_scale, int M, int K, int faults) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kQuantThreads / 32) + warp;
  if (row >= M) return;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(load_float(xr + k)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fmul_rn(amax, kInv127), kScaleFloor);
  const float inv = __fdiv_rn(127.f, amax);  // only the reciprocal_scale fault reads it
  if (lane == 0) x_scale[row] = s;
  int8_t* qr = xq + row * K;
  for (int k = lane; k < K; k += 32)
    qr[k] = (int8_t)quantize_one<true>(load_float(xr + k), s, inv, faults);
}

// Eight consecutive elements of a row as loaded: one 16-byte vector of bf16,
// two of fp32.
template <typename T> struct Unit;
template <>
struct Unit<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void floats(float (&f)[kQuantUnit]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);             // the low bf16
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // the high bf16
    }
  }
};
template <>
struct Unit<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void floats(float (&f)[kQuantUnit]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Persistent warps, each walking rows warp, warp + warps, ...; lane l holds
// units l, l + 32, ... of a row (kV of them at most, so K <= 256 kV) in
// registers from the amax to the quotient, so x is read once, and loads the
// next row's units before it divides this row's, so the loads of one row
// overlap the arithmetic of the last (the IEEE division costs about as much
// time as the bytes). Consecutive lanes read consecutive 16 bytes, and each
// unit's 8 s8 go out in one 8-byte store.
template <typename T, int kV>
__device__ __forceinline__ void load_row(Unit<T> (&u)[kV], const T* xr, int lane, int units) {
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (lane + 32 * i < units) u[i].load(xr + kQuantUnit * (lane + 32 * i));
}

// kFaults: the planted faults are read (the controls' build); without it
// the element loop has no branch on them.
template <typename T, int kV, bool kFaults>
__global__ void __launch_bounds__(kQuantVecThreads)
quantize_rows_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ x_scale, int M, int K, int faults) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kQuantVecThreads / 32);
  const int units = K / kQuantUnit;
  int row = blockIdx.x * (kQuantVecThreads / 32) + (threadIdx.x >> 5);
  Unit<T> u[kV], next[kV];
  if (row < M) load_row(u, x + (long long)row * K, lane, units);
  for (; row < M; row += warps) {
    if (row + warps < M) load_row(next, x + (long long)(row + warps) * K, lane, units);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (lane + 32 * i < units) {
        float f[kQuantUnit];
        u[i].floats(f);
#pragma unroll
        for (int e = 0; e < kQuantUnit; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(__fmul_rn(amax, kInv127), kScaleFloor);
    const float inv = __fdiv_rn(127.f, amax);  // only the reciprocal_scale fault reads it
    if (lane == 0) x_scale[row] = s;
    int8_t* qr = xq + (long long)row * K;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = lane + 32 * i;
      if (c < units) {
        float f[kQuantUnit];
        u[i].floats(f);
        uint32_t b[kQuantUnit], w[2];
#pragma unroll
        for (int e = 0; e < kQuantUnit; ++e) b[e] = quantize_one<kFaults>(f[e], s, inv, faults);
#pragma unroll
        for (int h = 0; h < 2; ++h)  // the low bytes of four results, in order
          w[h] = __byte_perm(__byte_perm(b[4 * h], b[4 * h + 1], 0x0040),
                             __byte_perm(b[4 * h + 2], b[4 * h + 3], 0x0040), 0x5410);
        *reinterpret_cast<uint2*>(qr + kQuantUnit * c) = make_uint2(w[0], w[1]);
      }
      u[i] = next[i];
    }
  }
}

// The vector kernel's launch: as many warps as fit on the card at once, or
// one per row where there are fewer rows.
template <typename T, int kV>
int launch_quantize_vec(const T* x, int8_t* xq, float* x_scale, int M, int K, int faults,
                        cudaStream_t s) {
  // the grid of the fault-free kernel (the controls' build runs on the same grid)
  static int blocks_per_sm = 0;  // per instantiation, found once
  if (blocks_per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, quantize_rows_vec_kernel<T, kV, false>, kQuantVecThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int rows_per_block = kQuantVecThreads / 32;
  const int blocks = min((M + rows_per_block - 1) / rows_per_block, num_sms() * blocks_per_sm);
  auto kernel = faults ? quantize_rows_vec_kernel<T, kV, true> : quantize_rows_vec_kernel<T, kV, false>;
  kernel<<<blocks, kQuantVecThreads, 0, s>>>(x, xq, x_scale, M, K, faults);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- GEMM

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;                // bytes of K per stage
constexpr int kLd = kBK + 16;          // 80-byte shared rows
constexpr int kGemmThreads = 256;      // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;       // m16 tiles per warp
constexpr int kNT = kWarpN / 8;        // n8 tiles per warp

struct GemmParams {
  const int8_t* xq;
  const float* x_scale;
  const int8_t* wq;
  const float* w_scale;
  const float* bias;  // may be null
  void* out;
  int M, N, K;
  int out_kind;
  int faults;
};

// One (128, 64) s8 tile of a row-major (rows, K) matrix into shared memory,
// byte by byte (any K, any alignment), zero where the row or the column lies
// outside the matrix.
__device__ __forceinline__ void load_tile(int8_t (*dst)[kLd], const int8_t* src, int rows,
                                          int row0, int K, int k0) {
  for (int c = threadIdx.x; c < kBM * kBK; c += kGemmThreads) {
    const int r = c / kBK;
    const int col = c % kBK;
    const bool in = row0 + r < rows && k0 + col < K;
    dst[r][col] = in ? src[(long long)(row0 + r) * K + k0 + col] : int8_t(0);
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue's arithmetic, element by element: ((acc * x_scale[m]) *
// w_scale[n]) in fp32, cast to the output type, then the bias cast to that
// type added in it. Both GEMM kernels compute through these.
__device__ __forceinline__ float rescaled(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

__device__ __forceinline__ float with_bias_f32(float f, float b, bool has_bias) {
  return has_bias ? __fadd_rn(f, b) : f;
}

__device__ __forceinline__ __nv_bfloat16 with_bias_bf16(float f, float b, bool has_bias, int faults) {
  if (has_bias && (faults & kFaultBiasBeforeCast)) return __float2bfloat16_rn(__fadd_rn(f, b));
  __nv_bfloat16 o = __float2bfloat16_rn(f);
  if (has_bias) {
    const float bb = __bfloat162float(__float2bfloat16_rn(b));
    o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), bb));
  }
  return o;
}

__device__ __forceinline__ void store_out(const GemmParams& p, int m, int n, int acc) {
  const long long i = (long long)m * p.N + n;
  if (p.out_kind == kOutS32) {
    static_cast<int*>(p.out)[i] = acc;
    return;
  }
  const float f = rescaled(acc, p.x_scale[m], p.w_scale[(p.faults & kFaultPerTensorWScale) ? 0 : n]);
  const float b = p.bias ? p.bias[n] : 0.f;
  if (p.out_kind == kOutF32) {
    static_cast<float*>(p.out)[i] = with_bias_f32(f, b, p.bias != nullptr);
  } else {
    static_cast<__nv_bfloat16*>(p.out)[i] = with_bias_bf16(f, b, p.bias != nullptr, p.faults);
  }
}

__global__ void __launch_bounds__(kGemmThreads, 2)
int8_gemm_kernel(const GemmParams p) {
  __shared__ __align__(16) int8_t as[2][kBM][kLd];
  __shared__ __align__(16) int8_t bs[2][kBN][kLd];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int wm = (warp >> 2) * kWarpM;
  const int wn = (warp & 3) * kWarpN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (p.K + kBK - 1) / kBK;
  load_tile(as[0], p.xq, p.M, m0, p.K, 0);
  load_tile(bs[0], p.wq, p.N, n0, p.K, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile(as[cur ^ 1], p.xq, p.M, m0, p.K, (kt + 1) * kBK);
      load_tile(bs[cur ^ 1], p.wq, p.N, n0, p.K, (kt + 1) * kBK);
    }
    __syncthreads();  // the stage of tile kt is in shared memory
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMT][4];
      uint32_t b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = lds32(&as[cur][r][kk + t * 4]);
        a[i][1] = lds32(&as[cur][r + 8][kk + t * 4]);
        a[i][2] = lds32(&as[cur][r][kk + 16 + t * 4]);
        a[i][3] = lds32(&as[cur][r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = lds32(&bs[cur][c][kk + t * 4]);
        b[j][1] = lds32(&bs[cur][c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // every warp is done with `cur` before it is refilled
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (m < p.M && n < p.N) store_out(p, m, n, acc[i][j][r]);
      }
}

// ---------------------------------------------------------------- Hopper GEMM
//
// TMA + wgmma, in three roles of one CTA:
// - one producer warpgroup, of which one thread keeps a ring of kStages
//   shared-memory stages filled by TMA. A stage is a (64 kWG, 128) tile of
//   x_q and a (kBN, 128) tile of the weight, both K-major with the 128-byte
//   swizzle, which is the layout that s8 wgmma reads (both operands K-major)
//   through a descriptor with SBO = 1024 B. TMA zero-fills the rows and
//   columns outside the matrices, so ragged M, N and K (K % 16 == 0) add
//   exact zeros;
// - kWG consumer warpgroups, 64 rows of the output tile each and its whole
//   width kBN: four m64nNk32 steps per stage, one wgmma group in flight
//   while the next stage is waited for; then the s32 sums go to a staged
//   tile in shared memory, and the consumers start on the next tile;
// - two epilogue warpgroups, which rescale the staged tile, cast it, add
//   the bias and store it with 16-byte vectors, while the consumers run the
//   next tile's products. (The MAR's K = 768 layers have six stages a
//   tile, and a tile's epilogue takes about as long: done by the consumers,
//   it would leave the tensor cores idle that long. One epilogue warpgroup,
//   one warp per scheduler, cannot hide its own latencies within six stages;
//   two can.)
//
// The CTAs are persistent: each walks the output tiles blockIdx.x, +
// gridDim.x, ... At small M the 64 x 64 tile gives the weight's read enough
// CTAs (M = 16, N = 1024: 16 of them, each walking K in a 4-stage ring).

constexpr int kTK = 128;  // bytes of K per stage: one 128-byte swizzle row

template <int N> struct Wgmma;
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

constexpr int kEpilogueThreads = 256;  // two warpgroups

struct WgmmaParams {
  GemmParams p;
  int n_tiles;  // output tiles along N
  int k_tiles;  // 128-byte K tiles
  int tiles;    // output tiles
};

template <int kWG, int kBN, int kStages>
struct WgmmaShape {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * (kWG + 1) + kEpilogueThreads;
  static constexpr int kABytes = kBM * kTK;
  static constexpr int kBBytes = kBN * kTK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kLd = kBN + 8;  // s32 per staged row; the pad spreads the banks
  static constexpr int kStagedBytes = kBM * kLd * 4;
  // the stages, the staged tile, 2 barriers per stage and 2 for the staged
  // tile, and the slack that aligns the stages to 1024 B (the swizzle atom)
  static constexpr int kSmem = kStages * kStageBytes + kStagedBytes + 16 * kStages + 16 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block on an H100");
};

// Eight consecutive columns n .. n + 7 (n % 8 == 0) of row m from their s32
// sums: rescaled, cast and biased, then stored as 16-byte vectors where the
// eight lie inside a row whose width is a multiple of 8, else one by one.
template <int kOut>
__device__ __forceinline__ void store_chunk(const GemmParams& p, int m, int n, const int (&v)[8],
                                            float xs, const float (&ws)[8], const float (&bs)[8]) {
  const bool has_bias = p.bias != nullptr;
  const bool vec = (p.N & 7) == 0 && n + 8 <= p.N;
  const long long i = (long long)m * p.N + n;
  if constexpr (kOut == kOutS32) {
    int* o = static_cast<int*>(p.out) + i;
    if (vec) {
      reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.N) o[e] = v[e];
    }
  } else if constexpr (kOut == kOutF32) {
    float r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = with_bias_f32(rescaled(v[e], xs, ws[e]), bs[e], has_bias);
    float* o = static_cast<float*>(p.out) + i;
    if (vec) {
      reinterpret_cast<float4*>(o)[0] = make_float4(r[0], r[1], r[2], r[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(r[4], r[5], r[6], r[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.N) o[e] = r[e];
    }
  } else {
    __nv_bfloat16 r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      r[e] = with_bias_bf16(rescaled(v[e], xs, ws[e]), bs[e], has_bias, p.faults);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + i;
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (uint32_t)__bfloat16_as_ushort(r[2 * e]) |
               ((uint32_t)__bfloat16_as_ushort(r[2 * e + 1]) << 16);
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n + e < p.N) o[e] = r[e];
    }
  }
}

// The epilogue warpgroup's share of one staged tile: rows r0, r0 + kStep,
// ... of the tile, columns cc .. cc + 7 of it, from `src` (the staged tile,
// `ld` s32 a row).
template <int kOut, int kBM, int kStep>
__device__ __forceinline__ void store_rows(const GemmParams& p, const int* src, int ld, int m0,
                                           int n, int r0, const float (&xs)[kBM / kStep],
                                           const float (&ws)[8], const float (&bs)[8]) {
#pragma unroll
  for (int i = 0; i < kBM / kStep; ++i) {
    const int m = m0 + r0 + i * kStep;
    if (m >= p.M) continue;
    int v[8];
    const int4* s = reinterpret_cast<const int4*>(src + (r0 + i * kStep) * ld);
    const int4 a = s[0], b = s[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    store_chunk<kOut>(p, m, n, v, xs[i], ws, bs);
  }
}

template <int kBM, int kStep>
__device__ __forceinline__ void store_tile(const GemmParams& p, const int* src, int ld, int m0,
                                           int n, int r0, const float (&xs)[kBM / kStep],
                                           const float (&ws)[8], const float (&bs)[8]) {
  if (p.out_kind == kOutS32) {
    store_rows<kOutS32, kBM, kStep>(p, src, ld, m0, n, r0, xs, ws, bs);
  } else if (p.out_kind == kOutF32) {
    store_rows<kOutF32, kBM, kStep>(p, src, ld, m0, n, r0, xs, ws, bs);
  } else {
    store_rows<kOutBF16, kBM, kStep>(p, src, ld, m0, n, r0, xs, ws, bs);
  }
}

template <int kWG, int kBN, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1) + kEpilogueThreads, kWG == 1 ? 2 : 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, const WgmmaParams q) {
  using S = WgmmaShape<kWG, kBN, kStages>;
  constexpr int kBM = S::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_smem = base;
  const uint32_t b_smem = base + kStages * S::kABytes;
  uint8_t* aligned = smem_raw + (base - raw);
  int* staged = reinterpret_cast<int*>(aligned + kStages * S::kStageBytes);
  uint8_t* tail = aligned + kStages * S::kStageBytes + S::kStagedBytes;
  const uint32_t full_bar = smem_u32(tail);
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t staged_full = empty_bar + 8 * kStages;  // consumers -> epilogue
  const uint32_t staged_empty = staged_full + 8;         // epilogue -> consumers

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kWG);
    }
    mbar_init(staged_full, kWG * 128);
    mbar_init(staged_empty, kEpilogueThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const GemmParams& p = q.p;

  if (wg == kWG) {
    // producer: one thread starts every TMA load
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
        const int m0 = (tile / q.n_tiles) * kBM;
        const int n0 = (tile % q.n_tiles) * kBN;
        for (int kt = 0; kt < q.k_tiles; ++kt) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          mbar_expect_tx(full_bar + 8 * stage, S::kStageBytes);
          tma_load(a_smem + stage * S::kABytes, &map_x, full_bar + 8 * stage, kt * kTK, m0);
          tma_load(b_smem + stage * S::kBBytes, &map_w, full_bar + 8 * stage, kt * kTK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (wg > kWG) {
    // epilogue: each thread owns 8 columns of the tile and every kStep-th row
    constexpr int kChunks = kBN / 8;                   // 8-column chunks per row
    constexpr int kStep = kEpilogueThreads / kChunks;  // rows between a thread's rows
    const int et = threadIdx.x - 128 * (kWG + 1);
    const int cc = (et % kChunks) * 8;
    const int r0 = et / kChunks;
    const bool scaled = p.out_kind != kOutS32;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x, phase ^= 1) {
      const int m0 = (tile / q.n_tiles) * kBM;
      const int n = (tile % q.n_tiles) * kBN + cc;
      // the scales, read while the products run
      float ws[8], bs[8], xs[kBM / kStep];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = scaled && n + e < p.N;
        ws[e] = in ? p.w_scale[(p.faults & kFaultPerTensorWScale) ? 0 : n + e] : 0.f;
        bs[e] = (in && p.bias) ? p.bias[n + e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBM / kStep; ++i) {
        const int m = m0 + r0 + i * kStep;
        xs[i] = (scaled && m < p.M) ? p.x_scale[m] : 0.f;
      }
      mbar_wait(staged_full, phase);
      store_tile<kBM, kStep>(p, staged + cc, S::kLd, m0, n, r0, xs, ws, bs);
      mbar_arrive(staged_empty);
    }
    return;
  }

  // consumers: the products, then the tile's s32 sums to shared memory
  const int warp = tid / 32;
  const int lane = tid % 32;
  int* frag = staged + (wg * 64 + warp * 16 + lane / 4) * S::kLd + 2 * (lane % 4);
  int acc[kBN / 2] = {};
  int stage = 0;
  uint32_t phase = 0, staged_phase = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x, staged_phase ^= 1) {
    int prev = 0;
    for (int kt = 0; kt < q.k_tiles; ++kt) {
      mbar_wait(full_bar + 8 * stage, phase);
      const uint64_t da = smem_desc(a_smem + stage * S::kABytes + wg * 64 * kTK);
      const uint64_t db = smem_desc(b_smem + stage * S::kBBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 32; ++kk)  // 32 bytes = 2 descriptor units per step
        Wgmma<kBN>::mma(acc, da + 2 * kk, db + 2 * kk, (kt > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_regs(acc);
      if (kt > 0 && tid == 0) mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty_bar + 8 * prev);
    // fragment of m64nNk32: rows lane / 4 and lane / 4 + 8 of the warp's 16,
    // columns 8 j + 2 (lane % 4) and the next
    mbar_wait(staged_empty, staged_phase ^ 1);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      *reinterpret_cast<int2*>(frag + 8 * j) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(frag + 8 * S::kLd + 8 * j) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    mbar_arrive(staged_full);
  }
}

// A K-major (rows, K) s8 matrix as a TMA map of (box_rows, 128) tiles with
// the 128-byte swizzle; rows and columns outside the matrix read as zero.
int encode_kmajor(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kTK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return (int)cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                                     dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kWG, int kBN, int kStages>
int launch_wgmma(const void* xq, const void* wq, WgmmaParams q, cudaStream_t s) {
  using S = WgmmaShape<kWG, kBN, kStages>;
  auto kernel = int8_gemm_wgmma_kernel<kWG, kBN, kStages>;
  static int blocks_per_sm = 0;  // per instantiation, found once
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, S::kThreads, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_x, map_w;
  int rc = encode_kmajor(&map_x, xq, q.p.M, q.p.K, S::kBM);
  if (rc != 0) return kEncodeError + rc;
  rc = encode_kmajor(&map_w, wq, q.p.N, q.p.K, kBN);
  if (rc != 0) return kEncodeError + rc;
  const int grid = min(q.tiles, num_sms() * blocks_per_sm);
  kernel<<<grid, S::kThreads, S::kSmem, s>>>(map_x, map_w, q);
  return (int)cudaGetLastError();
}

}  // namespace

// The scalar kernel. x: contiguous (M, K), dtype 0 = float32, 1 = bfloat16.
// Writes xq (M, K) int8 and x_scale (M,) float32. Returns cudaGetLastError()
// after the launch.
extern "C" int uva_quantize_rows(const void* x, void* xq, float* x_scale, int M, int K,
                                 int dtype, int faults, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kQuantThreads / 32 - 1) / (kQuantThreads / 32);
  if (dtype == 0) {
    quantize_rows_kernel<float><<<blocks, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), x_scale, M, K, faults);
  } else if (dtype == 1) {
    quantize_rows_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), x_scale, M, K, faults);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The vector kernel on the same arguments, which must have K % 8 == 0,
// K <= 256 per_lane and x (and xq) 16-byte aligned; per_lane (the units of
// 8 elements a lane holds) is 4 (bf16 or fp32), 12 or 20 (bf16: rows up to
// K = 3072, and up to 5120, mar_huge's fc2 input). Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for arguments it does not take.
extern "C" int uva_quantize_rows_vector(const void* x, void* xq, float* x_scale, int M, int K,
                                        int dtype, int faults, int per_lane, void* stream) {
  if (M <= 0 || K <= 0 || K % kQuantUnit != 0 || K > 32 * kQuantUnit * per_lane ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xq)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  if (dtype == 0 && per_lane == 4)
    return launch_quantize_vec<float, 4>(static_cast<const float*>(x), q, x_scale, M, K, faults, s);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (dtype == 1 && per_lane == 4)
    return launch_quantize_vec<__nv_bfloat16, 4>(xb, q, x_scale, M, K, faults, s);
  if (dtype == 1 && per_lane == 12)
    return launch_quantize_vec<__nv_bfloat16, 12>(xb, q, x_scale, M, K, faults, s);
  if (dtype == 1 && per_lane == 20)
    return launch_quantize_vec<__nv_bfloat16, 20>(xb, q, x_scale, M, K, faults, s);
  return (int)cudaErrorInvalidValue;
}

// xq: contiguous (M, K) int8; wq: contiguous (N, K) int8; x_scale (M,),
// w_scale (N,) and bias (N,) float32, bias may be null. out: contiguous
// (M, N) of out_kind 0 = float32, 1 = bfloat16 (both rescaled, plus bias),
// 2 = int32 (the raw product; scales and bias unread). Returns
// cudaGetLastError() after the launch.
extern "C" int uva_int8_gemm(const void* xq, const float* x_scale, const void* wq,
                             const float* w_scale, const float* bias, void* out, int M, int N,
                             int K, int out_kind, int faults, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || out_kind < kOutF32 || out_kind > kOutS32)
    return (int)cudaErrorInvalidValue;
  GemmParams p;
  p.xq = static_cast<const int8_t*>(xq);
  p.x_scale = x_scale;
  p.wq = static_cast<const int8_t*>(wq);
  p.w_scale = w_scale;
  p.bias = bias;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.out_kind = out_kind;
  p.faults = faults;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The Hopper kernel (TMA + wgmma) on the same operands as uva_int8_gemm,
// which must be 16-byte aligned with K % 16 == 0 (TMA's rules). (bm, bn) is
// the output tile: (64, 64) or (128, 128). Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for arguments it does not take, or
// kEncodeError + the CUresult of a failed TMA encode.
extern "C" int uva_int8_gemm_wgmma(const void* xq, const float* x_scale, const void* wq,
                                   const float* w_scale, const float* bias, void* out, int M,
                                   int N, int K, int out_kind, int faults, int bm, int bn,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || out_kind < kOutF32 || out_kind > kOutS32 ||
      ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  WgmmaParams q;
  q.p.xq = static_cast<const int8_t*>(xq);
  q.p.x_scale = x_scale;
  q.p.wq = static_cast<const int8_t*>(wq);
  q.p.w_scale = w_scale;
  q.p.bias = bias;
  q.p.out = out;
  q.p.M = M;
  q.p.N = N;
  q.p.K = K;
  q.p.out_kind = out_kind;
  q.p.faults = faults;
  q.n_tiles = (N + bn - 1) / bn;
  q.k_tiles = (K + kTK - 1) / kTK;
  q.tiles = ((M + bm - 1) / bm) * q.n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64) return launch_wgmma<1, 64, 4>(xq, wq, q, s);
  if (bm == 128 && bn == 128) return launch_wgmma<2, 128, 4>(xq, wq, q, s);
  return (int)cudaErrorInvalidValue;
}
