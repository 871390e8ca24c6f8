// W8A8 int8 matrix multiply for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernel `_mm_kernel` (unified_video_action_tpu/ops/
// int8_mm.py:32-39, launched through `int8_matmul_pallas` at :65) together
// with the arithmetic of its wrapper `w8a8_matmul` (:83-107), which is also
// the function of the XLA int8 dot that the JAX package's `QuantDense` runs
// (ops/quant.py:38-55). Two kernels:
//
//   uva_quantize_rows  x (M, K) bf16 or fp32 -> x_q (M, K) s8, x_scale (M,)
//                      fp32: one warp per row takes the fp32 amax, then
//                      x_scale = max(amax * fl(1/127), 1e-12) and
//                      x_q = clip(rint(x / x_scale), -127, 127). The
//                      quotient is a true IEEE division and the rounding is
//                      half to even, as in the reference; fl(1/127) is the
//                      constant that XLA folds `amax / 127` into.
//   uva_int8_gemm      x_q (M, K) s8 row-major times the weight kept as
//                      (N, K) s8 with K contiguous (the transpose of JAX's
//                      kernel_q, which is the .col operand of the mma), s32
//                      accumulation, and an epilogue that computes
//                      ((acc * x_scale[m]) * w_scale[n]), casts it to the
//                      output type and then adds the bias cast to that type
//                      in that type (models/transformer.py:78-79). It can
//                      write the raw s32 product instead (the checks use it).
//
// Every float operation of the reference is written with a _rn intrinsic,
// which the compiler never contracts into an FMA, so the kernels reproduce
// the plain PyTorch version (ops/quant.py) bit for bit. Do not build with
// --use_fast_math: it turns the division into an approximate one.
//
// Bound on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): the serving
// GEMMs at B=128 (M = 18,432 tokens in the MAR, 2,048 in the denoiser) are
// bound by operations: qkv (M, 768, 2304) is 65.2 G ops, 0.033 ms, against
// 101 MB of inputs and outputs, 0.030 ms. At B=1 (M = 144 and 16) and for
// the denoiser's K = 2 input projection they are bound by bytes, mostly the
// weight. The row quantization is bound by bytes (read x, write x_q).
//
// Design, simple first: 128 x 128 output tiles, 64-deep K tiles, 8 warps of
// 64 x 32 each issuing mma.sync.m16n8k32 s8 (not wgmma), two shared-memory
// stages filled by 16-byte cp.async where K % 16 == 0 and the operands are
// 16-byte aligned, else by byte loads; K is zero-filled up to the tile in
// shared memory, so any K (2 included) and ragged M and N are exact. Rows
// are padded to 80 bytes, which makes the 32-bit fragment loads free of
// bank conflicts. No wgmma, TMA or deeper pipeline yet.
//
// `faults` plants a known error for the serve checks' controls (0 in
// normal use; see kFault* below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFaultRoundHalfAway = 1;     // roundf instead of rintf
constexpr int kFaultReciprocalScale = 2;   // x * (127 / amax) instead of x / x_scale
constexpr int kFaultPerTensorWScale = 4;   // every column rescaled by w_scale[0]
constexpr int kFaultBiasBeforeCast = 8;    // bias added in fp32, then one cast

constexpr float kInv127 = 1.0f / 127.0f;   // folded to fl32(1/127)
constexpr float kScaleFloor = 1e-12f;

enum OutKind { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

// ---------------------------------------------------------------- quantize

constexpr int kQuantThreads = 256;  // 8 warps, one row each

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) { return __bfloat162float(*p); }

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
  for (int k = lane; k < K; k += 32) {
    const float v = load_float(xr + k);
    const float r = (faults & kFaultReciprocalScale) ? __fmul_rn(v, inv) : __fdiv_rn(v, s);
    float q = (faults & kFaultRoundHalfAway) ? roundf(r) : rintf(r);
    q = fminf(fmaxf(q, -127.f), 127.f);
    qr[k] = (int8_t)__float2int_rn(q);
  }
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One (128, 64) s8 tile of a row-major (rows, K) matrix into shared memory,
// zero where the row or the column lies outside the matrix.
template <bool kAligned>
__device__ __forceinline__ void load_tile(int8_t (*dst)[kLd], const int8_t* src, int rows,
                                          int row0, int K, int k0) {
  if (kAligned) {  // K % 16 == 0: a 16-byte chunk lies wholly inside or outside
    constexpr int kChunks = kBK / 16;
    for (int c = threadIdx.x; c < kBM * kChunks; c += kGemmThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 16;
      const bool in = row0 + r < rows && k0 + col < K;
      const int8_t* g = in ? src + (long long)(row0 + r) * K + k0 + col : src;
      cp_async16(&dst[r][col], g, in ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < kBM * kBK; c += kGemmThreads) {
      const int r = c / kBK;
      const int col = c % kBK;
      const bool in = row0 + r < rows && k0 + col < K;
      dst[r][col] = in ? src[(long long)(row0 + r) * K + k0 + col] : int8_t(0);
    }
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

__device__ __forceinline__ void store_out(const GemmParams& p, int m, int n, int acc) {
  const long long i = (long long)m * p.N + n;
  if (p.out_kind == kOutS32) {
    static_cast<int*>(p.out)[i] = acc;
    return;
  }
  const float ws = p.w_scale[(p.faults & kFaultPerTensorWScale) ? 0 : n];
  const float f = __fmul_rn(__fmul_rn(__int2float_rn(acc), p.x_scale[m]), ws);
  if (p.out_kind == kOutF32) {
    static_cast<float*>(p.out)[i] = p.bias ? __fadd_rn(f, p.bias[n]) : f;
    return;
  }
  __nv_bfloat16 o;
  if (p.bias && (p.faults & kFaultBiasBeforeCast)) {
    o = __float2bfloat16_rn(__fadd_rn(f, p.bias[n]));
  } else {
    o = __float2bfloat16_rn(f);
    if (p.bias) {
      const float b = __bfloat162float(__float2bfloat16_rn(p.bias[n]));
      o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), b));
    }
  }
  static_cast<__nv_bfloat16*>(p.out)[i] = o;
}

template <bool kAligned>
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
  load_tile<kAligned>(as[0], p.xq, p.M, m0, p.K, 0);
  load_tile<kAligned>(bs[0], p.wq, p.N, n0, p.K, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile<kAligned>(as[cur ^ 1], p.xq, p.M, m0, p.K, (kt + 1) * kBK);
      load_tile<kAligned>(bs[cur ^ 1], p.wq, p.N, n0, p.K, (kt + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait_prev();  // the stage of tile kt has landed
    __syncthreads();
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

}  // namespace

// x: contiguous (M, K), dtype 0 = float32, 1 = bfloat16. Writes xq (M, K)
// int8 and x_scale (M,) float32. Returns cudaGetLastError() after the launch.
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
  const bool aligned = K % 16 == 0 && (reinterpret_cast<uintptr_t>(xq) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(wq) % 16) == 0;
  if (aligned) {
    int8_gemm_kernel<true><<<grid, kGemmThreads, 0, s>>>(p);
  } else {
    int8_gemm_kernel<false><<<grid, kGemmThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
