// Non-causal flash attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernels `_attn_kernel_single_pass` and
// `_attn_kernel` (unified_video_action_tpu/ops/attention.py:33-110, launched
// through `flash_attention` at :161). Computes out = softmax(Q K^T / sqrt(D)) V
// for q, k, v of shape (B, N, H, D), D = 64, read in place through their
// strides (the layout the fused qkv projection produces, so no transpose is
// made first). Scores, row max, row sum and the accumulator are fp32; in bf16
// P is rounded to bf16 before P V, as the TPU kernels cast P to V's dtype.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the serving
// shape B=128, N=144, H=12, D=64 the kernel must move 4*B*N*H*D*2 = 113 MB
// (34 us) and compute 4*B*H*N*N*D = 8.2 GFLOP (8 us), so it is bound by
// bytes: each head's q, k and v should be read once and its output written
// once, and loads should overlap the math.
//
// Three kernels, picked by ops/attention.py's attention_plan:
//
//   uva_flash_attention_wgmma (bf16, N <= 256, every operand 16-byte
//       aligned): the counterpart of `_attn_kernel_single_pass`. Persistent
//       CTAs walk the B*H heads; per head one thread brings the head's Q, K
//       and V into shared memory by TMA (4-D tensor maps over (D, H, N, B)
//       straight on the strided views, 128-byte swizzle, rows past N
//       zero-filled) into a ring of stages, so the next heads load while
//       this one computes. Each warpgroup takes a 64-row q-tile of the
//       head: S = Q K^T by one wgmma m64nKVk16 per 16 of D (Q as the A
//       operand in registers, K as the K-major B operand), the exact softmax
//       over the whole row in registers (columns past N masked), P rounded
//       to bf16 into A-operand registers, O = P V by wgmma with V as an
//       MN-major B operand (the transpose flag; no transpose through shared
//       memory), then O / l staged in the q-tile's shared memory and stored
//       with 16-byte vectors, rows past N never stored. K and V are read
//       once per head, and at the serving N no KV column is padding (the
//       KV = 144 instance: 144 = 9 x 16). Instances hold KV = 144 or 256
//       rows; with few heads (B = 1) a split instance gives each q-tile of
//       each head a CTA of one warpgroup, which reads the head's K and V
//       itself, so the q-tiles of 12 heads run on 36 SMs.
//   uva_flash_attention, bf16: the counterpart of `_attn_kernel` for what
//       the single-pass kernel does not take (N > 256 or an operand off a
//       16-byte boundary): 4 warps per block, 64 query rows, mma.sync
//       m16n8k16 with an online softmax over 64-wide KV tiles, exact at any N.
//   uva_flash_attention, fp32: one query row per thread, scalar fp32 FMA
//       (tensor-core TF32 would not hold the fp32 tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;

// bf16 path tiles
constexpr int kBlockQ = 64;                 // 4 warps x 16 rows
constexpr int kBlockKV = 64;
constexpr int kPad = 8;                     // bf16 elements of row padding
constexpr int kLdQK = kHeadDim + kPad;      // row stride of the q and k tiles
constexpr int kLdVt = kBlockKV + kPad;      // row stride of the transposed v tile

// fp32 path tiles
constexpr int kF32BlockQ = kThreads;        // one query row per thread
constexpr int kF32BlockKV = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides of batch, token, head
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float scale_log2;            // D^-0.5 * log2(e): softmax runs on exp2
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B for one 16x8x16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 (or four fp32) from a row: one 16-byte load where the rows lie
// on 16-byte boundaries, else element by element.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (kVec) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    uint4 v;
    const uint16_t* src = static_cast<const uint16_t*>(p);
    uint16_t* dst = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = src[i];
    return v;
  }
}

template <bool kVec>
__device__ __forceinline__ float4 load4f(const float* p) {
  if constexpr (kVec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
attn_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][kLdQK];
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockKV][kLdQK];
  __shared__ __align__(16) __nv_bfloat16 vt[kHeadDim][kLdVt];

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared -> A fragments held for the whole KV loop.
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < p.N) val = load16<kVec>(qg + (q0 + r) * p.q_sn + col);
    *reinterpret_cast<uint4*>(&qs[r][col]) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&qs[r0][c0]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&qs[r0 + 8][c0]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&qs[r0][c0 + 8]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&qs[r0 + 8][c0 + 8]);
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // rows r0 (index 0) and r0 + 8 (index 1) of this warp's 16
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;  // per-thread partial sums, reduced at the end

  for (int kv0 = 0; kv0 < p.N; kv0 += kBlockKV) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockKV * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      uint4 kval = zero, vval = zero;
      if (kv0 + r < p.N) {
        kval = load16<kVec>(kg + (kv0 + r) * p.k_sn + col);
        vval = load16<kVec>(vg + (kv0 + r) * p.v_sn + col);
      }
      *reinterpret_cast<uint4*>(&ks[r][col]) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[col + i][r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[kBlockKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockKV / 8; ++nt) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale, mask the ragged edge, online softmax update.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = col < p.N ? s[nt][i] * p.scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // every tile holds column kv0 < N, so the tile max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0);  // 0 on the first tile
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int nt = 0; nt < kHeadDim / 8; ++nt) {
      acc[nt][0] *= alpha0;
      acc[nt][1] *= alpha0;
      acc[nt][2] *= alpha1;
      acc[nt][3] *= alpha1;
    }

    // O += P V: two adjacent 16x8 score fragments form one 16x16 A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nt = 0; nt < kHeadDim / 8; ++nt) {
        const __nv_bfloat16* vr = &vt[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(acc[nt], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / quad_sum(l0);
  const float inv1 = 1.f / quad_sum(l1);
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  const long long o_sn = (long long)p.H * kHeadDim;
  const long long base = ((long long)b * p.N * p.H + h) * kHeadDim;
#pragma unroll
  for (int nt = 0; nt < kHeadDim / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 < p.N)
      *reinterpret_cast<uint32_t*>(o + base + row0 * o_sn + col) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (row1 < p.N)
      *reinterpret_cast<uint32_t*>(o + base + row1 * o_sn + col) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
attn_f32_kernel(const Params p) {
  __shared__ __align__(16) float ks[kF32BlockKV][kHeadDim];
  __shared__ __align__(16) float vs[kF32BlockKV][kHeadDim];

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int tid = threadIdx.x;
  const int row = blockIdx.y * kF32BlockQ + tid;
  const bool active = row < p.N;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  constexpr int kChunks = kHeadDim / 4;  // float4 per row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float q[kHeadDim];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 val = zero;
    if (active) val = load4f<kVec>(qg + row * p.q_sn + 4 * c);
    q[4 * c + 0] = val.x * p.scale_log2;
    q[4 * c + 1] = val.y * p.scale_log2;
    q[4 * c + 2] = val.z * p.scale_log2;
    q[4 * c + 3] = val.w * p.scale_log2;
  }
  float acc[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < p.N; kv0 += kF32BlockKV) {
    __syncthreads();
    for (int c = tid; c < kF32BlockKV * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      float4 kval = zero, vval = zero;
      if (kv0 + r < p.N) {
        kval = load4f<kVec>(kg + (kv0 + r) * p.k_sn + col);
        vval = load4f<kVec>(vg + (kv0 + r) * p.v_sn + col);
      }
      *reinterpret_cast<float4*>(&ks[r][col]) = kval;
      *reinterpret_cast<float4*>(&vs[r][col]) = vval;
    }
    __syncthreads();

    float s[kF32BlockKV];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32BlockKV; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[j][4 * c]);
        d = fmaf(q[4 * c + 0], kv.x, d);
        d = fmaf(q[4 * c + 1], kv.y, d);
        d = fmaf(q[4 * c + 2], kv.z, d);
        d = fmaf(q[4 * c + 3], kv.w, d);
      }
      s[j] = kv0 + j < p.N ? d : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32BlockKV; ++j) {
      s[j] = exp2f(s[j] - mn);
      rs += s[j];
    }
    l = l * alpha + rs;
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BlockKV; ++j) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][4 * c]);
        acc[4 * c + 0] = fmaf(s[j], vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(s[j], vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(s[j], vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(s[j], vv.w, acc[4 * c + 3]);
      }
    }
  }

  if (!active) return;
  const float inv = 1.f / l;
  float* o = static_cast<float*>(p.o) + (((long long)b * p.N + row) * p.H + h) * kHeadDim;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    *reinterpret_cast<float4*>(o + 4 * c) =
        make_float4(acc[4 * c + 0] * inv, acc[4 * c + 1] * inv,
                    acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

// ---------------------------------------------------------------- single pass
//
// uva_flash_attention_wgmma. One CTA is kWG warpgroups, each taking the
// q-tiles wg, wg + kWG, ... of every head; thread 0 also issues the TMA
// loads. (A separate producer warp would round the block up to another
// warpgroup's worth of registers: 128 a thread at kWG = 3, which spills the
// 72-register score row.) A stage holds one head: its q-tiles (kQTiles x 64
// rows), K and V (kKV rows each), every row 128 bytes (D = 64 bf16) in the
// 128-byte swizzle, each buffer 1024-byte aligned. full[s] completes when
// the stage's bytes have landed; empty[s] when every thread is done with it
// (its output stored). Thread 0 fills the first kStages stages at the start
// and refills a stage for the head kStages turns later as soon as it is
// empty, so kStages - 1 heads load while one computes.

constexpr int kRowBytes = kHeadDim * 2;  // one 128-byte swizzle row

template <int kChunks, int kWG, int kStages, bool kSplit>
struct SinglePass {
  static_assert(!kSplit || kWG == 1, "a split CTA takes one q-tile with one warpgroup");
  static constexpr int kKV = 16 * kChunks;  // KV rows held: this instance takes N <= kKV
  static constexpr int kQTiles = kSplit ? 1 : (kKV + 63) / 64;  // q-tiles a stage holds
  static constexpr int kQBytes = kQTiles * 64 * kRowBytes;
  static constexpr int kKVBytes = kKV * kRowBytes;  // a multiple of 2048
  static constexpr int kStageBytes = kQBytes + 2 * kKVBytes;
  static constexpr int kThreads = 128 * kWG;
  // the stages, two barriers per stage, the slack that aligns the stages to
  // 1024 B (the swizzle atom)
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block on an H100");
  static_assert(kQTiles * 64 <= 256 && kKV <= 256, "a TMA box spans at most 256 rows");
};

struct SinglePassParams {
  __nv_bfloat16* o;
  int N, H;
  int n_qtiles;  // ceil(N / 64)
  int items;     // B * H heads, times n_qtiles where split
  float scale_log2;
};

// One (64, rows, 1, 1) box of a (D, H, N, B) tensor map: the rows n0 .. of
// head h of batch b; rows past N arrive as zeros.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int n0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(n0), "r"(b)
      : "memory");
}

// d (64 x kN, fp32) = a (64 x 16 bf16, registers) * b (16 x kN bf16, K-major
// in shared memory), plus d where kAccumulate: one k16 step of S = Q K^T over
// all kN KV columns. The first step of a sum writes d without reading it, so
// no zeros are kept in registers for it.
template <int kN> struct WgmmaQK;
template <>
struct WgmmaQK<144> {
  template <bool kAccumulate>
  __device__ __forceinline__ static void mma(float (&d)[72], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (kAccumulate) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
          "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
          "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
          "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
          "%66, %67, %68, %69, %70, %71"
          "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
          :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
          "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
          "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
          "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
          "%66, %67, %68, %69, %70, %71"
          "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
          :
          "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
          "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
          "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
          "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
          "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
          "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]),
          "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  }
  };

template <>
struct WgmmaQK<256> {
  template <bool kAccumulate>
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (kAccumulate) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
          "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
          "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
          "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
          "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
          "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
          "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
          "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
          "%124, %125, %126, %127"
          "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
          :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
          "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
          "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
          "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
          "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
          "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
          "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
          "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
          "%124, %125, %126, %127"
          "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
          :
          "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
          "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
          "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
          "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
          "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
          "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]),
          "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]), "=f"(d[72]), "=f"(d[73]),
          "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
          "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]),
          "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]),
          "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]), "=f"(d[96]), "=f"(d[97]),
          "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
          "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]),
          "=f"(d[110]), "=f"(d[111]), "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]),
          "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]), "=f"(d[120]), "=f"(d[121]),
          "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
  }
  };

// d (64 x 64, fp32) = a (64 x 16 bf16, registers) * b (16 x 64 bf16, MN-major
// in shared memory: the transpose flag), plus d where kAccumulate: 16 KV
// rows of O = P V.
#define UVA_PV_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define UVA_PV_OUT(m) m(d[0]), m(d[1]), m(d[2]), m(d[3]), m(d[4]), m(d[5]), m(d[6]), m(d[7]), \
  m(d[8]), m(d[9]), m(d[10]), m(d[11]), m(d[12]), m(d[13]), m(d[14]), m(d[15]), m(d[16]),  \
  m(d[17]), m(d[18]), m(d[19]), m(d[20]), m(d[21]), m(d[22]), m(d[23]), m(d[24]), m(d[25]), \
  m(d[26]), m(d[27]), m(d[28]), m(d[29]), m(d[30]), m(d[31])
#define UVA_RW(x) "+f"(x)
#define UVA_W(x) "=f"(x)
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kAccumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UVA_PV_REGS
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : UVA_PV_OUT(UVA_RW)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UVA_PV_REGS
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : UVA_PV_OUT(UVA_W)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}
#undef UVA_PV_REGS
#undef UVA_PV_OUT
#undef UVA_RW
#undef UVA_W

// 2^x with the hardware's approximation (2 ulp; -inf gives 0): the score
// tolerance is bf16's, and P is rounded to bf16 next.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// 128-byte-swizzled tile whose base is 1024-byte aligned.
__device__ __forceinline__ int swizzled(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

template <int kChunks, int kWG, int kStages, bool kSplit>
__global__ void __launch_bounds__(SinglePass<kChunks, kWG, kStages, kSplit>::kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const SinglePassParams p) {
  using S = SinglePass<kChunks, kWG, kStages, kSplit>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* aligned = smem_raw + (base - raw);
  const uint32_t full_bar = base + kStages * S::kStageBytes;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, S::kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A work item is a head, or where split one q-tile of a head.
  auto head_of = [&](int item) { return kSplit ? item / p.n_qtiles : item; };
  // thread 0: the loads of this CTA's item number `turn` into stage turn % kStages
  auto load_item = [&](int turn) {
    const int item = blockIdx.x + turn * gridDim.x;
    const int head = head_of(item);
    const int stage = turn % kStages;
    const uint32_t st = base + stage * S::kStageBytes;
    const uint32_t bar = full_bar + 8 * stage;
    mbar_expect_tx(bar, S::kStageBytes);
    tma_load_rows(st, &map_q, bar, head % p.H, kSplit ? 64 * (item % p.n_qtiles) : 0, head / p.H);
    tma_load_rows(st + S::kQBytes, &map_k, bar, head % p.H, 0, head / p.H);
    tma_load_rows(st + S::kQBytes + S::kKVBytes, &map_v, bar, head % p.H, 0, head / p.H);
  };
  const int turns = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;  // items of this CTA
  if (threadIdx.x == 0)
    for (int turn = 0; turn < kStages && turn < turns; ++turn) load_item(turn);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group: rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // fragment column pair
  const int r0 = warp * 16 + g;
  int stage = 0;
  uint32_t phase = 0;
  for (int turn = 0; turn < turns; ++turn) {
    const int item = blockIdx.x + turn * gridDim.x;
    const int head = head_of(item);
    const int b = head / p.H, h = head % p.H;
    const uint32_t st = base + stage * S::kStageBytes;
    uint8_t* st_ptr = aligned + stage * S::kStageBytes;
    const uint32_t k_smem = st + S::kQBytes;
    const uint32_t v_smem = k_smem + S::kKVBytes;
    mbar_wait(full_bar + 8 * stage, phase);
    const int qt_first = kSplit ? item % p.n_qtiles : wg;
    const int qt_end = kSplit ? qt_first + 1 : p.n_qtiles;
    for (int qt = qt_first; qt < qt_end; qt += kWG) {
      uint8_t* q_tile = st_ptr + (kSplit ? 0 : qt) * 64 * kRowBytes;

      // Q rows r0 and r0 + 8 as A fragments of the four k16 steps over D
      uint32_t qa[kHeadDim / 16][4];
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const int lo = swizzled(r0, 2 * kk) + 4 * t, hi = swizzled(r0, 2 * kk + 1) + 4 * t;
        const int lo8 = swizzled(r0 + 8, 2 * kk) + 4 * t, hi8 = swizzled(r0 + 8, 2 * kk + 1) + 4 * t;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_tile + lo);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_tile + lo8);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_tile + hi);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(q_tile + hi8);
      }

      // S = Q K^T over all kKV columns, one wgmma per k16 step of D.
      // Register 4 j + e: row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1).
      float s[S::kKV / 2];
      wgmma_fence();
      WgmmaQK<S::kKV>::template mma<false>(s, qa[0], smem_desc(k_smem));
#pragma unroll
      for (int kk = 1; kk < kHeadDim / 16; ++kk)
        WgmmaQK<S::kKV>::template mma<true>(s, qa[kk], smem_desc(k_smem + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // the exact softmax of the whole row: mask, max, exp2 of the scaled
      // difference (one FMA), sum
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int r = 0; r < S::kKV / 2; ++r) {
        const int col = 8 * (r / 4) + 2 * t + (r & 1);
        if (col >= p.N) s[r] = -INFINITY;
        if ((r >> 1) & 1) m1 = fmaxf(m1, s[r]); else m0 = fmaxf(m0, s[r]);
      }
      // column 0 < N: finite
      const float c0 = -quad_max(m0) * p.scale_log2, c1 = -quad_max(m1) * p.scale_log2;
      float l0 = 0.f, l1 = 0.f;
      uint32_t pa[kChunks][4];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float& x = s[8 * i + e];
          x = ex2(fmaf(x, p.scale_log2, ((e >> 1) & 1) ? c1 : c0));
          if ((e >> 1) & 1) l1 += x; else l0 += x;
        }
        // registers 8 i .. 8 i + 7 are the A fragment of the k16 step i of P V
        pa[i][0] = pack_bf16(s[8 * i], s[8 * i + 1]);
        pa[i][1] = pack_bf16(s[8 * i + 2], s[8 * i + 3]);
        pa[i][2] = pack_bf16(s[8 * i + 4], s[8 * i + 5]);
        pa[i][3] = pack_bf16(s[8 * i + 6], s[8 * i + 7]);
      }

      // O = P V. Register 4 j + e: row r0 + 8 (e >> 1), column 8 j + 2 t + (e & 1).
      float o[32];
      wgmma_fence();
      wgmma_pv<false>(o, pa[0], smem_desc(v_smem));
#pragma unroll
      for (int i = 1; i < kChunks; ++i) wgmma_pv<true>(o, pa[i], smem_desc(v_smem + i * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      // O / l into the q-tile's own rows of shared memory (each warp wrote
      // and read only its 16 rows so far), then 16-byte stores of the rows < N
      const float inv0 = 1.f / quad_sum(l0);
      const float inv1 = 1.f / quad_sum(l1);
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        *reinterpret_cast<uint32_t*>(q_tile + swizzled(r0, j) + 4 * t) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(q_tile + swizzled(r0 + 8, j) + 4 * t) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const long long o_sn = (long long)p.H * kHeadDim;
      __nv_bfloat16* o_head = p.o + ((long long)b * p.N * p.H + h) * kHeadDim;
#pragma unroll
      for (int c = tid; c < 64 * kHeadDim / 8; c += 128) {
        const int r = c / 8, chunk = c % 8;
        const int n = qt * 64 + r;
        if (n < p.N)
          *reinterpret_cast<uint4*>(o_head + n * o_sn + chunk * 8) =
              *reinterpret_cast<const uint4*>(q_tile + swizzled(r, chunk));
      }
    }
    // this thread is done with the stage: its generic reads and writes come
    // before the next TMA writes into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(empty_bar + 8 * stage);
    if (threadIdx.x == 0 && turn + kStages < turns) {
      mbar_wait(empty_bar + 8 * stage, phase);  // every thread is done with the stage
      load_item(turn + kStages);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A (B, N, H, 64) bf16 view as a 4-D TMA map over (D, H, N, B) with
// (64, 1, box_rows, 1) boxes and the 128-byte swizzle; rows past N read as zero.
int encode_heads(CUtensorMap* map, const void* ptr, int B, int N, int H, long long sb,
                 long long sn, long long sh, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHeadDim, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kHeadDim, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return (int)cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                     const_cast<void*>(ptr), dims, strides, box, elem_strides,
                                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kChunks, int kWG, int kStages, bool kSplit>
int launch_single_pass(const Params& a, cudaStream_t s) {
  using S = SinglePass<kChunks, kWG, kStages, kSplit>;
  auto kernel = attn_wgmma_kernel<kChunks, kWG, kStages, kSplit>;
  static int blocks_per_sm = 0;  // per instantiation, found once
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, S::kThreads, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_q, map_k, map_v;
  int rc = encode_heads(&map_q, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh, S::kQTiles * 64);
  if (rc == 0) rc = encode_heads(&map_k, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh, S::kKV);
  if (rc == 0) rc = encode_heads(&map_v, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh, S::kKV);
  if (rc != 0) return kEncodeError + rc;
  SinglePassParams p;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.N = a.N;
  p.H = a.H;
  p.n_qtiles = (a.N + 63) / 64;
  p.items = a.B * a.H * (kSplit ? p.n_qtiles : 1);
  p.scale_log2 = a.scale_log2;
  const int grid = min(p.items, num_sms() * blocks_per_sm);
  kernel<<<grid, S::kThreads, S::kSmem, s>>>(map_q, map_k, map_v, p);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

Params make_params(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                   int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                   long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                   long long v_sh) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.N = N;
  p.H = H;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  return p;
}

}  // namespace

// The mma.sync (bf16) and scalar (fp32) kernels. dtype: 0 = float32,
// 1 = bfloat16. Strides are in elements; the last dimension must be
// contiguous. aligned: every row of q, k and v starts on a 16-byte boundary
// (16-byte loads), else element loads. The output is a contiguous
// (B, N, H, D) tensor. Returns the value of cudaGetLastError() after the launch.
extern "C" int uva_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int N, int H, int D,
                                   long long q_sb, long long q_sn, long long q_sh,
                                   long long k_sb, long long k_sn, long long k_sh,
                                   long long v_sb, long long v_sn, long long v_sh,
                                   int dtype, int aligned, void* stream) {
  if (D != kHeadDim || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(B * H, (N + kBlockQ - 1) / kBlockQ);
    if (aligned) attn_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else attn_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (N + kF32BlockQ - 1) / kF32BlockQ);
    if (aligned) attn_f32_kernel<true><<<grid, kThreads, 0, s>>>(p);
    else attn_f32_kernel<false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The single-pass Hopper kernel, bf16 only, on the same arguments: every
// base and stride 16-byte aligned (TMA's rules) and N <= kv, where kv is the
// instance, 144 or 256 (the KV rows it holds in shared memory). split: one
// CTA (one warpgroup) for each q-tile of each head, for few heads; else one
// CTA for all q-tiles of a head. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for arguments
// it does not take, or kEncodeError + the CUresult of a failed TMA encode.
extern "C" int uva_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int B, int N, int H, int D,
                                         long long q_sb, long long q_sn, long long q_sh,
                                         long long k_sb, long long k_sn, long long k_sh,
                                         long long v_sb, long long v_sn, long long v_sh,
                                         int kv, int split, void* stream) {
  const long long strides[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  bool ok = D == kHeadDim && B > 0 && N > 0 && H > 0 && N <= kv &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (long long st : strides) ok = ok && (st * 2) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv == 144) return split ? launch_single_pass<9, 1, 2, true>(p, s)
                              : launch_single_pass<9, 3, 3, false>(p, s);
  if (kv == 256) return split ? launch_single_pass<16, 1, 2, true>(p, s)
                              : launch_single_pass<16, 2, 2, false>(p, s);
  return (int)cudaErrorInvalidValue;
}
