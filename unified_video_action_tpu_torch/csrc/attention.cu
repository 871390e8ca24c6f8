// Non-causal flash attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernels `_attn_kernel_single_pass` and
// `_attn_kernel` (unified_video_action_tpu/ops/attention.py:33-110, launched
// through `flash_attention` at :161). One design covers both: the TPU keeps
// the whole KV of a head in VMEM when it fits and streams 256-wide blocks
// otherwise; here every block streams 64-wide KV tiles through shared memory
// with an online softmax, which is exact at any sequence length.
//
// Computes out = softmax(Q K^T / sqrt(D)) V for q, k, v of shape (B, N, H, D)
// read in place through their strides (the layout the fused qkv projection
// produces, so no transpose is made first). Scores, the running max, the
// running sum and the accumulator are fp32. In the bf16 path P is rounded to
// bf16 before P V, as the TPU kernel casts P to V's dtype.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the serving
// shape B=128, N=144, H=12, D=64 the kernel must move 4*B*N*H*D*2 = 113 MB
// (34 us) and compute 4*B*H*N*N*D = 8.2 GFLOP (8 us), so it is bound by
// bytes. The design reads each of q, k, v once per q-tile from device
// memory and never writes the N x N scores: with N=144 a head's K and V are
// read by three q-tiles, mostly from L2.
//
// Paths:
//   bf16: 4 warps per block, 64 query rows (16 per warp), mma.sync
//         m16n8k16 with fp32 accumulation; the score fragment is reused as
//         the A operand of P V without leaving registers.
//   fp32: one query row per thread, scalar fp32 FMA (tensor-core TF32 would
//         not hold the fp32 tolerance).
// Only D = 64 is built; the wrapper refuses other head widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
    if (q0 + r < p.N) val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_sn + col);
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
        kval = *reinterpret_cast<const uint4*>(kg + (kv0 + r) * p.k_sn + col);
        vval = *reinterpret_cast<const uint4*>(vg + (kv0 + r) * p.v_sn + col);
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
    if (active) val = *reinterpret_cast<const float4*>(qg + row * p.q_sn + 4 * c);
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
        kval = *reinterpret_cast<const float4*>(kg + (kv0 + r) * p.k_sn + col);
        vval = *reinterpret_cast<const float4*>(vg + (kv0 + r) * p.v_sn + col);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension must be contiguous and every row 16-byte aligned (the wrapper
// checks). The output is a contiguous (B, N, H, D) tensor. Returns the value
// of cudaGetLastError() after the launch.
extern "C" int uva_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int N, int H, int D,
                                   long long q_sb, long long q_sn, long long q_sh,
                                   long long k_sb, long long k_sn, long long k_sh,
                                   long long v_sb, long long v_sn, long long v_sh,
                                   int dtype, void* stream) {
  if (D != kHeadDim || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(B * H, (N + kBlockQ - 1) / kBlockQ);
    attn_bf16_kernel<<<grid, kThreads, 0, s>>>(p);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (N + kF32BlockQ - 1) / kF32BlockQ);
    attn_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
