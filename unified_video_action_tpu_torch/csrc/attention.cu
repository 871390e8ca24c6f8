// Non-causal flash attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernels `_attn_kernel_single_pass` and
// `_attn_kernel` (unified_video_action_tpu/ops/attention.py:33-110, launched
// through `flash_attention` at :161). Computes out = softmax(Q K^T / sqrt(D)) V
// for q, k, v of shape (B, N, H, D), read in place through their strides (the
// layout the fused qkv projection produces, so no transpose is made first).
// Every kernel is a template over the head dimension D, built for D = 64
// (mar_base: 768 / 12 heads), D = 80 (mar_huge: 1280 / 16 heads) and D = 128
// (mar_small and mar_tiny: 768 / 6 heads); another D is refused. Scores, row
// max, row sum and the accumulator are fp32; in bf16 P is rounded to bf16
// before P V, as the TPU kernels cast P to V's dtype.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the 96 px
// serving shape B=128, N=144, H=12, D=64 the kernel must move 4*B*N*H*D*2 =
// 113 MB (34 us) and compute 4*B*H*N*N*D = 8.2 GFLOP (8 us), so it is bound
// by bytes: each head's q, k and v should be read once and its output
// written once, and loads should overlap the math. mar_small's shapes move
// the same bytes per token (H*D = 768) and are bound the same way. At the
// 256 px path's N=1024 it computes 412 GFLOP (0.417 ms) against 101 MB
// (0.030 ms), bound by operations, and at D = 64 the softmax's exp2 costs the
// SM as many clocks as the two products: hiding one behind the other is what
// that kernel does.
//
// Shared-memory tiles of the TMA kernels are 128-byte swizzle rows (64 bf16
// columns): at D = 128 a tile is two 64-column slabs, each its own block of
// rows (slab 0 rows, then slab 1 rows), loaded by one TMA box each. The
// Q K^T k-steps walk into the second slab from the fifth on, and the P V
// product reads V as an MN-major operand whose two 64-column halves lie one
// slab apart (the descriptor's leading-byte offset).
//
// D = 80 (160 bytes a row, not a whole number of 128-byte swizzle rows):
// the online kernel holds it at exact width, a 64-column slab in the
// 128-byte swizzle and a 16-column slab of 32-byte rows in the 32-byte
// swizzle, each loaded by its own TMA box (no box reaches past column 79);
// its section below says how. The single-pass kernel holds it in the D = 128
// layout, padded: the TMA maps' inner extent is the true 80, so the second
// slab's box (columns 64-127) brings columns 64-79 from memory and fills
// 80-127 with zeros; its P V is one m64n128k16 a k-step whose columns 80-127
// are zeros and never stored (1.3x the true work, the bytes moved unchanged).
// Neither reads a column past 79 from memory; the epilogues store 80 columns
// with a row stride of H * 80.
//
// Three kernels, picked by ops/attention.py's attention_plan, and a copy:
//
//   uva_flash_attention_wgmma (bf16, N <= 144, every operand 16-byte
//       aligned): the counterpart of `_attn_kernel_single_pass`. Persistent
//       CTAs walk the B*H heads; per head one thread brings the head's Q, K
//       and V into shared memory by TMA (4-D tensor maps over (D, H, N, B)
//       straight on the strided views, 128-byte swizzle, rows past N
//       zero-filled) into a ring of stages, so the next heads load while
//       this one computes. Each warpgroup takes a 64-row q-tile of the
//       head: S = Q K^T by one wgmma m64n144k16 per 16 of D (Q as the A
//       operand in registers, K as the K-major B operand), the exact softmax
//       over the whole row in registers (columns past N masked), P rounded
//       to bf16 into A-operand registers, O = P V by wgmma with V as an
//       MN-major B operand (the transpose flag; no transpose through shared
//       memory), then O / l staged in the q-tile's shared memory and stored
//       with 16-byte vectors, rows past N never stored. K and V are read
//       once per head, and at the serving N no KV column is padding (144 =
//       9 x 16). With few heads (B = 1) a split instance gives each q-tile of
//       each head a CTA of one warpgroup, which reads the head's K and V
//       itself, so the q-tiles of 12 heads run on 36 SMs.
//   uva_flash_attention_online (bf16, N > 144, aligned): the counterpart of
//       `_attn_kernel`, and of `_attn_kernel_single_pass` above 256 rows
//       (the same function): q-tiles against 128-row KV tiles streamed by
//       TMA through a ring of stages by a producer warpgroup, wgmma for both
//       products, an online softmax in registers, two consumer warpgroups
//       taking turns. Its section below says how.
//   uva_flash_attention, fp32, aligned or not: both products on the tensor
//       cores in 3xTF32 (each operand split into two TF32 halves, three
//       mma.sync m16n8k8 products; one TF32 product would not hold the fp32
//       tolerance), 16 or 32 query rows a warp, K and V streamed in 32-row
//       tiles by cp.async, an online softmax in registers. Its section
//       below says how. At (128, 144, 12, 64) it must move 226 MB (0.068 ms) and do
//       3 x 8.2 GFLOP of TF32 products (0.049 ms at 495 TFLOP/s): bound by
//       bytes at the serving N, by the products from N of about 200 on.
//   uva_stage_qkv: bf16 views TMA cannot read (an operand off a 16-byte
//       boundary) copied in one launch into one contiguous (B, N, 3, H, D)
//       buffer, whose views the two TMA kernels then take. Its section below
//       says how.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ fp32: 3xTF32
//
// uva_flash_attention with dtype 0 (and uva_flash_attention_tf32_tile, the
// tile sweep's entry): both products on the tensor cores as three TF32
// mma.sync m16n8k8 products each. One TF32 product keeps 10 mantissa bits of
// each operand (about 5e-4 relative), which would put the output about 1e-4
// to 5e-4 off the fp32 einsum, outside the fp32 tolerance of 2e-5. So every
// operand x is split in registers into hi = x with its low 13 bits cleared
// and lo = x - hi (exact in fp32), and a b is summed as lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b), the small products first. The tensor core reads
// the top 19 bits of each register, so hi is used whole and lo cut to its
// top 11 significant bits (about 2^-21 of x); the dropped lo(a) lo(b) is
// about 2^-20 of a b. The split is two full-rate instructions (LOP3, FADD).
// tests/test_torch_attention_tf32.py emulates the arithmetic on the CPU.
//
// A CTA of 4 warps takes 4 x kMT x 16 query rows of one head (a warp kMT
// m16 tiles, so that each K and V fragment it loads and splits serves
// kMT x 3 products) and streams the head's K and V in KV tiles of
// kBlockKV rows through a two-stage cp.async ring in shared memory (16-byte
// copies where every row lies on a 16-byte boundary, 4-byte ones where it
// does not; rows past N are zero-filled and masked out of the softmax). Q
// waits in shared memory, loaded with the first KV tile, and each k-step
// reads and splits its A fragments; the softmax is online, in registers, on
// the SFU's exp2 with D^-1/2 log2(e) applied in the exponent. The CTAs of
// one head are adjacent in the grid, so the head's K and V come from L2
// after the first.
//
// The tensor core adds into its fp32 accumulator rounding toward zero, so a
// sum carried through every KV tile drifts: O accumulated over N = 2304 rows
// that way missed the fp32 tolerance on the card. Each KV tile's P V starts
// from zero instead (its chain is the tile's 3 kBlockKV / 8 products), and
// O = O alpha + P V is an fp32 FMA; S's chain is 3 D / 8 products.
//
// No shuffle and no shared-memory round trip turns S into the A operand of
// P V: a contraction does not depend on the order of its index, so k-step
// index t of a fragment stands for column 2t and t + 4 for 2t + 1. Then the
// thread holding S's accumulator columns 2t and 2t + 1 (rows g and g + 8)
// holds exactly the A fragment of P, and V's B fragment is rows 2t and
// 2t + 1 of the tile (column g). The same relabelling in Q K^T makes Q's A
// fragment and K's B fragment two adjacent columns, one 8-byte load each.
// Row strides in shared memory are padded against bank conflicts: Q's and
// K's to 8 mod 32 words at D = 64 and 128, 24 at D = 80 (a half-warp's
// 8-byte loads of rows g, columns 2t hit 16 distinct bank pairs), V's to
// 4 mod 16 (rows 2t and 2t + 1, column g: 32 distinct banks).
//
// At D = 80 the products are exact width: 10 k-steps of 8 in Q K^T, 10
// n-tiles of 8 in P V. Registers a thread: O and the tile's P V kMT D / 2
// each, S kMT kBlockKV / 2.
template <int kD, int kMT, int kBlockKV>
struct Tf32Tiles {
  static constexpr int kThreads = 128;          // 4 warps
  static constexpr int kRows = 4 * kMT * 16;    // query rows a CTA
  static constexpr int kLdQK = kD + 8;
  static constexpr int kLdV = kD + 4;
  static constexpr int kStage = kBlockKV * (kLdQK + kLdV);  // floats
  static constexpr int kSmem = (kRows * kLdQK + 2 * kStage) * 4;
  static_assert(kD % 8 == 0 && kBlockKV % 8 == 0, "whole k-steps and n-tiles");
};

// x = hi + lo: hi is x with the 13 bits below TF32's mantissa cleared, lo
// the rest, exact; the tensor core reads lo's top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A * B for one 16x8x8 TF32 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B for one 16x8x8 TF32 tile, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                   uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// 2^x by the SFU (relative error about 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An A fragment (a0..a3) split into its hi and lo registers.
__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// D += A * B in 3xTF32 on A's split fragment and B's (b0, b1), the small
// products first; kFromZero: D = A * B.
template <bool kFromZero = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  if constexpr (kFromZero) {
    mma_tf32_from_zero(d, a_lo, b_hi[0], b_hi[1]);
  } else {
    mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  }
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// One 16-byte (kVec) or 4-byte piece of a row into shared memory by
// cp.async, or zeros where !valid (src-size 0: nothing is read).
template <bool kVec>
__device__ __forceinline__ void cp_async_piece(float* dst, const float* src, bool valid) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kTileRows rows from `row0` on (zeros from row N on) of a (rows, D) fp32
// view with row stride `sn` into shared-memory rows of `ld` floats, by
// cp.async.
template <int kD, int kTileRows, int kThreads, bool kVec>
__device__ __forceinline__ void cp_async_rows(float* dst, int ld, const float* src, long long sn,
                                              int row0, int N) {
  constexpr int kPiece = kVec ? 4 : 1;
  constexpr int kPieces = kD / kPiece;  // pieces a row
  for (int c = threadIdx.x; c < kTileRows * kPieces; c += kThreads) {
    const int r = c / kPieces;
    const int col = (c % kPieces) * kPiece;
    const bool valid = row0 + r < N;
    cp_async_piece<kVec>(dst + r * ld + col, src + (valid ? row0 + r : 0) * sn + col, valid);
  }
}

template <int kD, int kMT, int kBlockKV, bool kVec>
__global__ void __launch_bounds__(128)
attn_tf32_kernel(const Params p, const int n_qtiles) {
  using T = Tf32Tiles<kD, kMT, kBlockKV>;
  constexpr int kKSteps = kD / 8;      // k-steps of Q K^T, n-tiles of P V
  constexpr int kNT = kBlockKV / 8;    // n-tiles of S, k-steps of P V
  extern __shared__ __align__(16) float tf32_smem[];
  float* qs = tf32_smem;
  float* stages = tf32_smem + T::kRows * T::kLdQK;

  const int q_tile = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int q0 = q_tile * T::kRows;
  const int warp_row = warp * kMT * 16;     // in the CTA's rows
  const bool active = q0 + warp_row < p.N;  // a warp past the last row only loads

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  auto load_kv = [&](int stage, int kv0) {
    float* ks = stages + stage * T::kStage;
    cp_async_rows<kD, kBlockKV, T::kThreads, kVec>(ks, T::kLdQK, kg, p.k_sn, kv0, p.N);
    cp_async_rows<kD, kBlockKV, T::kThreads, kVec>(ks + kBlockKV * T::kLdQK, T::kLdV, vg, p.v_sn,
                                                  kv0, p.N);
    cp_async_commit();
  };

  const int n_kv = (p.N + kBlockKV - 1) / kBlockKV;
  cp_async_rows<kD, T::kRows, T::kThreads, kVec>(
      qs, T::kLdQK, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.N);
  load_kv(0, 0);  // one group with Q

  float o[kMT][kKSteps][4];
  float m[kMT][2], l[kMT][2];  // rows g and g + 8 of each m-tile; l per thread, reduced at the end
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < kKSteps; ++nd) o[mt][nd][0] = o[mt][nd][1] = o[mt][nd][2] = o[mt][nd][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int it = 0; it < n_kv; ++it) {
    const int kv0 = it * kBlockKV;
    if (it + 1 < n_kv) {
      load_kv((it + 1) & 1, kv0 + kBlockKV);  // its stage was freed at the end of it - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* ks = stages + (it & 1) * T::kStage;
      const float* vs = ks + kBlockKV * T::kLdQK;

      // S = Q K^T, kMT x 16 rows x kBlockKV columns: at k-step kk, Q's
      // a0..a3 are rows (g, g + 8, g, g + 8) at columns (c, c, c + 1, c + 1)
      // and K's b0, b1 row g of the n-tile at columns c and c + 1, c = 8 kk + 2t
      float s[kMT][kNT][4];
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int c = 8 * kk + 2 * t;
        uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float* qr = qs + (warp_row + mt * 16 + g) * T::kLdQK + c;
          const float2 x0 = *reinterpret_cast<const float2*>(qr);
          const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * T::kLdQK);
          const float qa[4] = {x0.x, x1.x, x0.y, x1.y};
          split_a(qa, a_hi[mt], a_lo[mt]);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float2 kb = *reinterpret_cast<const float2*>(ks + (nt * 8 + g) * T::kLdQK + c);
          uint32_t b_hi[2], b_lo[2];
          split_tf32(kb.x, b_hi[0], b_lo[0]);
          split_tf32(kb.y, b_hi[1], b_lo[1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            if (kk == 0)
              mma_3xtf32<true>(s[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
            else
              mma_3xtf32(s[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
          }
        }
      }

      // the online softmax on exp2, D^-1/2 log2(e) applied in the exponent:
      // p = 2^(s scale - m), m the running max of s scale
      float alpha[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (kv0 + kBlockKV > p.N) {  // the ragged last tile: zero-filled rows out of the softmax
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (kv0 + nt * 8 + 2 * t + (i & 1) >= p.N) s[mt][nt][i] = -INFINITY;
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
        }
        // every tile holds column kv0 < N, so the tile max is finite
        const float mn0 = fmaxf(m[mt][0], quad_max(mx0) * p.scale_log2);
        const float mn1 = fmaxf(m[mt][1], quad_max(mx1) * p.scale_log2);
        alpha[mt][0] = fast_exp2(m[mt][0] - mn0);  // 0 on the first tile
        alpha[mt][1] = fast_exp2(m[mt][1] - mn1);
        m[mt][0] = mn0;
        m[mt][1] = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          s[mt][nt][0] = fast_exp2(fmaf(s[mt][nt][0], p.scale_log2, -mn0));
          s[mt][nt][1] = fast_exp2(fmaf(s[mt][nt][1], p.scale_log2, -mn0));
          s[mt][nt][2] = fast_exp2(fmaf(s[mt][nt][2], p.scale_log2, -mn1));
          s[mt][nt][3] = fast_exp2(fmaf(s[mt][nt][3], p.scale_log2, -mn1));
          rs0 += s[mt][nt][0] + s[mt][nt][1];
          rs1 += s[mt][nt][2] + s[mt][nt][3];
        }
        l[mt][0] = l[mt][0] * alpha[mt][0] + rs0;
        l[mt][1] = l[mt][1] * alpha[mt][1] + rs1;
      }

      // P V of this tile into its own accumulator, from zero, then O = O
      // alpha + P V in fp32: the tensor core's accumulation (which rounds
      // toward zero) never runs longer than one tile's 3 kNT products. S's
      // n-tile j is P's k-step j, its k index t column 2t and t + 4 column
      // 2t + 1, so a0..a3 = s[j][0], s[j][2], s[j][1], s[j][3], and V's b0,
      // b1 are rows 8j + 2t and 8j + 2t + 1 at column g of the n-tile
      float pv[kMT][kKSteps][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float pa[4] = {s[mt][j][0], s[mt][j][2], s[mt][j][1], s[mt][j][3]};
          split_a(pa, a_hi[mt], a_lo[mt]);
        }
        const float* vr = vs + (8 * j + 2 * t) * T::kLdV + g;
#pragma unroll
        for (int nd = 0; nd < kKSteps; ++nd) {
          uint32_t b_hi[2], b_lo[2];
          split_tf32(vr[8 * nd], b_hi[0], b_lo[0]);
          split_tf32(vr[T::kLdV + 8 * nd], b_hi[1], b_lo[1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            if (j == 0)
              mma_3xtf32<true>(pv[mt][nd], a_hi[mt], a_lo[mt], b_hi, b_lo);
            else
              mma_3xtf32(pv[mt][nd], a_hi[mt], a_lo[mt], b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nd = 0; nd < kKSteps; ++nd) {
          o[mt][nd][0] = fmaf(o[mt][nd][0], alpha[mt][0], pv[mt][nd][0]);
          o[mt][nd][1] = fmaf(o[mt][nd][1], alpha[mt][0], pv[mt][nd][1]);
          o[mt][nd][2] = fmaf(o[mt][nd][2], alpha[mt][1], pv[mt][nd][2]);
          o[mt][nd][3] = fmaf(o[mt][nd][3], alpha[mt][1], pv[mt][nd][3]);
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!active) return;
  float* out = static_cast<float*>(p.o);
  const long long o_sn = (long long)p.H * kD;
  const long long base = ((long long)b * p.N * p.H + h) * kD;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int row0 = q0 + warp_row + mt * 16 + g;
    const int row1 = row0 + 8;
    const float inv0 = 1.f / quad_sum(l[mt][0]);
    const float inv1 = 1.f / quad_sum(l[mt][1]);
#pragma unroll
    for (int nd = 0; nd < kKSteps; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (row0 < p.N)
        *reinterpret_cast<float2*>(out + base + row0 * o_sn + col) =
            make_float2(o[mt][nd][0] * inv0, o[mt][nd][1] * inv0);
      if (row1 < p.N)
        *reinterpret_cast<float2*>(out + base + row1 * o_sn + col) =
            make_float2(o[mt][nd][2] * inv1, o[mt][nd][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------- single pass
//
// uva_flash_attention_wgmma. One CTA is kWG warpgroups, each taking the
// q-tiles wg, wg + kWG, ... of every head; thread 0 also issues the TMA
// loads. (A separate producer warp would round the block up to another
// warpgroup's worth of registers: 128 a thread at kWG = 3, which spills the
// 72-register score row.) A stage holds one head: its q-tiles (kQTiles x 64
// rows), K and V (kKV rows each), each as held_cols(kD) / 64 slabs of
// 128-byte rows (64 bf16) in the 128-byte swizzle, each slab 1024-byte
// aligned. full[s] completes when the stage's bytes have landed; empty[s]
// when every thread is done with it (its output stored). Thread 0 fills the first kStages stages at the start
// and refills a stage for the head kStages turns later as soon as it is
// empty, so kStages - 1 heads load while one computes. At D = 128 (and D =
// 80, held as 128) a stage of a whole head would be 120 KB, room for one
// stage and no overlap of loads and math, so only the split instance is
// built (two stages of 88 KB); tools/kernels_ab.py measured a one-stage
// whole-head instance slower at every batch but B = 16 of (B, 144, 6, 128).

constexpr int kRowBytes = 128;  // one 128-byte swizzle row: 64 bf16 columns
constexpr int kSlabCols = kRowBytes / 2;

// The columns of D that the single-pass kernel's shared-memory tile holds:
// whole 64-column slabs (D = 80 is held as 128, columns 80-127 TMA's zero
// fill). The online kernel's tiles hold D exactly (exact_chunk, below).
__host__ __device__ constexpr int held_cols(int d) { return (d + kSlabCols - 1) / kSlabCols * kSlabCols; }

template <int kD, int kChunks, int kWG, int kStages, bool kSplit>
struct SinglePass {
  static_assert(!kSplit || kWG == 1, "a split CTA takes one q-tile with one warpgroup");
  static_assert(kD % 16 == 0 && kD <= 128, "D is a whole number of k16 steps, at most two slabs");
  static constexpr int kSlabs = held_cols(kD) / kSlabCols;
  static constexpr int kKV = 16 * kChunks;  // KV rows held: this instance takes N <= kKV
  static constexpr int kQTiles = kSplit ? 1 : (kKV + 63) / 64;  // q-tiles a stage holds
  static constexpr int kQSlabBytes = kQTiles * 64 * kRowBytes;  // one slab of the q-tiles
  static constexpr int kKVSlabBytes = kKV * kRowBytes;          // a multiple of 2048
  static constexpr int kQBytes = kSlabs * kQSlabBytes;
  static constexpr int kKVBytes = kSlabs * kKVSlabBytes;
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

// One (64, 1, rows, 1) box of a (D, H, N, B) tensor map: columns col ..
// col + 63 of the rows n0 .. of head h of batch b; rows past N arrive as zeros.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int col, int h, int n0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(h), "r"(n0), "r"(b)
      : "memory");
}

// The rows n0 .. of head h of batch b, all kD columns: one box per 64-column
// slab, slab i at dst + i * slab_bytes (the columns of a box past kD, the
// map's inner extent, arrive as zeros).
template <int kD>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int slab_bytes, int h, int n0, int b) {
#pragma unroll
  for (int i = 0; i < held_cols(kD) / kSlabCols; ++i)
    tma_load_rows(dst + i * slab_bytes, map, bar, i * kSlabCols, h, n0, b);
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

// d (64 x 64, fp32: d[0 .. 31]) = a (64 x 16 bf16, registers) * b (16 x 64
// bf16, MN-major in shared memory: the transpose flag), plus d where
// kAccumulate: 16 KV rows of O = P V over a 64-column slab.
#define UVA_PV_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define UVA_PV_OUT(m) m(d[0]), m(d[1]), m(d[2]), m(d[3]), m(d[4]), m(d[5]), m(d[6]), m(d[7]), \
  m(d[8]), m(d[9]), m(d[10]), m(d[11]), m(d[12]), m(d[13]), m(d[14]), m(d[15]), m(d[16]),  \
  m(d[17]), m(d[18]), m(d[19]), m(d[20]), m(d[21]), m(d[22]), m(d[23]), m(d[24]), m(d[25]), \
  m(d[26]), m(d[27]), m(d[28]), m(d[29]), m(d[30]), m(d[31])
#define UVA_RW(x) "+f"(x)
#define UVA_W(x) "=f"(x)
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t (&a)[4], uint64_t b) {
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

// d (64 x 16, fp32: d[0 .. 7]) += a (64 x 16 bf16, registers) * b (16 x 16
// bf16, MN-major in shared memory): 16 KV rows of O = P V over the D = 80
// tiles' 16-column slab. Register 4 j + e: row r0 + 8 (e >> 1), column
// 8 j + 2 t + (e & 1) of the slab.
__device__ __forceinline__ void wgmma_pv_n16(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define UVA_QK_REGS "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define UVA_QK_OUT(m) m(d[0]), m(d[1]), m(d[2]), m(d[3]), m(d[4]), m(d[5]), m(d[6]), m(d[7]), \
  m(d[8]), m(d[9]), m(d[10]), m(d[11]), m(d[12]), m(d[13]), m(d[14]), m(d[15]), m(d[16]), \
  m(d[17]), m(d[18]), m(d[19]), m(d[20]), m(d[21]), m(d[22]), m(d[23]), m(d[24]), m(d[25]), \
  m(d[26]), m(d[27]), m(d[28]), m(d[29]), m(d[30]), m(d[31]), m(d[32]), m(d[33]), m(d[34]), \
  m(d[35]), m(d[36]), m(d[37]), m(d[38]), m(d[39]), m(d[40]), m(d[41]), m(d[42]), m(d[43]), \
  m(d[44]), m(d[45]), m(d[46]), m(d[47]), m(d[48]), m(d[49]), m(d[50]), m(d[51]), m(d[52]), \
  m(d[53]), m(d[54]), m(d[55]), m(d[56]), m(d[57]), m(d[58]), m(d[59]), m(d[60]), m(d[61]), \
  m(d[62]), m(d[63])
#define UVA_RW(x) "+f"(x)
#define UVA_W(x) "=f"(x)
// d (64 x 128, fp32) = a (64 x 16 bf16, registers) * b (16 x 128 bf16 in
// shared memory: K-major, or MN-major where kTransB), plus d where
// kAccumulate. K-major, one k16 step of S = Q K^T over a 128-row KV tile;
// MN-major, 16 KV rows of O = P V at D = 128. Register 4 j + e: row r0 + 8
// (e >> 1), column 8 j + 2 t + (e & 1).
template <bool kAccumulate, int kTransB = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kAccumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UVA_QK_REGS
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : UVA_QK_OUT(UVA_RW)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UVA_QK_REGS
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : UVA_QK_OUT(UVA_W)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0), "n"(kTransB));
  }
}
#undef UVA_QK_REGS
#undef UVA_QK_OUT
#undef UVA_RW
#undef UVA_W

// wgmma shared-memory descriptor of a 128-byte-swizzled MN-major operand
// whose 64-column halves lie lbo bytes apart (V at D = 128: one slab apart);
// SBO 1024 B, the next group of 8 rows along K.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand (the D = 80
// online tiles' 16-column slab, 32-byte rows): LBO 16 B (unused: the operand
// spans one swizzle row along its contiguous dimension, K for K-major K in
// Q K^T, N for MN-major V in P V), SBO 256 B (the next group of 8 rows:
// along N for K, along K for V), layout type 3 (32-byte swizzle). The
// address is a multiple of 256 B, the swizzle's atom (8 rows of 32 B).
__device__ __forceinline__ uint64_t smem_desc_32b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

// One k16 step (16 KV rows) of O = P V over the held columns of D: V
// MN-major, its 64-column slabs slab_bytes apart (at D = 80 the product's
// columns 80-127 are V's zero fill, zeros).
template <int kD, bool kAccumulate>
__device__ __forceinline__ void pv_step(float (&o)[held_cols(kD) / 2], const uint32_t (&a)[4],
                                        uint32_t v_addr, int slab_bytes) {
  if constexpr (kD == 64) {
    wgmma_pv<kAccumulate>(o, a, smem_desc(v_addr));
  } else {
    static_assert(held_cols(kD) == 128, "P V is built for one slab or two");
    wgmma_n128<kAccumulate, 1>(o, a, smem_desc_mn(v_addr, slab_bytes));
  }
}

// S = Q K^T over D: one k16 step per 16 columns, K K-major in 64-column slabs
// slab_bytes apart (four k16 steps of 32 bytes in each 128-byte row).
__device__ __forceinline__ uint64_t k_desc(uint32_t k_addr, int kk, int slab_bytes) {
  return smem_desc(k_addr + (kk / 4) * slab_bytes + (kk % 4) * 32);
}

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

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7, any of D's) of
// row r in a tile of 64-column slabs slab_bytes apart.
__device__ __forceinline__ int tile_chunk(int r, int c, int slab_bytes) {
  return (c / 8) * slab_bytes + swizzled(r, c % 8);
}

template <int kD, int kChunks, int kWG, int kStages, bool kSplit>
__global__ void __launch_bounds__(SinglePass<kD, kChunks, kWG, kStages, kSplit>::kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const SinglePassParams p) {
  using S = SinglePass<kD, kChunks, kWG, kStages, kSplit>;
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
    const int h = head % p.H, b = head / p.H;
    mbar_expect_tx(bar, S::kStageBytes);
    tma_load_tile<kD>(st, &map_q, bar, S::kQSlabBytes, h, kSplit ? 64 * (item % p.n_qtiles) : 0, b);
    tma_load_tile<kD>(st + S::kQBytes, &map_k, bar, S::kKVSlabBytes, h, 0, b);
    tma_load_tile<kD>(st + S::kQBytes + S::kKVBytes, &map_v, bar, S::kKVSlabBytes, h, 0, b);
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
      // the q-tile's rows in slab 0; its other slabs kQSlabBytes on
      uint8_t* q_tile = st_ptr + (kSplit ? 0 : qt) * 64 * kRowBytes;

      // Q rows r0 and r0 + 8 as A fragments of the D / 16 k16 steps over D
      uint32_t qa[kD / 16][4];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int lo = tile_chunk(r0, 2 * kk, S::kQSlabBytes) + 4 * t;
        const int hi = tile_chunk(r0, 2 * kk + 1, S::kQSlabBytes) + 4 * t;
        const int lo8 = tile_chunk(r0 + 8, 2 * kk, S::kQSlabBytes) + 4 * t;
        const int hi8 = tile_chunk(r0 + 8, 2 * kk + 1, S::kQSlabBytes) + 4 * t;
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
      for (int kk = 1; kk < kD / 16; ++kk)
        WgmmaQK<S::kKV>::template mma<true>(s, qa[kk], k_desc(k_smem, kk, S::kKVSlabBytes));
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
      float o[held_cols(kD) / 2];
      wgmma_fence();
      pv_step<kD, false>(o, pa[0], v_smem, S::kKVSlabBytes);
#pragma unroll
      for (int i = 1; i < kChunks; ++i)
        pv_step<kD, true>(o, pa[i], v_smem + i * 16 * kRowBytes, S::kKVSlabBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      // O / l into the q-tile's own rows of shared memory (each warp wrote
      // and read only its 16 rows so far), then 16-byte stores of the rows < N
      const float inv0 = 1.f / quad_sum(l0);
      const float inv1 = 1.f / quad_sum(l1);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(q_tile + tile_chunk(r0, j, S::kQSlabBytes) + 4 * t) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(q_tile + tile_chunk(r0 + 8, j, S::kQSlabBytes) + 4 * t) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const long long o_sn = (long long)p.H * kD;
      __nv_bfloat16* o_head = p.o + ((long long)b * p.N * p.H + h) * kD;
#pragma unroll
      for (int c = tid; c < 64 * kD / 8; c += 128) {
        const int r = c / (kD / 8), chunk = c % (kD / 8);
        const int n = qt * 64 + r;
        if (n < p.N)
          *reinterpret_cast<uint4*>(o_head + n * o_sn + chunk * 8) =
              *reinterpret_cast<const uint4*>(q_tile + tile_chunk(r, chunk, S::kQSlabBytes));
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

// A (B, N, H, kD) bf16 view as a 4-D TMA map over (D, H, N, B) with
// (box_cols, 1, box_rows, 1) boxes: by default one 64-column slab in the
// 128-byte swizzle; the online kernel's 16-column slab at D = 80 takes
// (16, 1, box_rows, 1) boxes in the 32-byte swizzle. Rows past N, and for
// the single pass at D = 80 the columns 80-127 of its second slab's box,
// read as zero and are not read from memory.
template <int kD>
int encode_heads(CUtensorMap* map, const void* ptr, int B, int N, int H, long long sb,
                 long long sn, long long sh, int box_rows, int box_cols = kSlabCols,
                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return (int)cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                     const_cast<void*>(ptr), dims, strides, box, elem_strides,
                                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kD, int kChunks, int kWG, int kStages, bool kSplit>
int launch_single_pass(const Params& a, cudaStream_t s) {
  using S = SinglePass<kD, kChunks, kWG, kStages, kSplit>;
  auto kernel = attn_wgmma_kernel<kD, kChunks, kWG, kStages, kSplit>;
  static int blocks_per_sm = 0;  // per instantiation, found once
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, S::kThreads, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_q, map_k, map_v;
  int rc = encode_heads<kD>(&map_q, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh, S::kQTiles * 64);
  if (rc == 0) rc = encode_heads<kD>(&map_k, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh, S::kKV);
  if (rc == 0) rc = encode_heads<kD>(&map_v, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh, S::kKV);
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

// ------------------------------------------------------------ online softmax
//
// uva_flash_attention_online. A work item is one q-tile of kC x 64 rows of
// one head; persistent CTAs walk the items, q-tile fastest, so the CTAs in
// flight share the K and V of a few heads in L2. A CTA is kC consumer
// warpgroups and a producer warpgroup after them, which gives its registers
// to the consumers (setmaxnreg: 24 a thread for the producer, 240 for the
// consumers at kC = 2; ptxas holds a block to a warpgroup's multiple, so a
// lone producer warp would leave the consumers 168 and spill).
//
// The producer's first thread loads each item's Q tile by TMA into one Q buffer
// (q_full / q_empty), then the item's KV tiles of 128 rows, K and V together,
// into a ring of kStages stages (kv_full[s] / kv_empty[s]). It runs ahead
// across items: the next item's Q and first tiles load while this item's
// last tiles are computed. Consumers copy their 64 Q rows into A-operand
// registers at the start of an item and free the Q buffer at once.
//
// Consumer warpgroup, per KV tile j (FA3's intra-warpgroup overlap):
//   issue S_j = Q K_j^T (four wgmma m64n128k16 over D = 64, K-major K),
//   issue O += P_{j-1} V_{j-1} (eight wgmma m64n64k16 over the tile's rows,
//   V MN-major through the transpose flag),
//   wait for S_j only, then the online softmax of S_j in registers (mask
//   the columns past N, row max, exp2 of the scaled difference) while the
//   tensor cores run P_{j-1} V_{j-1};
//   wait for it, free stage j - 1, rescale O by exp2(m_old - m_new), round
//   P_j to bf16 into A-operand registers.
// The softmax's exp2 is as costly as the products at D = 64 (an SM's 16
// ex2 a clock against about 2048 bf16 FMA a clock at the card's peak:
// 128 x 128 ex2 and 2 x 128 x 128 x 64 FMA per 128-row tile, 1024 clocks
// each), so hiding one behind the other is the design's main lever. The
// two consumer warpgroups also take turns (ping-pong, named barriers): each
// issues its products only in its turn and hands the turn over once they
// are issued, so one warpgroup's softmax runs beside the other's products
// instead of both competing for the exp units and then both for the tensor
// cores. tools/kernels_ab.py (attention_variants) at (128, 1024, 12, 64) on
// an H100: 1.06 ms without the turns and the overlap, 0.95 with both; a
// cubic exp2 on the FMA pipe for a quarter of the elements was slower (1.05
// against 0.91).
// At the end O / l goes through shared memory (the warpgroup's own 64 rows)
// to 16-byte stores of the rows < N.
//
// Bound on an H100 SXM at the 256 px path's (128, 1024, 12, 64): 4 B H N^2 D
// = 412 GFLOP at 989 TFLOP/s = 0.417 ms (operations; the 101 MB of q, k, v
// and out take 0.030 ms).
//
// At D = 128 (the kitchen path's N = 320: KV tiles of 128, 128 and 64 rows) a
// stage of K and V is 64 KB, so the ring holds two stages; O takes 64
// accumulator registers a consumer thread and Q's A fragments 32. The split
// instance (one consumer warpgroup, one CTA an SM) launches with 255
// registers a thread and needs no setmaxnreg.
//
// D = 80 (mar_huge) at exact width. A tile of `rows` rows is a 64-column
// slab (rows x 128 bytes, 128-byte swizzle) and then a 16-column slab (rows
// x 32 bytes, 32-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) &
// 1)), each at a 1024-byte multiple from the 1024-byte-aligned tile and
// each loaded by its own TMA box: (64, 1, rows, 1) at column 0 and (16, 1,
// rows, 1) at column 64 through a second map with the 32-byte swizzle, so
// no box reaches past column 79 and the barriers count 160 bytes a row.
// Q K^T is four k16 steps from the 128-byte slab and a fifth from the
// 32-byte slab (one swizzle row is one k16 step; K-major, SBO 256 B). P V is
// an m64n64k16 over the 128-byte slab and an m64n16k16 over the 32-byte one
// a k-step (V MN-major in both): 80 columns of work, O in 40 accumulator
// registers a thread, Q's A fragments in 20. A stage of K and V is 40 KB
// (64 KB padded to D = 128's layout), so the two-warpgroup instance keeps
// four stages, as D = 64's, and the split instance's 101 KB (two stages, Q
// and the output staging) lets two CTAs share an SM, as at D = 64 (128
// registers a thread at launch; setmaxnreg gives the consumers 232).

constexpr int kOnlineKV = 128;  // KV rows a stage holds
constexpr int kNarrowRowBytes = 32;  // one 32-byte swizzle row: 16 bf16 columns

// The 16-byte chunks of a row in an online tile's 128-byte-swizzle slabs
// (D = 64: 8, D = 80: 8, D = 128: 16); at D = 80 chunks 8 and 9 lie in the
// 16-column slab after them.
__host__ __device__ constexpr int wide_chunks(int d) { return d / kSlabCols * kSlabCols / 8; }

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in an
// online-kernel tile of `rows` rows held at exact width kD.
template <int kD>
__device__ __forceinline__ int exact_chunk(int r, int c, int rows) {
  if (c < wide_chunks(kD)) return tile_chunk(r, c, rows * kRowBytes);
  return kD / kSlabCols * rows * kRowBytes + r * kNarrowRowBytes +
         (((c - wide_chunks(kD)) ^ ((r >> 2) & 1)) << 4);
}

// The rows n0 .. of head h of batch b into an online-kernel tile of `rows`
// rows: one (64, 1, rows, 1) box of `map` per 64-column slab and at D = 80
// one (16, 1, rows, 1) box of `narrow` (the 32-byte swizzle) at column 64.
template <int kD>
__device__ __forceinline__ void tma_load_exact(uint32_t dst, const CUtensorMap* map,
                                               const CUtensorMap* narrow, uint32_t bar, int rows,
                                               int h, int n0, int b) {
#pragma unroll
  for (int i = 0; i < kD / kSlabCols; ++i)
    tma_load_rows(dst + i * rows * kRowBytes, map, bar, i * kSlabCols, h, n0, b);
  if constexpr (kD % kSlabCols != 0)
    tma_load_rows(dst + kD / kSlabCols * rows * kRowBytes, narrow, bar, kD / kSlabCols * kSlabCols, h,
                  n0, b);
}

template <int kD, int kC, int kStages, int kMinBlocks>
struct Online {
  static_assert(kStages >= 2, "tile j is loaded before tile j - 1 is freed");
  static_assert(kD % 16 == 0 && kD <= 128 && (kD % kSlabCols == 0 || kD % kSlabCols == 16),
                "D is whole 64-column slabs, or one and a 16-column slab");
  static constexpr int kQRows = 64 * kC;
  static constexpr int kQBytes = kQRows * 2 * kD;       // exact width: 2 kD bytes a row
  static constexpr int kKVBytes = kOnlineKV * 2 * kD;   // a multiple of 1024
  static constexpr int kStageBytes = 2 * kKVBytes;  // K, then V
  static constexpr int kThreads = 128 * (kC + 1);
  // setmaxnreg: the producer warpgroup drops to 24 registers a thread and
  // the consumers take what that frees of the launch's share (up to 240),
  // where the launch's share is less than 240
  static constexpr int kProducerRegs = 24;
  static constexpr int kLaunchRegs = (65536 / (kMinBlocks * kThreads)) / 8 * 8;
  static constexpr bool kSetMaxNReg = kLaunchRegs < 240;
  static constexpr int kFreed = (kLaunchRegs * (kC + 1) - kProducerRegs) / kC / 8 * 8;
  static constexpr int kConsumerRegs = kFreed < 240 ? kFreed : 240;
  // stages, Q, the output staging (as large as Q), 2 + 2 kStages barriers,
  // the slack that aligns the buffers to 1024 B (the swizzle atom)
  static constexpr int kSmem = kStages * kStageBytes + 2 * kQBytes + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "shared memory of an H100 SM");
};

struct OnlineParams {
  __nv_bfloat16* o;
  int N, H;
  int n_qtiles;  // ceil(N / (64 kC))
  int n_kv;      // ceil(N / kOnlineKV)
  int items;     // B * H * n_qtiles
  float scale_log2;
};


// Keeps registers that an asynchronous wgmma reads as its A operand alive
// until the wgmma_wait after it.
template <int kN, int kM>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kN][kM]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < kM; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// S = Q K^T for one KV tile: the D / 16 k16 steps over D, four in each
// 128-byte-swizzle slab and at D = 80 the fifth from the 32-byte one.
template <int kD>
__device__ __forceinline__ void qk_tile(float (&s)[64], const uint32_t (&qa)[kD / 16][4], uint32_t k_smem) {
  constexpr int kSlabBytes = kOnlineKV * kRowBytes;
  wgmma_n128<false>(s, qa[0], smem_desc(k_smem));
#pragma unroll
  for (int kk = 1; kk < kD / 16; ++kk) {
    if (kk < wide_chunks(kD) / 2)
      wgmma_n128<true>(s, qa[kk], k_desc(k_smem, kk, kSlabBytes));
    else
      wgmma_n128<true>(s, qa[kk], smem_desc_32b(k_smem + kD / kSlabCols * kSlabBytes));
  }
}

// O += P V for one KV tile: eight k16 steps over its rows (at D = 80 an
// n64 over the 128-byte-swizzle slab and an n16 over the 32-byte one each).
template <int kD>
__device__ __forceinline__ void pv_tile(float (&o)[kD / 2], const uint32_t (&pa)[8][4], uint32_t v_smem) {
  constexpr int kSlabBytes = kOnlineKV * kRowBytes;
#pragma unroll
  for (int i = 0; i < kOnlineKV / 16; ++i) {
    if constexpr (kD % kSlabCols == 0) {
      pv_step<kD, true>(o, pa[i], v_smem + i * 16 * kRowBytes, kSlabBytes);
    } else {
      wgmma_pv<true>(o, pa[i], smem_desc(v_smem + i * 16 * kRowBytes));
      wgmma_pv_n16(o + 32, pa[i], smem_desc_32b(v_smem + kSlabBytes + i * 16 * kNarrowRowBytes));
    }
  }
}

// The online softmax of one tile of S (rows r0 and r0 + 8 of the
// warpgroup's 64, 32 columns each in this thread), in place: columns at or
// past `limit` masked, the running maxima m (raw scores) raised to the
// tile's, s = 2^((s - m) D^-1/2 log2 e), the thread's partial row sums l
// rescaled and increased, and the factors a by which O must be rescaled.
__device__ __forceinline__ void online_softmax(float (&s)[64], int limit, int t, float scale_log2,
                                               float (&m)[2], float (&l)[2], float (&a)[2]) {
  if (limit < kOnlineKV) {
#pragma unroll
    for (int r = 0; r < 64; ++r)
      if (8 * (r / 4) + 2 * t + (r & 1) >= limit) s[r] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int r = 0; r < 64; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
  float c[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);  // column kv0 < N: finite
    a[i] = ex2((m[i] - mx[i]) * scale_log2);  // 0 on the first tile (m = -inf)
    m[i] = mx[i];
    c[i] = -mx[i] * scale_log2;
  }
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    s[r] = ex2(fmaf(s[r], scale_log2, c[(r >> 1) & 1]));
    sum[(r >> 1) & 1] += s[r];
  }
  l[0] = l[0] * a[0] + sum[0];
  l[1] = l[1] * a[1] + sum[1];
}

// Registers 8 i .. 8 i + 7 of a tile of P are the A fragment of the k16
// step i of P V.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pa[i][0] = pack_bf16(s[8 * i], s[8 * i + 1]);
    pa[i][1] = pack_bf16(s[8 * i + 2], s[8 * i + 3]);
    pa[i][2] = pack_bf16(s[8 * i + 4], s[8 * i + 5]);
    pa[i][3] = pack_bf16(s[8 * i + 6], s[8 * i + 7]);
  }
}

// Named barriers: 0 is __syncthreads, 1 + wg the epilogue of consumer
// warpgroup wg, kTurnBar + wg its turn to issue wgmma (ping-pong).
constexpr int kTurnBar = 3;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kD, int kC, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(Online<kD, kC, kStages, kMinBlocks>::kThreads, kMinBlocks)
attn_online_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap narrow_q,
                   const __grid_constant__ CUtensorMap narrow_k,
                   const __grid_constant__ CUtensorMap narrow_v, const OnlineParams p) {
  using L = Online<kD, kC, kStages, kMinBlocks>;
  // two consumer warpgroups take turns to issue their products
  constexpr bool kPingPong = kC == 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* aligned = smem_raw + (base - raw);
  // [stage 0: K, V] ... [stage kStages - 1] [Q] [O staging] [barriers]
  constexpr int kQOff = kStages * L::kStageBytes;
  constexpr int kOOff = kQOff + L::kQBytes;
  const uint32_t q_smem = base + kQOff;
  const uint32_t q_full = base + kOOff + L::kQBytes;
  const uint32_t q_empty = q_full + 8;
  const uint32_t kv_full = q_full + 16;
  const uint32_t kv_empty = kv_full + 8 * kStages;

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kC);  // lane 0 of every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 4 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kC) {
    // the producer warpgroup: its first thread waits for a buffer to be free
    // (the first pass over each passes at once: parity 1 of a fresh
    // barrier), then loads it
    if constexpr (L::kSetMaxNReg) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    if (threadIdx.x == 128 * kC) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int head = item / p.n_qtiles, qt = item % p.n_qtiles;
        const int b = head / p.H, h = head % p.H;
        mbar_wait(q_empty, q_phase ^ 1);
        mbar_expect_tx(q_full, L::kQBytes);
        tma_load_exact<kD>(q_smem, &map_q, &narrow_q, q_full, L::kQRows, h, qt * L::kQRows, b);
        q_phase ^= 1;
        for (int j = 0; j < p.n_kv; ++j) {
          const uint32_t st = base + stage * L::kStageBytes, bar = kv_full + 8 * stage;
          mbar_wait(kv_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, L::kStageBytes);
          tma_load_exact<kD>(st, &map_k, &narrow_k, bar, kOnlineKV, h, j * kOnlineKV, b);
          tma_load_exact<kD>(st + L::kKVBytes, &map_v, &narrow_v, bar, kOnlineKV, h, j * kOnlineKV, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers
    if constexpr (L::kSetMaxNReg) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int g = lane / 4;  // fragment row group: rows g and g + 8 of the warp's 16
    const int t = lane % 4;  // fragment column pair
    const int r0 = (tid / 32) * 16 + g;
    // Q and the output staging, each a tile of kQRows rows; the
    // warpgroup's 64 are rows wg * 64 .. of each
    const uint8_t* q_tile = aligned + kQOff;
    uint8_t* o_tile = aligned + kOOff;
    const int row0 = wg * 64 + r0;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    auto advance = [&]() {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // Ping-pong: a warpgroup issues its wgmma only in its turn and hands the
    // turn over right after issuing, so one warpgroup's softmax runs while
    // the other's products occupy the tensor cores. Warpgroup 1 gives
    // warpgroup 0 the first turn; both take the same number of turns, and
    // warpgroup 1 hands over no turn after its last.
    if (kPingPong && wg == 1) named_arrive(kTurnBar, 256);
    auto my_turn = [&]() {
      if constexpr (kPingPong) named_sync(kTurnBar + wg, 256);
    };
    auto hand_over = [&](bool last) {
      if constexpr (kPingPong) {
        if (!(last && wg == 1)) named_arrive(kTurnBar + 1 - wg, 256);
      }
    };
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int head = item / p.n_qtiles, qt = item % p.n_qtiles;
      const int b = head / p.H, h = head % p.H;
      const bool last_item = item + gridDim.x >= p.items;

      // Q rows r0 and r0 + 8 as A fragments of the D / 16 k16 steps over D
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      constexpr int kQRows = L::kQRows;
      uint32_t qa[kD / 16][4];
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(q_tile + exact_chunk<kD>(row0, 2 * kk, kQRows) + 4 * t);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(q_tile + exact_chunk<kD>(row0 + 8, 2 * kk, kQRows) + 4 * t);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(q_tile + exact_chunk<kD>(row0, 2 * kk + 1, kQRows) + 4 * t);
        qa[kk][3] =
            *reinterpret_cast<const uint32_t*>(q_tile + exact_chunk<kD>(row0 + 8, 2 * kk + 1, kQRows) + 4 * t);
      }
      // these generic reads come before the next TMA write into the buffer
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      release(q_empty);

      // O's accumulators, D / 2 a thread (at D = 80: 32 of the n64 product,
      // then 8 of the n16)
      float o[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
      float s[64];
      uint32_t pa[8][4];
      // tile 0: S, its softmax, P
      mbar_wait(kv_full + 8 * stage, phase);
      my_turn();
      wgmma_fence();
      qk_tile<kD>(s, qa, base + stage * L::kStageBytes);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax(s, p.N, t, p.scale_log2, m, l, a);
      pack_p(pa, s);
      int prev = stage;
      advance();
      for (int j = 1; j < p.n_kv; ++j) {
        mbar_wait(kv_full + 8 * stage, phase);
        my_turn();
        wgmma_fence();
        qk_tile<kD>(s, qa, base + stage * L::kStageBytes);
        wgmma_commit();
        pv_tile<kD>(o, pa, base + prev * L::kStageBytes + L::kKVBytes);
        wgmma_commit();
        hand_over(false);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
        fence_regs(s);
        online_softmax(s, p.N - j * kOnlineKV, t, p.scale_log2, m, l, a);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(kv_empty + 8 * prev);
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] *= a[(i >> 1) & 1];
        pack_p(pa, s);
        prev = stage;
        advance();
      }
      my_turn();
      wgmma_fence();
      pv_tile<kD>(o, pa, base + prev * L::kStageBytes + L::kKVBytes);
      wgmma_commit();
      hand_over(last_item);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(kv_empty + 8 * prev);

      // O / l into the warpgroup's 64 rows of the staging buffer, then
      // 16-byte stores of the rows < N
      const float inv0 = 1.f / quad_sum(l[0]);
      const float inv1 = 1.f / quad_sum(l[1]);
      named_sync(1 + wg, 128);  // the last item's stores are done
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(o_tile + exact_chunk<kD>(row0, j, kQRows) + 4 * t) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(o_tile + exact_chunk<kD>(row0 + 8, j, kQRows) + 4 * t) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      named_sync(1 + wg, 128);
      const long long o_sn = (long long)p.H * kD;
      __nv_bfloat16* o_head = p.o + ((long long)b * p.N * p.H + h) * kD;
#pragma unroll
      for (int c = tid; c < 64 * kD / 8; c += 128) {
        const int r = c / (kD / 8), chunk = c % (kD / 8);
        const int n = qt * L::kQRows + wg * 64 + r;
        if (n < p.N)
          *reinterpret_cast<uint4*>(o_head + n * o_sn + chunk * 8) =
              *reinterpret_cast<const uint4*>(o_tile + exact_chunk<kD>(wg * 64 + r, chunk, kQRows));
      }
    }
  }
}

template <int kD, int kC, int kStages, int kMinBlocks>
int launch_online(const Params& a, cudaStream_t s) {
  using L = Online<kD, kC, kStages, kMinBlocks>;
  auto kernel = attn_online_kernel<kD, kC, kStages, kMinBlocks>;
  static int blocks_per_sm = 0;  // per instantiation, found once
  if (blocks_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, L::kThreads, L::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_q, map_k, map_v;
  int rc = encode_heads<kD>(&map_q, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh, L::kQRows);
  if (rc == 0) rc = encode_heads<kD>(&map_k, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh, kOnlineKV);
  if (rc == 0) rc = encode_heads<kD>(&map_v, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh, kOnlineKV);
  // the 16-column slab's maps (read at D = 80 only)
  CUtensorMap narrow_q = map_q, narrow_k = map_k, narrow_v = map_v;
  if constexpr (kD % kSlabCols != 0) {
    constexpr int kCols = kD % kSlabCols;
    constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
    if (rc == 0)
      rc = encode_heads<kD>(&narrow_q, a.q, a.B, a.N, a.H, a.q_sb, a.q_sn, a.q_sh, L::kQRows, kCols, kSwizzle);
    if (rc == 0)
      rc = encode_heads<kD>(&narrow_k, a.k, a.B, a.N, a.H, a.k_sb, a.k_sn, a.k_sh, kOnlineKV, kCols, kSwizzle);
    if (rc == 0)
      rc = encode_heads<kD>(&narrow_v, a.v, a.B, a.N, a.H, a.v_sb, a.v_sn, a.v_sh, kOnlineKV, kCols, kSwizzle);
  }
  if (rc != 0) return kEncodeError + rc;
  OnlineParams p;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.N = a.N;
  p.H = a.H;
  p.n_qtiles = (a.N + L::kQRows - 1) / L::kQRows;
  p.n_kv = (a.N + kOnlineKV - 1) / kOnlineKV;
  p.items = a.B * a.H * p.n_qtiles;
  p.scale_log2 = a.scale_log2;
  const int grid = min(p.items, num_sms() * blocks_per_sm);
  kernel<<<grid, L::kThreads, L::kSmem, s>>>(map_q, map_k, map_v, narrow_q, narrow_k, narrow_v, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ staging copy
//
// uva_stage_qkv: bf16 q, k and v of shape (B, N, H, D), read through their
// strides (any base and stride a multiple of 2 bytes), copied in one launch
// into one contiguous (B, N, 3, H, D) buffer with a 16-byte-aligned base.
// Every base and stride of the buffer's three views is then a multiple of
// D * 2 or H * D * 2 bytes, so the TMA kernels take them: ops/attention.py
// stages the views TMA cannot read (an operand off a 16-byte boundary) this
// way. One thread a 16-byte chunk of the buffer (8 columns of one row of one
// operand), consecutive threads on consecutive chunks: it reads the chunk
// with the widest loads its operand's base and strides allow (16, 8, 4 or 2
// bytes) and writes it with one 16-byte store. Bound by bytes: 3 B N H D
// values read once and written once, 12 B N H D bytes.

constexpr int kStageThreads = 256;

struct StageOperand {
  const uint8_t* ptr;
  long long sb, sn, sh;  // byte strides of batch, token, head
  int width;             // bytes a load: 16, 8, 4 or 2
};

struct StageParams {
  StageOperand q, k, v;
  uint4* qkv;
  int N, H;
  unsigned chunks;  // B N 3 H D / 8
};

// The 16 bytes at p in loads of kWidth bytes.
template <int kWidth>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p) {
  if constexpr (kWidth == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (kWidth == 8) {
    const uint2 a = reinterpret_cast<const uint2*>(p)[0], b = reinterpret_cast<const uint2*>(p)[1];
    return make_uint4(a.x, a.y, b.x, b.y);
  } else if constexpr (kWidth == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
    return make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16, h[4] | (uint32_t)h[5] << 16,
                      h[6] | (uint32_t)h[7] << 16);
  }
}

template <int kD>
__global__ void __launch_bounds__(kStageThreads) stage_qkv_kernel(const __grid_constant__ StageParams p) {
  const unsigned i = blockIdx.x * kStageThreads + threadIdx.x;
  if (i >= p.chunks) return;
  constexpr unsigned kRowChunks = kD / 8;
  const unsigned row = i / kRowChunks;  // row (b, n, operand, h) of the buffer
  const int c = i % kRowChunks;
  const int h = row % p.H;
  const unsigned bnw = row / p.H;
  const int w = bnw % 3;
  const unsigned bn = bnw / 3;
  const long long n = bn % p.N, b = bn / p.N;
  const StageOperand& op = w == 0 ? p.q : (w == 1 ? p.k : p.v);
  const uint8_t* src = op.ptr + b * op.sb + n * op.sn + h * op.sh + c * 16;
  uint4 val;
  switch (op.width) {
    case 16: val = load_chunk<16>(src); break;
    case 8: val = load_chunk<8>(src); break;
    case 4: val = load_chunk<4>(src); break;
    default: val = load_chunk<2>(src); break;
  }
  p.qkv[i] = val;
}

// The widest load (16, 8, 4 or 2 bytes) that every chunk of a view with
// this base and these byte strides allows.
int load_width(const void* ptr, long long sb, long long sn, long long sh) {
  const unsigned long long bits = reinterpret_cast<uintptr_t>(ptr) | (unsigned long long)sb |
                                  (unsigned long long)sn | (unsigned long long)sh;
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 2;
}

StageOperand stage_operand(const void* ptr, long long sb, long long sn, long long sh) {
  return {static_cast<const uint8_t*>(ptr), sb * 2, sn * 2, sh * 2, load_width(ptr, sb * 2, sn * 2, sh * 2)};
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

// A head dimension the kernels are built for.
bool built_d(int D) { return D == 64 || D == 80 || D == 128; }

// TMA's rules for the Hopper kernels: bf16, a built D, every base and stride
// a multiple of 16 bytes.
bool tma_ok(const void* q, const void* k, const void* v, int B, int N, int H, int D,
            const long long (&strides)[9]) {
  bool ok = built_d(D) && B > 0 && N > 0 && H > 0 &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (long long st : strides) ok = ok && (st * 2) % 16 == 0;
  return ok;
}

template <int kD, int kMT, int kBlockKV, bool kVec>
int launch_tf32(const Params& p, cudaStream_t s) {
  using T = Tf32Tiles<kD, kMT, kBlockKV>;
  auto kernel = attn_tf32_kernel<kD, kMT, kBlockKV, kVec>;
  static bool ready = false;  // per instantiation, set once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int n_qtiles = (p.N + T::kRows - 1) / T::kRows;
  const long long blocks = (long long)n_qtiles * p.B * p.H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, T::kThreads, T::kSmem, s>>>(p, n_qtiles);
  return (int)cudaGetLastError();
}

// The fp32 kernel's tile (tools/kernels_ab.py --parts tf32_tiles, PERF.md):
// CTAs of 4 warps, KV tiles of 32 rows; a warp takes two m16 tiles (each K
// and V fragment it splits serves six products) at D = 64 past N = 144, else
// one (at N <= 144 a CTA of 128 rows leaves 112 of a head's 256 idle; at
// D = 80 and 128 two m16 tiles a warp spill).
constexpr int kTf32BlockKV = 32;

template <int kD, bool kVec>
int launch_tf32_default(const Params& p, cudaStream_t s) {
  if constexpr (kD == 64) {
    if (p.N > 144) return launch_tf32<kD, 2, kTf32BlockKV, kVec>(p, s);
  }
  return launch_tf32<kD, 1, kTf32BlockKV, kVec>(p, s);
}

// Every tile the sweep times, on aligned views: (m16 tiles a warp, KV rows),
// 4 warps a CTA; two m16 tiles at D = 64 only.
template <int kD>
int launch_tf32_tile(const Params& p, int m_tiles, int kv_rows, cudaStream_t s) {
  if (m_tiles == 1 && kv_rows == 32) return launch_tf32<kD, 1, 32, true>(p, s);
  if (m_tiles == 1 && kv_rows == 48) return launch_tf32<kD, 1, 48, true>(p, s);
  if (m_tiles == 1 && kv_rows == 64) return launch_tf32<kD, 1, 64, true>(p, s);
  if constexpr (kD == 64) {
    if (m_tiles == 2 && kv_rows == 32) return launch_tf32<kD, 2, 32, true>(p, s);
    if (m_tiles == 2 && kv_rows == 64) return launch_tf32<kD, 2, 64, true>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}


}  // namespace

// The 3xTF32 (fp32) kernel. dtype: 0 = float32; any other (1, bfloat16,
// which goes to the TMA kernels, staged where TMA cannot read it) is
// refused. D: 64, 80 or 128. Strides are in elements; the last dimension
// must be contiguous. aligned: every row of q, k and v starts on a 16-byte
// boundary (16-byte copies), else 4-byte ones. The output is a contiguous
// (B, N, H, D) tensor. Returns the value of cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int uva_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int N, int H, int D,
                                   long long q_sb, long long q_sn, long long q_sh,
                                   long long k_sb, long long k_sn, long long k_sh,
                                   long long v_sb, long long v_sn, long long v_sh,
                                   int dtype, int aligned, void* stream) {
  if (!built_d(D) || B <= 0 || N <= 0 || H <= 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return aligned ? launch_tf32_default<64, true>(p, s) : launch_tf32_default<64, false>(p, s);
  if (D == 80) return aligned ? launch_tf32_default<80, true>(p, s) : launch_tf32_default<80, false>(p, s);
  return aligned ? launch_tf32_default<128, true>(p, s) : launch_tf32_default<128, false>(p, s);
}

// The fp32 kernel at a tile of its sweep (m16 tiles a warp, KV rows a tile:
// (1, 32), (1, 48), (1, 64) at every D; (2, 32), (2, 64) at D = 64), 4 warps
// a CTA, aligned views only, on the same arguments; uva_flash_attention
// takes the tile launch_tf32_default names. Returns as uva_flash_attention.
extern "C" int uva_flash_attention_tf32_tile(const void* q, const void* k, const void* v, void* o,
                                             int B, int N, int H, int D,
                                             long long q_sb, long long q_sn, long long q_sh,
                                             long long k_sb, long long k_sn, long long k_sh,
                                             long long v_sb, long long v_sn, long long v_sh,
                                             int m_tiles, int kv_rows, void* stream) {
  const long long strides[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  bool ok = built_d(D) && B > 0 && N > 0 && H > 0 &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (long long st : strides) ok = ok && (st * 4) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_tf32_tile<64>(p, m_tiles, kv_rows, s);
  if (D == 80) return launch_tf32_tile<80>(p, m_tiles, kv_rows, s);
  return launch_tf32_tile<128>(p, m_tiles, kv_rows, s);
}

// The staging copy: bf16 q, k, v of shape (B, N, H, D) (D: 64, 80 or 128;
// strides in elements, the last dimension contiguous, every base and stride
// a multiple of 2 bytes) into qkv, a contiguous (B, N, 3, H, D) bf16 buffer
// whose base is 16-byte aligned, in one launch. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int uva_stage_qkv(const void* q, const void* k, const void* v, void* qkv,
                             int B, int N, int H, int D,
                             long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh,
                             long long v_sb, long long v_sn, long long v_sh, void* stream) {
  const long long chunks = 3LL * B * N * H * D / 8;
  if (!built_d(D) || B <= 0 || N <= 0 || H <= 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 2) != 0 ||
      chunks > 0xffffffffLL - kStageThreads)
    return (int)cudaErrorInvalidValue;
  StageParams p;
  p.q = stage_operand(q, q_sb, q_sn, q_sh);
  p.k = stage_operand(k, k_sb, k_sn, k_sh);
  p.v = stage_operand(v, v_sb, v_sn, v_sh);
  p.qkv = static_cast<uint4*>(qkv);
  p.N = N;
  p.H = H;
  p.chunks = (unsigned)chunks;
  const unsigned grid = (unsigned)((chunks + kStageThreads - 1) / kStageThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) stage_qkv_kernel<64><<<grid, kStageThreads, 0, s>>>(p);
  else if (D == 80) stage_qkv_kernel<80><<<grid, kStageThreads, 0, s>>>(p);
  else stage_qkv_kernel<128><<<grid, kStageThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The single-pass Hopper kernel, bf16 only, on the same arguments: every
// base and stride 16-byte aligned (TMA's rules) and N <= 144 (the KV rows it
// holds in shared memory). split: one
// CTA (one warpgroup) for each q-tile of each head, for few heads; else one
// CTA for all q-tiles of a head (D = 64 only: at D = 80 and 128 split must
// be set). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for arguments
// it does not take, or kEncodeError + the CUresult of a failed TMA encode.
extern "C" int uva_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int B, int N, int H, int D,
                                         long long q_sb, long long q_sn, long long q_sh,
                                         long long k_sb, long long k_sn, long long k_sh,
                                         long long v_sb, long long v_sn, long long v_sh,
                                         int split, void* stream) {
  const long long strides[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  if (!tma_ok(q, k, v, B, N, H, D, strides) || N > 144) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return split ? launch_single_pass<64, 9, 1, 2, true>(p, s)
                 : launch_single_pass<64, 9, 3, 3, false>(p, s);
  if (!split) return (int)cudaErrorInvalidValue;
  return D == 80 ? launch_single_pass<80, 9, 1, 2, true>(p, s) : launch_single_pass<128, 9, 1, 2, true>(p, s);
}

// The online-softmax Hopper kernel, bf16 only, any N, on the same arguments
// and TMA's rules. split: work items of one 64-row q-tile (CTAs of one
// consumer warpgroup; two to an SM at D = 64 and 80, one at D = 128), for
// few items; else of 128 rows (two consumer warpgroups taking turns).
// Returns as uva_flash_attention_wgmma.
extern "C" int uva_flash_attention_online(const void* q, const void* k, const void* v, void* o,
                                          int B, int N, int H, int D,
                                          long long q_sb, long long q_sn, long long q_sh,
                                          long long k_sb, long long k_sn, long long k_sh,
                                          long long v_sb, long long v_sn, long long v_sh,
                                          int split, void* stream) {
  const long long strides[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh};
  if (!tma_ok(q, k, v, B, N, H, D, strides)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, N, H, D, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                               v_sb, v_sn, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return split ? launch_online<64, 1, 2, 2>(p, s) : launch_online<64, 2, 4, 1>(p, s);
  if (D == 80) return split ? launch_online<80, 1, 2, 2>(p, s) : launch_online<80, 2, 4, 1>(p, s);
  return split ? launch_online<128, 1, 2, 1>(p, s) : launch_online<128, 2, 2, 1>(p, s);
}
