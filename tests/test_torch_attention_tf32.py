"""The arithmetic of the fp32 attention kernel (csrc/attention.cu, 3xTF32 on
the tensor cores), emulated on the CPU: no card is needed.

* TF32 rounding as ``cvt.rna.tf32.f32`` does it (10 mantissa bits, to
  nearest, ties away from zero) and as the tensor core reads an fp32
  register (its top 19 bits: toward zero), and the split x = hi + lo either
  way: the kernel's (hi = x with its low 13 bits cleared, lo = x - hi read
  by the tensor core) and the one that rounds both halves with cvt.rna.
* The kernel's function at head dimensions 64, 80 and 128 and N = 144 and
  1088: both products as three TF32 products of the split operands summed in
  fp32, the online softmax over KV tiles on exp2 with D^-1/2 log2(e) in the
  exponent, each tile's P V added to O in fp32, against a float64
  reference. With either split it holds a tenth of the fp32 tolerance of
  2e-5 (tests/test_ops.py, chip_smoke.py's ``ATTN_ATOL``; about 1e-7 to
  8e-7, as the fp32 einsum); one TF32 product (hi times hi) misses it by
  more than 2x (about 1e-4 to 5e-4), which is why the kernel runs three.
* The fragment layouts of ``mma.sync.m16n8k8`` (PTX ISA) with the kernel's
  relabelled k index (k-step index t is column 2t, t + 4 is 2t + 1): S's
  accumulator fragments, taken as they lie, are P's A fragments, and one
  warp's 16 rows of S = Q K^T and O = S V come out exact.
"""

import numpy as np
import pytest
import torch
from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

TOL = 2e-5  # ATTN_ATOL[float32]
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: round the magnitude to 10
    mantissa bits, half away from zero, kept in an fp32 tensor."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An fp32 register as the tensor core reads it for a TF32 operand: its
    top 19 bits, the magnitude cut toward zero."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, mode: str):
    """x = hi + lo as the TF32 operands the tensor core multiplies: "kernel"
    (hi = x with its low 13 bits cleared, exact; lo = x - hi, exact in fp32
    and cut by the read) or "rna" (both halves rounded by cvt.rna)."""
    if mode == "kernel":
        hi = tf32_read(x)
        return hi, tf32_read(x - hi)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int, mode: str) -> torch.Tensor:
    """a @ b on TF32 operands summed in fp32: 3 products (lo·hi + hi·lo +
    hi·hi, the small ones first, as the kernel issues them) or 1 (hi·hi)."""
    a_hi, a_lo = split(a, mode)
    b_hi, b_lo = split(b, mode)
    if products == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def kernel_arithmetic(q, k, v, products: int = 3, mode: str = "kernel", kv_tile: int = 32) -> torch.Tensor:
    """The fp32 kernel's function on (B, N, H, D) fp32 tensors: S by TF32
    products, the online softmax over KV tiles on exp2 with fp32 statistics
    and D^-1/2 log2(e) applied in the exponent, each tile's P V by TF32
    products added to O alpha, O / l at the end."""
    B, N, H, D = q.shape
    scale = np.float32(LOG2E / np.sqrt(D))
    qs, ks, vs = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((B, H, N, 1), -float("inf"))
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, D)
    for kv0 in range(0, N, kv_tile):
        s = tf32_matmul(qs, ks[:, :, kv0:kv0 + kv_tile].transpose(-1, -2), products, mode)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * scale - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + tf32_matmul(p, vs[:, :, kv0:kv0 + kv_tile], products, mode)
        m = mn
    return (o / l).permute(0, 2, 1, 3)


def reference_fp64(q, k, v) -> torch.Tensor:
    q, k, v = (x.double() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _qkv(B, N, H, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32)) for _ in range(3)]


def test_tf32_rounding_to_nearest_ties_away_and_the_tensor_cores_read():
    one = 1.0
    half_ulp = 2.0 ** -11  # TF32's ulp at 1 is 2^-10
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      one + 3 * half_ulp, 0.0, -2.5], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 0.0, -2.5], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert torch.equal(tf32_read(x), torch.tensor([one, -one, one, one + 2 * half_ulp, 0.0, -2.5]))


@pytest.mark.parametrize("mode,bound", [("kernel", 2.0 ** -21), ("rna", 2.0 ** -22)])
def test_the_split_keeps_x_to_about_2_to_the_minus_22(mode, bound):
    # hi is a TF32 value and hi + lo is x to 2^-21 of x (the kernel's: lo is
    # cut toward zero) or 2^-22 (both halves rounded)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(y, mode)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_read(hi), hi)
    assert torch.equal(tf32_read(lo), lo)
    assert ((hi.double() + lo.double() - y.double()).abs() <= bound * y.double().abs()).all()


@pytest.mark.parametrize("mode", ["kernel", "rna"])
@pytest.mark.parametrize("D,H", [(64, 2), (80, 2), (128, 1)])
@pytest.mark.parametrize("N", [144, 1088])
def test_3xtf32_holds_the_fp32_tolerance(D, H, N, mode):
    q, k, v = _qkv(1, N, H, D, seed=N + D)
    got = kernel_arithmetic(q, k, v, products=3, mode=mode).double()
    err = (got - reference_fp64(q, k, v)).abs().max().item()
    assert err <= TOL / 10, f"3xTF32 ({mode} split) max error {err} against float64"


@pytest.mark.parametrize("mode", ["kernel", "rna"])
@pytest.mark.parametrize("D,H", [(64, 2), (80, 2), (128, 1)])
@pytest.mark.parametrize("N", [144, 1088])
def test_one_tf32_product_misses_the_fp32_tolerance(D, H, N, mode):
    q, k, v = _qkv(1, N, H, D, seed=N + D)
    got = kernel_arithmetic(q, k, v, products=1, mode=mode).double()
    err = (got - reference_fp64(q, k, v)).abs().max().item()
    assert err > 2 * TOL, f"1xTF32 ({mode}) max error {err}: would hold the fp32 tolerance"


def _mma_m16n8k8(a, b, c):
    """One warp's ``mma.sync.aligned.m16n8k8.row.col`` on lane fragments
    (PTX ISA layouts, g = lane // 4, t = lane % 4): a (32, 4) holds A[g][t],
    A[g+8][t], A[g][t+4], A[g+8][t+4]; b (32, 2) B[t][g], B[t+4][g]; c and
    the result (32, 4) C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]."""
    A, Bm, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        Bm[t, g], Bm[t + 4, g] = b[lane]
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c[lane]
    Dm = A @ Bm + C
    return np.array([[Dm[l // 4, 2 * (l % 4)], Dm[l // 4, 2 * (l % 4) + 1],
                      Dm[l // 4 + 8, 2 * (l % 4)], Dm[l // 4 + 8, 2 * (l % 4) + 1]] for l in range(32)])


def _gather_c(frags):
    """n-tiles of C fragments (32, 4) -> the (16, 8 * n) matrix."""
    out = np.zeros((16, 8 * len(frags)))
    for n, c in enumerate(frags):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            out[g, 8 * n + 2 * t:8 * n + 2 * t + 2] = c[lane, :2]
            out[g + 8, 8 * n + 2 * t:8 * n + 2 * t + 2] = c[lane, 2:]
    return out


@pytest.mark.parametrize("D", [64, 80, 128])
def test_the_kernels_fragments_compute_qk_and_pv(D):
    # one warp's 16 query rows against one KV tile of 64 rows, with the
    # kernel's loads: Q's a0..a3 = Q[g][c], Q[g+8][c], Q[g][c+1], Q[g+8][c+1]
    # and K's b0, b1 = K[8n+g][c], K[8n+g][c+1] (c = 8 kk + 2t); P's a0..a3
    # = S's c0, c2, c1, c3 and V's b0, b1 = V[8j+2t][8nd+g], V[8j+2t+1][8nd+g]
    rng = np.random.default_rng(D)
    kv = 64
    Q, K, V = (rng.integers(-4, 5, size=s).astype(np.float64) for s in ((16, D), (kv, D), (kv, D)))
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    s = [np.zeros((32, 4)) for _ in range(kv // 8)]
    for kk in range(D // 8):
        a = np.array([[Q[g, 8 * kk + 2 * t], Q[g + 8, 8 * kk + 2 * t], Q[g, 8 * kk + 2 * t + 1],
                       Q[g + 8, 8 * kk + 2 * t + 1]] for g, t in lanes])
        for n in range(kv // 8):
            b = np.array([[K[8 * n + g, 8 * kk + 2 * t], K[8 * n + g, 8 * kk + 2 * t + 1]] for g, t in lanes])
            s[n] = _mma_m16n8k8(a, b, s[n])
    S = _gather_c(s)
    np.testing.assert_array_equal(S, Q @ K.T)
    o = [np.zeros((32, 4)) for _ in range(D // 8)]
    for j in range(kv // 8):
        a = s[j][:, [0, 2, 1, 3]]
        for nd in range(D // 8):
            b = np.array([[V[8 * j + 2 * t, 8 * nd + g], V[8 * j + 2 * t + 1, 8 * nd + g]] for g, t in lanes])
            o[nd] = _mma_m16n8k8(a, b, o[nd])
    np.testing.assert_array_equal(_gather_c(o), S @ V)
