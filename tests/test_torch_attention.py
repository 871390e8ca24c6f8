"""Port of ops/attention.py: the plain version against the JAX package's
Pallas kernel (interpret mode) and einsum path, the wrapper's CPU route and
the kernel build, at head dimensions 64, 80 and 128. The CUDA kernel itself is
held against the plain version in tests/test_torch_attention_cuda.py, on the
card.

Tolerances are those of tests/test_ops.py: atol 2e-5 in fp32 (the same
function summed in another order) and 3e-2 in bf16 (inputs rounded to bf16,
P rounded to bf16 before P·V in the kernels).
"""

import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_video_action_tpu.ops.attention import flash_attention as jax_flash_attention
from unified_video_action_tpu_torch.ops import _build
from unified_video_action_tpu_torch.ops import attention as port


def _qkv(B, N, H, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)]


def _jax_einsum(q, k, v):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("N", [128, 200, 1024, 1088])
def test_plain_matches_jax_flash_attention_fp32(N):
    q, k, v = _qkv(2, N, 3)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))
    got = port.attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_jax_einsum(q, k, v)), atol=2e-5)


def test_plain_matches_jax_flash_attention_bf16():
    q, k, v = _qkv(1, 256, 2, seed=1)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = port.attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


# JAX's flash_attention with single_pass=False runs _attn_kernel, the online
# softmax over 256-row KV blocks (ragged last block masked at N = 1088), which
# the port's online-softmax kernel counterparts; the plain version is what
# that kernel is held against on the card
@pytest.mark.parametrize("N", [1024, 1088])
def test_plain_matches_jax_online_kernel_fp32(N):
    q, k, v = _qkv(2, N, 3, seed=4)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          single_pass=False, interpret=True))
    got = port.attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_plain_matches_jax_online_kernel_bf16():
    q, k, v = _qkv(1, 1024, 2, seed=5)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, single_pass=False, interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = port.attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


# Every head dimension the kernels are built for (64 mar_base, 80 mar_huge,
# 128 mar_small), at the 96 px paths' N = 144 and the kitchen model's 320
# (256 frame tokens and 64 text tokens), through both Pallas kernels
# (single_pass True and False) in interpret mode. Tolerances as above: fp32
# 2e-5, bf16 3e-2.
@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("N", [144, 320])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_plain_matches_jax_at_each_head_dim_fp32(D, N, single_pass):
    q, k, v = _qkv(1, N, 2, D, seed=D + N)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          single_pass=single_pass, interpret=True))
    got = port.attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("N", [144, 320])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_plain_matches_jax_at_each_head_dim_bf16(D, N):
    q, k, v = _qkv(1, N, 2, D, seed=D + N + 1)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = port.attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.tensor(x) for x in _qkv(2, 100, 2, seed=2))
    before = dict(port.launch_count)
    got = port.flash_attention(q, k, v)
    assert port.launch_count == before
    torch.testing.assert_close(got, port.attention_plain(q, k, v), rtol=0, atol=0)


def test_plain_version_reads_strided_qkv_views():
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.standard_normal((2, 50, 3, 4, 64)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = port.flash_attention(q, k, v)
    want = port.attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_checks_reject_what_the_kernel_cannot_take():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="D=32"):
        port._check(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port._check(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="shape"):
        port._check(q, q, torch.zeros(1, 9, 2, 64))
    with pytest.raises(ValueError, match="last dimension"):
        t = torch.zeros(1, 8, 2, 128)[..., ::2]
        port._check(t, t, t)
    port._check(q, q, q)


def _fake_nvcc(tmp_path, script):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2; exit 2\n")))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build("attention")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_writes_the_library_and_its_report(tmp_path, monkeypatch):
    # a stand-in compiler that writes its -o argument, to check the
    # plumbing: output renamed into place, log kept, an unchanged source not rebuilt
    script = 'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"; echo "ptxas info: 0 bytes"\n'
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, script)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.build("attention") > 0
    assert _build.library_path("attention").read_text() == "lib\n"
    assert "ptxas info" in _build.build_log("attention")
    assert _build.build("attention") == 0.0


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (csrc / "k.cu").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "shared.cuh").write_text("// a header\n")
    assert _build.library_path("k") != second
