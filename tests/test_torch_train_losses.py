"""The training losses of the port against the JAX package on the CPU, at a
small size (2+2 blocks of d = 64 over 4 heads, a 32 px VAE with ch = 32,
1-block video and 2-block action denoisers).

- ``training_losses`` and ``vb_terms_bpd`` of the 1000-step cosine
  diffusion at fixed steps (t = 0, the decoder-NLL branch, included) and
  noise, with targets at the +-1 edges of the discretized likelihood.
- The two heads' losses, with the JAX head's own draws of t and noise.
- ``compute_loss`` in each of the five task modes, with the device-side
  augmentation and a fitted action normalizer, in fp32 with dropout at 0:
  the loss within 1e-5 relative, and each gradient leaf of the MAR within
  1e-4 of that leaf's largest magnitude. The JAX keys (``policy.py:736-741``,
  ``mar.py:552-579``, ``heads.py:61-66``) are replayed into the port's
  noise arguments.
- The same at bf16 in each task mode (flax's ``dtype=bfloat16`` with fp32
  parameters against the port's cast of its parameters; every dense layer
  of the port takes and gives bf16): the loss within BF16_LOSS_RTOL, and the
  gradients as relative L2 distances measured against JAX's own bf16
  rounding, its distance from the fp32 gradient (the port's fp32 stands for
  JAX's: they agree to GRAD_TOL). The whole gradient lies within
  BF16_GRAD_GAP times that distance of JAX's bf16, each leaf within
  BF16_LEAF_GAP times its own; and the port's bf16 lies at least
  BF16_MIN_GAP times it from the port's fp32, which a port computing in
  fp32 would not. Both sides round every dense product's inputs and outputs
  to bf16, in their own order. On these inputs JAX's own distance is 0.0085
  (video_model) to 0.134 (policy_model) for the whole gradient; the port's
  bf16 sits 0.90-2.45 times it from JAX's bf16 (2.45 in inverse_model, where
  the port's bf16 lies 2.1 times as far from fp32 as JAX's), a leaf up to
  3.63 times its own, and the port's bf16 0.62-2.1 times it from the port's
  fp32.
- Dropout: the port's ``dropout`` given JAX's mask, and ``compute_loss`` at
  rate 0.1 with JAX's masks (``jax.random.bernoulli`` replaced by a queue of
  numpy masks) handed to the port in the same order.
- Gradient checkpointing (``nn.remat``) leaves the loss and the gradients as
  they are; the video-only stage (``predict_action`` false) drops the
  action-only task modes as JAX's policy does.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    FP32_TOL,
    TINY_POLICY_KW,
    init_shapes,
    random_params,
    to_numpy,
)
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.models import heads as jh
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.models import transformer as jt
from unified_video_action_tpu.models.diffusion import create_diffusion as j_create
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.models import heads as ph
from unified_video_action_tpu_torch.models.diffusion import create_diffusion as p_create
from unified_video_action_tpu_torch.models.transformer import dropout
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

TASK_MODES = jm_.TASK_MODES
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
BF16_LOSS_RTOL = 1e-2
# multiples of JAX's own bf16 distance from fp32 (module docstring)
BF16_GRAD_GAP = 3.0
BF16_LEAF_GAP = 4.0
BF16_MIN_GAP = 0.5

# the tiny policy for training: fp32, no dropout, every mode drawable
TRAIN_KW = copy.deepcopy(TINY_POLICY_KW)
TRAIN_KW["selected_training_mode"] = None
B, T = 2, 32


def train_kw(dtype="float32", dropout_rate=0.0):
    kw = copy.deepcopy(TRAIN_KW)
    kw["compute_dtype"] = dtype
    kw["autoregressive_model_params"].update(attn_dropout=dropout_rate, proj_dropout=dropout_rate)
    return kw


def make_batch(seed=0, aug=True, batch=B):
    """An obs window (B, 32, 3, 32, 32) uint8 and its actions, with the
    device-side augmentation's scalars."""
    rng = np.random.default_rng(seed)
    obs = {"image": rng.integers(0, 256, (batch, T, 3, 32, 32), dtype=np.uint8)}
    if aug:
        obs.update(aug_top=rng.integers(0, 3, batch).astype(np.int32),
                   aug_left=rng.integers(0, 3, batch).astype(np.int32),
                   aug_sigma=rng.uniform(0.1, 2.0, batch).astype(np.float32))
    return {"obs": obs, "action": rng.uniform(0, 512, (batch, T, 2)).astype(np.float32)}


def to_torch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
            "action": torch.from_numpy(batch["action"])}


def to_jax(batch):
    return {"obs": {k: jnp.asarray(v) for k, v in batch["obs"].items()},
            "action": jnp.asarray(batch["action"])}


def fitted_normalizers(batch):
    data = {"action": batch["action"].reshape(-1, 2)}
    jn, pn = JaxNormalizer(), LinearNormalizer()
    jn.fit(data)
    pn.fit(data)
    return jn, pn


def jax_train_draws(key, policy, batch, n_sel=8):
    """The draws of JAX's ``compute_loss`` from ``key``, keyed as the port's
    ``sample_train_noise``."""
    out = _jax_draws(key, policy.mar_cfg, batch, n_sel)
    return {k: torch.from_numpy(np.array(v)).to(torch.int64 if k.endswith("_t") else torch.float32)
            for k, v in out.items()}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, c, batch, n_sel):
    k_vae1, k_vae2, k_fwd = jax.random.split(key, 3)
    vae = (batch * n_sel // 2, c.vae_embed_dim, c.seq_hw, c.seq_hw)
    k_rate, k_mask, _k_enc, k_head = jax.random.split(k_fwd, 4)
    rate = jm_.sample_mask_rate(k_rate, c.mask_ratio_min)
    out = {"vae_cond": jax.random.normal(k_vae1, vae), "vae_target": jax.random.normal(k_vae2, vae),
           "mask": jm_.random_spatial_mask(k_mask, batch, c.seq_len, rate)}
    kv, ka, _kp = jax.random.split(k_head, 3)
    heads = (("video", kv, batch * c.total_tokens, c.token_embed_dim, 1000),
             ("action", ka, batch * c.num_action_tokens, c.action_dim, c.act_diff_training_steps))
    for name, k, n, ch, steps in heads:
        t_key, noise_key = jax.random.split(k)
        out[f"{name}_t"] = jax.random.randint(t_key, (n,), 0, steps)
        out[f"{name}_noise"] = jax.random.normal(noise_key, (n, ch))
    return out


def build_pair(kw, seed=0, batch=None):
    """The JAX policy with numpy-drawn params and the port's training policy
    holding the same weights (and, given a batch, the same fitted action
    normalizer)."""
    jp = JaxPolicy(**kw)
    params = to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                                    seed=seed))
    port = UnifiedVideoActionPolicy(**kw, train=True, device="cpu")
    port.load_params(params["mar"], params["vae"])
    if batch is not None:
        jn, pn = fitted_normalizers(batch)
        jp.set_normalizer(jn)
        port.set_normalizer(pn)
    return jp, params, port


def jax_loss_and_grads(jp, params, batch, key, mode):
    def f(mar):
        loss, aux = jp.compute_loss({"mar": mar, "vae": params["vae"]}, batch, key, mode)
        return loss, aux

    (loss, (vl, al)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params["mar"])
    return float(loss), float(vl), float(al), convert.flatten_tree(to_numpy(grads))


def port_grads(mar):
    """The MAR's gradients in the flax layout (zeros where none arrived)."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in mar.named_parameters()}
    return convert.flatten_tree(convert.to_flax_tree(mar, grads))


def assert_grads_close(got, want, tol):
    assert set(got) == set(want)
    for path, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol * scale + 1e-30,
                                   err_msg="/".join(path))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _whole(grads, paths):
    return np.concatenate([grads[p].ravel() for p in sorted(paths)])


def assert_grads_close_bf16(got, want, fp32):
    """``got`` (the port's bf16) against ``want`` (JAX's bf16), in multiples
    of JAX's own distance from ``fp32``; ``got`` at least BF16_MIN_GAP of
    that distance away from ``fp32``."""
    assert set(got) == set(want) == set(fp32)
    for path, w in want.items():
        assert _rel(got[path], w) <= BF16_LEAF_GAP * _rel(w, fp32[path]), \
            ("/".join(path), _rel(got[path], w), _rel(w, fp32[path]))
    g, w, f = (_whole(d, want) for d in (got, want, fp32))
    jax_gap = _rel(w, f)
    assert jax_gap > 0
    assert _rel(g, w) <= BF16_GRAD_GAP * jax_gap, (_rel(g, w), jax_gap)
    assert _rel(g, f) >= BF16_MIN_GAP * jax_gap, (_rel(g, f), jax_gap)


# ---------------------------------------------------------------- diffusion


def _denoise_pair(C):
    """One deterministic denoiser for both sides: (x_t, t) -> (eps ‖ v)."""
    w = np.random.default_rng(5).standard_normal((C, 2 * C)).astype(np.float32) * 0.5
    jfn = lambda x, t: jnp.tanh(x @ jnp.asarray(w) + (t[:, None] / 1000.0))
    pfn = lambda x, t: torch.tanh(x @ torch.tensor(w) + (t[:, None] / 1000.0))
    return jfn, pfn


@pytest.mark.parametrize("edges", [False, True])
def test_training_losses_and_vb_match_jax(edges):
    N, C = 64, 4
    rng = np.random.default_rng(int(edges))
    x0 = rng.uniform(-1, 1, (N, C)).astype(np.float32)
    if edges:
        x0[: N // 2] = np.sign(x0[: N // 2])  # the +-1 branches of the likelihood
    t = rng.integers(0, 1000, N)
    t[:8] = 0  # the decoder-NLL branch
    t[8:12] = 999
    noise = rng.standard_normal((N, C)).astype(np.float32)
    jd, pd = j_create(""), p_create("")
    jfn, pfn = _denoise_pair(C)
    want = jd.training_losses(jfn, jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise))
    got = pd.training_losses(pfn, torch.tensor(x0), torch.tensor(t), torch.tensor(noise))
    for k in ("loss", "mse", "vb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FP32_TOL, err_msg=k)

    out = rng.standard_normal((N, 2 * C)).astype(np.float32)
    x_t = rng.standard_normal((N, C)).astype(np.float32)
    want = jd.vb_terms_bpd(jnp.asarray(out), jnp.asarray(x0), jnp.asarray(x_t), jnp.asarray(t))
    got = pd.vb_terms_bpd(torch.tensor(out), torch.tensor(x0), torch.tensor(x_t), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_vb_term_sees_eps_detached():
    C = 4
    x0 = torch.rand(8, C) * 2 - 1
    t = torch.arange(8) * 100 + 1
    w = torch.randn(C, 2 * C, requires_grad=True)
    out = p_create("").training_losses(lambda x, tt: x @ w, x0, t, torch.randn(8, C))
    (g_vb,) = torch.autograd.grad(out["vb"].sum(), w)
    assert g_vb[:, :C].abs().max() == 0 and g_vb[:, C:].abs().max() > 0


# -------------------------------------------------------------------- heads

D = 32


def _head_draws(key, n, ch, steps=1000):
    t_key, noise_key = jax.random.split(key)
    t = np.asarray(jax.random.randint(t_key, (n,), 0, steps))
    return torch.tensor(t, dtype=torch.int64), torch.tensor(np.asarray(jax.random.normal(noise_key, (n, ch))))


def test_video_head_loss_matches_jax():
    L, C = 4 * 16, 8
    rng = np.random.default_rng(3)
    target = rng.standard_normal((B, L, C)).astype(np.float32)
    z = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.uniform(size=(B, L)) < 0.7).astype(np.float32)
    jm = jh.VideoDiffusionHead(target_channels=C, z_channels=D, width=24, depth=2)
    args = (jnp.asarray(target), jnp.asarray(z), jnp.asarray(mask))
    params = random_params(init_shapes(jm, *args, jax.random.PRNGKey(0)), seed=4)
    key = jax.random.PRNGKey(12)
    want = float(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args, key))
    pm = convert.load_into(ph.VideoDiffusionHead(C, D, width=24, depth=2), to_numpy(params))
    t, noise = _head_draws(key, B * L, C)
    with torch.no_grad():
        got = pm.loss(torch.tensor(target), torch.tensor(z), torch.tensor(mask), t, noise)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_action_head_loss_matches_jax():
    A = 2
    rng = np.random.default_rng(4)
    target = rng.uniform(-1, 1, (B, 16, A)).astype(np.float32)
    z = rng.standard_normal((B, 4 * 36, D)).astype(np.float32)
    jm = jh.ActionDiffusionHead(target_channels=A, z_channels=D, width=24, depth=2)
    args = (jnp.asarray(target), jnp.asarray(z))
    params = random_params(init_shapes(jm, *args, jax.random.PRNGKey(0)), seed=5)
    key = jax.random.PRNGKey(13)
    want = float(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *args, key))
    pm = convert.load_into(ph.ActionDiffusionHead(A, D, width=24, depth=2), to_numpy(params))
    t, noise = _head_draws(key, B * 16, A)
    with torch.no_grad():
        got = pm.loss(torch.tensor(target), torch.tensor(z), t, noise)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


# ------------------------------------------------------------- compute_loss


@pytest.fixture(scope="module")
def fp32_pair():
    batch = make_batch(0)
    return (*build_pair(train_kw(), seed=0, batch=batch), batch)


@pytest.mark.parametrize("mode", TASK_MODES)
def test_compute_loss_and_grads_match_jax(fp32_pair, mode):
    jp, params, port, batch = fp32_pair
    key = jax.random.PRNGKey(TASK_MODES.index(mode) + 20)
    loss, vl, al, want_grads = jax_loss_and_grads(jp, params, to_jax(batch), key, mode)
    port.mar.zero_grad(set_to_none=True)
    got = port.compute_loss(to_torch(batch), mode, noise=jax_train_draws(key, port, B))
    got[0].backward()
    np.testing.assert_allclose([x.item() for x in got], [loss, vl, al], rtol=LOSS_RTOL)
    assert (vl > 0) == (mode in jm_.TASK_MODES[:2] + ("full_dynamic_model",))
    assert (al > 0) == (mode in ("policy_model", "inverse_model", "full_dynamic_model"))
    assert_grads_close(port_grads(port.mar), want_grads, GRAD_TOL)


def test_compute_loss_without_augmentation_matches_jax(fp32_pair):
    jp, params, port, _ = fp32_pair
    batch = make_batch(1, aug=False)
    key = jax.random.PRNGKey(30)
    loss, vl, al, _ = jax_loss_and_grads(jp, params, to_jax(batch), key, "full_dynamic_model")
    with torch.no_grad():
        got = port.compute_loss(to_torch(batch), "full_dynamic_model",
                                noise=jax_train_draws(key, port, B))
    np.testing.assert_allclose([x.item() for x in got], [loss, vl, al], rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def bf16_pair():
    """The bf16 pair, and the port in fp32 on the same weights."""
    batch = make_batch(2)
    return (*build_pair(train_kw("bfloat16"), seed=1, batch=batch),
            build_pair(train_kw(), seed=1, batch=batch)[2], batch)


@pytest.mark.parametrize("mode", TASK_MODES)
def test_compute_loss_bf16_matches_jax(bf16_pair, mode):
    jp, params, port, port32, batch = bf16_pair
    port.mar.zero_grad(set_to_none=True)
    port32.mar.zero_grad(set_to_none=True)
    key = jax.random.PRNGKey(40 + TASK_MODES.index(mode))
    noise = jax_train_draws(key, port, B)
    loss, vl, al, want_grads = jax_loss_and_grads(jp, params, to_jax(batch), key, mode)
    dense_dtypes = set()

    def record(module, inputs, output):
        dense_dtypes.update({inputs[0].dtype, output.dtype})

    hooks = [m.register_forward_hook(record) for m in port.mar.modules()
             if isinstance(m, torch.nn.Linear)]
    got = port.compute_loss(to_torch(batch), mode, noise=noise)
    for h in hooks:
        h.remove()
    got[0].backward()
    assert all(p.dtype == torch.float32 for p in port.mar.parameters())
    assert dense_dtypes == {torch.bfloat16}
    np.testing.assert_allclose([x.item() for x in got], [loss, vl, al], rtol=BF16_LOSS_RTOL)
    port32.compute_loss(to_torch(batch), mode, noise=noise)[0].backward()
    assert_grads_close_bf16(port_grads(port.mar), want_grads, port_grads(port32.mar))


# ------------------------------------------------------------------ dropout


class _Drop(jt.nn.Module):
    @jt.nn.compact
    def __call__(self, x):
        return jt.tied_dropout(self, x, 0.1, deterministic=False)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dropout_given_jax_mask(dtype):
    x = jnp.asarray(np.random.default_rng(6).uniform(0.5, 2.0, (4, 64, 32)), dtype)
    want = _Drop().apply({}, x, rngs={"dropout": jax.random.PRNGKey(1)})
    keep = np.asarray(want) != 0
    assert 0.8 < keep.mean() < 0.97
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = dropout(torch.tensor(np.asarray(x, np.float32)).to(tdtype), torch.tensor(keep), 0.1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_compute_loss_with_jax_dropout_masks(monkeypatch):
    batch = make_batch(3)
    jp, params, port = build_pair(train_kw(dropout_rate=0.1), seed=2, batch=batch)
    c = port.mar_cfg
    N, Dm = c.total_tokens, c.encoder_embed_dim
    rng = np.random.default_rng(7)
    stacks = {}
    for stack, depth, heads in (("encoder_blocks", c.encoder_depth, c.encoder_num_heads),
                                ("decoder_blocks", c.decoder_depth, c.decoder_num_heads)):
        stacks[stack] = [tuple(rng.uniform(size=s) < 0.9 for s in
                               ((B, heads, N, N), (B, N, Dm), (B, N, Dm))) for _ in range(depth)]
    queue = [m for stack in ("encoder_blocks", "decoder_blocks") for blk in stacks[stack] for m in blk]

    def bernoulli(key, p, shape):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape and abs(p - 0.9) < 1e-6
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    key = jax.random.PRNGKey(50)
    loss, vl, al, want_grads = jax_loss_and_grads(jp, params, to_jax(batch), key, "full_dynamic_model")
    assert not queue
    drop = {k: [tuple(torch.from_numpy(m) for m in blk) for blk in v] for k, v in stacks.items()}
    got = port.compute_loss(to_torch(batch), "full_dynamic_model",
                            noise=jax_train_draws(key, port, B), drop=drop)
    got[0].backward()
    np.testing.assert_allclose([x.item() for x in got], [loss, vl, al], rtol=LOSS_RTOL)
    assert_grads_close(port_grads(port.mar), want_grads, GRAD_TOL)


def test_generator_draws_and_refusals():
    batch = to_torch(make_batch(4))
    port = UnifiedVideoActionPolicy(**train_kw(dropout_rate=0.1), train=True, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        port.compute_loss(batch, "policy_model")
    losses = [port.compute_loss(batch, "full_dynamic_model",
                                generator=torch.Generator().manual_seed(0))[0] for _ in range(2)]
    assert torch.isfinite(losses[0]) and float(losses[0]) == float(losses[1])
    noise = port.sample_train_noise(B, torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in noise.items()} == port.train_noise_shapes(B)
    assert noise["mask"].sum(-1).min() >= np.ceil(port.mar_cfg.seq_len * 0.7)
    with pytest.raises(RuntimeError, match="train=True"):
        UnifiedVideoActionPolicy(**train_kw(), device="cpu").compute_loss(batch, "policy_model")
    with pytest.raises(ValueError, match="task_mode"):
        port.compute_loss(batch, "bogus_model", generator=torch.Generator())


def test_grad_checkpointing_gives_the_same_loss_and_grads():
    # the masks are drawn before each block, outside its checkpoint, so the
    # recompute in the backward sees the same ones
    batch = to_torch(make_batch(6))
    out = {}
    for remat in (False, True):
        kw = train_kw(dropout_rate=0.1)
        kw["autoregressive_model_params"]["grad_checkpointing"] = remat
        port = UnifiedVideoActionPolicy(**kw, train=True, device="cpu")
        port.load_params(convert.seeded_tree(port.mar, 0), convert.seeded_tree(port.vae, 1))
        assert port.mar.encoder_blocks.remat == remat
        loss = port.compute_loss(batch, "full_dynamic_model",
                                 generator=torch.Generator().manual_seed(1))[0]
        loss.backward()
        out[remat] = (loss.item(), port_grads(port.mar))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for path, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][path], g, rtol=1e-6, atol=1e-7, err_msg=str(path))


def test_video_stage_without_the_action_head():
    # stage 1 of the recipe: predict_action false drops the action-only modes
    kw = train_kw()
    kw["action_model_params"] = {"predict_action": False, "act_model_type": "conv_fc"}
    port = UnifiedVideoActionPolicy(**kw, train=True, device="cpu")
    assert port.task_modes == JaxPolicy(**kw).task_modes
    assert "policy_model" not in port.task_modes and not hasattr(port.mar, "diffactloss")
    port.init_params(0)
    loss, vl, al = port.compute_loss(to_torch(make_batch(7)), "video_model",
                                     generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(loss) and al.item() == 0.0 and loss.item() == vl.item() > 0
