"""The port in bf16, the flagship's compute dtype (latest/meta.json), against
the JAX package on the CPU at the tiny config of tests/_torch_parity.py, one
seed: at the VAE mean, the MAR encoder+decoder output, the action
denoiser's output and the sampled (normalized) action chunk.

bf16 keeps 8 significant bits, and the two stacks round at other places:
the port casts its parameters to bf16 once (policy.py), flax keeps them in
fp32 and casts at each use, so sums of parameters (the position embeddings)
round differently. The port's bf16 result and JAX's bf16 result therefore
differ from each other about as much as each differs from fp32. What is
held is the port's distance to JAX's fp32 result, mean |port_bf16 -
jax_fp32|, against JAX's own, mean |jax_bf16 - jax_fp32|, on the same fp32
inputs for every stage: at most BF16_RATIO times it. A port that lost
precision somewhere (an fp32 island computed in bf16, a sum taken in bf16)
moves that ratio well past 1. Measured here, port vs JAX: VAE mean 0.0073
vs 0.0078, MAR output 0.0069 vs 0.0067, denoiser 0.0087 vs 0.0095, sampled
actions 0.0053 vs 0.0052 (ratios 0.92-1.03).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import TINY_POLICY_KW, head_draws, random_params, to_numpy
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.models.vae import KLVae as JaxKLVae
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

BF16_RATIO = 1.5
B = 4


def _kwargs(dtype):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    kw["compute_dtype"] = dtype
    return kw


@pytest.fixture(scope="module")
def stacks():
    j32, j16 = JaxPolicy(**_kwargs("float32")), JaxPolicy(**_kwargs("bfloat16"))
    params = random_params(jax.eval_shape(j32.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**_kwargs("bfloat16"), device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    assert port.dtype == torch.bfloat16
    return j32, j16, params, port


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _hold(name, port16, jax16, jax32):
    port_err = np.abs(_f32(port16) - _f32(jax32)).mean()
    jax_err = np.abs(_f32(jax16) - _f32(jax32)).mean()
    assert jax_err > 0, f"{name}: JAX's bf16 equals its fp32"
    assert port_err <= BF16_RATIO * jax_err, (
        f"{name}: port bf16 vs JAX fp32 {port_err:.3g} > {BF16_RATIO} x JAX bf16 vs fp32 "
        f"{jax_err:.3g}")


def test_bf16_vae_mean(stacks):
    j32, j16, params, port = stacks
    x = np.random.default_rng(1).uniform(-1, 1, (B, 3, 32, 32)).astype(np.float32)
    run = lambda jp: jp.vae.apply({"params": params["vae"]}, jnp.asarray(x), method=JaxKLVae.encode)[0]
    with torch.no_grad():
        got = port.vae.encode(torch.tensor(x).to(torch.bfloat16))[0]
    _hold("VAE mean", got, run(j16), run(j32))


def _latents(seed):
    return np.random.default_rng(seed).standard_normal((B, 4, 8, 4, 4)).astype(np.float32)


def test_bf16_mar_output(stacks):
    j32, j16, params, port = stacks
    lat = _latents(2)
    tokens = np.asarray(jm_.patchify(jnp.asarray(lat.reshape(B * 4, 8, 4, 4)), 1)).reshape(B, 4, 16, 8)

    def fwd(mdl, tok):
        h = mdl.forward_encoder(jnp.zeros_like(tok), jnp.ones(tok.shape[:3]), tok, "policy_model")
        return mdl.forward_decoder(h)

    run = lambda jp: jp.mar.apply({"params": params["mar"]}, jnp.asarray(tokens), method=fwd)
    with torch.no_grad():
        got = port.mar.policy_latents(torch.tensor(lat))
    _hold("MAR output", got, run(j16), run(j32))


def test_bf16_denoiser_output(stacks):
    j32, j16, params, port = stacks
    rng = np.random.default_rng(3)
    n = B * 16
    x = rng.standard_normal((n, 2)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    c = rng.standard_normal((n, 64)).astype(np.float32)
    run = lambda jp: jp.mar.apply(
        {"params": params["mar"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
        method=lambda m, x, t, c: m.diffactloss.net(x, t, c))
    with torch.no_grad():
        got = port.mar.diffactloss.net(torch.tensor(x), torch.tensor(t).long(),
                                       torch.tensor(c).to(torch.bfloat16))
    _hold("denoiser", got, run(j16), run(j32))


def test_bf16_sampled_actions(stacks):
    j32, j16, params, port = stacks
    lat = _latents(4)
    key = jax.random.PRNGKey(5)
    run = lambda jp: jp.mar.apply({"params": params["mar"]}, jnp.asarray(lat), key,
                                  temperature=0.95, method=jm_.Mar.sample_policy)
    init, per_step = head_draws(key, B * 16, 2, port.mar.diffactloss.num_steps)
    with torch.no_grad():
        got = port.mar.sample_policy(torch.tensor(lat), torch.tensor(init), torch.tensor(per_step),
                                     temperature=0.95)
    _hold("sampled actions", got, run(j16), run(j32))


def _jax_stages(policy, params, target, cond, future, key):
    """Every MAR module's output in JAX's inverse_model training forward, by
    module path: flax's capture_intermediates, under jit."""
    @jax.jit
    def run(params, target, cond, future):
        _, state = policy.mar.apply(
            {"params": params}, target, cond, "inverse_model", key, actions=future, train=True,
            rngs={"dropout": jax.random.fold_in(key, 7)}, capture_intermediates=True,
            mutable=["intermediates"])
        return state["intermediates"]

    flat = {}

    def walk(d, path):
        for k, v in d.items():
            if k == "__call__":
                flat[".".join(path)] = [_f32(x) for x in v]
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(run(params, *(jnp.asarray(t.numpy()) for t in (target, cond, future))), ())
    return flat


def test_bf16_inverse_model_stages():
    """ROADMAP C7: in inverse_model the port's bf16 gradient sat 2.45x JAX's
    own bf16-vs-fp32 distance from JAX's bf16 (tests/test_torch_train_losses.py,
    seed 0). Stage by stage on the same fp32 latents, every MAR module's
    output in the forward stays within BF16_RATIO of JAX's own bf16 error
    (measured 0.71-1.26): the forward does not part. The backward parts first
    at the action pool's fc1 ReLU (tests/torch_bf16_grad_stages.py): one of
    its 512 pre-activations lies near 0 and rounds to the other sign in bf16,
    and inverse_model sends all its gradient through that pool; over other
    seeds the gap is 0.79-1.61x (ROADMAP C7)."""
    from torch.func import functional_call

    from tests.test_torch_train_losses import (
        build_pair,
        jax_train_draws,
        make_batch,
        to_torch,
        train_kw,
    )

    batch = make_batch(2)
    j32, params, p32 = build_pair(train_kw(), seed=1, batch=batch)
    j16, _, p16 = build_pair(train_kw("bfloat16"), seed=1, batch=batch)
    key = jax.random.PRNGKey(40 + jm_.TASK_MODES.index("inverse_model"))
    noise = jax_train_draws(key, p32, 2)
    captured = {}
    hook = p32.mar.register_forward_pre_hook(lambda m, args: captured.setdefault("args", args))
    p32.compute_loss(to_torch(batch), "inverse_model", noise=noise)
    hook.remove()
    target, cond, mode, future, draws, drop = captured["args"]
    k_fwd = jax.random.split(key, 3)[2]
    want32 = _jax_stages(j32, params["mar"], target, cond, future, k_fwd)
    want16 = _jax_stages(j16, params["mar"], target, cond, future, k_fwd)
    got, order = {}, []

    def record(name):
        def f(module, inputs, output):
            if isinstance(output, torch.Tensor):
                got.setdefault(name, []).append(output.detach())
                order.append((name, len(got[name]) - 1))
        return f

    hooks = [m.register_forward_hook(record(n)) for n, m in p16.mar.named_modules() if n]
    cast = {n: p.to(torch.bfloat16) for n, p in p16.mar.named_parameters()}
    with torch.no_grad():
        functional_call(p16.mar, cast, (target, cond, mode, future, draws, drop))
    for h in hooks:
        h.remove()
    held = 0
    for name, i in order:
        if name in want32 and i < len(want32[name]) and want32[name][i].shape == tuple(got[name][i].shape):
            _hold(f"{name}[{i}]", got[name][i], want16[name][i], want32[name][i])
            held += 1
    assert held >= 60  # every block, norm, head layer and the pool's dense layers
