"""Shared pieces of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py).

Weights: the JAX modules' own parameter layout (``jax.eval_shape`` of their
init), filled with numpy draws from a seed, goes through the port's weight
bridge. Random values everywhere (rather than the JAX initializers, which
zero the AdaLN modulations and the denoiser's last projection) keep every
layer of the comparison live.

Noise: the JAX package draws its noise with ``jax.random`` inside the
computation; the tests draw the same numbers from the same keys here and
inject them into the port.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

# fp32 algorithm parity: the same arithmetic in another order on the CPU.
FP32_TOL = dict(rtol=1e-5, atol=1e-5)

TINY_POLICY_KW = dict(
    shape_meta={"action": {"shape": [2]}},
    vae_model_params={
        "autoencoder_path": None,
        "ddconfig": {"vae_embed_dim": 8, "ch_mult": [1, 1, 2, 2], "ch": 32},
    },
    autoregressive_model_params={
        "model_size": "custom",
        "encoder_embed_dim": 64, "encoder_depth": 2, "encoder_num_heads": 4,
        "decoder_embed_dim": 64, "decoder_depth": 2, "decoder_num_heads": 4,
        "img_size": 32, "vae_stride": 8, "vae_embed_dim": 8,
        "diffloss_d": 1, "diffloss_w": 32,
        "diffloss_act_d": 2, "diffloss_act_w": 32,
        "num_sampling_steps": "2", "act_diff_testing_steps": "100",
        "attn_dropout": 0.0, "proj_dropout": 0.0,
        "pretrained_model_path": None, "temperature": 0.95,
    },
    action_model_params={"predict_action": True, "act_model_type": "conv_fc"},
    task_name="pusht",
    compute_dtype="float32",
)


def random_params(shapes, seed: int, scale: float = 1.0):
    """A pytree of ShapeDtypeStructs (flax layout) -> numpy fp32 arrays:
    kernels N(0, scale²/fan_in), norm scales 1 + N(0, 0.1²), everything else
    N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(s.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(scale / np.sqrt(np.prod(shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * x
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def init_shapes(module, *args, method=None, **kwargs):
    """Parameter shapes of a flax module's init, without computing it."""
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(
        lambda: module.init({"params": key, "dropout": key}, *args, method=method, **kwargs)
    )["params"]


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def head_draws(key, n: int, channels: int, steps: int):
    """The draws of ``ActionDiffusionHead.sample`` (heads.py:283-297) and its
    ``p_sample_loop`` (gaussian.py:322-330) from ``key``: the sampler's start
    (n, C) and the per-step noise (steps, n, C)."""
    noise_key, loop_key = jax.random.split(key)
    init = np.asarray(jax.random.normal(noise_key, (n, channels)))
    step_keys = jax.random.split(loop_key, steps)
    per_step = np.stack([np.asarray(jax.random.normal(k, (n, channels))) for k in step_keys])
    return init, per_step


def video_draws(key, shapes):
    """The draws of JAX's ``Mar.sample_video`` (mar.py:756-832) from ``key``,
    shaped as the port's ``Mar.video_draw_shapes`` gives them: the order
    from ``k_order, key = split(key)``; per round ``key, ka = split(key)``
    for the action head where the round samples it (``head_draws``), then
    ``key, kv = split(key)`` for the video head, whose ``noise_key,
    loop_key = split(kv)`` give the start and the per-step noise, then
    likewise ``key, kw = split(key)`` for the wrist head where there is one. Returns
    torch tensors in the form ``sample_video`` takes."""
    from unified_video_action_tpu.models.mar import sample_orders

    k_order, key = jax.random.split(key)
    B, S = shapes["order_rank"]
    rounds = []
    for r in shapes["rounds"]:
        d = {}
        if "action_init" in r:
            key, ka = jax.random.split(key)
            steps, n, channels = r["action_steps"]
            d["action_init"], d["action_steps"] = head_draws(ka, n, channels, steps)
        key, kv = jax.random.split(key)
        noise_key, loop_key = jax.random.split(kv)
        d["video_init"] = np.asarray(jax.random.normal(noise_key, r["video_init"]))
        steps = r["video_steps"][0]
        d["video_steps"] = np.stack([np.asarray(jax.random.normal(k, r["video_steps"][1:]))
                                     for k in jax.random.split(loop_key, steps)])
        if "wrist_init" in r:  # the wrist head's: key, kw = split(key) (mar.py:839)
            key, kw = jax.random.split(key)
            noise_key, loop_key = jax.random.split(kw)
            d["wrist_init"] = np.asarray(jax.random.normal(noise_key, r["wrist_init"]))
            d["wrist_steps"] = np.stack([np.asarray(jax.random.normal(k, r["wrist_steps"][1:]))
                                         for k in jax.random.split(loop_key, steps)])
        rounds.append({k: torch.tensor(v) for k, v in d.items()})
    order = torch.tensor(np.asarray(sample_orders(k_order, B, S)), dtype=torch.int64)
    return {"order_rank": order, "rounds": rounds}


def policy_draws(key, noise_shapes):
    """The draws of the JAX policy's predict fn (policy.py:443): the key
    splits into (k_vae, k_wrist, k_samp); k_vae feeds the VAE posterior,
    k_wrist the second camera's where the shapes name one (``vae_wrist``)
    and k_samp the action head. Returns torch tensors keyed as the port's
    ``UnifiedVideoActionPolicy.sample_noise``."""
    k_vae, k_wrist, k_samp = jax.random.split(key, 3)
    steps, n, channels = noise_shapes["steps"]
    init, per_step = head_draws(k_samp, n, channels, steps)
    out = {"vae": np.asarray(jax.random.normal(k_vae, noise_shapes["vae"])),
           "init": init, "steps": per_step}
    if "vae_wrist" in noise_shapes:
        out["vae_wrist"] = np.asarray(jax.random.normal(k_wrist, noise_shapes["vae_wrist"]))
    return {k: torch.tensor(v) for k, v in out.items()}


# W8A8 parity. x_q = round(x / scale) is a step function: a float32 rounding
# difference upstream (LayerNorm, attention, a convolution, computed in
# another order than XLA computes it) that puts an activation on the other
# side of a step changes that element by one quantum, 1/127 of its row's
# largest value, and the change spreads through the row's later layers.
#
# A layer or a block: most rows are held to FP32_TOL and the mean difference
# to a tenth of the gap between JAX's int8 and float results on the same
# inputs (an implementation of the float function, or of another
# quantization, sits at the gap itself).
INT8_MIN_EXACT_ROWS = 0.9
INT8_GAP_FRACTION = 0.1


def assert_int8_parity(got, want, want_float):
    """Arrays whose last axis is a row: the share of rows within FP32_TOL, and
    mean |got - want| against mean |want - want_float|."""
    got, want, want_float = (np.asarray(a, np.float64) for a in (got, want, want_float))
    rows = np.isclose(got, want, **FP32_TOL).reshape(-1, got.shape[-1]).all(axis=-1).mean()
    err, gap = np.abs(got - want).mean(), np.abs(want - want_float).mean()
    assert rows >= INT8_MIN_EXACT_ROWS and err <= INT8_GAP_FRACTION * gap, (
        f"rows within FP32_TOL {rows:.3f} (min {INT8_MIN_EXACT_ROWS}), mean |d| {err:.3g} "
        f"vs {INT8_GAP_FRACTION} x int8-vs-float gap {gap:.3g}"
    )


# Sampled action chunks: attention spreads one crossed step over the whole
# chunk, and the sampler's first steps multiply x and eps by up to 2e4
# before clipping x0, so a chunk is either reproduced to the float slice's
# tolerance (INT8_CHUNK_ATOL in normalized action units, as
# tests/test_torch_policy.py's NORMALIZED_ATOL) or moved about as far as
# quantization itself moves it. Held: at least ``min_exact`` chunks within
# INT8_CHUNK_ATOL, each of them at least 30x tighter than its own int8-vs-
# float gap (a float implementation reproduces no chunk), and the mean over
# all chunks below the mean gap.
INT8_CHUNK_ATOL = 1e-4


def assert_int8_chunks(got, want, want_float, min_exact):
    """Chunks along the first axis: mean |got - want| and mean |want -
    want_float| per chunk."""
    got, want, want_float = (np.asarray(a, np.float64) for a in (got, want, want_float))
    axes = tuple(range(1, got.ndim))
    d, gap = np.abs(got - want).mean(axis=axes), np.abs(want - want_float).mean(axis=axes)
    exact = d <= INT8_CHUNK_ATOL
    assert exact.sum() >= min_exact, (d, gap)
    assert (gap[exact] >= 30 * INT8_CHUNK_ATOL).all(), (d, gap)
    assert d.mean() < gap.mean(), (d, gap)


# Run configs. bench.py's parity tier (bench.py:64-74, :128-145) on top of
# uva_pusht.yaml: the action head on, 100 sampler steps, bf16, VAE encodes of
# 64 frames, the default VAE width written out, and no checkpoint paths
# (weights load apart); the port's config.PUSHT_256 and PUSHT_HUGE256
BENCH_PARITY_OVERRIDES = [
    "model.policy.action_model_params.predict_action=true",
    "model.policy.autoregressive_model_params.act_diff_testing_steps=100",
    "model.policy.autoregressive_model_params.pretrained_model_path=null",
    "model.policy.vae_model_params.autoencoder_path=null",
    "model.policy.vae_model_params.ddconfig.ch=128",
    "model.policy.compute_dtype=bfloat16",
    "model.policy.vae_encode_chunk=64",
]


def leaves(tree, prefix=()):
    """(path, value) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def assert_same_run_config(got: dict, jax_cfg: dict, as_str=()):
    """The port's run config ``got`` against the JAX package's composed
    ``jax_cfg``: every leaf of ``model.policy`` (those named in ``as_str``
    compared as strings: an override reads 100 as an int where the yaml
    quotes "100"), and the task's name and shape_meta."""
    want = dict(leaves(jax_cfg["model"]["policy"]))
    have = dict(leaves(got["model"]["policy"]))
    assert sorted(have) == sorted(want)
    for path, value in want.items():
        assert have[path] == (str(value) if path[-1] in as_str else value), path
    assert got["task"] == {"name": jax_cfg["task"]["name"],
                           "shape_meta": jax_cfg["task"]["shape_meta"]}
