"""The MAR's conditioning streams in the port against the JAX package on the
CPU, at a small size (1+1 blocks of d = 32 over 2 heads, 4 frames of 4 x 4
tokens, 1-block heads of width 16), for each case of the JAX package's own
stream table (``tests/test_mar_import_parity.py:52-67``): pusht (no
stream), umi (CLIP text, history actions, proprioception of 16 and a
proprioception head of 6), toolhang (proprioception of 9 with the second
camera, a proprioception head of 9) and human_wrist (the wrist video head).

- ``forward_encoder`` in all five task modes, in eval and in training with
  the history keep mask and the label drop that JAX draws from its keys;
- the training forward's three losses in all five modes, with every draw of
  JAX's ``__call__`` (mask, each head's steps and noise, the keep mask, the
  label drop) replayed into the port;
- ``sample_policy`` in ``policy_model`` and ``inverse_model`` (JAX refuses
  the inverse mode with the wrist head, and so does the port) and
  ``sample_video`` with the wrist head, under JAX's draws;
- the label drop and the keep mask shown to act: all dropped is the null
  latent, all discarded the fake history latent;
- a history whose rows do not divide the tokens refused, as JAX refuses it.

fp32 throughout: FP32_TOL on activations and losses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    FP32_TOL,
    head_draws,
    init_shapes,
    random_params,
    to_numpy,
    video_draws,
)
from unified_video_action_tpu.models import mar as jm
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import mar as pm

B, T, C_TOK = 2, 4, 8
SIZE = dict(img_size=32, vae_stride=8, patch_size=1, vae_embed_dim=C_TOK,
            encoder_embed_dim=32, encoder_depth=1, encoder_num_heads=2,
            decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
            attn_dropout=0.0, proj_dropout=0.0, diffloss_d=1, diffloss_w=16,
            diffloss_act_d=1, diffloss_act_w=16, num_sampling_steps="3",
            act_diff_testing_steps="4", label_drop_prob=0.5, action_mask_ratio=0.5)
# the JAX package's stream table (tests/test_mar_import_parity.py:52-67)
CASES = {
    "pusht": dict(action_dim=2, task_name="pusht"),
    "umi": dict(action_dim=10, language_emb_model="clip", use_history_action=True,
                use_proprioception=True, proprio_dim=16, predict_proprioception=True,
                proprio_pred_dim=6, task_name="umi"),
    "toolhang": dict(action_dim=10, use_proprioception=True, proprio_dim=9,
                     proprio_use_image=True, predict_proprioception=True, proprio_pred_dim=9,
                     task_name="toolhang"),
    "human_wrist": dict(action_dim=14, predict_wrist_img=True, task_name="human_pp"),
}
MODES = jm.TASK_MODES


@functools.lru_cache(maxsize=None)
def build(case):
    jcfg = jm.MarConfig(**SIZE, **CASES[case])
    pcfg = pm.MarConfig(**SIZE, **CASES[case])
    jmar, pmar = jm.Mar(jcfg), pm.Mar(pcfg)
    inp = inputs(case, jcfg)
    kw = {k: inp[k] for k in ("text_latents", "proprio", "proprio_target") if inp[k] is not None}
    shapes = init_shapes(jmar, jnp.asarray(inp["x_frames"]), jnp.asarray(inp["cond_frames"]),
                         jax.random.PRNGKey(0), jnp.asarray(inp["actions"]),
                         method=jm.Mar.init_forward, **jax.tree.map(jnp.asarray, kw))
    params = to_numpy(random_params(shapes, seed=3))
    convert.load_into(pmar, params)
    return jmar, pmar, params, inp


def inputs(case, c):
    """Seeded numpy inputs for every stream the case has."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lat = (B, T, C_TOK, c.seq_hw, c.seq_hw)
    proprio = None
    if c.use_proprioception or c.predict_wrist_img:
        proprio = {}
        if c.use_proprioception:
            proprio["state"] = f(B, 16, c.proprio_dim)
        if c.proprio_use_image:
            proprio["second_image"] = f(*lat)
        if c.predict_wrist_img:
            proprio["pred_second_image"] = f(*lat)
    return {
        "x_frames": f(*lat), "cond_frames": f(*lat),
        "actions": np.clip(f(B, 16, c.action_dim), -1, 1),
        "history": f(B, 16, c.action_dim) if c.use_history_action else None,
        "text_latents": f(B, 512) if c.language_emb_model else None,
        "text_proj": f(B, 32) if c.language_emb_model else None,
        "proprio": proprio,
        "proprio_target": f(B, 16, c.proprio_pred_dim) if c.predict_proprioception else None,
        "mask": (rng.uniform(size=(B, 1, c.seq_len)) < 0.6).repeat(T, 1).astype(np.float32),
    }


def t(x, dtype=torch.float32):
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype)


def tokens(c, frames):
    return jm.patchify(jnp.asarray(frames).reshape(B * T, *frames.shape[2:]), 1).reshape(
        B, T, c.seq_len, C_TOK)


def proprio_tokens(c, proprio, keys=("second_image", "pred_second_image")):
    if proprio is None:
        return None
    out = {k: jnp.asarray(v) for k, v in proprio.items()}
    for k in keys:
        if k in proprio:
            out[k + "_tokens"] = tokens(c, proprio[k])
    return out


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(key, c, n_hist):
    k_rate, k_mask, k_enc, k_head = jax.random.split(key, 4)
    rate = jm.sample_mask_rate(k_rate, c.mask_ratio_min)
    out = {"mask": jm.random_spatial_mask(k_mask, B, c.seq_len, rate)}
    kv, ka, kp = jax.random.split(k_head, 3)
    heads = [("video", kv, B * c.total_tokens, C_TOK, 1000),
             ("action", ka, B * 16, c.action_dim, c.act_diff_training_steps)]
    if c.predict_wrist_img:
        heads.append(("wrist", jax.random.fold_in(kv, 1), B * c.total_tokens, C_TOK, 1000))
    if c.predict_proprioception:
        heads.append(("prop", kp, B * 16, c.proprio_pred_dim, c.act_diff_training_steps))
    for name, k, n, ch, steps in heads:
        t_key, noise_key = jax.random.split(k)
        out[f"{name}_t"] = jax.random.randint(t_key, (n,), 0, steps)
        out[f"{name}_noise"] = jax.random.normal(noise_key, (n, ch))
    out.update(_encoder_draws(k_enc, c, n_hist))
    return out


def _encoder_draws(k_enc, c, n_hist):
    """forward_encoder's draws from its rngs_key (mar.py:397-404, :463-469)."""
    out = {}
    if c.use_history_action:
        u = jax.random.uniform(jax.random.fold_in(k_enc, 1), (B, n_hist))
        out["history_keep"] = u <= c.action_mask_ratio
    if c.language_emb_model == "clip":
        out["label_drop"] = jax.random.uniform(jax.random.fold_in(k_enc, 2), (B,)) < c.label_drop_prob
    return out


def jax_draws(key, c, n_hist=16):
    """The draws of JAX's training ``__call__`` (mar.py:552-592, the keep
    mask and label drop of :397-404, :463-469) in the port's form."""
    out = {}
    for k, v in _jax_draws(key, c, n_hist).items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if k.endswith("_t") else
                                  v if v.dtype == bool else v.astype(np.float32))
    return out


def port_proprio(inp):
    return None if inp["proprio"] is None else {k: t(v) for k, v in inp["proprio"].items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("train", [False, True])
def test_forward_encoder_all_modes(case, train):
    """The encoder's output in every mode; in training with JAX's keep mask
    and label drop (drawn from the same rngs_key)."""
    jmar, pmar, params, inp = build(case)
    c = jmar.cfg
    key = jax.random.PRNGKey(5)
    draws = ({k: torch.from_numpy(np.asarray(v)) for k, v in _encoder_draws(key, c, 16).items()}
             if train else {})
    for mode in MODES:
        want = jmar.apply(
            {"params": params}, tokens(c, inp["x_frames"]), jnp.asarray(inp["mask"]),
            tokens(c, inp["cond_frames"]), mode,
            text_latents=None if inp["text_proj"] is None else jnp.asarray(inp["text_proj"]),
            history_actions=None if inp["history"] is None else jnp.asarray(inp["history"]),
            actions=jnp.asarray(inp["actions"]), proprio=proprio_tokens(c, inp["proprio"]),
            train=train, rngs_key=key if train else None, rngs={"dropout": key},
            method=jm.Mar.forward_encoder)
        got = pmar.forward_encoder(
            t(tokens(c, inp["cond_frames"])), t(inp["text_proj"]), mode, t(tokens(c, inp["x_frames"])),
            t(inp["mask"]), t(inp["actions"]), None, t(inp["history"]),
            port_proprio({"proprio": proprio_tokens(c, inp["proprio"])}),
            draws.get("history_keep"), draws.get("label_drop"))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32_TOL,
                                   err_msg=f"{case} {mode}")


@pytest.mark.parametrize("case", list(CASES))
def test_training_losses_all_modes(case):
    """(loss, video loss, action loss) of the training forward in every mode
    with every draw replayed from JAX's key."""
    jmar, pmar, params, inp = build(case)
    c = jmar.cfg
    for i, mode in enumerate(MODES):
        key = jax.random.PRNGKey(20 + i)
        want = jmar.apply(
            {"params": params}, jnp.asarray(inp["x_frames"]), jnp.asarray(inp["cond_frames"]), mode,
            key, history_actions=None if inp["history"] is None else jnp.asarray(inp["history"]),
            actions=jnp.asarray(inp["actions"]),
            text_latents=None if inp["text_latents"] is None else jnp.asarray(inp["text_latents"]),
            proprio=None if inp["proprio"] is None else jax.tree.map(jnp.asarray, inp["proprio"]),
            proprio_target=None if inp["proprio_target"] is None else jnp.asarray(inp["proprio_target"]),
            train=True, rngs={"dropout": key})
        got = pmar(t(inp["x_frames"]), t(inp["cond_frames"]), mode, t(inp["actions"]),
                   jax_draws(key, c), None,
                   t(inp["history"]), t(inp["text_latents"]), port_proprio(inp),
                   t(inp["proprio_target"]))
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   rtol=1e-5, atol=1e-6, err_msg=f"{case} {mode}")


def _policy_draws(key, c):
    init, steps = head_draws(key, B * 16, c.action_dim, 4)
    return torch.tensor(init), torch.tensor(steps)


@pytest.mark.parametrize("case", list(CASES))
def test_sample_policy(case):
    """The action chunk of ``sample_policy`` under JAX's sampler draws, in
    policy_model and inverse_model (raw goal latents, history, state and
    the second camera's latents)."""
    jmar, pmar, params, inp = build(case)
    c = jmar.cfg
    prop = None if inp["proprio"] is None else {k: v for k, v in inp["proprio"].items()
                                                if k != "pred_second_image"}
    for mode in ("policy_model", "inverse_model"):
        key = jax.random.PRNGKey(31)
        kwargs = dict(history_actions=t(inp["history"]), text_latents=t(inp["text_latents"]),
                      proprio=None if prop is None else {k: t(v) for k, v in prop.items()},
                      task_mode=mode, x_frames=t(inp["x_frames"]))
        if mode == "inverse_model" and c.predict_wrist_img:
            # JAX's sample_policy gives the inverse mode no wrist tokens
            with pytest.raises(KeyError):
                jmar.apply({"params": params}, jnp.asarray(inp["cond_frames"]), key,
                           proprio=jax.tree.map(jnp.asarray, prop), task_mode=mode,
                           x_frames=jnp.asarray(inp["x_frames"]), method=jm.Mar.sample_policy)
            with pytest.raises(ValueError, match="pred_second_image"):
                pmar.sample_policy(t(inp["cond_frames"]), *_policy_draws(key, c), **kwargs)
            continue
        want = jmar.apply(
            {"params": params}, jnp.asarray(inp["cond_frames"]), key, temperature=0.9,
            history_actions=None if inp["history"] is None else jnp.asarray(inp["history"]),
            text_latents=None if inp["text_latents"] is None else jnp.asarray(inp["text_latents"]),
            proprio=None if prop is None else jax.tree.map(jnp.asarray, prop),
            x_frames=jnp.asarray(inp["x_frames"]), task_mode=mode, method=jm.Mar.sample_policy)
        with torch.no_grad():
            got = pmar.sample_policy(t(inp["cond_frames"]), *_policy_draws(key, c), temperature=0.9,
                                     **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{case} {mode}")


def test_sample_video_wrist_head():
    """``sample_video`` with the wrist head (human_wrist) at num_iter 2 in
    full_dynamic_model under JAX's draws: the wrist frames it returns and
    the action chunk."""
    jmar, pmar, params, inp = build("human_wrist")
    c = jmar.cfg
    key = jax.random.PRNGKey(41)
    want_frames, want_act = jmar.apply({"params": params}, jnp.asarray(inp["cond_frames"]), key,
                                       num_iter=2, actions=jnp.asarray(inp["actions"]),
                                       method=jm.Mar.sample_video)
    draws = video_draws(key, pmar.video_draw_shapes(B, 2))
    assert "wrist_init" in draws["rounds"][0]
    got_frames, got_act = pmar.sample_video(t(inp["cond_frames"]), draws, num_iter=2,
                                            actions=t(inp["actions"]))
    scale = float(np.abs(np.asarray(want_frames)).max())
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), rtol=0,
                               atol=FP32_TOL["atol"] * max(scale, 1.0))
    np.testing.assert_allclose(got_act.numpy(), np.asarray(want_act), rtol=1e-4, atol=1e-4)


def test_label_drop_and_history_keep_act():
    """A label drop on every row gives the null latent's encoder output; a
    keep mask that keeps no history action gives the fake history latent's."""
    _, pmar, _, inp = build("umi")
    c = pmar.cfg
    args = (t(tokens(c, inp["cond_frames"])),)
    common = dict(task_mode="policy_model", proprio=port_proprio(inp))
    hist = t(inp["history"])
    with torch.no_grad():
        null = pmar.forward_encoder(*args, None, history_actions=None, **common)
        dropped = pmar.forward_encoder(*args, t(inp["text_proj"]), history_actions=hist,
                                       history_keep=torch.zeros(B, 16, dtype=torch.bool),
                                       label_drop=torch.ones(B, dtype=torch.bool), **common)
        kept = pmar.forward_encoder(*args, t(inp["text_proj"]), history_actions=hist,
                                    history_keep=torch.ones(B, 16, dtype=torch.bool),
                                    label_drop=torch.zeros(B, dtype=torch.bool), **common)
        plain = pmar.forward_encoder(*args, t(inp["text_proj"]), history_actions=hist, **common)
    torch.testing.assert_close(dropped, null, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kept, plain, rtol=0, atol=0)
    assert (kept - null).abs().max() > 1e-3


def test_history_rows_must_divide_the_tokens():
    """A 15-row history (the UMI window's with shift_action false) is refused
    by both: 64 tokens do not split into 15 slots."""
    jmar, pmar, params, inp = build("umi")
    c = jmar.cfg
    hist = inp["history"][:, :15]
    with pytest.raises(AssertionError):
        jmar.apply({"params": params}, jnp.asarray(inp["cond_frames"]), jax.random.PRNGKey(0),
                   history_actions=jnp.asarray(hist),
                   proprio=jax.tree.map(jnp.asarray, inp["proprio"]), method=jm.Mar.sample_policy)
    with pytest.raises(ValueError, match="do not divide"):
        pmar.policy_latents(t(inp["cond_frames"]), history_actions=t(hist), proprio=port_proprio(inp))
