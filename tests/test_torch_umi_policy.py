"""The UMI and toolhang policies of the port against the JAX package on the
CPU, in fp32 at a small size (1+1 blocks of d = 32 over 2 heads, a 32 px
VAE with ch = 32, 4 x 4 tokens a frame, 1-block heads, 4 sampler steps):

- ``_build_proprio_eval`` (UMI's four keys, robomimic's three and the wrist
  camera's selected frames) and ``_build_proprio_train`` (UMI's state over
  the window and gathered at the history ``img_indices``; robomimic's halves,
  the history frames under ``different_history_freq``, the wrist camera's
  latents under JAX's keys) equal to JAX's;
- ``predict_action`` on the obs dict (UMI: the 16-step relative-pose obs,
  ``past_action`` and precomputed language latents; toolhang: both
  cameras and the 9-d state) and UMI's ``predict_action_cached``, under
  JAX's draws: actions within 1e-4;
- ``compute_loss`` for UMI in policy_model and full_dynamic_model on a
  loader batch with the random history frequency and language (the label
  drop), and for toolhang with the wrist head and the proprioception head,
  every draw of JAX's keys replayed: losses within 1e-5 relative and each
  gradient leaf within 1e-4 of its largest magnitude; history actions on
  UMI's 32-step window refused by both;
- three AdamW + EMA steps of the UMI policy against JAX's
  ``make_train_step``;
- the weight bridge both ways on the new leaves;
- ``config.UMI_MULTI`` and ``config.TOOLHANG`` against ``load_config``
  with the same overrides, field by field;
- the UMI validation reading against JAX's predict program (JAX's own
  ``_val_action_l2`` raises on a UMI batch);
- ``train_torch.py --config umi_multi`` on the CPU at a tiny size.
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, policy_draws, random_params, to_numpy
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.data import umi_dataset as jumi
from unified_video_action_tpu.data.loader import DataLoader as JaxLoader
from unified_video_action_tpu.models import mar as jm
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.training import optim as joptim
from unified_video_action_tpu.training import train_state as jts
from unified_video_action_tpu.training.ema import EmaConfig as JaxEma
from unified_video_action_tpu.training.workspace import TrainWorkspace
from unified_video_action_tpu_torch import config, convert
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import workspace as pws
from unified_video_action_tpu_torch.training.ema import EmaConfig
from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step

AMP = {
    "model_size": "custom",
    "encoder_embed_dim": 32, "encoder_depth": 1, "encoder_num_heads": 2,
    "decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 2,
    "img_size": 32, "vae_stride": 8, "vae_embed_dim": 8,
    "diffloss_d": 1, "diffloss_w": 16, "diffloss_act_d": 1, "diffloss_act_w": 16,
    "num_sampling_steps": "2", "act_diff_testing_steps": "4",
    "attn_dropout": 0.0, "proj_dropout": 0.0, "pretrained_model_path": None,
    "temperature": 0.95, "label_drop_prob": 0.5,
}
VAE = {"autoencoder_path": None, "ddconfig": {"vae_embed_dim": 8, "ch_mult": [1, 1, 2, 2], "ch": 32}}
UMI_KW = dict(shape_meta={"action": {"shape": [10]}}, vae_model_params=VAE,
              autoregressive_model_params=AMP,
              action_model_params={"predict_action": True, "act_model_type": "conv_fc"},
              task_name="umi", normalizer_type="none", shift_action=False,
              use_proprioception=True, different_history_freq=True, language_emb_model="clip",
              compute_dtype="float32", task_modes=("policy_model", "full_dynamic_model"))
TOOLHANG_KW = dict(UMI_KW, task_name="toolhang", normalizer_type="all", shift_action=True,
                   different_history_freq=True, language_emb_model=None,
                   predict_proprioception=True, predict_wrist_img=True)
B = 2
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def _params(kind, history):
    kw = dict(UMI_KW if kind == "umi" else TOOLHANG_KW, use_history_action=history)
    jp = JaxPolicy(**kw)
    return to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=9))


def pair(kind, train=False, **overrides):
    """The JAX policy with numpy-drawn parameters and the port's holding
    them; serving takes UMI's history actions (``use_history_action``),
    training on UMI's window cannot (JAX refuses it)."""
    overrides.setdefault("use_history_action", kind == "umi" and not train)
    kw = dict(UMI_KW if kind == "umi" else TOOLHANG_KW, **overrides)
    params = _params(kind, kw["use_history_action"])
    jp = JaxPolicy(**kw)
    port = UnifiedVideoActionPolicy(**kw, train=train, device="cpu")
    port.load_params(params["mar"], params["vae"])
    return jp, params, port


def umi_obs(rng, T=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"camera0_rgb": rng.uniform(size=(B, T, 3, 32, 32)).astype(np.float32),
            "robot0_eef_pos": f(B, T, 3), "robot0_eef_rot_axis_angle": f(B, T, 6),
            "robot0_gripper_width": rng.uniform(size=(B, T, 1)).astype(np.float32),
            "robot0_eef_rot_axis_angle_wrt_start": f(B, T, 6), "past_action": f(B, 16, 10)}


def toolhang_obs(rng, T=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"sideview_image": rng.integers(0, 256, (B, T, 3, 40, 40), dtype=np.uint8),
            "robot0_eye_in_hand_image": rng.uniform(size=(B, T, 3, 40, 40)).astype(np.float32),
            "robot0_eef_pos": f(B, T, 3), "robot0_eef_quat": f(B, T, 4),
            "robot0_gripper_qpos": f(B, T, 2)}


def umi_batch(seed=0, epoch=0):
    """A loader batch of UMI items with the random history frequency."""
    ds = jumi.UmiLazyDataset(jumi.make_synthetic_umi(2, 40, seed=seed, image_size=32),
                             val_ratio=0.0, random_img_sampling=True)
    ds.set_epoch(epoch)
    b = next(iter(JaxLoader(ds, batch_size=B, shuffle=True, seed=seed, num_workers=1)))
    b = {"obs": b["obs"], "action": b["action"]}
    b["language_latents"] = np.random.default_rng(seed).standard_normal((B, 512)).astype(np.float32)
    return b


def toolhang_batch(seed=0, T=32):
    rng = np.random.default_rng(seed)
    obs = toolhang_obs(rng, T)
    obs["sideview_image"] = obs["sideview_image"][..., :32, :32].copy()
    obs["robot0_eye_in_hand_image"] = obs["robot0_eye_in_hand_image"][..., :32, :32].copy()
    return {"obs": obs, "action": rng.uniform(-1, 1, (B, T, 10)).astype(np.float32)}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- the state streams -------------------------------------------------------

def test_build_proprio_eval_equals_jax():
    rng = np.random.default_rng(1)
    for kind, obs in (("umi", umi_obs(rng)), ("toolhang", toolhang_obs(rng))):
        jp, _, port = pair(kind)
        idx = np.array([3, 7, 11, 15])
        remap = lambda o: {("wrist_image" if k == "robot0_eye_in_hand_image" else k): v
                           for k, v in o.items()}
        want = jp._build_proprio_eval(remap(obs), idx)
        got = port._build_proprio_eval(remap(obs), idx)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{kind} {k}")


def test_build_proprio_train_equals_jax():
    # UMI: the state gathered per sample at the history img_indices
    jp, params, port = pair("umi", train=True)
    batch = umi_batch(3)
    want, _ = jp._build_proprio_train(params, to_jax(batch["obs"]), np.arange(8), None)
    got, target = port._build_proprio_train(to_torch(batch["obs"]), np.arange(8), {})
    assert target is None and got["state"].shape == (B, 4, 16)
    np.testing.assert_array_equal(got["state"].numpy(), np.asarray(want["state"]))
    # robomimic: the halves at the history frames, and the wrist camera's
    # latents under JAX's keys (k1, k2 = split(key))
    jp, params, port = pair("toolhang", train=True)
    batch = toolhang_batch(4)
    obs = {("wrist_image" if k == "robot0_eye_in_hand_image" else k): v
           for k, v in batch["obs"].items()}
    frames = np.array([0, 5, 9, 15, 19, 23, 27, 31])
    key = jax.random.PRNGKey(8)
    k1, k2 = jax.random.split(key)
    shape = (B * 4, 8, 4, 4)
    noise = {"vae_wrist_cond": torch.tensor(np.asarray(jax.random.normal(k1, shape))),
             "vae_wrist_target": torch.tensor(np.asarray(jax.random.normal(k2, shape)))}
    want, want_t = jp._build_proprio_train(params, to_jax(obs), frames, key)
    got, got_t = port._build_proprio_train(to_torch(obs), frames, noise)
    np.testing.assert_array_equal(got["state"].numpy(), np.asarray(want["state"]))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    for k in ("second_image", "pred_second_image"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FP32_TOL, err_msg=k)


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["umi", "toolhang"])
def test_predict_action_equals_jax(kind):
    """The obs-dict request under JAX's draws (the second camera's posterior
    noise from JAX's k_wrist)."""
    jp, params, port = pair(kind)
    rng = np.random.default_rng(2)
    obs = umi_obs(rng) if kind == "umi" else toolhang_obs(rng)
    goal = rng.standard_normal((1, 512)).astype(np.float32) if kind == "umi" else None
    key = jax.random.PRNGKey(12)
    want = jp.predict_action(to_jax(params), obs, key, language_goal=goal)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)), language_goal=goal)
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-4, atol=1e-4)
    assert got["action"].shape == (B, 8, 10)
    if kind == "umi":
        # the history stream is live: other past actions give other actions
        other = dict(obs, past_action=obs["past_action"][::-1].copy())
        moved = port.predict_action(other, noise=policy_draws(key, port.noise_shapes(B)),
                                    language_goal=goal)
        assert np.abs(moved["action_pred"] - got["action_pred"]).max() > 1e-4


def test_umi_predict_action_cached_equals_jax():
    jp, params, port = pair("umi")
    rng = np.random.default_rng(5)
    windows = [umi_obs(rng), umi_obs(rng)]
    goal = rng.standard_normal((B, 512)).astype(np.float32)
    jparams, cache_j, cache_p = to_jax(params), None, None
    for step, obs in enumerate(windows):
        key = jax.random.PRNGKey(30 + step)
        want, cache_j = jp.predict_action_cached(jparams, obs, key, cache=cache_j, language_goal=goal)
        n_new = len(port.cache_plan(16, cache_p, 8)[1])
        noise = policy_draws(key, port.noise_shapes(B, n_new))
        got, cache_p = port.predict_action_cached(obs, cache=cache_p, noise=noise, language_goal=goal)
        np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-4, atol=1e-4)


# -- training ------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_loss_draws(key, c, n_sel, n_hist, wrist):
    """JAX's compute_loss draws (policy.py:732-764, mar.py:552-592) in the
    port's form."""
    k_vae1, k_vae2, k_fwd = jax.random.split(key, 3)
    vae = (B * n_sel // 2, c.vae_embed_dim, c.seq_hw, c.seq_hw)
    out = {"vae_cond": jax.random.normal(k_vae1, vae), "vae_target": jax.random.normal(k_vae2, vae)}
    if wrist:
        k1, k2 = jax.random.split(jax.random.fold_in(key, 3))
        out["vae_wrist_cond"] = jax.random.normal(k1, vae)
        if c.predict_wrist_img:
            out["vae_wrist_target"] = jax.random.normal(k2, vae)
    k_rate, k_mask, k_enc, k_head = jax.random.split(k_fwd, 4)
    out["mask"] = jm.random_spatial_mask(k_mask, B, c.seq_len, jm.sample_mask_rate(k_rate, c.mask_ratio_min))
    kv, ka, kp = jax.random.split(k_head, 3)
    heads = [("video", kv, B * c.total_tokens, c.token_embed_dim, 1000),
             ("action", ka, B * 16, c.action_dim, c.act_diff_training_steps)]
    if c.predict_wrist_img:
        heads.append(("wrist", jax.random.fold_in(kv, 1), B * c.total_tokens, c.token_embed_dim, 1000))
    if c.predict_proprioception:
        heads.append(("prop", kp, B * 16, c.proprio_pred_dim, c.act_diff_training_steps))
    for name, k, n, ch, steps in heads:
        t_key, noise_key = jax.random.split(k)
        out[f"{name}_t"] = jax.random.randint(t_key, (n,), 0, steps)
        out[f"{name}_noise"] = jax.random.normal(noise_key, (n, ch))
    if c.use_history_action:
        out["history_keep"] = jax.random.uniform(jax.random.fold_in(k_enc, 1), (B, n_hist)) \
            <= c.action_mask_ratio
    if c.language_emb_model == "clip":
        out["label_drop"] = jax.random.uniform(jax.random.fold_in(k_enc, 2), (B,)) < c.label_drop_prob
    return out


def jax_loss_draws(key, port, n_sel=8, n_hist=None):
    out = _jax_loss_draws(key, port.mar_cfg, n_sel, n_hist, port.encodes_wrist_in_training)
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k.endswith("_t") else torch.bool if v.dtype == bool else torch.float32)
        for k, v in out.items()}


def _loss_and_grads(jp, params, batch, key, mode, frames):
    def f(mar, batch, key):
        return jp.compute_loss({"mar": mar, "vae": params["vae"]}, batch, key, mode,
                               frame_indices=frames)

    (loss, (vl, al)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        to_jax(params["mar"]), batch, key)
    return [float(loss), float(vl), float(al)], convert.flatten_tree(to_numpy(grads))


def _assert_loss_and_grads(port, got, want, want_grads):
    np.testing.assert_allclose([float(x) for x in got], want, rtol=LOSS_RTOL, atol=1e-7)
    got[0].backward()
    flat = convert.flatten_tree(convert.to_flax_tree(port.mar, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in port.mar.named_parameters()}))
    assert set(flat) == set(want_grads)
    for path, w in want_grads.items():
        np.testing.assert_allclose(flat[path], w, rtol=0, atol=GRAD_TOL * np.abs(w).max() + 1e-30,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mode", ["policy_model", "full_dynamic_model"])
def test_umi_compute_loss_equals_jax(mode):
    """A loader batch of UMI items (8 gathered frames, img_indices drawn at
    random, language latents): the label drop and the history-gathered
    state in both of the stage-2 modes."""
    jp, params, port = pair("umi", train=True)
    batch = umi_batch(7)
    frames = np.array([2, 9, 11, 15, 7, 8, 9, 10])  # a drawn history: only its length is read
    key = jax.random.PRNGKey(40)
    want, grads = _loss_and_grads(jp, params, to_jax(batch), key, mode, frames)
    got = port.compute_loss(to_torch(batch), mode, frames, noise=jax_loss_draws(key, port))
    _assert_loss_and_grads(port, got, want, grads)


def test_toolhang_compute_loss_equals_jax():
    """toolhang with the second camera, the wrist head and the
    proprioception head, at the history frames of a drawn frequency."""
    jp, params, port = pair("toolhang", train=True)
    batch = toolhang_batch(6)
    frames = np.array([0, 5, 9, 15, 19, 23, 27, 31])
    key = jax.random.PRNGKey(41)
    want, grads = _loss_and_grads(jp, params, to_jax(batch), key, "full_dynamic_model", frames)
    got = port.compute_loss(to_torch(batch), "full_dynamic_model", frames,
                            noise=jax_loss_draws(key, port))
    _assert_loss_and_grads(port, got, want, grads)


def test_history_actions_on_umis_window_are_refused_by_both():
    """UMI's 32-step window gives 15 history rows with shift_action false,
    which do not divide the tokens: JAX's assertion and the port's error."""
    jp, params, port = pair("umi", train=True, use_history_action=True)
    batch = umi_batch(2)
    with pytest.raises(AssertionError):
        jp.compute_loss(to_jax(params), to_jax(batch), jax.random.PRNGKey(0), "policy_model",
                        frame_indices=np.arange(8))
    with pytest.raises(ValueError, match="do not divide"):
        port.compute_loss(to_torch(batch), "policy_model", np.arange(8),
                          noise=port.sample_train_noise(B, torch.Generator().manual_seed(0), 8, 15))


def test_umi_three_train_steps_equal_jax():
    jp, params, port = pair("umi", train=True)
    opt = dict(learning_rate=1e-3, weight_decay=0.02, betas=(0.9, 0.95), warmup_steps=1,
               total_steps=10)
    ema = dict(power=0.75, inv_gamma=1.0, max_value=0.9999)
    tx = joptim.make_optimizer(**opt)
    jstate = jts.create_train_state(jp, to_jax(params), tx)
    jstep = jts.make_train_step(jp, tx, JaxEma(**ema), donate=False)
    pstate = create_train_state(port, EmaConfig(**ema), **opt)
    for step, mode in enumerate(("policy_model", "full_dynamic_model", "policy_model")):
        batch = umi_batch(20 + step)
        frames = np.arange(3, 11)
        key = jax.random.PRNGKey(70 + step)
        jstate, want = jstep(jstate, to_jax(batch), key, mode, frames)
        got = train_step(pstate, to_torch(batch), mode, frames, noise=jax_loss_draws(key, port))
        for k in ("train_loss", "diffusion_loss", "action_loss"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    atol = 2 * opt["learning_rate"] * 3 + 1e-6
    for got_tree, want_tree in ((convert.to_flax_tree(port.mar), jstate.mar_params),
                                (pstate.ema_tree(), jstate.ema_params)):
        got_flat = convert.flatten_tree(got_tree)
        for path, w in convert.flatten_tree(to_numpy(want_tree)).items():
            np.testing.assert_allclose(got_flat[path], w, rtol=0, atol=atol, err_msg=str(path))


# -- weights and configs -------------------------------------------------------

NEW_LEAVES = {"umi": ("history_action_proj_cond", "fake_latent_history_action",
                      "proprioception_proj_cond", "proprioception_image_proj_cond"),
              "toolhang": ("proprioception_proj_cond", "proprioception_image_proj_cond",
                           "z_proj_wrist", "fake_latent_wrist_x", "diffloss_wrist",
                           "diffproploss")}


@pytest.mark.parametrize("kind", ["umi", "toolhang"])
def test_weight_bridge_both_ways_on_the_new_leaves(kind):
    """JAX's tree -> the port -> the flax tree again, leaf for leaf, and the
    new subtrees present on both sides."""
    _, params, port = pair(kind, use_history_action=True)
    back = convert.flatten_tree(convert.to_flax_tree(port.mar))
    want = convert.flatten_tree(params["mar"])
    assert set(back) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))
    for name in NEW_LEAVES[kind]:
        assert any(p[0] == name for p in want), name


def _policy_cfg(cfg):
    return {k: v for k, v in cfg["model"]["policy"].items()
            if k not in ("_target_", "shape_meta", "vae_model_params")}


@pytest.mark.parametrize("name", ["umi_multi", "toolhang"])
def test_configs_match_load_config(name):
    amp = "model.policy.autoregressive_model_params."
    common = [f"{amp}pretrained_model_path=null", "model.policy.vae_model_params.autoencoder_path=null",
              "model.policy.action_model_params.predict_action=true"]
    if name == "umi_multi":
        ours = config.UMI_MULTI
        want = load_config("uva_umi_multi", common + [
            "model.policy.shift_action=false", "model.policy.different_history_freq=true",
            "model.policy.use_proprioception=true", "model.policy.use_history_action=true",
            "model.policy.language_emb_model=clip"])
        for section in ("training", "checkpoint", "ema", "logging", "dataloader",
                        "val_dataloader", "output_dir"):
            assert ours[section] == want[section], section
        for k in ("name", "task_type", "task_modes", "shape_meta"):
            assert ours["task"][k] == want["task"][k], k
        for k in ("normalizer_type", "random_img_sampling", "val_ratio"):
            assert ours["task"]["dataset"][k] == want["task"]["dataset"][k], k
        for ds, spec in want["task"]["datasets"].items():  # JAX's zarr stores, path too
            assert ours["task"]["datasets"][ds] == spec
            assert ours["task"]["dataset"]["datasets_cfg"][ds] == spec
    else:
        ours = config.TOOLHANG
        want = load_config("uva_toolhang", common + [
            "model.policy.use_proprioception=true", "model.policy.predict_proprioception=true"])
        assert ours["task"]["shape_meta"] == want["task"]["shape_meta"]
    want_policy = _policy_cfg(want)
    want_policy["autoregressive_model_params"] = dict(want_policy["autoregressive_model_params"])
    got_policy = _policy_cfg(ours)
    assert got_policy == want_policy
    assert ours["model"]["policy"]["vae_model_params"]["ddconfig"]["ch"] == 128
    port = UnifiedVideoActionPolicy.from_cfg(ours, device="meta")
    jp = JaxPolicy(**{k: v for k, v in want["model"]["policy"].items() if k != "_target_"},
                   task_name=want["task"]["name"])
    for field in ("use_proprioception", "use_history_action", "different_history_freq",
                  "predict_proprioception", "proprio_dim", "proprio_pred_dim",
                  "proprio_use_image", "language_emb_model", "img_size", "action_dim",
                  "label_drop_prob", "action_mask_ratio"):
        assert getattr(port.mar_cfg, field) == getattr(jp.mar_cfg, field), field


# -- validation and the run ----------------------------------------------------

def test_umi_validation_reading():
    """The port's reading on a UMI batch: JAX's predict program on the
    batch's 4 conditioning frames, its training state and its latents, under
    the same key, against the future half of the window. JAX's
    ``_val_action_l2`` raises on this batch."""
    jp, params, port = pair("umi")
    batch = umi_batch(11)
    state = types.SimpleNamespace(ema_params=to_jax(params["mar"]), vae_params=to_jax(params["vae"]))
    with pytest.raises(IndexError):
        TrainWorkspace._val_action_l2(types.SimpleNamespace(policy=jp), state, batch,
                                      jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(13)
    proprio, _ = jp._build_proprio_train(params, to_jax(batch["obs"]), np.arange(8), None)
    frames = jnp.asarray(batch["obs"]["camera0_rgb"][:, :4])
    pred = jp._build_predict_fn()(to_jax(params), frames, key,
                                  text_latents=jnp.asarray(batch["language_latents"]),
                                  proprio=proprio)
    future = batch["action"][:, 16:]
    want = float(np.sqrt(((np.asarray(pred)[..., :9] - future[..., :9]) ** 2).mean()))
    got = pws.val_action_l2(port, to_torch(batch), noise=policy_draws(key, port.noise_shapes(B)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_torch_umi_multi_runs_on_the_cpu(tmp_path):
    """``train_torch.py --config umi_multi`` at a tiny size on three small
    stores: two epochs through the host loader, the validation reading in
    the log, the top-k named by it, the FVD skipped as in JAX."""
    import json

    import train_torch
    from unified_video_action_tpu_torch.tools.gen_synthetic_umi import write_corpus

    paths = write_corpus(str(tmp_path / "umi"), episodes=3, episode_len=30, image_size=32)
    amp = "model.policy.autoregressive_model_params."
    overrides = [f"{amp}{k}={json.dumps(v) if isinstance(v, (list, dict)) else v}"
                 for k, v in AMP.items() if v is not None] + [
        f"{amp}pretrained_model_path=null", "model.policy.vae_model_params.ddconfig.ch=32",
        "model.policy.vae_model_params.ddconfig.vae_embed_dim=8",
        "model.policy.vae_model_params.ddconfig.ch_mult=[1,1,2,2]",
        "model.policy.compute_dtype=float32", "task.dataset.val_ratio=0.34",
        "dataloader.batch_size=2", "dataloader.num_workers=2", "training.num_epochs=2",
        "training.max_train_steps=2", "training.lr_warmup_steps=1", "training.checkpoint_every=1",
        "training.max_val_steps=1", f"output_dir={tmp_path / 'run'}"] + [
        f"task.dataset.datasets_cfg.{name}.path={p}" for name, p in paths.items()]
    state = train_torch.main(["--config", "umi_multi", "--device", "cpu", *overrides])
    assert state.step == 4 and not state.policy.use_history_action
    lines = [json.loads(line) for line in open(tmp_path / "run" / "logs.jsonl")]
    assert len(lines) == 2 and all(np.isfinite(line["val_action_l2_distances"]) for line in lines)
    ckpts = sorted(p.name for p in (tmp_path / "run" / "checkpoints").iterdir())
    assert any(name.startswith("epoch=0001-val_action_l2=") for name in ckpts), ckpts


def test_bf16_grad_checkpointing_matches_without():
    """The bf16 loss with ``grad_checkpointing`` (each block recomputed in
    the backward) equals the loss without it, and so do the gradients: the
    recompute runs on the bf16 casts of the forward, not on the fp32
    parameters the module holds outside ``functional_call`` (which raised
    a dtype error)."""
    batch = to_torch(umi_batch(4))
    frames = np.arange(3, 11)
    out = {}
    for remat in (False, True):
        amp = dict(AMP, grad_checkpointing=remat, attn_dropout=0.1, proj_dropout=0.1)
        _, params, port = pair("umi", train=True, compute_dtype="bfloat16",
                               autoregressive_model_params=amp)
        gen = torch.Generator().manual_seed(3)
        noise = port.sample_train_noise(B, gen)
        drop = port.mar.draw_dropout(B, gen, torch.device("cpu"))
        loss = port.compute_loss(batch, "full_dynamic_model", frames, noise=noise, drop=drop)[0]
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in port.mar.named_parameters()
                                    if p.grad is not None})
    assert out[True][0] == out[False][0]
    assert out[True][1].keys() == out[False][1].keys()
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, rtol=0, atol=0, msg=name)


def test_every_umi_run_config_key_is_acted_on_or_named():
    """Every key of ``config.UMI_MULTI``'s training sections is acted on by
    the trainer on the host-loader path, or named as ignored with a reason
    (no key falls to "the port does not read this key")."""
    report = pws.config_report(config.UMI_MULTI)
    assert "dataloader.num_workers" not in report  # the host loader's threads
    assert all(why != "the port does not read this key" for why in report.values()), report
    assert set(report) == {"training.use_ema", "training.mesh", "checkpoint.save_last_ckpt",
                           "dataloader.shuffle", "val_dataloader.batch_size",
                           "val_dataloader.num_workers", "val_dataloader.shuffle"}
