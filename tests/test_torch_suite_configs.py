"""The kitchen and Fetch run configs of the port (``config.KITCHEN``,
``config.FETCH``) and their paths without mujoco, against the JAX package,
on the CPU.

- Both dicts against ``load_config("uva_kitchen")`` and
  ``load_config("uva_fetch")`` with the serving stage's action head on (and
  for the kitchen no checkpoint paths: ``kl16.ckpt`` and the MAR's release
  are not in the repository): every section, the dataset's and the runner's
  keys but their ``_target_``, and every leaf of ``model.policy``.
- At a reduced depth and width (1+1 blocks of d = 32, 32 px, a 4-level VAE
  of 32 channels, fp32), built from each config dict and from JAX's
  ``load_config``, with the same numpy-drawn weights through the bridge:
  one obs-dict request under JAX's draws within the existing suite tests'
  1e-4, and one ``compute_loss`` with JAX's keys replayed (loss 1e-5
  relative, each gradient leaf 1e-4 of its largest magnitude). JAX has no
  camera-key remap for Fetch (``utils/image.py:20-30``), so its policy
  reads ``obs["image"]``; the port's maps the env's ``agentview_image`` to
  it and is held on both keys.
- The stub backends with the configs' actions: the kitchen's 9-d and
  Fetch's 4-d reach the stubs as the policy made them, as JAX's runners
  deliver them (JAX's stubs take 7-d only, so its stubs are widened here);
  ``load_env_runner``'s dispatch of both configs.
- ``train_torch.py --config kitchen`` (host loader, ColorJitter) and
  ``--config fetch`` (the device-resident store, here host memory) at that
  width on ``tools/gen_synthetic_suites.py``'s stores, validation and a stub
  rollout, then ``eval_sim_torch.py`` on the export.
"""

import copy
import os
import json

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import leaves, policy_draws, random_params, to_numpy
from tests.test_torch_kitchen_env import ScriptedPolicy
from tests.test_torch_umi_policy import (
    B,
    _assert_loss_and_grads,
    _loss_and_grads,
    jax_loss_draws,
    to_jax,
    to_torch,
)
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.envs import stub as jstub
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.runners import libero_runner as jlr
from unified_video_action_tpu.runners import robomimic_runner as jrr
from unified_video_action_tpu_torch import config
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.data.robomimic_dataset import write_npz_store
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.runners import base as pbase
from unified_video_action_tpu_torch.runners.libero_runner import LiberoImageRunner
from unified_video_action_tpu_torch.runners.robomimic_runner import RobomimicImageRunner
from unified_video_action_tpu_torch.tools import gen_synthetic_suites as gen

AMP = "model.policy.autoregressive_model_params."
SERVING = ["model.policy.action_model_params.predict_action=true"]
JAX_OVERRIDES = {"kitchen": [f"{AMP}pretrained_model_path=null",
                             "model.policy.vae_model_params.autoencoder_path=null", *SERVING],
                 "fetch": SERVING}
CONFIGS = {"kitchen": ("uva_kitchen", config.KITCHEN), "fetch": ("uva_fetch", config.FETCH)}
IMAGE_KEY = {"kitchen": "agentview_rgb", "fetch": "agentview_image"}
ACTION_ATOL = 1e-4


def _without_target(d):
    return {k: v for k, v in d.items() if k != "_target_"}


@pytest.mark.parametrize("kind", ["kitchen", "fetch"])
def test_config_is_load_config(kind):
    name, ours = CONFIGS[kind]
    want = load_config(name, JAX_OVERRIDES[kind]).to_dict()
    assert sorted(ours) == sorted(want)
    for section in set(ours) - {"task", "model"}:
        assert ours[section] == want[section], section
    for k in ("name", "task_type", "task_modes", "shape_meta"):
        assert ours["task"][k] == want["task"][k], k
    for k in ("dataset", "env_runner"):
        assert _without_target(ours["task"][k]) == _without_target(want["task"][k]), k
        assert ours["task"][k]["_target_"].startswith("unified_video_action_tpu_torch.")
    have_policy, want_policy = (dict(leaves(c["model"]["policy"])) for c in (ours, want))
    if kind == "kitchen":  # the port's ddconfig names JAX's default ch, 128
        assert have_policy.pop(("vae_model_params", "ddconfig", "ch")) == 128
        assert ("vae_model_params", "ddconfig", "ch") not in want_policy
    have_policy.pop(("_target_",))
    want_policy.pop(("_target_",))
    assert have_policy == want_policy
    meta = UnifiedVideoActionPolicy.from_cfg(ours, device="meta")
    c = meta.mar_cfg
    assert (c.attention_tokens, c.encoder_embed_dim // c.encoder_num_heads, meta.action_dim) == \
        ((1024, 64, 9) if kind == "kitchen" else (144, 128, 4))
    assert not c.has_text and meta.text_encoder is None


TINY = [f"{AMP}{k}={v}" for k, v in {
    "model_size": "custom", "encoder_embed_dim": 32, "encoder_depth": 1, "encoder_num_heads": 2,
    "decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 2, "img_size": 32,
    "vae_stride": 8, "vae_embed_dim": 8, "diffloss_d": 1, "diffloss_w": 16, "diffloss_act_d": 1,
    "diffloss_act_w": 16, "num_sampling_steps": "2", "act_diff_testing_steps": "4",
    "attn_dropout": 0.0, "proj_dropout": 0.0}.items()] + [
    "model.policy.vae_model_params.autoencoder_path=null",
    'model.policy.vae_model_params.ddconfig.ch_mult=[1, 1, 2, 2]',
    "model.policy.vae_model_params.ddconfig.ch=32",
    "model.policy.vae_model_params.ddconfig.vae_embed_dim=8",
    "model.policy.compute_dtype=float32"]


def tiny_pair(kind, train=False):
    name, ours = CONFIGS[kind]
    want = load_config(name, JAX_OVERRIDES[kind] + TINY).to_dict()
    jp = JaxPolicy(**_without_target(want["model"]["policy"]), task_name=want["task"]["name"])
    params = to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=4))
    cfg = copy.deepcopy(ours)
    apply_overrides(cfg, TINY)
    port = UnifiedVideoActionPolicy.from_cfg(cfg, device="cpu", train=train)
    port.load_params(params["mar"], params["vae"])
    return jp, params, port


@pytest.mark.parametrize("kind", ["kitchen", "fetch"])
def test_request_equals_jax(kind):
    jp, params, port = tiny_pair(kind)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (B, 16, 3, 32, 32), dtype=np.uint8)
    obs = {IMAGE_KEY[kind]: frames}
    if kind == "fetch":  # JAX reads obs["image"]: it has no Fetch camera key
        obs.update(robot0_eef_pos=rng.standard_normal((B, 16, 3)).astype(np.float32))
        with pytest.raises(KeyError, match="image"):
            jp.predict_action(to_jax(params), obs, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(5)
    want = jp.predict_action(to_jax(params), {"image": frames}, key)
    for request in ({"image": frames}, obs):
        got = port.predict_action(request, noise=policy_draws(key, port.noise_shapes(B)))
        np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-4,
                                   atol=ACTION_ATOL)
    assert got["action"].shape == (B, 8, 9 if kind == "kitchen" else 4)


@pytest.mark.parametrize("kind", ["kitchen", "fetch"])
def test_compute_loss_equals_jax(kind):
    jp, params, port = tiny_pair(kind, train=True)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (B, 32, 3, 32, 32), dtype=np.uint8)
    action = rng.uniform(-1, 1, (B, 32, 9 if kind == "kitchen" else 4)).astype(np.float32)
    sel = np.array([0, 4, 9, 13, 16, 20, 25, 29])
    key = jax.random.PRNGKey(44)
    want, grads = _loss_and_grads(jp, params, to_jax({"obs": {"image": frames}, "action": action}),
                                  key, "full_dynamic_model", sel)
    batch = {"obs": {IMAGE_KEY[kind]: frames}, "action": action}
    got = port.compute_loss(to_torch(batch), "full_dynamic_model", sel,
                            noise=jax_loss_draws(key, port))
    _assert_loss_and_grads(port, got, want, grads)


def _widened_stub(monkeypatch, name, dim):
    """JAX's stub ``name`` taking ``dim``-d actions (JAX's take 7-d only);
    returns the list of those made."""
    made, cls = [], getattr(jstub, name)

    def init(self, *a, **k):
        cls.__init__(self, *a, **dict(k, action_dim=dim))
        made.append(self)

    monkeypatch.setattr(jstub, name, type(name, (cls,), {"__init__": init}))
    return made


def test_the_kitchen_stub_receives_jax_actions(monkeypatch):
    made = _widened_stub(monkeypatch, "StubLiberoEnv", 9)
    kw = dict(n_test=2, test_start_seed=0, max_steps=16, n_obs_steps=16, n_action_steps=8,
              abs_action=False, env_backend="stub")
    with pytest.raises(ValueError, match="7-dim"):  # JAX's own stub refuses them
        jstub.StubLiberoEnv.__mro__[1]().step(np.zeros(9, np.float32))
    jr = jlr.LiberoImageRunner("kitchen_microwave_demo.hdf5", **kw)
    jp, pp = ScriptedPolicy("agentview_rgb", 9), ScriptedPolicy("agentview_rgb", 9)
    want = jr.run(jp, None)
    pr = LiberoImageRunner("kitchen_microwave_demo.npz",
                           shape_meta=config.KITCHEN["task"]["shape_meta"], **kw)
    got = pr.run(pp)
    assert got == want and pr.stub_action_dim == 9 and pr.language_goal == jr.language_goal
    for a, b in zip(pp.seen, jp.seen):
        np.testing.assert_array_equal(a, b)
    for env, jenv in zip(pr.raw_envs, made):
        np.testing.assert_array_equal(np.stack(env.action_log), np.stack(jenv.action_log))
        assert env.action_log[0].shape == (9,)


LIBERO10_MICROWAVE = "KITCHEN_SCENE6_put_the_yellow_and_white_mug_in_the_microwave_and_close_it_demo"


@pytest.mark.parametrize("store", [LIBERO10_MICROWAVE, "kitchen_microwave_demo"])
def test_the_stub_without_a_shape_meta_takes_jax_7d_actions(store, monkeypatch):
    """A runner with raw actions and no shape_meta sizes its stub as JAX's
    (7-d), whatever the store's name says: LIBERO-10's microwave task and a
    kitchen task's store alike; the config's shape_meta alone widens it."""
    made = _widened_stub(monkeypatch, "StubLiberoEnv", 7)  # JAX's own width: records them
    kw = dict(n_test=2, test_start_seed=0, max_steps=16, n_obs_steps=16, n_action_steps=8,
              abs_action=False, env_backend="stub")
    jr = jlr.LiberoImageRunner(store + ".hdf5", **kw)
    jp, pp = ScriptedPolicy("agentview_rgb", 7), ScriptedPolicy("agentview_rgb", 7)
    want = jr.run(jp, None)
    pr = LiberoImageRunner(store + ".npz", **kw)
    got = pr.run(pp)
    assert got == want and pr.stub_action_dim == 7 and pr.language_goal == jr.language_goal
    assert len(made) == len(pr.raw_envs) == 2
    for env, jenv in zip(pr.raw_envs, made):
        np.testing.assert_array_equal(np.stack(env.action_log), np.stack(jenv.action_log))
        assert env.action_log[0].shape == (7,)
    libero = copy.deepcopy(config.LIBERO10["task"]["shape_meta"])
    assert LiberoImageRunner(store + ".npz", shape_meta=libero, **kw).stub_action_dim == 10
    assert LiberoImageRunner(store + ".npz", shape_meta=libero,
                             **dict(kw, abs_action=True)).stub_action_dim == 7


def test_the_fetch_stub_receives_jax_actions(monkeypatch):
    made = _widened_stub(monkeypatch, "StubRobosuiteEnv", 4)
    meta = copy.deepcopy(config.FETCH["task"]["shape_meta"])
    meta["obs"]["agentview_image"]["shape"] = [3, 32, 32]
    kw = dict(shape_meta=meta, n_train=1, n_test=2, max_steps=16, n_obs_steps=16,
              n_action_steps=8, abs_action=False, env_backend="stub")
    jp, pp = ScriptedPolicy("agentview_image", 4), ScriptedPolicy("agentview_image", 4)
    want = jrr.RobomimicImageRunner(**kw).run(jp, None)
    pr = RobomimicImageRunner(**kw)
    got = pr.run(pp)
    assert got == want and pr.env_action_dim == 4
    for a, b in zip(pp.seen, jp.seen):
        np.testing.assert_array_equal(a, b)
    for env, jenv in zip(pr.raw_envs, made):
        np.testing.assert_array_equal(np.stack(env.action_log), np.stack(jenv.action_log))
    # the configs' dispatch: one runner a kitchen task, Fetch's robomimic runner
    kitchen = copy.deepcopy(config.KITCHEN)
    kitchen["task"]["env_runner"].update(env_backend="stub", dataset_dir=None)
    fetch = copy.deepcopy(config.FETCH)
    fetch["task"]["env_runner"].update(env_backend="stub", dataset_path=None, n_train=0)
    runners = pbase.load_env_runner(kitchen)  # no stores: the stub takes LIBERO-10's names, as JAX
    assert [r.log_prefix for r in runners] == \
        [r.log_prefix for r in jlr.make_libero_runners(env_backend="stub")]
    assert [r.stub_action_dim for r in runners] == [9] * len(runners)  # the config's width
    libero = copy.deepcopy(config.LIBERO10)
    libero["task"]["env_runner"].update(env_backend="stub", dataset_dir=None)
    assert [r.stub_action_dim for r in pbase.load_env_runner(libero)] == [7] * len(runners)
    assert isinstance(pbase.load_env_runner(fetch), RobomimicImageRunner)


TINY_RUN = TINY + ["task.dataset.val_ratio=0.3", "dataloader.batch_size=2",
                   "dataloader.num_workers=1", "training.num_epochs=1",
                   "training.max_train_steps=2", "training.max_val_steps=1",
                   "training.lr_warmup_steps=1", "training.rollout_every=1",
                   "training.checkpoint_every=1", "training.sample_every=0",
                   "task.env_runner.env_backend=stub", "task.env_runner.n_test=1",
                   "task.env_runner.max_steps=16"]


@pytest.mark.parametrize("kind", ["kitchen", "fetch"])
def test_train_torch_config_then_eval_on_the_stub(kind, tmp_path, capsys):
    import eval_sim_torch
    import train_torch

    key = IMAGE_KEY[kind]
    if kind == "kitchen":
        d = tmp_path / gen.KITCHEN_DIR
        d.mkdir()
        for i, task in enumerate(("microwave", "kettle")):
            write_npz_store(str(d / f"kitchen_{task}_demo.npz"), gen.kitchen_demos(2, 40, 32, i))
        data = [f"task.dataset.dataset_dir={d}", f"task.env_runner.dataset_dir={d}"]
    else:
        path = str(tmp_path / "fetch.npz")
        write_npz_store(path, gen.fetch_demos(3, 40, 32, 0))
        data = [f"task.dataset.dataset_path={path}", f"task.env_runner.dataset_path={path}",
                "task.env_runner.n_train=1",
                f"task.env_runner.shape_meta.obs.{key}.shape=[3, 32, 32]"]
    meta = [f"{sec}.shape_meta.obs.{key}.shape=[3, 32, 32]"
            for sec in ("task", "task.dataset", "model.policy")]
    state = train_torch.main(["--config", kind, "--device", "cpu", *TINY_RUN, *data, *meta,
                              f"output_dir={tmp_path / 'out'}"])
    printed = capsys.readouterr().out
    assert f"[config] {kind}" in printed and state.step == 2
    line = json.loads(open(tmp_path / "out" / "logs.jsonl").readline())
    assert np.isfinite(line["train_loss"]) and np.isfinite(line["val_action_l2_distances"])
    assert line["nonfinite_steps"] == 0 and "test_mean_score" in line
    out = eval_sim_torch.main(["-c", str(tmp_path / "out" / "export"), "-o", str(tmp_path / "eval"),
                               "--device", "cpu", "task.env_runner.env_backend=stub",
                               "task.env_runner.n_test=1", "task.env_runner.max_steps=16"])
    log = json.load(open(out))
    assert out.endswith(".STUB.json") and log["env_backend"] == "stub"
    runs = [k for k in log if k.endswith("test/mean_score")]
    assert len(runs) == (2 if kind == "kitchen" else 1)
    if kind == "fetch":
        assert "train/mean_score" in log


def test_the_device_store_of_a_robomimic_dataset_gathers_its_items(tmp_path):
    """``config.FETCH``'s device-resident store: a gathered batch is the
    dataset's items (the frames as uint8, the items' float / 255), the
    validation split over the same store."""
    from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
    from unified_video_action_tpu_torch.data.robomimic_dataset import RobomimicReplayImageDataset

    path = str(tmp_path / "fetch.npz")
    write_npz_store(path, gen.fetch_demos(4, 40, 32, 1))
    meta = copy.deepcopy(config.FETCH["task"]["shape_meta"])
    meta["obs"]["agentview_image"]["shape"] = [3, 32, 32]
    ds = RobomimicReplayImageDataset(dataset_path=path, shape_meta=meta, horizon=32, pad_before=1,
                                     pad_after=7, abs_action=False, val_ratio=0.25)
    store = DeviceReplayDataset(ds, "cpu")
    val = store.split(ds.get_validation_dataset())
    assert val.img is store.img and len(val) == len(ds.get_validation_dataset()) > 0
    idxs, sel = np.array([0, 7, len(ds) - 1]), np.array([0, 5, 9, 31])
    batch = store.gather(idxs, sel)
    items = [ds[i] for i in idxs]
    assert set(batch["obs"]) == set(meta["obs"]) and batch["obs"]["agentview_image"].dtype == torch.uint8
    np.testing.assert_array_equal(batch["obs"]["agentview_image"].numpy() / np.float32(255.0),
                                  np.stack([it["obs"]["agentview_image"][sel] for it in items]))
    for k in ("robot0_eef_pos", "robot0_gripper_qpos"):
        np.testing.assert_array_equal(batch["obs"][k].numpy(), np.stack([it["obs"][k] for it in items]))
    np.testing.assert_array_equal(batch["action"].numpy(), np.stack([it["action"] for it in items]))


@pytest.mark.parametrize("kind", ["two_cameras", "libero", "kitchen"])
def test_the_device_store_refuses_what_it_cannot_hold(kind, tmp_path):
    """The device store holds one camera and the low-dim tracks: a
    two-camera robomimic store (tool-hang's layout), a LIBERO store and a
    kitchen store (ColorJitter, language) are refused, naming the host
    loader, where they would train on other batches than the host loader
    gives."""
    from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
    from unified_video_action_tpu_torch.data.libero_dataset import LiberoReplayImageDataset
    from unified_video_action_tpu_torch.data.robomimic_dataset import RobomimicReplayImageDataset

    if kind == "two_cameras":
        path = str(tmp_path / "toolhang.npz")
        cams = ("agentview_image", "robot0_eye_in_hand_image")
        write_npz_store(path, gen.make_demos(2, 40, 32, cams, 0))
        meta = {"action": {"shape": [10]}, "obs": {
            **{k: {"shape": [3, 32, 32], "type": "rgb"} for k in cams},
            "robot0_eef_pos": {"shape": [3], "type": "low_dim"}}}
        ds = RobomimicReplayImageDataset(dataset_path=path, shape_meta=meta, horizon=32,
                                         abs_action=True)
        want = "cameras"
    else:
        write = gen.write_libero10 if kind == "libero" else gen.write_kitchen
        d = os.path.dirname(write(str(tmp_path), n_demos=1, steps=40, image_size=32)[0])
        meta = copy.deepcopy((config.LIBERO10 if kind == "libero" else config.KITCHEN)
                             ["task"]["shape_meta"])
        meta["obs"][IMAGE_KEY["kitchen"]]["shape"] = [3, 32, 32]
        ds = LiberoReplayImageDataset(dataset_dir=d, shape_meta=meta, horizon=32,
                                      abs_action=kind == "libero", data_aug=True)
        want = "host transforms"
    with pytest.raises(ValueError, match=f"{want}.*host loader"):
        DeviceReplayDataset(ds, "cpu")
    if kind != "two_cameras":  # without the jitter the language field is still refused
        ds.transforms = None
        with pytest.raises(ValueError, match="item keys.*language.*host loader"):
            DeviceReplayDataset(ds, "cpu")

