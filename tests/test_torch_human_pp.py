"""The human-video keypoint task (``config.HUMAN_PP``, uva_human_pp.yaml) and
the three other action pools, against the JAX package on the CPU.

- The synthetic 14-d keypoint store (``make_synthetic_pusht(agent_pos_dim=
  14)``) bit-equal to JAX's, and the dataset's items and normalizer from it
  as ``.npz`` and as HDF5 bit-equal to JAX's dataset on the HDF5 (with the
  host augmentation too, ``device_aug=false``).
- ``predict_action`` and ``compute_loss`` of the human_pp policy at a small
  size (1+1 blocks of d = 32, 32 px frames upscaled to 64 on the way in as
  the task's 96 px frames are to 256, a 5-level VAE of 32 channels, fp32),
  built from ``config.HUMAN_PP`` and from JAX's ``load_config``, with the
  same numpy-drawn weights through the bridge and JAX's draws replayed:
  actions within 1e-4, the loss within 1e-5, each gradient leaf within 1e-4
  of its largest magnitude; the same for each of the pools ``conv_ori``,
  ``conv2`` and ``fc2``.
- The pools alone, forward and through ``convert.py`` both ways, within
  1e-5 of JAX with weights that are not symmetric in time; flax's transposed
  convolution does not flip its kernel and torch's does, and a bridge that
  did not reverse it is shown to miss.
- The trainer's keypoint overlay: ``train_torch.py --config human_pp`` and
  ``--config-name uva_human_pp`` write ``media/keypoints_epoch0.gif`` whose
  frames are bit-equal to JAX's ``_write_keypoint_overlay`` drawing the same
  arrays, log it to the tracker, and an overlay that fails leaves the
  validation reading standing.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests._torch_parity import policy_draws, random_params, to_numpy
from tests.test_torch_umi_policy import (
    B,
    _assert_loss_and_grads,
    _loss_and_grads,
    jax_loss_draws,
    to_jax,
    to_torch,
)
from unified_video_action_tpu.config import load_config as jax_load_config
from unified_video_action_tpu.data import pusht_dataset as jds
from unified_video_action_tpu.eval import offline as joffline
from unified_video_action_tpu.models import heads as jh
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import config, convert
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.data import pusht_dataset as pds
from unified_video_action_tpu_torch.eval import offline
from unified_video_action_tpu_torch.models import heads as ph
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

AMP = "model.policy.autoregressive_model_params."
TINY = [f"{AMP}{k}={v}" for k, v in {
    "model_size": "custom", "encoder_embed_dim": 32, "encoder_depth": 1, "encoder_num_heads": 2,
    "decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 2, "img_size": 64,
    "vae_stride": 16, "vae_embed_dim": 8, "diffloss_d": 1, "diffloss_w": 16, "diffloss_act_d": 1,
    "diffloss_act_w": 16, "num_sampling_steps": "2", "act_diff_testing_steps": "4",
    "attn_dropout": 0.0, "proj_dropout": 0.0}.items()] + [
    "model.policy.vae_model_params.ddconfig.ch=32",
    "model.policy.vae_model_params.ddconfig.vae_embed_dim=8",
    "model.policy.compute_dtype=float32"]
FRAME = 32  # the frames' size: the 64 px model upscales them
POOLS = ("conv_ori", "conv2", "fc2")
ACTION_ATOL = 1e-4


def _without_target(d):
    return {k: v for k, v in d.items() if k != "_target_"}


def tiny_pair(train=False, pool=None):
    ov = TINY + ([f"model.policy.action_model_params.act_model_type={pool}"] if pool else [])
    want = jax_load_config("uva_human_pp", list(config.HUMAN_PP_OVERRIDES) + ov).to_dict()
    jp = JaxPolicy(**_without_target(want["model"]["policy"]), task_name=want["task"]["name"])
    params = to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=4))
    cfg = copy.deepcopy(config.HUMAN_PP)
    apply_overrides(cfg, ov)
    port = UnifiedVideoActionPolicy.from_cfg(cfg, device="cpu", train=train)
    port.load_params(params["mar"], params["vae"])
    return jp, params, port


# -- the keypoint store and dataset ---------------------------------------------

STORE = dict(n_episodes=3, max_steps=40, seed=5, render_size=FRAME, agent_pos_dim=14)


def test_the_synthetic_keypoint_store_is_jaxs():
    want, got = jds.make_synthetic_pusht(**STORE), pds.make_synthetic_pusht(**STORE)
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    for k in ("img", "state", "action"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["action"].shape[1] == 14 and got["state"].shape[1] == 14 + 3


@pytest.mark.parametrize("device_aug", [True, False])
@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_the_keypoint_dataset_is_jaxs(suffix, device_aug, tmp_path):
    jax_path, path = str(tmp_path / "jax.h5"), str(tmp_path / f"port{suffix}")
    jds.make_synthetic_pusht(**STORE).save(jax_path)
    pds.make_synthetic_pusht(**STORE).save(path)
    kw = dict(horizon=32, pad_before=1, pad_after=7, seed=42, val_ratio=0.3, data_aug=True,
              device_aug=device_aug, agent_pos_dim=14)
    want, got = jds.PushTImageDataset(jax_path, **kw), pds.PushTImageDataset(path, **kw)
    assert len(got) == len(want) > 0
    for i in (0, len(want) // 2, len(want) - 1):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["obs"]["image"], b["obs"]["image"])
        np.testing.assert_array_equal(a["obs"]["agent_pos"], b["obs"]["agent_pos"])
        np.testing.assert_array_equal(a["action"], b["action"])
        assert a["obs"]["agent_pos"].shape == (32, 14)
    val, jval = got.get_validation_dataset(), want.get_validation_dataset()
    np.testing.assert_array_equal(val[0]["action"], jval[0]["action"])
    n, jn = got.get_normalizer(), want.get_normalizer()
    for k in ("action", "agent_pos"):
        x = np.asarray(want.replay_buffer["action"][:5] if k == "action"
                       else want.replay_buffer["state"][:5, :14])
        np.testing.assert_allclose(n[k].normalize(torch.from_numpy(x)).numpy(),
                                   np.asarray(jn[k].normalize(x)), rtol=1e-6, atol=1e-6)


# -- the policy ------------------------------------------------------------------

@pytest.mark.parametrize("pool", [None, *POOLS])
def test_predict_action_equals_jax(pool):
    jp, params, port = tiny_pair(pool=pool)
    assert port.action_dim == 14 and port.mar_cfg.act_model_type == (pool or "conv_fc")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (B, 16, 3, FRAME, FRAME), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want = jp.predict_action(to_jax(params), {"image": frames}, key)
    got = port.predict_action({"image": frames}, noise=policy_draws(key, port.noise_shapes(B)))
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-4, atol=ACTION_ATOL)
    assert got["action"].shape == (B, 8, 14)


@pytest.mark.parametrize("pool,mode", [(None, "policy_model"), (None, "full_dynamic_model"),
                                       *((p, "full_dynamic_model") for p in POOLS)])
def test_compute_loss_equals_jax(pool, mode):
    jp, params, port = tiny_pair(train=True, pool=pool)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (B, 32, 3, FRAME, FRAME), dtype=np.uint8)
    action = rng.uniform(0, 512, (B, 32, 14)).astype(np.float32)
    sel = np.array([0, 4, 9, 13, 16, 20, 25, 29])
    key = jax.random.PRNGKey(44)
    want, grads = _loss_and_grads(jp, params, to_jax({"obs": {"image": frames}, "action": action}),
                                  key, mode, sel)
    got = port.compute_loss(to_torch({"obs": {"image": frames}, "action": action}), mode, sel,
                            noise=jax_loss_draws(key, port))
    _assert_loss_and_grads(port, got, want, grads)


# -- the pools alone ---------------------------------------------------------------

T, W, D = 4, 3, 8


def _pools(name):
    n = T * W * W
    return {"conv_ori": (jh.ConvOriPool(D), ph.ConvOriPool(D)),
            "conv2": (jh.Conv2Pool(D), ph.Conv2Pool(n)),
            "fc2": (jh.Fc2Pool(D), ph.Fc2Pool(n))}[name]


@pytest.mark.parametrize("name", POOLS)
def test_the_pools_and_their_bridge_equal_jax(name):
    jpool, pool = _pools(name)
    tree = convert.seeded_tree(pool, 3)  # random in time: no kernel reads the same reversed
    z = np.random.default_rng(1).standard_normal((2, T * W * W, D)).astype(np.float32)
    want = np.asarray(jpool.apply({"params": tree}, z))
    convert.load_into(pool, tree)
    with torch.no_grad():
        got = pool(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 16, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = convert.flatten_tree(convert.to_flax_tree(pool))
    for path, value in convert.flatten_tree(tree).items():
        np.testing.assert_array_equal(back[path], value)
    if name == "conv_ori":  # torch's kernel reversed in time is the bridge's doing
        kernel = tree["conv_transpose3d"]["kernel"]
        assert not np.allclose(kernel, kernel[::-1])
        naive = np.ascontiguousarray(np.transpose(kernel, (3, 4, 0, 1, 2)))
        with torch.no_grad():
            pool.conv_transpose3d.weight.copy_(torch.from_numpy(naive))
            missed = pool(torch.from_numpy(z)).numpy()
        assert np.abs(missed - want).max() > 100 * np.abs(got - want).max() + 1e-3


def test_an_unknown_pool_is_refused():
    with pytest.raises(NotImplementedError, match="conv_fc"):
        ph.ActionDiffusionHead(2, D, 16, 1, act_model_type="conv3")


# -- the trainer's keypoint overlay ---------------------------------------------------

RUN = ["task.dataset.val_ratio=0.3", "dataloader.batch_size=2", "dataloader.num_workers=1",
       "training.num_epochs=1", "training.max_train_steps=2", "training.max_val_steps=1",
       "training.lr_warmup_steps=1", "training.checkpoint_every=1", "training.sample_every=0"]


def gif_frames(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return frames


@pytest.mark.parametrize("how", ["config", "config_name"])
def test_the_trainer_writes_jaxs_keypoint_overlay(how, tmp_path, monkeypatch):
    import imageio.v2 as imageio

    import train_torch

    store = str(tmp_path / "human_replay.npz")
    pds.make_synthetic_pusht(4, max_steps=40, seed=1, render_size=FRAME, agent_pos_dim=14).save(store)
    drawn = []
    original = offline._write_keypoint_overlay

    def recorded(frames, gt, pred, path, **kw):
        drawn.append((np.array(frames), np.array(gt), np.array(pred), path))
        return original(frames, gt, pred, path, **kw)

    monkeypatch.setattr(offline, "_write_keypoint_overlay", recorded)
    src = (["--config", "human_pp"] if how == "config"
           else ["--config-name", "uva_human_pp", "--device", "cpu", *config.HUMAN_PP_OVERRIDES])
    out = tmp_path / "run"
    state = train_torch.main([*src, *(["--device", "cpu"] if how == "config" else []), *TINY, *RUN,
                              f"task.dataset.dataset_path={store}", f"output_dir={out}"])
    assert state.step == 2
    gif = out / "media" / "keypoints_epoch0.gif"
    assert gif.exists() and len(drawn) == 1 and drawn[0][3] == str(gif)
    frames, gt, pred, _ = drawn[0]
    assert frames.shape == (32, 3, FRAME, FRAME) and gt.shape == pred.shape == (16, 14)
    captured = []
    monkeypatch.setattr(imageio, "mimwrite", lambda p, ims, **kw: captured.append(list(ims)))
    joffline._write_keypoint_overlay(frames, gt, pred, str(tmp_path / "jax.gif"))
    got = gif_frames(gif)
    assert len(got) == len(captured[0]) == 16
    for a, b in zip(got, captured[0]):
        np.testing.assert_array_equal(a, b)
    log = json.loads(open(out / "logs.jsonl").readline())
    assert np.isfinite(log["val_action_l2_distances"])
    rows = [json.loads(line) for line in open(out / "tracker" / "metrics.jsonl")]
    video = [r["eval/keypoints"] for r in rows if "eval/keypoints" in r]
    assert video == [{"_type": "video-file", "path": os.path.join("media", "2_eval_keypoints.gif")}]
    assert gif_frames(out / "tracker" / video[0]["path"]) is not None


def test_train_torch_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    import train_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for src in (["--config-name", "uva_human_pp"], ["--config", "human_pp"]):
        with pytest.raises(RuntimeError, match="cuda"):
            train_torch.main(src)


def test_a_failed_overlay_leaves_the_reading(tmp_path, monkeypatch, capsys):
    from unified_video_action_tpu_torch.training.workspace import Trainer

    store = str(tmp_path / "human_replay.npz")
    pds.make_synthetic_pusht(4, max_steps=40, seed=2, render_size=FRAME, agent_pos_dim=14).save(store)
    cfg = copy.deepcopy(config.HUMAN_PP)
    apply_overrides(cfg, [*TINY, *RUN, f"task.dataset.dataset_path={store}",
                          f"output_dir={tmp_path / 'run'}"])
    trainer = Trainer(cfg, "cpu")
    kept = trainer.validate()

    def broken(*a, **k):
        raise RuntimeError("no drawing here")

    monkeypatch.setattr(offline, "_write_keypoint_overlay", broken)
    trainer.generator.manual_seed(0)
    again = trainer.validate()
    assert np.isfinite(again) and np.isfinite(kept)
    assert "[keypoints] overlay failed: no drawing here" in capsys.readouterr().out
    assert trainer.keypoint_video_path().endswith(os.path.join("media", "keypoints_epoch0.gif"))
