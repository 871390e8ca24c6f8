"""The port's PushT pipeline from the scripted expert to a training batch,
against the JAX package on the CPU.

- The action marker: ``envs/raster.draw_marker_cross`` against
  ``cv2.drawMarker`` (MARKER_CROSS) at thickness 1, 2 and 3 on random
  positions, the frame's edges and beyond; the env's frames with
  ``render_action=True`` at 96 and 256 px and the image env's ``render()``
  against the JAX env's (which draws with OpenCV), an action at the frame's
  edge among them: bit-equal.
- The expert: the port's ``PushTExpert`` and JAX's in lockstep on their envs
  with the same env seed and ``default_rng``, the actions and the states
  within 1e-9 (measured: equal) over 90 and 80 steps at seeds 20002 (the
  MPC endgame, to success) and 20011 (the wall recovery).
- The demo tool: ``tools/gen_pusht_demos.py`` against
  ``scripts/gen_pusht_demos.py`` on the same arguments, the same episodes
  bit for bit; ``--min-reward`` and ``--max-tries``; the publish every 25
  kept episodes.
- ``config.PUSHT_256_RUN`` against JAX's ``load_config("uva_pusht")``.
- ``PushTImageDataset.__getitem__`` against JAX's on the same buffer:
  without augmentation and with the host augmentation (JAX's cv2 path),
  bit-equal (the share of differing uint8 values is printed: 0). The host
  loader's batches (at most ``num_workers + prefetch`` batches ahead; an
  item's error raised), the device augmentation's draws in JAX's order, and
  ``train_torch.py --config pusht_256`` at a tiny width on the CPU with the
  host augmentation.
"""

import copy
import json
import os
import runpy
import sys
import threading
import time

import cv2
import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from tests._torch_parity import BENCH_PARITY_OVERRIDES
from unified_video_action_tpu.config import load_config
from unified_video_action_tpu.data import pusht_dataset as jpd
from unified_video_action_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from unified_video_action_tpu.envs.pusht import PushTEnv as JaxEnv
from unified_video_action_tpu.envs.pusht import PushTImageEnv as JaxImageEnv
from unified_video_action_tpu.envs.pusht_expert import PushTExpert as JaxExpert
from unified_video_action_tpu_torch import config
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.data import pusht_dataset as ppd
from unified_video_action_tpu_torch.data.loader import DataLoader, collate
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.envs import raster
from unified_video_action_tpu_torch.envs.pusht import PushTEnv, PushTImageEnv
from unified_video_action_tpu_torch.envs.pusht_expert import PushTExpert
from unified_video_action_tpu_torch.tools import gen_pusht_demos
from unified_video_action_tpu_torch.training import workspace as pws
from unified_video_action_tpu_torch.utils import image as pimage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERT_ATOL = 1e-9


# -- the action marker ---------------------------------------------------------


@pytest.mark.parametrize("size,thickness", [(96, 1), (256, 2), (160, 3)])
def test_marker_equals_opencv(size, thickness):
    rng = np.random.default_rng(size)
    marker = int(8 / 96 * size)
    edges = [0, 1, size - 2, size - 1, size, -1, -marker // 2, size + marker // 2]
    for i in range(120):
        pos = rng.integers(-marker, size + marker, 2)
        if i < 2 * len(edges):
            pos[i % 2] = edges[i // 2]
        want = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        got = want.copy()
        cv2.drawMarker(want, (int(pos[0]), int(pos[1])), color=(255, 0, 0),
                       markerType=cv2.MARKER_CROSS, markerSize=marker, thickness=thickness)
        raster.draw_marker_cross(got, pos, (255, 0, 0), marker, thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(pos))


@pytest.mark.parametrize("size", [96, 256])
def test_frames_with_the_action_marker_match_jax(size):
    # the marker's coordinate stays on the 96 px grid: 512 lands on the 96 px
    # frame's edge (and past a 256 px frame's marker half-width), 0 on the corner
    actions = [(100.0, 300.0), (512.0, 256.0), (0.0, 0.0), (511.9, 3.0), (256.0, 509.0)]
    jax_env, port_env = JaxEnv(render_size=size), PushTEnv(render_size=size)
    for env in (jax_env, port_env):
        env.seed(11)
        env.reset()
    np.testing.assert_array_equal(port_env.render(), jax_env.render())  # no action yet
    for a in actions:
        jax_env.step(np.array(a))
        port_env.step(np.array(a))
        want = jax_env.render()
        got = port_env.render()
        assert got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want, err_msg=str(a))
        assert (got == (255, 0, 0)).all(-1).any()  # the marker is there


def test_the_image_envs_render_matches_jax():
    jax_env, port_env = JaxImageEnv(), PushTImageEnv()
    for env in (jax_env, port_env):
        env.seed(4)
    jo, _ = jax_env.reset()
    po, _ = port_env.reset()
    np.testing.assert_array_equal(port_env.render(), jax_env.render())
    rng = np.random.default_rng(4)
    for a in rng.uniform(0, 512, (6, 2)):
        jo = jax_env.step(a)[0]
        po = port_env.step(a)[0]
        np.testing.assert_array_equal(po["image"], jo["image"])  # the obs has no marker
        np.testing.assert_array_equal(port_env.render(), jax_env.render())


# -- the expert ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,steps,mode", [(20002, 90, "mpc"), (20011, 80, "recover")])
def test_expert_matches_jax(seed, steps, mode):
    jax_env, port_env = JaxEnv(render_action=False), PushTEnv(render_action=False)
    for env in (jax_env, port_env):
        env.seed(seed)
        env.reset()
    jx = JaxExpert(noise=1.5, rng=np.random.default_rng(seed))
    px = PushTExpert(noise=1.5, rng=np.random.default_rng(seed))
    modes, n = set(), 0
    for _ in range(steps):
        want, got = jx.act(jax_env), px.act(port_env)
        np.testing.assert_allclose(got, want, rtol=0, atol=EXPERT_ATOL)
        modes.add(px._mode)
        jr = jax_env.step(want)
        pr = port_env.step(got)
        np.testing.assert_allclose(pr[0], jr[0], rtol=0, atol=EXPERT_ATOL)
        assert pr[1:3] == jr[1:3]
        n += 1
        if jr[2]:
            break
    assert n >= 40 and mode in modes, (n, modes)


# -- the demo tool ------------------------------------------------------------------


def test_demo_tool_matches_the_jax_script(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    args = ["--episodes", "2", "--max-steps", "24", "--min-reward", "0", "--seed0", "20003"]
    monkeypatch.setattr(sys, "argv", ["gen_pusht_demos.py", "--out", str(tmp_path / "jax.h5"), *args])
    runpy.run_path(os.path.join(REPO, "scripts", "gen_pusht_demos.py"), run_name="__main__")
    meta = gen_pusht_demos.generate(str(tmp_path / "port.npz"), episodes=2, seed0=20003,
                                    max_steps=24, min_reward=0.0, log=lambda m: None)
    want = JaxReplayBuffer.load(str(tmp_path / "jax.h5"))
    got = ReplayBuffer.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert sorted(got.keys()) == sorted(want.keys()) == ["action", "img", "state"]
    for k in got.keys():
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "jax_meta.json") as f:
        jax_meta = json.load(f)
    with open(tmp_path / "port_meta.json") as f:
        assert json.load(f) == meta
    assert {k: meta[k] for k in jax_meta} == jax_meta


def test_demo_tool_filters_and_bounds_its_tries(tmp_path, monkeypatch):
    # 30 steps reach no 0.9 reward: every episode is tried and none kept
    out = str(tmp_path / "demos.npz")
    meta = gen_pusht_demos.generate(out, episodes=2, max_steps=30, max_tries=3, log=lambda m: None)
    assert meta["tried"] == 3 and meta["episodes"] == 0 and len(meta["tried_rewards"]) == 3
    assert max(meta["tried_rewards"]) < 0.9 and meta["mean_max_reward"] is None
    assert ReplayBuffer.load(out).n_episodes == 0
    # the publish: every PUBLISH_EVERY kept episodes the buffer so far, renamed
    # into place (no temporary file left)
    published = []
    publish = gen_pusht_demos._publish
    monkeypatch.setattr(gen_pusht_demos, "PUBLISH_EVERY", 2)
    monkeypatch.setattr(gen_pusht_demos, "_publish",
                        lambda eps, path: published.append(len(eps)) or publish(eps, path))
    gen_pusht_demos.main(["--out", out, "--episodes", "3", "--max-steps", "8",
                          "--min-reward", "0", "--max-tries", "5"])
    assert published == [2, 3] and ReplayBuffer.load(out).n_episodes == 3
    assert sorted(os.listdir(tmp_path)) == ["demos.npz", "demos_meta.json"]


# -- the dataset and its host loader --------------------------------------------------


@pytest.fixture(scope="module")
def buffer_path(tmp_path_factory):
    """Three corpus episodes in JAX's HDF5 replay buffer, which the port
    reads through h5py where h5py is installed."""
    pytest.importorskip("h5py")
    with np.load(os.path.join(REPO, "corpora", "pusht_demos_r5b.npz")) as z:
        ends = z["episode_ends"][:3]
        data = {k: z[k][: ends[-1]] for k in ("img", "state", "action")}
    buf = JaxReplayBuffer.create_empty()
    start = 0
    for end in ends:
        buf.add_episode({k: v[start:end] for k, v in data.items()})
        start = end
    path = str(tmp_path_factory.mktemp("pusht") / "buffer.h5")
    buf.save(path)
    return path


DS_KW = dict(horizon=16, pad_before=1, pad_after=7, seed=42, val_ratio=0.34)


@pytest.mark.parametrize("data_aug", [False, True])
def test_getitem_matches_jax(buffer_path, data_aug):
    want_ds = jpd.PushTImageDataset(buffer_path, data_aug=data_aug, device_aug=False, **DS_KW)
    got_ds = ppd.PushTImageDataset(buffer_path, data_aug=data_aug, device_aug=False, **DS_KW)
    assert len(got_ds) == len(want_ds) > 0
    rng = np.random.default_rng(0)
    idxs = [0, len(got_ds) - 1, *rng.integers(0, len(got_ds), 10)]
    differ, total = 0, 0
    for idx in idxs:
        want, got = want_ds[int(idx)], got_ds[int(idx)]
        assert got["obs"]["image"].dtype == np.uint8 and got["obs"]["image"].shape == (16, 3, 96, 96)
        np.testing.assert_array_equal(got["obs"]["agent_pos"], want["obs"]["agent_pos"])
        np.testing.assert_array_equal(got["action"], want["action"])
        differ += int((got["obs"]["image"] != want["obs"]["image"]).sum())
        total += got["obs"]["image"].size
        if data_aug:  # the clip changed
            assert (got["obs"]["image"] != got_ds.sampler.sample_sequence(int(idx))["img"]
                    .transpose(0, 3, 1, 2)).any()
    print(f"data_aug={data_aug}: {differ} of {total} uint8 values differ from JAX's")
    assert differ == 0


def test_host_loader_batches_and_device_aug_draws(buffer_path):
    ds = ppd.PushTImageDataset(buffer_path, data_aug=True, device_aug=False, **DS_KW)
    loader = DataLoader(ds, 4, shuffle=True, seed=3, num_workers=2)
    order = np.arange(len(ds))
    np.random.default_rng((3, 0)).shuffle(order)
    for b, batch in enumerate(loader):
        want = collate([ds[int(i)] for i in order[4 * b: 4 * b + 4]])
        for k in ("image", "agent_pos"):
            np.testing.assert_array_equal(batch["obs"][k], want["obs"][k])
        np.testing.assert_array_equal(batch["action"], want["action"])
        if b == 1:
            break


class _CountedItems:
    """A dataset of ``n`` tiny items that counts the items built and raises
    at item ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.built, self.lock = n, fail_at, 0, threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.built += 1
        if i == self.fail_at:
            raise ValueError(f"item {i} raised")
        return {"x": np.full(2, i)}


def test_host_loader_runs_a_bounded_way_ahead_and_raises_an_items_error():
    ds = _CountedItems(400)
    it = iter(DataLoader(ds, 2, shuffle=False, num_workers=2, prefetch=2))
    np.testing.assert_array_equal(next(it)["x"], [[0, 0], [1, 1]])
    time.sleep(0.5)
    # the batch taken, 2 in the queue, 1 waiting to enter it, 4 in flight
    assert ds.built <= 2 * (1 + 2 + 1 + 4), ds.built
    it.close()
    with pytest.raises(ValueError, match="item 5 raised"):
        list(DataLoader(_CountedItems(40, fail_at=5), 2, shuffle=False, num_workers=2))


def _tiny_pusht_256(out, *overrides):
    amp = "model.policy.autoregressive_model_params."
    cfg = copy.deepcopy(config.PUSHT_256_RUN)
    apply_overrides(cfg, [
        f"{amp}model_size=custom", f"{amp}encoder_embed_dim=32", f"{amp}encoder_depth=1",
        f"{amp}encoder_num_heads=2", f"{amp}decoder_embed_dim=32", f"{amp}decoder_depth=1",
        f"{amp}decoder_num_heads=2", f"{amp}img_size=32", f"{amp}vae_stride=8", f"{amp}vae_embed_dim=8",
        f"{amp}diffloss_d=1", f"{amp}diffloss_w=16", f"{amp}diffloss_act_d=1", f"{amp}diffloss_act_w=16",
        f"{amp}num_sampling_steps=2", f"{amp}act_diff_testing_steps=4", f"{amp}attn_dropout=0.0",
        f"{amp}proj_dropout=0.0", "model.policy.vae_model_params.ddconfig.vae_embed_dim=8",
        "model.policy.vae_model_params.ddconfig.ch_mult=[1, 1, 2, 2]",
        "model.policy.vae_model_params.ddconfig.ch=32", "model.policy.compute_dtype=float32",
        "task.dataset.val_ratio=0.34", "dataloader.batch_size=2", "dataloader.num_workers=2",
        "training.num_epochs=1", "training.max_train_steps=2", "training.max_val_steps=1",
        "training.lr_warmup_steps=1", "training.rollout_every=0", "training.checkpoint_every=0",
        "training.sample_every=0", f"output_dir={out}", *overrides])
    return cfg


def test_pusht_256_run_is_uva_pusht_yaml():
    """``config.PUSHT_256_RUN`` against JAX's ``load_config("uva_pusht")``
    (with bench.py's serving overrides, as ``PUSHT_256``): every section of
    the run, the dataset and the runner but their targets and the dataset's
    path (the committed corpus), and no ``device_resident``: the host loader."""
    jax_cfg = load_config("uva_pusht", BENCH_PARITY_OVERRIDES).to_dict()
    got = config.PUSHT_256_RUN
    assert got["model"] == config.PUSHT_256["model"]
    assert sorted(got) == sorted(jax_cfg)
    for k in got:
        if k not in ("model", "task"):
            assert got[k] == jax_cfg[k], k
    assert sorted(got["task"]) == sorted(jax_cfg["task"])
    strip = lambda d: {k: v for k, v in d.items() if k not in ("_target_", "dataset_path")}
    for k, v in got["task"].items():
        assert (strip(v) == strip(jax_cfg["task"][k])) if isinstance(v, dict) and "_target_" in v \
            else v == jax_cfg["task"][k], k
    assert got["task"]["dataset"]["dataset_path"] == "corpora/pusht_demos_r5b.npz"
    assert pws.uses_host_loader(got)


def test_device_aug_draws_follow_jax_order(buffer_path, tmp_path):
    """Under ``data_aug`` with ``device_aug`` (the recipe's default), each
    host batch gets its crop corners and blur widths after the task mode
    and the frame indices, from the trainer's generator, as JAX's
    ``prepare`` draws them."""
    trainer = pws.Trainer(_tiny_pusht_256(tmp_path, f"task.dataset.dataset_path={buffer_path}"), "cpu")
    assert trainer.host_loader and trainer.dataset.data_aug and trainer.dataset.device_aug
    rng = np.random.default_rng(trainer.seed)
    for i, (mode, frames, batch) in enumerate(trainer.batches()):
        assert mode == trainer.policy.choose_task_mode(rng)
        obs = batch["obs"]
        assert tuple(obs["image"].shape) == (2, 8, 3, 96, 96)
        m_h, m_w = pimage.aug_margins(96, 96)
        np.testing.assert_array_equal(obs["aug_top"].numpy(), rng.integers(0, m_h, 2))
        np.testing.assert_array_equal(obs["aug_left"].numpy(), rng.integers(0, m_w, 2))
        np.testing.assert_array_equal(obs["aug_sigma"].numpy(),
                                      rng.uniform(0.1, 2.0, 2).astype(np.float32))
        if i == 1:
            break


def test_train_torch_pusht_256_on_the_host_loader(buffer_path, tmp_path):
    """``train_torch.py --config pusht_256`` (uva_pusht.yaml's recipe) at a
    tiny width on the CPU, the loader's workers augmenting each clip: two
    steps and a validation reading, finite."""
    import train_torch

    out = tmp_path / "run"
    cfg = _tiny_pusht_256(out, f"task.dataset.dataset_path={buffer_path}", "task.dataset.device_aug=false")
    base, want = _flat(config.PUSHT_256_RUN), _flat(cfg)
    train_torch.main(["--config", "pusht_256", "--device", "cpu",
                      *(f"{k}={v if isinstance(v, str) else json.dumps(v)}"
                        for k, v in sorted(want.items()) if base.get(k) != v)])
    with open(out / "logs.jsonl") as f:
        line = json.loads(f.readline())
    assert line["global_step"] == 2 and np.isfinite(line["train_loss"])
    assert np.isfinite(line["val_action_l2_distances"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
