"""The port's Fetch suite (``envs/fetch_env.py``, ``envs/fetch_expert.py``,
``tools/gen_fetch_demos.py`` and the robomimic runner's ``fetch`` backend)
against the JAX package's, on the CPU, in mujoco's physics.

- ``FetchImageEnv`` against JAX's, ``np.random`` seeded alike before each
  reset (the EnvRobosuite contract: ``reset`` draws its episode seed from
  it): obs (the goal marker in the frame), reward, done and ``get_state``
  bit-equal over 20 seeded random actions; ``reset_to`` of a recorded state
  and ``get_state`` round trips in both.
- ``FetchPickPlaceExpert``'s first 40 actions bit-equal to JAX's on twin
  envs, its noise from the caller's seed.
- ``tools/gen_fetch_demos.py`` against ``scripts/gen_fetch_demos.py``: two
  episodes of at most 40 steps at 32 px, the same HDF5 arrays and attrs;
  JAX's and the port's ``RobomimicReplayImageDataset`` read it to equal
  arrays.
- ``RobomimicImageRunner`` on ``env_backend="fetch"``: the port's and
  JAX's, driven by one scripted stand-in policy for 16 env steps, 1 train
  env (reset to the store's first state) and 1 test env, give equal logs,
  frames and env actions; the JAX test's random-policy rollout is slow, as
  there (``tests/test_fetch_env.py:85``).
"""

import importlib.util
import os

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from tests.test_torch_kitchen_env import ScriptedPolicy
from unified_video_action_tpu_torch.envs import kitchen_env

pytestmark = pytest.mark.skipif(not kitchen_env.available(),
                                reason="mujoco/gymnasium-robotics absent")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
EXPERT_ACTIONS = 40
SHAPE_META = {"image_resolution": 32, "action": {"shape": [4]},
              "obs": {"agentview_image": {"shape": [3, 32, 32], "type": "rgb"},
                      "robot0_eef_pos": {"shape": [3], "type": "low_dim"},
                      "robot0_gripper_qpos": {"shape": [2], "type": "low_dim"}}}


def _pair(**kw):
    from unified_video_action_tpu.envs.fetch_env import FetchImageEnv as JaxEnv
    from unified_video_action_tpu_torch.envs.fetch_env import FetchImageEnv

    return FetchImageEnv(**kw), JaxEnv(**kw)


def _reset_both(port, jax_, seed):
    np.random.seed(seed)
    a = port.reset()
    np.random.seed(seed)
    return a, jax_.reset()


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_env_equals_jax():
    port, jax_ = _pair(camera_heights=48, camera_widths=48)
    obs0, obs0_j = _reset_both(port, jax_, 5)
    _same(obs0, obs0_j)
    state0 = port.get_state()
    rng = np.random.default_rng(5)
    states = []
    for t in range(STEPS):
        a = rng.uniform(-1.2, 1.2, 4).astype(np.float32)
        (po, pr_, pd, _), (jo, jr_, jd, _) = port.step(a), jax_.step(a)
        _same(po, jo)
        assert (pr_, pd) == (jr_, jd) and port.is_success() == jax_.is_success()
        np.testing.assert_array_equal(port.get_state()["states"], jax_.get_state()["states"])
        states.append((port.get_state(), po))
    state, _ = states[5]
    assert state["states"].shape == (46,)  # nq 22 + nv 21 + the goal
    _same(port.reset_to(state), jax_.reset_to(state))
    np.testing.assert_array_equal(port.get_state()["states"], state["states"])
    # the regenerated view of the state at the reset (JAX's rule, tests/test_fetch_env.py:53)
    back = port.reset_to(state0)
    _same(back, jax_.reset_to(state0))
    assert (back["agentview_image"] == obs0["agentview_image"]).mean() > 0.99
    np.testing.assert_array_equal(port.render(), jax_.render())
    with pytest.raises(ValueError):
        port.step(np.zeros(7, np.float32))
    # a seeded reset repeats, and reset_to works before any reset
    fresh, fresh_j = _pair(camera_heights=48, camera_widths=48)
    _same(fresh.reset_to(state), fresh_j.reset_to(state))
    _same(*_reset_both(fresh, fresh_j, 5))


def test_goal_marker_appears_in_the_frame():
    """JAX's case (tests/test_fetch_env.py:75-81): the goal sphere changes
    pixels the scene alone lacks, the same pixels as JAX's."""
    port, jax_ = _pair(camera_heights=84, camera_widths=84)
    _reset_both(port, jax_, 3)
    marked = port.render()
    assert (port._renderer.render(port.data) != marked).any(axis=-1).sum() > 0
    np.testing.assert_array_equal(marked, jax_.render())


def test_shape_meta_sets_the_image_and_the_keys():
    port, jax_ = _pair(shape_meta=SHAPE_META)
    p, j = _reset_both(port, jax_, 1)
    _same(p, j)
    assert set(p) == set(SHAPE_META["obs"]) and p["agentview_image"].shape == (32, 32, 3)


def test_expert_first_actions_equal_jax():
    from unified_video_action_tpu.envs.fetch_expert import FetchPickPlaceExpert as JaxExpert
    from unified_video_action_tpu_torch.envs.fetch_expert import FetchPickPlaceExpert

    port, jax_ = _pair(camera_heights=24, camera_widths=24)
    _reset_both(port, jax_, 50001)
    pe, je = FetchPickPlaceExpert(noise=0.05, seed=50001), JaxExpert(noise=0.05, seed=50001)
    phases = set()
    for t in range(EXPERT_ACTIONS):
        a = pe.act(port._raw_obs["observation"], port._env.unwrapped.goal)
        b = je.act(jax_._raw_obs["observation"], jax_._env.unwrapped.goal)
        np.testing.assert_array_equal(a, b, err_msg=f"action {t}")
        phases.add(pe.phase)
        port.step(a)
        jax_.step(b)
    assert pe.phase == je.phase and len(phases) > 1


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts",
                                                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_tool_equals_jax_and_both_datasets_read_it(tmp_path, monkeypatch):
    import sys

    import h5py

    from unified_video_action_tpu.data.robomimic_dataset import (
        RobomimicReplayImageDataset as JaxDataset,
    )
    from unified_video_action_tpu_torch.data.robomimic_dataset import RobomimicReplayImageDataset
    from unified_video_action_tpu_torch.tools import gen_fetch_demos

    args = ["--episodes", "2", "--max-steps", "40", "--image-size", "32"]
    gen_fetch_demos.main(["--out", str(tmp_path / "port.h5"), *args, "--max-tries", "20"])
    monkeypatch.setattr(sys, "argv", ["gen_fetch_demos.py", "--out", str(tmp_path / "jax.h5"), *args])
    _jax_script("gen_fetch_demos").main()
    with h5py.File(tmp_path / "port.h5") as p, h5py.File(tmp_path / "jax.h5") as j:
        assert dict(p["data"].attrs) == dict(j["data"].attrs) and p["data"].attrs["total"] == 2
        keys = []
        p.visit(keys.append)
        assert {"data/demo_1/obs/agentview_image", "data/demo_1/states"} <= set(keys)
        for k in keys:
            if isinstance(p[k], h5py.Dataset):
                np.testing.assert_array_equal(p[k][()], j[k][()], err_msg=k)
    meta = dict(SHAPE_META)
    kw = dict(shape_meta=meta, horizon=8, pad_before=1, pad_after=7, abs_action=False, seed=0,
              val_ratio=0.0)
    ours = RobomimicReplayImageDataset(dataset_path=str(tmp_path / "port.h5"), **kw)
    theirs = JaxDataset(dataset_path=str(tmp_path / "port.h5"), **kw)
    assert len(ours) == len(theirs) > 0
    for k in ("agentview_image", "robot0_eef_pos", "robot0_gripper_qpos", "action"):
        np.testing.assert_array_equal(ours.replay_buffer[k], theirs.replay_buffer[k], err_msg=k)
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["action"], b["action"])
        for k in meta["obs"]:
            np.testing.assert_array_equal(a["obs"][k], b["obs"][k], err_msg=k)


def test_runner_on_the_fetch_backend_equals_jax(tmp_path, monkeypatch):
    from unified_video_action_tpu.envs import fetch_env as jfe
    from unified_video_action_tpu.runners.robomimic_runner import RobomimicImageRunner as JaxRunner
    from unified_video_action_tpu_torch.runners.robomimic_runner import RobomimicImageRunner
    from unified_video_action_tpu_torch.tools import gen_fetch_demos

    store = str(tmp_path / "demos.h5")
    gen_fetch_demos.main(["--out", store, "--episodes", "1", "--max-steps", "40",
                          "--image-size", "32", "--max-tries", "20"])
    made = []
    cls = jfe.FetchImageEnv
    monkeypatch.setattr(jfe, "FetchImageEnv", type("Rec", (cls,), {
        "__init__": lambda self, *a, **k: (cls.__init__(self, *a, **k), made.append(self))[0]}))
    kw = dict(dataset_path=store, shape_meta=SHAPE_META, n_train=1, n_test=1, max_steps=16,
              n_obs_steps=2, n_action_steps=8, env_backend="fetch")
    jp, pp = ScriptedPolicy("agentview_image", 4), ScriptedPolicy("agentview_image", 4)
    jr_ = JaxRunner(**kw)
    want = jr_.run(jp, None)
    pr_ = RobomimicImageRunner(**kw)
    got = pr_.run(pp)
    assert got == want and not pr_.abs_action and not jr_.abs_action
    assert {"train/sim_max_reward_0", "test/sim_max_reward_100000"} <= set(got)
    assert len(pp.seen) == len(jp.seen) > 0
    for a, b in zip(pp.seen, jp.seen):
        np.testing.assert_array_equal(a, b)
    for port_env, jax_env in zip(pr_.raw_envs, made):
        np.testing.assert_array_equal(np.stack(port_env.action_log), np.stack(jax_env.action_log))


@pytest.mark.slow
def test_robomimic_runner_on_fetch_backend(tmp_path):
    from unified_video_action_tpu_torch.runners.robomimic_runner import RobomimicImageRunner

    shape_meta = {"obs": {"agentview_image": {"shape": [3, 84, 84]},
                          "robot0_eef_pos": {"shape": [3]}}, "action": {"shape": [4]}}
    runner = RobomimicImageRunner(output_dir=str(tmp_path), shape_meta=shape_meta, n_train=1,
                                  n_test=2, max_steps=16, n_obs_steps=2, n_action_steps=8,
                                  env_backend="fetch")
    assert runner.abs_action is False
    log = runner.run(ScriptedPolicy("agentview_image", 4))
    assert 0.0 <= log["test/mean_score"] <= 1.0
