"""The port's Franka-kitchen suite (``envs/kitchen_env.py``,
``envs/kitchen_expert.py``, ``tools/gen_kitchen_demos.py`` and the LIBERO
runner's ``kitchen`` backend) against the JAX package's, on the CPU, in
mujoco's physics.

- ``KitchenImageEnv`` against JAX's for two tasks, the same seed and the
  same 20 seeded random actions: obs, reward, done and ``get_sim_state``
  bit-equal at every step, and ``set_init_state`` of a recorded state
  regenerating the same obs in both.
- ``KitchenExpert``'s first 40 actions bit-equal to JAX's on twin envs, with
  its noise from the caller's seed; whole successful episodes are marked
  slow where JAX marks its own (``tests/test_kitchen_expert.py:30``).
- ``tools/gen_kitchen_demos.py`` against ``scripts/gen_kitchen_demos.py``:
  one kettle episode at 32 px (the expert solves it in 42 steps), the same
  HDF5 arrays and attrs; JAX's and the port's ``LiberoReplayImageDataset``
  read it to equal arrays. The JAX test's two-episode run is slow, as there
  (``tests/test_kitchen_expert.py:56``).
- ``LiberoImageRunner`` on ``env_backend="kitchen"``: the port's and JAX's,
  driven by one scripted stand-in policy (its actions a function of the
  frames it is given) for 16 env steps in 1 env, give equal logs, the same
  frames to the policy and the same actions to the env; the JAX test's
  random-policy rollout is slow, as there (``tests/test_kitchen_env.py:182``).
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu_torch.envs import kitchen_env as pk

pytestmark = pytest.mark.skipif(not pk.available(), reason="mujoco/gymnasium-robotics absent")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20
EXPERT_ACTIONS = 40


def _jax_kitchen():
    from unified_video_action_tpu.envs import kitchen_env

    return kitchen_env


def _same_obs(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("task,seed", [("microwave", 3), ("slide cabinet", 11)])
def test_env_equals_jax(task, seed):
    jk = _jax_kitchen()
    port, jax_ = pk.KitchenImageEnv(tasks=[task]), jk.KitchenImageEnv(tasks=[task])
    assert port.language_goal == jax_.language_goal
    for env in (port, jax_):
        env.seed(seed)
    _same_obs(port.reset(), jax_.reset())
    rng = np.random.default_rng(seed)
    states = []
    for t in range(STEPS):
        a = rng.uniform(-1.2, 1.2, 9).astype(np.float32)  # beyond [-1, 1]: both clip
        (po, pr_, pd, _), (jo, jr_, jd, _) = port.step(a), jax_.step(a)
        _same_obs(po, jo)
        assert (pr_, pd) == (jr_, jd) and port.check_success() == jax_.check_success()
        np.testing.assert_array_equal(port.get_sim_state(), jax_.get_sim_state())
        states.append((port.get_sim_state(), po))
    np.testing.assert_array_equal(np.stack(port.action_log), np.stack(jax_.action_log))
    state, obs = states[STEPS // 2]
    _same_obs(port.set_init_state(state), jax_.set_init_state(state))
    np.testing.assert_array_equal(port.get_sim_state(), state)
    np.testing.assert_array_equal(port.render(), jax_.render())
    with pytest.raises(ValueError):
        port.step(np.zeros(7, np.float32))
    port.close()
    jax_.close()


@pytest.mark.parametrize("task", ["microwave", "kettle"])
def test_expert_first_actions_equal_jax(task):
    from unified_video_action_tpu.envs.kitchen_expert import KitchenExpert as JaxExpert
    from unified_video_action_tpu_torch.envs.kitchen_expert import KitchenExpert

    jk = _jax_kitchen()
    port, jax_ = pk.KitchenImageEnv(tasks=[task], camera_heights=24, camera_widths=24), \
        jk.KitchenImageEnv(tasks=[task], camera_heights=24, camera_widths=24)
    for env in (port, jax_):
        env.seed(7)
        env.reset()
    pe, je = KitchenExpert(port, task, noise=0.05, seed=7), JaxExpert(jax_, task, noise=0.05, seed=7)
    for t in range(EXPERT_ACTIONS):
        a, b = pe.act(), je.act()
        np.testing.assert_array_equal(a, b, err_msg=f"action {t}")
        assert a.dtype == np.float32 and a.shape == (9,)
        port.step(a)
        jax_.step(b)
    assert (pe._phase_i, pe._steps_in_phase) == (je._phase_i, je._steps_in_phase)
    assert pe._phase_i > 0  # the script moved past its first phase


@pytest.mark.slow
@pytest.mark.parametrize("task", ["slide cabinet", "light switch", "kettle"])
def test_expert_solves_task(task):
    import gymnasium as gym
    import gymnasium_robotics

    from unified_video_action_tpu_torch.envs.kitchen_expert import KitchenExpert

    gym.register_envs(gymnasium_robotics)
    env = gym.make("FrankaKitchen-v1", tasks_to_complete=[task], max_episode_steps=260)
    env.reset(seed=0)
    expert = KitchenExpert(env, task, noise=0.0, seed=0)
    success = False
    for _ in range(260):
        env.step(expert.act())
        if env.unwrapped.episode_task_completions:
            success = True
            break
        if expert.done:
            break
    env.close()
    assert success, f"expert failed {task!r}"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts",
                                                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPE_META = {"image_resolution": 32, "action": {"shape": [9]},
              "obs": {"agentview_rgb": {"shape": [3, 32, 32], "type": "rgb"},
                      "language": {"shape": [15], "type": "low_dim"}}}


def test_demo_tool_equals_jax_and_both_datasets_read_it(tmp_path, monkeypatch):
    import sys

    import h5py

    # JAX's dataset looks for CLIP files through transformers first, for seconds
    monkeypatch.setitem(sys.modules, "transformers", None)

    from unified_video_action_tpu.data.libero_dataset import LiberoReplayImageDataset as JaxDataset
    from unified_video_action_tpu_torch.data.libero_dataset import LiberoReplayImageDataset
    from unified_video_action_tpu_torch.tools import gen_kitchen_demos

    args = ["--tasks", "kettle", "--episodes", "1", "--max-steps", "60", "--image-size", "32",
            "--noise", "0.0", "--max-tries", "1"]
    gen_kitchen_demos.main(["--out-dir", str(tmp_path / "port"), *args])
    jax_tool = _jax_script("gen_kitchen_demos")
    ns = argparse.Namespace(out_dir=str(tmp_path / "jax"), episodes=1, seed0=50000, max_steps=60,
                            max_tries=1, noise=0.0, image_size=32)
    os.makedirs(ns.out_dir)
    jax_tool.gen_task("kettle", ns)
    name = "kitchen_kettle_demo.hdf5"
    with h5py.File(tmp_path / "port" / name) as p, h5py.File(tmp_path / "jax" / name) as j:
        assert dict(p["data"].attrs) == dict(j["data"].attrs) and p["data"].attrs["total"] == 1
        keys = []
        p.visit(keys.append)
        assert "data/demo_0/obs/agentview_rgb" in keys and "data/demo_0/states" in keys
        for k in keys:
            if isinstance(p[k], h5py.Dataset):
                np.testing.assert_array_equal(p[k][()], j[k][()], err_msg=k)
        assert p["data/demo_0/actions"].shape[1] == 9
    kw = dict(shape_meta=SHAPE_META, horizon=8, pad_before=1, pad_after=7, abs_action=False,
              seed=0, val_ratio=0.0, data_aug=False)
    ours, theirs = (LiberoReplayImageDataset(dataset_dir=str(tmp_path / "port"), **kw),
                    JaxDataset(dataset_dir=str(tmp_path / "port"), **kw))
    assert len(ours) == len(theirs) > 0
    for k in ("agentview_rgb", "action"):
        np.testing.assert_array_equal(ours.replay_buffer[k], theirs.replay_buffer[k], err_msg=k)
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["action"], b["action"])
        np.testing.assert_array_equal(a["obs"]["agentview_rgb"], b["obs"]["agentview_rgb"])


@pytest.mark.slow
def test_generated_demos_load_through_libero_dataset(tmp_path):
    from unified_video_action_tpu_torch.data.libero_dataset import LiberoReplayImageDataset
    from unified_video_action_tpu_torch.tools import gen_kitchen_demos

    out_dir = str(tmp_path / "demos")
    gen_kitchen_demos.main(["--out-dir", out_dir, "--tasks", "slide cabinet", "--episodes", "2",
                            "--image-size", "48", "--noise", "0.0"])
    assert os.path.exists(os.path.join(out_dir, "kitchen_slide_cabinet_demo.hdf5"))
    meta = dict(SHAPE_META, obs=dict(SHAPE_META["obs"], agentview_rgb={"shape": [3, 48, 48],
                                                                       "type": "rgb"}))
    ds = LiberoReplayImageDataset(dataset_dir=out_dir, shape_meta=meta, horizon=8, pad_before=1,
                                  pad_after=7, abs_action=False, seed=0, val_ratio=0.5,
                                  data_aug=False)
    item = ds[0]
    assert item["action"].shape == (8, 9) and item["obs"]["agentview_rgb"].shape[-2:] == (48, 48)
    # uint8 frames, as JAX's dataset gives them (JAX's own test expects [0, 1] and fails)
    assert np.isfinite(item["action"]).all() and item["obs"]["agentview_rgb"].dtype == np.uint8


class ScriptedPolicy:
    """Actions from the frames alone (a sine of each frame window's mean),
    for the JAX runner's and the port's calls alike; keeps what it saw."""

    def __init__(self, key: str, dim: int):
        self.key, self.dim, self.seen, self.goals = key, dim, [], []

    def _act(self, obs, language_goal):
        img = np.asarray(obs[self.key])
        self.seen.append(img.copy())
        self.goals.append(language_goal)
        m = img.reshape(img.shape[0], -1).mean(axis=1)
        k = np.arange(8 * self.dim).reshape(8, self.dim)
        return {"action": np.sin(10.0 * m[:, None, None] + k[None]).astype(np.float32)}

    def predict_action(self, *args, language_goal=None, **kwargs):
        obs = args[1] if len(args) > 1 and isinstance(args[1], dict) else args[0]
        return self._act(obs, language_goal)


def test_runner_on_the_kitchen_backend_equals_jax(monkeypatch):
    from unified_video_action_tpu.runners import libero_runner as jlr
    from unified_video_action_tpu_torch.runners.libero_runner import LiberoImageRunner

    made = []
    jk = _jax_kitchen()
    cls = jk.KitchenImageEnv
    monkeypatch.setattr(jk, "KitchenImageEnv", type("Rec", (cls,), {
        "__init__": lambda self, *a, **k: (cls.__init__(self, *a, **k), made.append(self))[0]}))
    kw = dict(n_test=1, max_steps=16, n_obs_steps=2, n_action_steps=8)
    jp, pp = ScriptedPolicy("agentview_rgb", 9), ScriptedPolicy("agentview_rgb", 9)
    jr_ = jlr.LiberoImageRunner("kitchen_microwave_demo.hdf5", env_backend="kitchen", **kw)
    want = jr_.run(jp, None)
    pr_ = LiberoImageRunner("kitchen_microwave_demo.hdf5", env_backend="kitchen", **kw)
    got = pr_.run(pp)
    assert got == want and set(got) == {"test/sim_max_reward_100000", "test/mean_score"}
    assert pr_.language_goal == jr_.language_goal == pk.KITCHEN_TASK_PROMPTS["microwave"]
    assert pp.goals == jp.goals and not pr_.abs_action and not jr_.abs_action
    assert len(pp.seen) == len(jp.seen) == 2
    for a, b in zip(pp.seen, jp.seen):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(pr_.raw_envs[0].action_log), np.stack(made[0].action_log))
    assert len(made[0].action_log) == 16


@pytest.mark.slow
def test_libero_runner_on_kitchen_backend():
    from unified_video_action_tpu_torch.runners.libero_runner import LiberoImageRunner

    runner = LiberoImageRunner("kitchen_microwave_demo.hdf5", n_test=2, max_steps=24,
                               n_obs_steps=2, n_action_steps=8, env_backend="kitchen")
    policy = ScriptedPolicy("agentview_rgb", 9)
    log = runner.run(policy)
    assert runner.language_goal == pk.KITCHEN_TASK_PROMPTS["microwave"] and not runner.abs_action
    assert 0.0 <= log["test/mean_score"] <= 1.0 and len(policy.seen) == 3
