"""The port's stub environments (``envs/stub.py``) against the JAX
package's, on the CPU: for the same seed and the same action stream, the
images, rewards, done flags, success, ``get_state`` and ``action_log`` are
bit-equal (numpy only on both sides; tolerance 0), through ``reset``,
``seed``, ``set_init_state`` and ``reset_to``; a wrong action width raises
on both.
"""

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.envs import stub as jstub
from unified_video_action_tpu_torch.envs import stub as pstub

SHAPE_META = {"obs": {"sideview_image": {"shape": [3, 24, 20]},
                      "robot0_eef_pos": {"shape": [3]},
                      "robot0_gripper_qpos": {"shape": [2]}}}


def _same_obs(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _drive(env_j, env_p, actions):
    for a in actions:
        (oj, rj, dj, ij), (op, rp, dp, ip) = env_j.step(a), env_p.step(a)
        _same_obs(oj, op)
        assert (rj, dj, ij) == (rp, dp, ip) and type(rj) is type(rp)
    assert len(env_j.action_log) == len(env_p.action_log) == len(actions)
    for a, b in zip(env_j.action_log, env_p.action_log):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3, 7, 100002, 100005])
def test_libero_stub_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    actions = rng.standard_normal((60, 7)).astype(np.float64)
    env_j, env_p = jstub.StubLiberoEnv(camera_heights=32, camera_widths=24), \
        pstub.StubLiberoEnv(camera_heights=32, camera_widths=24)
    env_j.seed(seed)
    env_p.seed(seed)
    _same_obs(env_j.reset(), env_p.reset())
    assert env_j._sim.success_step == env_p._sim.success_step
    _drive(env_j, env_p, actions)
    assert env_j.check_success() == env_p.check_success()
    # set_init_state regenerates the obs and the success schedule from the state
    state = rng.uniform(-2, 2, 5)
    _same_obs(env_j.set_init_state(state), env_p.set_init_state(state))
    _drive(env_j, env_p, actions[:20])
    with pytest.raises(ValueError):
        env_p.step(np.zeros(6))


@pytest.mark.parametrize("seed", [0, 2, 6, 9, 100000])
def test_robosuite_stub_is_bit_equal(seed):
    rng = np.random.default_rng(seed + 1)
    actions = rng.standard_normal((40, 7)).astype(np.float32)
    env_j = jstub.StubRobosuiteEnv(SHAPE_META, seed=seed)
    env_p = pstub.StubRobosuiteEnv(SHAPE_META, seed=seed)
    _same_obs(env_j.reset(), env_p.reset())
    _drive(env_j, env_p, actions)
    _same_obs(env_j.get_observation(), env_p.get_observation())
    sj, sp = env_j.get_state(), env_p.get_state()
    np.testing.assert_array_equal(sj["states"], sp["states"])
    # reset_to keeps the seed's schedule and clears the log
    _same_obs(env_j.reset_to(sj), env_p.reset_to(sp))
    np.testing.assert_array_equal(env_j.init_state, env_p.init_state)
    _drive(env_j, env_p, actions[:12])
    with pytest.raises(ValueError):
        env_p.step(np.zeros(10))
