"""The port's ``AsyncVectorEnv`` and the runner's ``vector_env="async"`` on
the CPU.

- ``AsyncVectorEnv`` against ``SyncVectorEnv`` on the runner's own env
  factories (``envs/pusht.make_runner_env``, pickled into spawned children)
  and against the JAX package's ``AsyncVectorEnv`` on the JAX env: reset,
  step, render, ``call`` and ``call_each``, bit-equal.
- Its failures: a factory that raises, a child that raises in a command
  (the pipes stay in step), a child that dies and one that hangs past the
  receive timeout all raise in the parent instead of hanging it, and
  ``close`` leaves no child alive; the children do not run the parent's
  ``__main__`` again.
- ``PushTImageRunner(vector_env="async")`` against the sync runner with a
  tiny policy of seeded weights (2+2 blocks of d = 64, ddim10) and the same
  generator: per-seed rewards and final agent positions equal, over one and
  two streams (2 envs, 16 steps).
"""

import copy
import functools
import sys

import numpy as np
import pytest
import torch

from tests import _torch_real_child as child
from tests._torch_parity import TINY_POLICY_KW
from unified_video_action_tpu.envs.pusht import PushTImageEnv as JaxImageEnv
from unified_video_action_tpu.envs.wrappers import AsyncVectorEnv as JaxAsyncVectorEnv
from unified_video_action_tpu.envs.wrappers import MultiStepWrapper as JaxMultiStep
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.envs.pusht import make_runner_env
from unified_video_action_tpu_torch.envs.wrappers import AsyncVectorEnv, SyncVectorEnv
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.runners.pusht_runner import PushTImageRunner

SEEDS = (100000, 100001)
N_OBS, N_ACT, MAX_STEPS = 4, 8, 16


def _jax_factory(seed):
    def make():
        env = JaxImageEnv(legacy=True, fix_goal=True)
        env.seed(seed)
        return JaxMultiStep(env, n_obs_steps=N_OBS, n_action_steps=N_ACT, max_episode_steps=MAX_STEPS)
    return make


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_async_matches_sync_and_jax():
    fns = [functools.partial(make_runner_env, s, True, True, N_OBS, N_ACT, MAX_STEPS) for s in SEEDS]
    venvs = {"async": AsyncVectorEnv(fns), "sync": SyncVectorEnv(fns),
             "jax": JaxAsyncVectorEnv([_jax_factory(s) for s in SEEDS])}
    try:
        out = {k: v.reset() for k, v in venvs.items()}
        _assert_same(out["async"], out["sync"])
        _assert_same(out["async"], out["jax"])
        rng = np.random.default_rng(0)
        for _ in range(2):
            actions = rng.uniform(50, 450, (len(SEEDS), N_ACT, 2))
            out = {k: v.step(actions) for k, v in venvs.items()}
            for k in ("sync", "jax"):
                _assert_same(out["async"][:3], out[k][:3])
                for got, want in zip(out["async"][3], out[k][3]):
                    _assert_same({i: list(v) for i, v in got.items()},
                                 {i: list(v) for i, v in want.items()})
        frames = {k: v.render() for k, v in venvs.items()}
        _assert_same(frames["async"], frames["sync"])
        _assert_same(frames["async"], frames["jax"])
        assert (frames["async"][0] == (255, 0, 0)).all(-1).any()  # the action marker
        for name, args in (("get_rewards", None), ("seed", [[7], [8]])):
            got = venvs["async"].call_each(name, args)
            _assert_same(got, venvs["sync"].call_each(name, args))
            _assert_same(got, venvs["jax"].call_each(name, args))
        assert venvs["async"].call("n_obs_steps") == venvs["jax"].call("n_obs_steps") == [N_OBS] * 2
    finally:
        for v in venvs.values():
            v.close()
    assert not any(p.is_alive() for p in venvs["async"].procs)


def test_failures_raise_and_close_leaves_no_child():
    with pytest.raises(RuntimeError, match="this factory raises"):
        AsyncVectorEnv([child.CountingEnv, child.raising_factory])

    venv = AsyncVectorEnv([child.CountingEnv] * 2)
    venv.reset()
    with pytest.raises(RuntimeError, match="no attribute 'nope'"):
        venv.call("nope")
    # the pipes stayed in step: every child's answer to the bad call was read
    obs, rewards, _, _ = venv.step([0, 0])
    assert rewards.tolist() == [1.0, 1.0] and obs.shape == (2, 2)
    venv.close()
    assert not any(p.is_alive() for p in venv.procs)

    dies = functools.partial(child.CountingEnv, exit_at=1)
    venv = AsyncVectorEnv([child.CountingEnv, dies])
    with pytest.raises(RuntimeError, match="died"):
        venv.step([0, 0])
    venv.close()
    assert [p.exitcode for p in venv.procs] == [0, 3]

    hangs = functools.partial(child.CountingEnv, sleep_at=1, sleep_s=60.0)
    venv = AsyncVectorEnv([hangs, child.CountingEnv], timeout=1.0)
    with pytest.raises(TimeoutError):
        venv.step([0, 0])
    venv.close(timeout=1.0)
    assert not any(p.is_alive() for p in venv.procs)


def test_children_do_not_run_the_parents_main_module(tmp_path, monkeypatch):
    """A spawned child would run the parent's ``__main__`` again (for
    chip_smoke.py: import torch); AsyncVectorEnv hides it while starting its
    children, then restores it."""
    marker = tmp_path / "ran"
    script = tmp_path / "parent_main.py"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    main = sys.modules["__main__"]
    monkeypatch.setattr(main, "__file__", str(script), raising=False)
    monkeypatch.setattr(main, "__spec__", None, raising=False)
    venv = AsyncVectorEnv([child.CountingEnv] * 2)
    try:
        assert venv.reset().shape == (2, 2)
    finally:
        venv.close()
    assert not marker.exists()
    assert main.__file__ == str(script) and main.__spec__ is None


@pytest.fixture(scope="module")
def tiny_policy():
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    policy = UnifiedVideoActionPolicy(**kw, device="cpu")
    policy.init_params(0)
    norm = LinearNormalizer()
    norm.fit({"action": np.array([[0.0, 0.0], [512.0, 512.0]], np.float32),
              "agent_pos": np.array([[0.0, 0.0], [512.0, 512.0]], np.float32)})
    policy.set_normalizer(norm)
    return policy


@pytest.mark.parametrize("n_streams", [1, 2])
def test_async_runner_matches_sync(tiny_policy, n_streams):
    results = {}
    for vector_env in ("sync", "async"):
        runner = PushTImageRunner(n_train=0, n_test=2, max_steps=16, vector_env=vector_env,
                                  n_streams=n_streams, latent_cache=n_streams == 2)
        log = runner.run(tiny_policy, torch.Generator().manual_seed(5))
        results[vector_env] = (log, runner.final_agent_pos.copy(), dict(runner.timing))
    assert results["async"][0] == results["sync"][0]
    np.testing.assert_array_equal(results["async"][1], results["sync"][1])
    assert results["async"][2]["dispatches"] == results["sync"][2]["dispatches"] == 2 * n_streams
    assert results["async"][2]["env_start_s"] > 0
    with pytest.raises(ValueError, match="vector_env"):
        PushTImageRunner(vector_env="threads")
