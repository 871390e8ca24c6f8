"""The port's PushTImageRunner against the JAX package's, on the CPU.

- Without a model: both runners drive the same deterministic stub policy (a
  function of the last agent position): the per-seed ``sim_max_reward`` and
  the log's keys are equal, with the latent cache on and off, over one and two
  streams; and the port's runner gives the same results with one stream and
  with two.
- With the whole slice: the JAX runner drives the tiny JAX policy of
  tests/_torch_parity.py (ddim10, fp32) and the port's runner the port's
  policy with the same weights; the port's side takes each call's noise from
  the key the JAX runner passed to that call (the runners dispatch in the
  same order). Three seeds, ``max_steps=24``, the latent cache on (two
  streams) and off (one stream). Held: every action chunk to 1e-3 in
  normalized action units and every ``sim_max_reward`` to 1e-3; measured:
  1.3e-4 (cache on) and 7.2e-5 (cache off) for the chunks, the sampler's
  first steps amplifying float32 rounding differences as in
  tests/test_torch_policy.py, and 0 for the rewards.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import TINY_POLICY_KW, policy_draws, random_params, to_numpy
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.runners.pusht_runner import PushTImageRunner as JaxRunner
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.runners.base import env_rollout, load_env_runner
from unified_video_action_tpu_torch.runners.pusht_runner import PushTImageRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")
ACTION_ATOL = 1e-3
REWARD_ATOL = 1e-3


def _stub_chunk(obs_dict):
    """(B, 16, 2) targets circling toward the middle from the last agent
    position: the agent sweeps through the block now and then."""
    pos = np.asarray(obs_dict["agent_pos"], np.float64)[:, -1]
    k = np.arange(16)[None, :, None]
    phase = (pos[:, None, :1] + pos[:, None, 1:]) / 37.0
    toward = (256.0 - pos)[:, None, :] * (k + 1) / 24.0
    swirl = 40.0 * np.concatenate([np.cos(phase + k / 3), np.sin(phase + k / 3)], axis=-1)
    return np.clip(pos[:, None, :] + toward + swirl, 0, 512)


class JaxStub:
    def predict_action_async(self, params, obs_dict, key):
        return _stub_chunk(obs_dict)

    def predict_action_cached_async(self, params, obs_dict, key, cache=None, n_shift=8):
        return _stub_chunk(obs_dict), None


class PortStub:
    device = torch.device("cpu")

    def predict_action_async(self, obs_dict, generator=None):
        assert isinstance(generator, torch.Generator)
        return torch.from_numpy(_stub_chunk(obs_dict))

    def predict_action_cached_async(self, obs_dict, cache=None, n_shift=8, generator=None):
        return self.predict_action_async(obs_dict, generator), None


RUNNER_KW = dict(n_train=1, n_test=4, max_steps=48)


@pytest.mark.parametrize("latent_cache,n_streams", [(False, 1), (True, 2)])
def test_runner_with_a_stub_policy_matches_jax(latent_cache, n_streams):
    kw = dict(RUNNER_KW, latent_cache=latent_cache, n_streams=n_streams)
    want = JaxRunner(**kw).run(JaxStub(), None)
    got = PushTImageRunner(**kw).run(PortStub())
    assert got.keys() == want.keys()
    assert got == want
    assert any(v > 0 for k, v in got.items() if "sim_max_reward" in k)


def test_streams_do_not_change_the_results():
    one = PushTImageRunner(**RUNNER_KW, latent_cache=True, n_streams=1)
    two = PushTImageRunner(**RUNNER_KW, latent_cache=True, n_streams=2)
    three = PushTImageRunner(**RUNNER_KW, latent_cache=True, chunk_size=2, n_streams=2)
    results = [r.run(PortStub()) for r in (one, two, three)]
    assert results[0] == results[1] == results[2]
    assert one.timing["dispatches"] == 6 and two.timing["dispatches"] == 12


def test_loader_and_rollout_log():
    cfg = {"task": {"name": "pusht", "env_runner": dict(
        RUNNER_KW, _target_="unified_video_action_tpu.runners.pusht_runner.PushTImageRunner")}}
    runner = load_env_runner(cfg)
    assert isinstance(runner, PushTImageRunner) and runner.seeds == [0, 100000, 100001, 100002, 100003]
    log = env_rollout(PortStub(), runner)
    assert log["env_backend"] == "real" and log["test_mean_score"] == log["test/mean_score"]
    # the libero and robomimic runners dispatch; their real simulators are
    # not installed here, and the stub backend runs them
    for name, package in (("libero_10", "LIBERO"), ("square", "robosuite")):
        with pytest.raises(ImportError, match=package):
            load_env_runner({"task": {"name": name, "env_runner": {}}})
        assert load_env_runner({"task": {"name": name, "env_runner": {"env_backend": "stub"}}})
    # the async vector env is ported (tests/test_torch_async_env.py); other
    # names are refused
    assert PushTImageRunner(vector_env="async").vector_env == "async"
    with pytest.raises(ValueError, match="vector_env"):
        PushTImageRunner(vector_env="gym")


class RecordingJaxPolicy:
    """The JAX policy, recording each call's key and action chunk."""

    def __init__(self, policy):
        self.policy, self.keys, self.actions = policy, [], []

    def predict_action_async(self, params, obs_dict, key):
        self.keys.append(key)
        out = self.policy.predict_action_async(params, obs_dict, key)
        self.actions.append(np.asarray(out))
        return out

    def predict_action_cached_async(self, params, obs_dict, key, cache=None, n_shift=8):
        self.keys.append(key)
        out, cond = self.policy.predict_action_cached_async(params, obs_dict, key, cache=cache,
                                                            n_shift=n_shift)
        self.actions.append(np.asarray(out))
        return out, cond


class PortPolicyUnderJaxKeys:
    """The port's policy, each call's noise drawn from the key that the JAX
    runner passed to the same call."""

    def __init__(self, policy, keys):
        self.policy, self.keys, self.actions = policy, list(keys), []
        self.device = policy.device

    def _noise(self, obs_dict, n_new):
        key = self.keys.pop(0)
        return policy_draws(key, self.policy.noise_shapes(len(obs_dict["image"]), n_new))

    def predict_action_async(self, obs_dict, generator=None):
        out = self.policy.predict_action_async(obs_dict, noise=self._noise(obs_dict, None))
        self.actions.append(out.numpy())
        return out

    def predict_action_cached_async(self, obs_dict, cache=None, n_shift=8, generator=None):
        _, new = self.policy.cache_plan(obs_dict["image"].shape[1], cache, n_shift)
        out, cond = self.policy.predict_action_cached_async(
            obs_dict, cache=cache, n_shift=n_shift, noise=self._noise(obs_dict, len(new)))
        self.actions.append(out.numpy())
        return out, cond


@pytest.mark.parametrize("latent_cache,n_streams", [(True, 2), (False, 1)])
def test_runner_with_the_whole_slice_matches_jax(latent_cache, n_streams):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    jp = JaxPolicy(**kw)
    jp.set_normalizer(JaxNormalizer.load(NORMALIZER))
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(to_numpy(params["mar"]), to_numpy(params["vae"]))
    port.set_normalizer(LinearNormalizer.load(NORMALIZER))

    runner_kw = dict(n_train=0, n_test=3, max_steps=24, latent_cache=latent_cache,
                     n_streams=n_streams)
    jax_policy = RecordingJaxPolicy(jp)
    want = JaxRunner(**runner_kw).run(jax_policy, params, jax.random.PRNGKey(3))
    port_policy = PortPolicyUnderJaxKeys(port, jax_policy.keys)
    got = PushTImageRunner(**runner_kw).run(port_policy)

    assert got.keys() == want.keys() and not port_policy.keys
    assert len(port_policy.actions) == len(jax_policy.actions) == (6 if n_streams == 2 else 3)
    scale = np.asarray(port.normalizer["action"].scale)
    worst = max(np.abs((g - w) * scale).max() for g, w in zip(port_policy.actions, jax_policy.actions))
    print(f"max |d| of the normalized action chunks: {worst:.3g}")
    assert worst <= ACTION_ATOL, worst
    reward_d = max(abs(got[k] - want[k]) for k in want)
    print(f"max |d| of sim_max_reward: {reward_d:.3g}")
    assert reward_d <= REWARD_ATOL, (got, want)
