"""The port's robomimic and LIBERO runners (``runners/robomimic_runner.py``,
``runners/libero_runner.py``, ``runners/base.py``) against the JAX
package's, on the stub backend, on the CPU.

- Both runners drive a two-block policy (one encoder and one decoder block
  of width 32, fp32, 4 sampler steps) whose numpy-drawn weights go through
  the weight bridge: toolhang (two 32 px cameras, the 9-d state, rot6d
  actions) and a LIBERO policy (128 px stub frames resized to 32). Each of
  the port's calls takes its noise from the key the JAX runner passed to
  the same call (the runners call in the same order). Held: every action
  chunk to ACTION_ATOL, every action a stub received (``action_log``, after
  the rot6d -> axis-angle undo) to LOG_ATOL of the JAX stub's, the logs'
  keys and scores equal, the LIBERO goal of each runner equal to JAX's, and
  in the port every stub's ``action_log`` equal to the runner's undone
  actions, cut where its episode ended. Measured: chunks 5.4e-6, logs 6.0e-6.
- ``load_env_runner``'s dispatch and ``env_rollout``'s averaging and stub
  flag against JAX's; each backend that cannot run raises, naming what is
  missing (robosuite and LIBERO here, mujoco where it is hidden);
  ``eval_sim_torch.py`` on a LIBERO checkpoint writes the
  ``.STUB`` log; ``train_torch.py --config toolhang|libero10`` trains a
  tiny model on the synthetic stores, validates and rolls out on the stub.
"""

import copy
import json
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_sim_torch
from tests._torch_parity import policy_draws, random_params, to_numpy
from unified_video_action_tpu.envs import stub as jstub
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.runners import base as jbase
from unified_video_action_tpu.runners.libero_runner import make_libero_runners as jax_libero
from unified_video_action_tpu.runners.robomimic_runner import RobomimicImageRunner as JaxRobomimic
from unified_video_action_tpu_torch import config, convert
from unified_video_action_tpu_torch.data.robomimic_dataset import write_npz_store
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.runners import base as pbase
from unified_video_action_tpu_torch.runners.libero_runner import (
    LIBERO10_TASK_NAMES,
    LiberoImageRunner,
    make_libero_runners,
)
from unified_video_action_tpu_torch.runners.robomimic_runner import RobomimicImageRunner
from unified_video_action_tpu_torch.tools import gen_synthetic_suites as gen

ACTION_ATOL = 1e-4
LOG_ATOL = 1e-3

AMP = {
    "model_size": "custom",
    "encoder_embed_dim": 32, "encoder_depth": 1, "encoder_num_heads": 2,
    "decoder_embed_dim": 32, "decoder_depth": 1, "decoder_num_heads": 2,
    "img_size": 32, "vae_stride": 8, "vae_embed_dim": 8,
    "diffloss_d": 1, "diffloss_w": 16, "diffloss_act_d": 1, "diffloss_act_w": 16,
    "num_sampling_steps": "2", "act_diff_testing_steps": "4",
    "attn_dropout": 0.0, "proj_dropout": 0.0, "pretrained_model_path": None, "temperature": 0.95,
}
VAE = {"autoencoder_path": None, "ddconfig": {"vae_embed_dim": 8, "ch_mult": [1, 1, 2, 2], "ch": 32}}
TOOLHANG_META = copy.deepcopy(config.TOOLHANG["task"]["shape_meta"])
for _cam in ("sideview_image", "robot0_eye_in_hand_image"):
    TOOLHANG_META["obs"][_cam]["shape"] = [3, 32, 32]
BASE_KW = dict(vae_model_params=VAE, autoregressive_model_params=AMP,
               action_model_params={"predict_action": True, "act_model_type": "conv_fc"},
               normalizer_type="all", compute_dtype="float32")
KW = {"toolhang": dict(BASE_KW, shape_meta=TOOLHANG_META, task_name="toolhang",
                       use_proprioception=True),
      "libero10": dict(BASE_KW, shape_meta=config.LIBERO10["task"]["shape_meta"],
                       task_name="libero10")}
RUNNER_KW = dict(n_obs_steps=16, n_action_steps=8, max_steps=16, abs_action=True,
                 env_backend="stub")


def pair(kind):
    jp = JaxPolicy(**KW[kind])
    params = to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=5))
    port = UnifiedVideoActionPolicy(**KW[kind], device="cpu")
    port.load_params(params["mar"], params["vae"])
    return jp, jax.tree.map(jnp.asarray, params), port


class RecordingJax:
    def __init__(self, policy):
        self.policy, self.keys, self.chunks, self.goals = policy, [], [], []

    def predict_action(self, params, obs, key, language_goal=None):
        self.keys.append(key)
        self.goals.append(language_goal)
        out = self.policy.predict_action(params, obs, key, language_goal=language_goal)
        self.chunks.append(np.asarray(out["action"]))
        return out


class PortUnderJaxKeys:
    device = torch.device("cpu")

    def __init__(self, policy, keys):
        self.policy, self.keys, self.chunks, self.goals = policy, list(keys), [], []

    def predict_action(self, obs, generator=None, language_goal=None):
        assert isinstance(generator, torch.Generator)
        B = len(next(iter(obs.values())))
        noise = policy_draws(self.keys.pop(0), self.policy.noise_shapes(B))
        self.goals.append(language_goal)
        out = self.policy.predict_action(obs, noise=noise, language_goal=language_goal)
        self.chunks.append(out["action"])
        return out


@pytest.fixture
def jax_stubs(monkeypatch):
    """The JAX stubs that the JAX runners make, in order."""
    made = []
    for name in ("StubRobosuiteEnv", "StubLiberoEnv"):
        cls = getattr(jstub, name)
        rec = type(name, (cls,), {"__init__": lambda self, *a, _c=cls, **k: (
            _c.__init__(self, *a, **k), made.append(self))[0]})
        monkeypatch.setattr(jstub, name, rec)
    return made


def _check_logs(port_runner):
    """Each of the port's stubs received the runner's undone actions, cut
    where its episode ended."""
    stepped = np.stack(port_runner.env_actions, axis=1)  # (B, steps, n_action_steps, 7)
    for i, env in enumerate(port_runner.raw_envs):
        flat = stepped[i].reshape(-1, stepped.shape[-1])
        log = np.stack(env.action_log)
        assert 0 < len(log) <= len(flat)
        np.testing.assert_array_equal(log, flat[: len(log)].astype(np.float32))


def _same_action_logs(jax_envs, port_envs):
    assert len(jax_envs) == len(port_envs)
    worst = 0.0
    for je, pe in zip(jax_envs, port_envs):
        assert len(je.action_log) == len(pe.action_log)
        worst = max(worst, np.abs(np.stack(je.action_log) - np.stack(pe.action_log)).max())
    assert worst <= LOG_ATOL, worst
    return worst


def test_robomimic_runner_equals_jax(tmp_path, jax_stubs):
    jp, params, port = pair("toolhang")
    rng = np.random.default_rng(1)
    demos = [{"obs": {}, "actions": np.zeros((4, 7), np.float32), "states": rng.standard_normal((4, 6))}
             for _ in range(2)]
    with h5py.File(tmp_path / "th.hdf5", "w") as f:
        for i, d in enumerate(demos):
            f.create_dataset(f"data/demo_{i}/states", data=d["states"])
    write_npz_store(str(tmp_path / "th.npz"), demos)
    kw = dict(RUNNER_KW, shape_meta=TOOLHANG_META, n_train=2, n_test=2)
    jr = JaxRobomimic(dataset_path=str(tmp_path / "th.hdf5"), **kw)
    rec = RecordingJax(jp)
    want = jr.run(rec, params, jax.random.PRNGKey(7))
    pr = RobomimicImageRunner(dataset_path=str(tmp_path / "th.npz"), **kw)
    port_policy = PortUnderJaxKeys(port, rec.keys)
    got = pr.run(port_policy, torch.Generator().manual_seed(0))

    assert got == want and not port_policy.keys and len(rec.chunks) == 2
    assert any(v == 1.0 for k, v in got.items() if "sim_max_reward" in k)
    worst = max(np.abs(g - w).max() for g, w in zip(port_policy.chunks, rec.chunks))
    print(f"max |d| of the action chunks {worst:.3g}")
    assert worst <= ACTION_ATOL
    _check_logs(pr)
    print(f"max |d| of the stubs' action logs {_same_action_logs(jax_stubs, pr.raw_envs):.3g}")
    assert all(log.shape == (7,) for log in pr.raw_envs[0].action_log)
    for i, env in enumerate(pr.raw_envs[:2]):  # train episodes: the store's first states
        np.testing.assert_array_equal(env.init_state, demos[i]["states"][0])


def test_libero_runners_equal_jax(tmp_path, jax_stubs):
    jp, params, port = pair("libero10")
    for name in LIBERO10_TASK_NAMES[2:4]:
        (tmp_path / f"{name}.hdf5").touch()
    kw = dict(RUNNER_KW, n_test=2, test_start_seed=0)
    jrs = jax_libero(dataset_dir=str(tmp_path), **kw)
    prs = make_libero_runners(dataset_dir=str(tmp_path), **kw)
    rec = RecordingJax(jp)
    want = jbase.env_rollout(rec, params, jrs, jax.random.PRNGKey(3))
    port_policy = PortUnderJaxKeys(port, rec.keys)
    got = pbase.env_rollout(port_policy, prs, torch.Generator().manual_seed(0))

    assert got == want and not port_policy.keys and len(rec.chunks) == 4
    assert got["STUB_SCORES_NOT_REAL"] and got["env_backend"] == "stub"
    means = [got[r.log_prefix + "test/mean_score"] for r in prs]
    assert got["test_mean_score"] == float(sum(means) / len(means)) and max(means) > 0
    assert [r.language_goal for r in prs] == [r.language_goal for r in jrs]
    assert port_policy.goals == rec.goals and len(set(port_policy.goals)) == 2
    worst = max(np.abs(g - w).max() for g, w in zip(port_policy.chunks, rec.chunks))
    print(f"max |d| of the action chunks {worst:.3g}")
    assert worst <= ACTION_ATOL
    for r in prs:
        _check_logs(r)
    _same_action_logs(jax_stubs, [e for r in prs for e in r.raw_envs])


class ZeroPolicy:
    """rot6d identity rotations, or NaN."""

    device = torch.device("cpu")

    def __init__(self, value=0.0):
        self.value = value

    def predict_action(self, obs, generator=None, language_goal=None):
        B = len(next(iter(obs.values())))
        a = np.full((B, 8, 10), self.value, np.float32)
        a[..., 3] = a[..., 7] = 1.0
        return {"action": a}


def test_load_env_runner_dispatch_and_backends():
    th = copy.deepcopy(config.TOOLHANG)
    th["task"]["env_runner"].update(env_backend="stub", n_train=1, n_test=2, max_steps=16,
                                    dataset_path=None, shape_meta=TOOLHANG_META)
    runner = pbase.load_env_runner(th)
    assert isinstance(runner, RobomimicImageRunner) and runner.env_backend == "stub"
    assert (runner.n_train, runner.n_test, runner.max_steps) == (1, 2, 16)
    for name in ("square", "can", "lift"):
        cfg = {"task": {"name": name, "env_runner": {"env_backend": "stub"}}}
        assert isinstance(pbase.load_env_runner(cfg), RobomimicImageRunner)
    lib = copy.deepcopy(config.LIBERO10)
    lib["task"]["env_runner"].update(env_backend="stub", dataset_dir=None, n_test=2, max_steps=16)
    runners = pbase.load_env_runner(lib)
    jax_runners = jbase.load_env_runner(
        {"task": {"name": "libero10", "env_runner": dict(lib["task"]["env_runner"], _target_="")}})
    assert [r.log_prefix for r in runners] == [r.log_prefix for r in jax_runners]
    assert len(runners) == 10 and all(isinstance(r, LiberoImageRunner) for r in runners)
    log = pbase.env_rollout(ZeroPolicy(), runners[:2] + [runner])
    assert log["env_backend"] == "stub" and log["STUB_SCORES_NOT_REAL"]
    assert log["test_mean_score"] == np.mean([log[p + "test/mean_score"] for p in
                                              (runners[0].log_prefix, runners[1].log_prefix, "")])
    with pytest.raises(RuntimeError, match="non-finite"):
        runners[0].run(ZeroPolicy(np.nan))
    with pytest.raises(ValueError, match="no runner"):
        pbase.load_env_runner({"task": {"name": "mystery", "env_runner": {}}})


@pytest.mark.parametrize("make,backend,names", [
    (lambda b: RobomimicImageRunner(env_backend=b), "robosuite", "robosuite"),
    (lambda b: RobomimicImageRunner(env_backend=b), "fetch", "mujoco"),
    (lambda b: LiberoImageRunner("x_demo.hdf5", env_backend=b), "libero", "LIBERO"),
    (lambda b: make_libero_runners(env_backend=b), "libero", "LIBERO"),
    (lambda b: make_libero_runners(env_backend=b), "kitchen", "mujoco"),
    (lambda b: LiberoImageRunner("x_demo.hdf5", env_backend=b), "kitchen", "mujoco"),
])
def test_backends_that_cannot_run_raise(make, backend, names, monkeypatch):
    """robosuite and LIBERO are not installed here; mujoco, gymnasium and
    gymnasium_robotics are, so the kitchen and Fetch cases hide them, as on
    the card's machine."""
    if names == "mujoco":
        for module in ("mujoco", "gymnasium", "gymnasium_robotics"):
            monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=names):
        make(backend)
    with pytest.raises(ValueError, match="unknown env_backend"):
        make("gym")


def test_eval_sim_torch_writes_a_stub_log(tmp_path):
    cfg = copy.deepcopy(config.LIBERO10)
    cfg["model"]["policy"].update(copy.deepcopy({k: v for k, v in KW["libero10"].items()
                                                 if k not in ("task_name", "shape_meta")}))
    ckpt = tmp_path / "tiny"
    ckpt.mkdir()
    (ckpt / "meta.json").write_text(json.dumps({"cfg": cfg}))
    port = UnifiedVideoActionPolicy.from_cfg(cfg, device="cpu")
    weights = tmp_path / "weights.npz"
    convert.save_flat_npz(str(weights), {"mar": convert.seeded_tree(port.mar, 0),
                                         "vae": convert.seeded_tree(port.vae, 1)})
    (tmp_path / "tasks").mkdir()
    for name in LIBERO10_TASK_NAMES[:2]:
        (tmp_path / "tasks" / f"{name}.hdf5").touch()
    out = eval_sim_torch.main(["-c", str(ckpt), "-o", str(tmp_path / "out"), "--weights",
                               str(weights), "--device", "cpu", "task.env_runner.env_backend=stub",
                               f"task.env_runner.dataset_dir={tmp_path / 'tasks'}",
                               "task.env_runner.n_test=1",
                               "task.env_runner.max_steps=8"])
    assert out.endswith("eval_log_tiny.STUB.json")
    log = json.load(open(out))
    assert log["STUB_SCORES_NOT_REAL"] and log["env_backend"] == "stub"
    assert sum(k.endswith("/test/mean_score") for k in log) == 2 and "test_mean_score" in log


# toolhang shows the stub guard (three rollouts at patience 1 would stop an
# unguarded run after the second epoch); LIBERO the mean over its runners
EPOCHS = {"toolhang": 3, "libero10": 1}


def _tiny_overrides(kind, root, out):
    amp = "model.policy.autoregressive_model_params."
    size = {"toolhang": ("sideview_image", "robot0_eye_in_hand_image"), "libero10": ("agentview_rgb",)}
    data = ([f"task.dataset.dataset_path={root}/{gen.TOOLHANG_PATH}",
             f"task.env_runner.dataset_path={root}/{gen.TOOLHANG_PATH}", "task.env_runner.n_train=1"]
            if kind == "toolhang" else
            [f"task.dataset.dataset_dir={root}/{gen.LIBERO_DIR}",
             f"task.env_runner.dataset_dir={root}/{gen.LIBERO_DIR}"])
    meta = [f"{sec}.shape_meta.obs.{k}.shape=[3, 32, 32]" for k in size[kind]
            for sec in ("task", "task.dataset", "model.policy")]
    if kind == "toolhang":
        meta += [f"task.env_runner.shape_meta.obs.{k}.shape=[3, 32, 32]" for k in size[kind]]
    return [*(f"{amp}{k}={v}" for k, v in AMP.items() if k != "pretrained_model_path"),
            *(f"model.policy.vae_model_params.ddconfig.{k}={json.dumps(v)}"
              for k, v in VAE["ddconfig"].items()),
            "model.policy.compute_dtype=float32", *data, *meta,
            "task.dataset.val_ratio=0.3", "dataloader.batch_size=2", "dataloader.num_workers=1",
            f"training.num_epochs={EPOCHS[kind]}", "training.max_train_steps=1",
            "training.max_val_steps=1",
            "training.lr_warmup_steps=1", "training.rollout_every=1", "training.checkpoint_every=0",
            "training.sample_every=0", "training.early_stop_patience=1",
            "task.env_runner.env_backend=stub", "task.env_runner.n_test=1",
            "task.env_runner.max_steps=8", f"output_dir={out}"]


@pytest.mark.parametrize("kind", ["toolhang", "libero10"])
def test_train_torch_config_on_the_stub(kind, tmp_path, capsys):
    """``train_torch.py --config toolhang|libero10`` at a tiny width on the
    CPU: synthetic stores (``tools/gen_synthetic_suites.py``'s; two LIBERO
    tasks) through the host loader (LIBERO under ``data_aug``), validation, a
    stub rollout each epoch whose scores never stop the run early (the
    warning printed), ``test_mean_score`` the mean of the runners' test
    scores."""
    import train_torch

    root = tmp_path / "data"
    if kind == "toolhang":
        gen.write_toolhang(str(root), n_demos=3, steps=40, image_size=32)
    else:
        (root / gen.LIBERO_DIR).mkdir(parents=True)
        for i, name in enumerate(LIBERO10_TASK_NAMES[:2]):
            write_npz_store(str(root / gen.LIBERO_DIR / f"{name}.npz"),
                            gen.make_demos(2, 40, 32, ("agentview_rgb",), seed=i))
    state = train_torch.main(["--config", kind, "--device", "cpu",
                              *_tiny_overrides(kind, root, tmp_path / "out")])
    printed = capsys.readouterr().out
    assert f"[config] {kind} with ['model.policy.autoregressive_model_params.grad_checkpointing=true']" \
        in printed
    assert "early stopping is off" in printed and state.step == EPOCHS[kind]
    lines = [json.loads(line) for line in open(tmp_path / "out" / "logs.jsonl")]
    assert [line["epoch"] for line in lines] == list(range(EPOCHS[kind]))
    for line in lines:
        assert np.isfinite(line["train_loss"]) and np.isfinite(line["val_action_l2_distances"])
        assert "early_stopped" not in line and line["nonfinite_steps"] == 0
        means = [v for k, v in line.items() if k.endswith("test/mean_score")]
        assert len(means) == (1 if kind == "toolhang" else 2)
        assert line["test_mean_score"] == float(sum(means) / len(means))
