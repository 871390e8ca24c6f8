"""eval_sim_torch.py, the port's evaluation entry point, on the CPU: a tiny
checkpoint directory (the tiny config of tests/_torch_parity.py as its
embedded ``cfg``, the flagship's normalizer, seeded weights as a flat
``.npz``) evaluated on a few short PushT episodes, and its pieces against the
JAX package's: the digest of a checkpoint and the dotted overrides.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

import eval_sim_torch
from tests._torch_parity import TINY_POLICY_KW, random_params, to_numpy
from unified_video_action_tpu.config import Cfg
from unified_video_action_tpu.config import apply_overrides as jax_apply_overrides
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.utils.ckpt_id import ckpt_digest as jax_ckpt_digest
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.utils.ckpt_id import ckpt_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATEST = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest")


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    ckpt = root / "tiny"
    ckpt.mkdir()
    policy_kw = {k: v for k, v in TINY_POLICY_KW.items() if k != "task_name"}
    cfg = {
        "task": {"name": "pusht", "env_runner": {
            "_target_": "unified_video_action_tpu.runners.pusht_runner.PushTImageRunner",
            "n_train": 1, "n_test": 10, "max_steps": 300, "n_obs_steps": 16,
            "n_action_steps": 8, "test_start_seed": 100000, "train_start_seed": 0}},
        "model": {"policy": dict(policy_kw, _target_="policy.UnifiedVideoActionPolicy")},
    }
    (ckpt / "meta.json").write_text(json.dumps({"cfg": cfg, "slim": True}))
    shutil.copy(os.path.join(LATEST, "normalizer.npz"), ckpt / "normalizer.npz")
    jp = JaxPolicy(**TINY_POLICY_KW)
    params = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=0)
    weights = root / "weights.npz"
    np.savez(weights, **_flat(to_numpy(params["mar"]), "mar/"), **_flat(to_numpy(params["vae"]), "vae/"))
    return str(ckpt), str(weights)


def test_eval_sim_torch_writes_the_jax_log_keys(tiny_checkpoint, tmp_path):
    ckpt, weights = tiny_checkpoint
    out = tmp_path / "out"
    eval_sim_torch.main(["-c", ckpt, "-o", str(out), "--device", "cpu", "--weights", weights,
                         "task.env_runner.n_test=2", "task.env_runner.max_steps=16",
                         "task.env_runner.latent_cache=true", "task.env_runner.n_streams=2",
                         "model.policy.autoregressive_model_params.act_diff_testing_steps=ddim10",
                         "model.policy.serving_quant=int8"])
    log = json.loads((out / "eval_log_tiny.json").read_text())
    seeds = ["train/sim_max_reward_0", "test/sim_max_reward_100000", "test/sim_max_reward_100001"]
    assert set(log) == {*seeds, "train/mean_score", "test/mean_score", "test_mean_score",
                        "env_backend", "ckpt_source", "ckpt_digest", "act_steps", "serving_quant",
                        "obs_codec", "port", "device", "compute_dtype", "eval_wall_s"}
    assert all(0.0 <= log[k] <= 1.0 for k in seeds)
    assert log["test_mean_score"] == log["test/mean_score"]
    assert (log["env_backend"], log["act_steps"], log["serving_quant"], log["obs_codec"]) == (
        "real", "ddim10", "int8", "raw")
    assert (log["port"], log["device"], log["compute_dtype"]) == ("torch", "cpu", "float32")
    assert log["ckpt_digest"] == jax_ckpt_digest(ckpt) and log["ckpt_source"] == ckpt
    # the JAX package's own flagship logs carry the same keys, less the port's
    jax_log = json.load(open(os.path.join(LATEST, "..", "eval_yuv420", "eval_log_latest.json")))
    assert {k for k in jax_log if "sim_max_reward" not in k} <= set(log)


def test_ckpt_digest_equals_the_jax_package_s(tiny_checkpoint):
    ckpt, weights = tiny_checkpoint
    for path in (ckpt, weights):
        assert ckpt_digest(path) == jax_ckpt_digest(path)
    assert ckpt_digest(LATEST).startswith("501d06eb0633")


def test_apply_overrides_equals_the_jax_package_s():
    overrides = ["task.env_runner.n_test=50", "task.env_runner.latent_cache=true",
                 "model.policy.autoregressive_model_params.act_diff_testing_steps=ddim10",
                 "model.policy.serving_quant=int8", "a.b.c=0.5", "a.d=null", "a.e=[1, 2]",
                 "task.env_runner.n_streams=2"]
    cfg = {"task": {"env_runner": {"n_test": 10}}, "model": {"policy": {}}}
    want = Cfg.wrap(json.loads(json.dumps(cfg)))
    jax_apply_overrides(want, overrides)
    apply_overrides(cfg, overrides)
    assert cfg == want.to_dict()


def test_eval_sim_torch_serves_a_port_export_with_c_alone(tiny_checkpoint, tmp_path):
    """A slim export of the port (training/checkpoint.py) is served with -c
    alone: the same per-seed results as the same weights through --weights,
    and no orbax on that path."""
    import subprocess
    import sys

    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.training.checkpoint import export_slim

    ckpt, weights = tiny_checkpoint
    cfg = json.loads(open(os.path.join(ckpt, "meta.json")).read())["cfg"]
    tree = convert.load_flat_npz(weights)
    export = str(tmp_path / "export")
    export_slim(export, tree["mar"], tree["vae"], cfg,
                LinearNormalizer.load(os.path.join(ckpt, "normalizer.npz")), dtype="float32")
    overrides = ["--device", "cpu", "task.env_runner.n_test=2", "task.env_runner.n_train=0",
                 "task.env_runner.max_steps=16",
                 "model.policy.autoregressive_model_params.act_diff_testing_steps=ddim10"]
    eval_sim_torch.main(["-c", export, "-o", str(tmp_path / "a"), *overrides])
    eval_sim_torch.main(["-c", ckpt, "-o", str(tmp_path / "b"), "--weights", weights, *overrides])
    got = json.loads((tmp_path / "a" / "eval_log_export.json").read_text())
    want = json.loads((tmp_path / "b" / "eval_log_tiny.json").read_text())
    rewards = [k for k in want if "sim_max_reward" in k]
    assert len(rewards) == 2 and {k: got[k] for k in rewards} == {k: want[k] for k in rewards}
    assert got["ckpt_digest"] == ckpt_digest(export)
    probe = ("import sys, eval_sim_torch; eval_sim_torch.load_weights(sys.argv[1]); "
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'orbax', 'jax', 'h5py'}))")
    out = subprocess.run([sys.executable, "-c", probe, export], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
