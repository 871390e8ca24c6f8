"""A whole training run of the port on the CPU at a tiny width
(``training/workspace.py``): validation against the JAX package, then the
run's cadences, logs, top-k, early stop, resume, preemption and the config
keys it acts on or names.

- ``val_action_l2`` equals JAX's ``_val_action_l2`` on the same weights,
  batch and predict noise (JAX's own draws from its key, as in
  ``tests/test_torch_predict_obs.py``), within that file's tolerance.
- A ``Trainer`` on a synthetic store with every cadence at 1 and a rollout of
  one seed: each ``logs.jsonl`` line carries JAX's step-log keys
  (``training/workspace.py:435-440``, ``:503``, ``:523-525``, ``:579``), the
  tracker's ``metrics.jsonl`` the same steps; the early stop and the top-k
  checkpoints follow JAX's rules (its ``TopKCheckpointManager`` replayed on
  the logged scores); the video FVD is logged (``video_fvd_vae`` and
  ``video_fvd_pixel``) and never skipped; the export is written.
- Resume restarts at the saved epoch with the saved state and appends to
  ``logs.jsonl``.
- SIGTERM to ``train_torch.py`` in a subprocess stops it with exit 0 and a
  ``latest`` that resumes.
- Every key of the flagship config's ``training``, ``checkpoint``, ``ema``,
  ``logging``, ``dataloader`` and ``val_dataloader`` is acted on or named
  in the log as ignored (ROADMAP C8).
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time
import types

import jax
import numpy as np
import torch

from tests._torch_parity import policy_draws
from tests.test_torch_train_losses import (
    B,
    build_pair,
    fitted_normalizers,
    make_batch,
    to_torch,
    train_kw,
)
from unified_video_action_tpu.training import checkpoint as jckpt
from unified_video_action_tpu.training.workspace import TrainWorkspace
from unified_video_action_tpu_torch.config import apply_overrides
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import workspace as pws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "meta.json")
NORMALIZED_ATOL = 1e-4  # tests/test_torch_predict_obs.py's
# the keys of JAX's step log for a run with the video FVD, validation and
# test-only rollouts (no I3D weights: the pixel FVD)
JAX_STEP_LOG_KEYS = {"epoch", "global_step", "epoch_time", "train_loss", "diffusion_loss",
                     "action_loss", "grad_norm", "video_fvd_vae", "video_fvd_pixel",
                     "val_action_l2_distances", "test/mean_score", "test_mean_score", "_step"}


def test_val_action_l2_matches_jax():
    kw = train_kw()
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    batch = make_batch(6, aug=False)
    jp, params, _ = build_pair(kw, seed=2, batch=batch)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(params["mar"], params["vae"])
    port.set_normalizer(fitted_normalizers(batch)[1])
    key = jax.random.PRNGKey(17)
    state = types.SimpleNamespace(ema_params=params["mar"], vae_params=params["vae"])
    want = TrainWorkspace._val_action_l2(types.SimpleNamespace(policy=jp), state, batch, key)
    got = pws.val_action_l2(port, to_torch(batch), noise=policy_draws(key, port.noise_shapes(B)))
    scale = float(port.normalizer["action"].scale.min())
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=NORMALIZED_ATOL / scale)
    # without the action head there is nothing to validate
    kw_video = copy.deepcopy(kw)
    kw_video["action_model_params"]["predict_action"] = False
    video = UnifiedVideoActionPolicy(**kw_video, train=True, device="cpu")
    assert pws.val_action_l2(video, to_torch(batch)) is None


def tiny_config(out, *overrides):
    """The flagship's run config at a tiny width (a narrow VAE of random
    weights too, the video head sampling in 2 steps) on 2 synthetic
    episodes, one of them for validation, every cadence at 1, a rollout of
    one test seed."""
    with open(META) as f:
        cfg = json.load(f)["cfg"]
    amp = "model.policy.autoregressive_model_params."
    apply_overrides(cfg, [
        f"{amp}model_size=custom", f"{amp}encoder_embed_dim=64", f"{amp}encoder_depth=1",
        f"{amp}encoder_num_heads=4", f"{amp}decoder_embed_dim=64", f"{amp}decoder_depth=1",
        f"{amp}decoder_num_heads=4", f"{amp}diffloss_d=1", f"{amp}diffloss_w=32",
        f"{amp}diffloss_act_d=1", f"{amp}diffloss_act_w=32", f"{amp}act_diff_testing_steps=ddim10",
        # the video FVD's sampler at 2 steps: 100 steps of tiny operations
        # take minutes where the suite's workers share the cores
        f"{amp}num_sampling_steps=2", f"{amp}pretrained_model_path=null",
        # a narrow VAE of random weights: the run's checkpoints carry it
        "model.policy.vae_model_params.autoencoder_path=null", "model.policy.vae_model_params.ddconfig.ch=32",
        "task.dataset.synthetic=2", "task.dataset.val_ratio=0.5", "dataloader.batch_size=2",
        "training.num_epochs=2", "training.max_train_steps=2", "training.lr_warmup_steps=1",
        "training.val_every=1", "training.rollout_every=1", "training.checkpoint_every=1",
        "training.sample_every=1", "training.max_val_steps=2", "task.env_runner.n_train=0",
        "task.env_runner.n_test=1", "task.env_runner.max_steps=8", f"output_dir={out}",
        *overrides])
    return cfg


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_logs_topk_early_stop_and_export(tmp_path, capsys):
    cfg = tiny_config(tmp_path, "training.num_epochs=4", "training.early_stop_patience=1",
                      "checkpoint.topk.k=1")
    trainer = pws.Trainer(cfg, "cpu")
    state = trainer.run()
    printed = capsys.readouterr().out
    lines = _lines(tmp_path / "logs.jsonl")
    for line in lines:
        assert JAX_STEP_LOG_KEYS <= set(line), JAX_STEP_LOG_KEYS - set(line)
        assert all(np.isfinite(v) for v in line.values() if isinstance(v, float))
        assert "test/sim_max_reward_100000" in line and line["nonfinite_steps"] == 0
    assert [l["_step"] for l in lines] == [l["_step"] for l in _lines(tmp_path / "tracker" / "metrics.jsonl")]
    assert json.load(open(tmp_path / "tracker" / "summary.json"))["_step"] == lines[-1]["_step"]
    assert "[fvd] skipped" not in printed
    # JAX's early stop (patience 1) and top-k (k = 1) over the logged scores
    scores = [l["test_mean_score"] for l in lines]
    best, stop_at = scores[0], None
    for epoch, s in enumerate(scores[1:], 1):
        if s > best:
            best = s
        elif stop_at is None:
            stop_at = epoch
    assert stop_at is not None, "the tiny policy's scores rose every epoch: no early stop to check"
    # JAX's JsonLogger writes True as 1.0
    assert len(lines) == stop_at + 1 and lines[-1].get("early_stopped") == 1.0
    assert not any(l.get("early_stopped") for l in lines[:-1])
    assert state.step == 2 * len(lines) and trainer.epoch == len(lines)
    topk = jckpt.TopKCheckpointManager(str(tmp_path / "jax_topk"), "test_mean_score", "max", 1,
                                       cfg["checkpoint"]["topk"]["format_str"])
    kept = [topk.get_ckpt_path({"epoch": e, "test_mean_score": s, "monitor": s})
            for e, s in enumerate(scores)]
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert names == sorted(["latest"] + [os.path.basename(p) for p in topk.kept])
    assert any(kept)
    meta = json.load(open(tmp_path / "checkpoints" / "latest" / "meta.json"))
    assert meta["epoch"] == len(lines) - 1 and meta["step"] == state.step
    export = json.load(open(tmp_path / "export" / "meta.json"))
    assert export["slim"] and export["export_dtype"] == "bfloat16" and export["step"] == state.step


def test_resume_restarts_at_the_saved_epoch(tmp_path):
    # the video FVD is test_run_logs_topk_early_stop_and_export's to check
    cfg = tiny_config(tmp_path, "training.rollout_every=0", "training.val_every=0",
                      "training.sample_every=0")
    first = pws.Trainer(cfg, "cpu")
    first.run()
    assert [l["epoch"] for l in _lines(tmp_path / "logs.jsonl")] == [0, 1]
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg["training"].update(resume=True, num_epochs=3)
    second = pws.Trainer(resumed_cfg, "cpu", dataset=first.dataset)
    assert second.restore() and second.epoch == 1 and second.state.step == first.state.step
    for (n, p), q in zip(second.state.mar.named_parameters(), first.state.mar.parameters()):
        assert torch.equal(p, q) and torch.equal(second.state.ema[n], first.state.ema[n]), n
    second.run()
    lines = _lines(tmp_path / "logs.jsonl")
    assert [l["epoch"] for l in lines] == [0, 1, 1, 2]
    assert [l["global_step"] for l in lines] == [2, 4, 6, 8]


def test_sigterm_leaves_a_latest_that_resumes(tmp_path):
    cfg = tiny_config(tmp_path, "training.num_epochs=10000", "training.rollout_every=0",
                      "training.val_every=0", "training.checkpoint_every=0",
                      "training.sample_every=0")
    (tmp_path / "run.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "train_torch.py", "--run-config",
                             str(tmp_path / "run.json"), "--device", "cpu"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = tmp_path / "logs.jsonl"
    deadline = time.time() + 120
    while time.time() < deadline and not (log.exists() and log.read_text()):
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert "[preempt] checkpoint saved" in out
    meta = json.load(open(tmp_path / "checkpoints" / "latest" / "meta.json"))
    done = len(_lines(log))
    assert meta["epoch"] == done  # the unfinished epoch, replayed on resume
    cfg["training"]["resume"] = True
    resumed = pws.Trainer(cfg, "cpu")
    assert resumed.restore() and resumed.epoch == done and resumed.state.step == meta["step"]
    assert meta["step"] >= 2 * done


def test_every_flagship_key_is_acted_on_or_named(capsys):
    with open(META) as f:
        cfg = json.load(f)["cfg"]
    cfg["dataloader"]["pin_memory"] = True  # a key no table lists
    ignored = pws.config_report(cfg)
    for section, acted in pws.ACTED_ON.items():
        for key in cfg[section]:
            assert key in acted or f"{section}.{key}" in ignored, f"{section}.{key}"
            assert not (key in acted and f"{section}.{key}" in ignored)
    assert ignored["dataloader.num_workers"].startswith("the device-resident store")
    assert ignored["dataloader.pin_memory"] == "the port does not read this key"
    assert {"training.resume", "training.checkpoint_every", "training.rollout_every",
            "training.val_every", "training.sample_every", "training.early_stop_patience",
            "training.max_val_steps", "checkpoint.topk"}.isdisjoint(ignored)
    cfg = tiny_config("unused", "dataloader.pin_memory=true")
    pws.Trainer(cfg, "cpu")
    printed = capsys.readouterr().out
    for key in pws.config_report(cfg):
        assert f"[config] ignored {key}: " in printed, key
