"""Port of the offline evaluation (eval/metrics.py, eval/offline.py) and of
the trainer's ``sample_every`` hook against the JAX package on the CPU.

- The metrics: ``frechet_distance``, ``pixel_embeddings``,
  ``vae_latent_embeddings`` and ``action_l2`` against JAX's on the same
  arrays (FP32_TOL; the Fréchet distance in float64 on both sides).
- ``test_video_fvd`` on a tiny policy (tests/_torch_parity.py's
  TINY_POLICY_KW: 2+2 blocks of d = 64, a 32 px VAE of ch 32, the video head
  at 2 steps) with numpy-drawn weights, against JAX's on the same batches:
  JAX's fixed evaluation keys (``fold_in(PRNGKey(0), bi)`` split into the
  conditioning posterior, ``sample_video`` and the target posterior) handed
  to the port. Both report the same keys; the values agree within
  FVD_RTOL. The sampled latents reach 1e4 under random weights
  (tests/test_torch_video.py), and an element's float32 rounding there
  moves the decoded frames' uint8 truncation by one step now and then, so
  the distances are held relatively.
- ``test_action_l2`` against JAX's under JAX's predict keys.
- The trainer: the ``sample_every`` hook logs ``video_fvd_vae`` and
  ``video_fvd_pixel``, writes its media, and without the action head
  ``train_torch.py`` keeps the top-k by ``video_fvd_vae`` (mode min), as
  JAX's ``train.py`` does.
- ``save_video_grid`` writes PNG frames that decode to the grid, and the GIF.
"""

import copy
import json
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, TINY_POLICY_KW, policy_draws, random_params, to_numpy, video_draws
from tests.test_torch_train_run import tiny_config
from unified_video_action_tpu.eval import metrics as jmetrics
from unified_video_action_tpu.eval import offline as joffline
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch.eval import metrics as pmetrics
from unified_video_action_tpu_torch.eval import offline as poffline
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import workspace as pws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FVD_RTOL = 1e-3


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 12)).astype(np.float32)
    y = (rng.standard_normal((40, 12)) * 1.3 + 0.2).astype(np.float32)
    got = pmetrics.frechet_distance(x, y)
    np.testing.assert_allclose(got, jmetrics.frechet_distance(x, y), rtol=1e-12)
    assert got > 0 and abs(pmetrics.frechet_distance(x, x)) < 1e-9


def test_embeddings_and_action_l2_match_jax():
    rng = np.random.default_rng(1)
    videos = rng.integers(0, 256, (3, 8, 32, 40, 3), dtype=np.uint8)
    np.testing.assert_allclose(pmetrics.pixel_embeddings(videos), jmetrics.pixel_embeddings(videos),
                               **FP32_TOL)
    assert pmetrics.pixel_embeddings(videos).shape == (3, 4 * 8 * 8 * 3)
    lat = rng.standard_normal((3, 4, 16, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(pmetrics.vae_latent_embeddings(lat),
                               jmetrics.vae_latent_embeddings(lat), **FP32_TOL)
    pred, target = rng.standard_normal((2, 16, 10)), rng.standard_normal((2, 16, 10))
    assert pmetrics.action_l2(pred, target) == jmetrics.action_l2(pred, target)


def _val_batches(n, B=3, seed=5):
    rng = np.random.default_rng(seed)
    return [{"obs": {"image": rng.integers(0, 256, (B, 32, 3, 32, 32), dtype=np.uint8)},
             "action": rng.uniform(0, 512, (B, 32, 2)).astype(np.float32)} for _ in range(n)]


@pytest.fixture(scope="module")
def policies():
    kw = copy.deepcopy(TINY_POLICY_KW)
    jp = JaxPolicy(**kw)
    params = to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=3))
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(params["mar"], params["vae"])
    return jp, params, port


def _jax_eval_draws(port, bi, B, num_iter, task_mode):
    """JAX's test_video_fvd draws of batch bi (offline.py:92-107)."""
    c = port.mar_cfg
    k1, k2, k3 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), bi), 3)
    vae = lambda k: torch.tensor(np.asarray(jax.random.normal(
        k, (B * 4, c.vae_embed_dim, c.seq_hw, c.seq_hw))))
    return {"vae_cond": vae(k1),
            "video": video_draws(k2, port.mar.video_draw_shapes(B, num_iter, task_mode)),
            "vae_target": vae(k3)}


def test_video_fvd_matches_jax(policies, tmp_path):
    jp, params, port = policies
    batches, num_iter = _val_batches(2), 1
    want = joffline.test_video_fvd(
        jp, jax.tree.map(jnp.asarray, params),
        [{"obs": {"image": jnp.asarray(b["obs"]["image"])}} for b in batches],
        jax.random.PRNGKey(9), num_batches=2, num_iter=num_iter)
    got = poffline.test_video_fvd(
        port, [{"obs": {"image": torch.from_numpy(b["obs"]["image"])}} for b in batches],
        num_batches=2, num_iter=num_iter, output_dir=str(tmp_path),
        draws=lambda bi, B: _jax_eval_draws(port, bi, B, num_iter, "full_dynamic_model"))
    assert set(got) == set(want) == {"video_fvd_vae", "video_fvd_pixel"}
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=FVD_RTOL, err_msg=k)
    # the real-vs-predicted grid: 6 videos of 4 frames side by side, 3x2, as
    # JAX's real_vs_pred.gif and a PNG a frame
    frames = sorted(os.listdir(tmp_path))
    assert frames == ["real_vs_pred.gif"] + [f"real_vs_pred_{t:02d}.png" for t in range(4)]
    assert read_png(tmp_path / frames[1]).shape == (2 * 32, 3 * 64, 3)


def test_video_fvd_draws_are_fixed_per_batch(policies):
    _, _, port = policies
    batches = [{"obs": {"image": torch.from_numpy(b["obs"]["image"])}} for b in _val_batches(1)]
    torch.manual_seed(0)
    a = poffline.test_video_fvd(port, batches, num_batches=1)
    torch.manual_seed(1)
    b = poffline.test_video_fvd(port, batches, num_batches=1)
    assert a == b


def test_action_l2_matches_jax(policies):
    jp, params, port = policies
    batches = _val_batches(2, seed=6)
    key = jax.random.PRNGKey(4)
    want = joffline.test_action_l2(jp, jax.tree.map(jnp.asarray, params), batches, key,
                                   num_batches=2)
    subs = []
    for _ in batches:
        key, sub = jax.random.split(key)
        subs.append(sub)
    got = poffline.test_action_l2(port, batches, num_batches=2,
                                  noise=lambda bi, B: policy_draws(subs[bi], port.noise_shapes(B)))
    np.testing.assert_allclose(got["val_action_l2_distances"], want["val_action_l2_distances"],
                               rtol=1e-5)


def read_png(path):
    """An 8-bit RGB PNG without filters (as ``write_png`` writes it) -> (H, W, 3)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            W, H, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
            shape = (H, W)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], 1 + 3 * shape[1])
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


def test_save_video_grid_writes_readable_frames(tmp_path):
    videos = np.random.default_rng(3).integers(0, 256, (5, 2, 8, 6, 3), dtype=np.uint8)
    poffline.save_video_grid(videos, str(tmp_path / "media" / "grid"))
    for t in range(2):
        img = read_png(tmp_path / "media" / f"grid_{t:02d}.png")
        assert img.shape == (2 * 8, 3 * 6, 3)  # 5 videos on a 3-wide grid, 2 rows
        for b in range(5):
            r, c = divmod(b, 3)
            np.testing.assert_array_equal(img[r * 8:(r + 1) * 8, c * 6:(c + 1) * 6], videos[b, t])
        assert not img[8:, 12:].any()  # the blank sixth cell


def _train_torch():
    sys.path.insert(0, REPO)
    import train_torch

    return train_torch


def test_video_only_stage_logs_the_fvd_and_keeps_its_topk_by_it(tmp_path, capsys):
    train_torch = _train_torch()
    cfg = tiny_config(tmp_path, "model.policy.selected_training_mode=video_model",
                      "model.policy.action_model_params.predict_action=false",
                      "training.rollout_every=0", "training.val_every=0", "training.num_epochs=1",
                      "checkpoint.topk.k=1")
    assert cfg["checkpoint"]["topk"]["monitor_key"] == "test_mean_score"
    trainer = pws.Trainer(train_torch.video_monitor(cfg), "cpu")
    trainer.run()
    assert "[fvd] skipped" not in capsys.readouterr().out
    line = json.loads(open(tmp_path / "logs.jsonl").readline())
    fvd = {k: line[k] for k in ("video_fvd_vae", "video_fvd_pixel")}
    assert all(np.isfinite(v) for v in fvd.values())
    assert os.path.isfile(tmp_path / "media" / "real_vs_pred_00.png")
    # the top-k kept by video_fvd_vae
    name = f"epoch=0000-video_fvd_vae={fvd['video_fvd_vae']:.3f}"
    assert sorted(os.listdir(tmp_path / "checkpoints")) == sorted(["latest", name])


def test_train_torch_switches_a_video_only_runs_monitor(tmp_path, monkeypatch):
    train_torch = _train_torch()
    cfg = tiny_config(tmp_path, "model.policy.action_model_params.predict_action=false")
    want = {"monitor_key": "video_fvd_vae", "mode": "min",
            "format_str": "epoch={epoch:04d}-video_fvd_vae={video_fvd_vae:.3f}"}
    # main hands the switched config to the trainer
    seen = {}

    class Recorder:
        def __init__(self, run_cfg, device):
            seen.update(cfg=run_cfg, device=device)

        def run(self):
            return "state"

    monkeypatch.setattr(train_torch, "Trainer", Recorder)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(cfg))
    assert train_torch.main(["--run-config", str(path), "--device", "cpu"]) == "state"
    assert seen["cfg"]["checkpoint"]["topk"] == dict(cfg["checkpoint"]["topk"], **want)
    # as JAX's train.py makes it: runs with the action head, or with another
    # monitor, keep theirs
    stage2 = copy.deepcopy(cfg)
    stage2["model"]["policy"]["action_model_params"]["predict_action"] = True
    assert train_torch.video_monitor(copy.deepcopy(stage2)) == stage2
    other = copy.deepcopy(cfg)
    other["checkpoint"]["topk"]["monitor_key"] = "train_loss"
    assert train_torch.video_monitor(copy.deepcopy(other)) == other
