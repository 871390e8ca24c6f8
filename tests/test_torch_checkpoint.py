"""The port's checkpoints, slim export and stage bootstrap
(``training/checkpoint.py``, ``convert.merge_params``,
``UnifiedVideoActionPolicy.load_pretrained``) against the JAX package on the
CPU, at the tiny training size of ``tests/test_torch_train_losses.py``.

- Save -> load restores every parameter, the EMA, AdamW's moments and step
  counts, the scheduler, the step, the epoch and the frozen VAE (its
  decoder and ``post_quant_conv`` too) bit for bit; one
  ``train_step`` after loading equals one from the saved state (same batch
  and noise) bit for bit. A non-blocking save keeps the state of its call.
- ``load_checkpoint`` falls back to ``.old``, then ``.tmp``.
- ``TopKCheckpointManager`` keeps the paths JAX's keeps on the same
  metrics, in both modes; ``JsonLogger`` writes JAX's lines.
- The slim export served through ``eval_sim_torch.load_weights`` gives fp32
  actions bit-equal to the EMA in memory and decodes bit-equal to the VAE
  in memory; its ``mar/`` and ``vae/`` keys (``decoder/`` too) are
  JAX's ``init_params`` tree; bf16 exports hold torch's bf16 roundings.
- ``merge_params`` gives JAX's merged tree and skipped list (shape
  mismatches and unexpected keys included). A stage-1 (video_model) ->
  stage-2 bootstrap through the port's checkpoint (``init_params`` with
  ``pretrained_model_path``) merges the same leaves as JAX's through its own
  ``save_checkpoint`` and ``load_pretrained`` (the step of its
  ``init_params`` that reads the path; its flax init, 40 s on the CPU, is
  replaced by a random tree of the same shapes), with JAX's skipped count;
  an orbax directory and a torch file are refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import random_params, to_numpy
from tests.test_torch_train_losses import B, fitted_normalizers, make_batch, to_torch, train_kw
from unified_video_action_tpu.models.torch_import import merge_params as jax_merge_params
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.training import checkpoint as jckpt
from unified_video_action_tpu.training import optim as joptim
from unified_video_action_tpu.training import train_state as jts
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import checkpoint as ckpt
from unified_video_action_tpu_torch.training.ema import EmaConfig
from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step

OPT = dict(learning_rate=1e-3, weight_decay=0.02, betas=(0.9, 0.95), warmup_steps=1, total_steps=10)
FRAMES = np.arange(3, 32, 4)


@pytest.fixture(scope="module")
def jax_shapes():
    """The parameter shapes of JAX's policy at ``train_kw()`` (the stage-2
    policy of the bootstrap)."""
    return jax.eval_shape(JaxPolicy(**train_kw()).init_params, jax.random.PRNGKey(0))


def _state(seed=4, steps=2):
    """A tiny training state after ``steps`` steps (non-zero moments, a
    moved EMA and scheduler), and its batch."""
    batch = make_batch(seed)
    port = UnifiedVideoActionPolicy(**train_kw(), train=True, device="cpu")
    port.init_params(seed)
    port.set_normalizer(fitted_normalizers(batch)[1])
    state = create_train_state(port, EmaConfig(), **OPT)
    for k in range(steps):
        train_step(state, to_torch(batch), "full_dynamic_model", FRAMES,
                   noise=port.sample_train_noise(B, torch.Generator().manual_seed(k)))
    return state, batch


def _differences(a, b):
    from chip_smoke import same_state

    return same_state(a, b)


def test_save_load_is_bit_equal_and_a_step_after_it_too(tmp_path):
    state, batch = _state()
    path = str(tmp_path / "latest")
    ckpt.save_checkpoint(path, state, cfg={"a": 1}, normalizer=state.policy.normalizer, epoch=3)
    assert sorted(os.listdir(path)) == ["meta.json", "normalizer.npz", "state.pt"]
    fresh, _ = _state(seed=9, steps=0)
    vae, vae_fresh = state.policy.vae.state_dict(), fresh.policy.vae.state_dict()
    decode_half = [k for k in vae if k.startswith(("decoder.", "post_quant_conv."))]
    assert len(decode_half) > 100 and not all(torch.equal(vae[k], vae_fresh[k]) for k in decode_half)
    _, meta, norm = ckpt.load_checkpoint(path, fresh)
    assert meta == {"epoch": 3, "step": 2, "cfg": {"a": 1}}
    assert _differences(fresh, state) == []
    # the frozen VAE comes back whole, its decoder and post_quant_conv too
    assert all(torch.equal(v, fresh.policy.vae.state_dict()[k]) for k, v in vae.items())
    assert norm.to_flat_dict().keys() == state.policy.normalizer.to_flat_dict().keys()
    np.testing.assert_array_equal(norm["action"].scale, state.policy.normalizer["action"].scale)
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    # one more step from each, on the same batch and noise
    noise = state.policy.sample_train_noise(B, torch.Generator().manual_seed(7))
    fresh.policy.set_normalizer(state.policy.normalizer)
    a = train_step(state, to_torch(batch), "policy_model", FRAMES, noise=noise)
    b = train_step(fresh, to_torch(batch), "policy_model", FRAMES, noise=noise)
    assert {k: v.item() for k, v in a.items()} == {k: v.item() for k, v in b.items()}
    assert _differences(fresh, state) == []


def test_non_blocking_save_keeps_the_state_of_its_call(tmp_path):
    state, _ = _state(steps=1)
    want = {n: p.detach().clone() for n, p in state.mar.named_parameters()}
    ckpt.save_checkpoint(str(tmp_path / "c"), state, blocking=False)
    with torch.no_grad():
        for p in state.mar.parameters():
            p.add_(1.0)
    ckpt.wait_for_checkpoints()
    fresh, _ = _state(seed=9, steps=0)
    ckpt.load_checkpoint(str(tmp_path / "c"), fresh)
    for n, p in fresh.mar.named_parameters():
        assert torch.equal(p, want[n]), n


def test_old_and_tmp_fallbacks(tmp_path):
    state, _ = _state(steps=1)
    path = str(tmp_path / "latest")
    ckpt.save_checkpoint(path, state, epoch=1)
    ckpt.save_checkpoint(path, state, epoch=2)  # publishes over the first
    assert sorted(os.listdir(tmp_path)) == ["latest"]
    for suffix in (".old", ".tmp"):
        os.replace(path, path + suffix)
        fresh, _ = _state(seed=9, steps=0)
        _, meta, _ = ckpt.load_checkpoint(path, fresh)
        assert meta["epoch"] == 2 and _differences(fresh, state) == []
        assert ckpt.is_port_checkpoint(path)
        os.replace(path + suffix, path)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_topk_keeps_jax_s_paths(tmp_path, mode):
    scores = [0.2, 0.5, 0.1, 0.5, 0.7, 0.3, 0.9, 0.05]
    fmt = "epoch={epoch:04d}-test_mean_score={test_mean_score:.3f}"
    managers = {"jax": jckpt.TopKCheckpointManager(str(tmp_path / "jax"), "test_mean_score", mode, 2, fmt),
                "port": ckpt.TopKCheckpointManager(str(tmp_path / "port"), "test_mean_score", mode, 2, fmt)}
    for epoch, score in enumerate(scores):
        data = {"epoch": epoch, "test_mean_score": score, "monitor": score}
        got = {}
        for name, m in managers.items():
            p = m.get_ckpt_path(data)
            if p is not None:
                os.makedirs(p)
            got[name] = None if p is None else os.path.relpath(p, str(tmp_path / name))
        assert got["jax"] == got["port"], epoch
        assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    assert managers["port"].get_ckpt_path({"epoch": 9}) is None  # no monitor
    assert len(os.listdir(tmp_path / "port")) == 2


def test_json_logger_writes_jax_s_lines(tmp_path):
    records = [({"epoch": 0, "train_loss": np.float32(0.25), "n": 3, "ok": True, "mode": "x",
                 "t": torch.tensor(1.5), "j": jnp.asarray(2.0)}, 7),
               ({"test/mean_score": 0.5, "early_stopped": True}, None)]
    for name, cls in (("jax", jckpt.JsonLogger), ("port", ckpt.JsonLogger)):
        logger = cls(str(tmp_path / name / "logs.jsonl"))
        for rec, step in records:
            logger.log(rec, step=step)
        logger.close()
    assert (tmp_path / "port" / "logs.jsonl").read_text() == (tmp_path / "jax" / "logs.jsonl").read_text()


def _serving(policy, state_tree, vae_tree):
    serve = UnifiedVideoActionPolicy(**train_kw(), device="cpu")
    serve.load_params(state_tree, vae_tree)
    serve.set_normalizer(policy.normalizer)
    return serve


def test_export_serves_the_ema_bit_equal_and_has_jax_s_keys(tmp_path, jax_shapes):
    import eval_sim_torch

    state, _ = _state(steps=2)
    policy = state.policy
    shapes = jax_shapes
    # a VAE tree of JAX's shapes, the decode half too, as autoencoder_path gives it
    policy.load_params(convert.to_flax_tree(policy.mar), to_numpy(random_params(shapes["vae"], 1)))
    out = str(tmp_path / "export")
    ckpt.export_slim(out, state.ema_tree(), policy.vae_params(), cfg={"c": 1},
                     normalizer=policy.normalizer, dtype="float32", epoch=1, step=state.step)
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta == {"epoch": 1, "step": 2, "slim": True, "export_dtype": "float32", "cfg": {"c": 1}}
    memory = _serving(policy, state.ema_tree(), policy.vae_params())
    served = _serving(policy, *eval_sim_torch.load_weights(out))
    frames = torch.randint(0, 256, (3, 4, 3, 32, 32), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    noise = memory.sample_noise(3, torch.Generator().manual_seed(2))
    want = memory.predict_action_frames(frames, noise=noise)
    assert torch.equal(served.predict_action_frames(frames, noise=noise), want)
    # and decodes as the VAE in memory does: the export carries the decoder
    z = torch.randn((2, 8, 4, 4), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(served.vae.decode(z), memory.vae.decode(z))
    # the full checkpoint serves the same EMA
    ckpt.save_checkpoint(str(tmp_path / "full"), state)
    full = _serving(policy, *eval_sim_torch.load_weights(str(tmp_path / "full")))
    assert torch.equal(full.predict_action_frames(frames, noise=noise), want)

    with np.load(os.path.join(out, ckpt.WEIGHTS)) as z:
        keys = set(z.files)
    want_keys = {"/".join((part,) + path) for part in ("mar", "vae")
                 for path in convert.flatten_tree(to_numpy(shapes[part]))}
    assert keys == want_keys


def test_bf16_export_holds_torch_s_roundings(tmp_path):
    x = np.random.default_rng(0).standard_normal((64, 33)).astype(np.float32) * 3
    x[0, :4] = [0.0, -0.0, np.inf, 1e-40]
    bits = convert.to_bf16_bits(x)
    assert bits.dtype == np.uint16
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(convert.from_bf16_bits(bits), want)
    convert.save_flat_npz(str(tmp_path / "w.npz"), {"mar": {"a": {"kernel": x}}}, "bfloat16")
    back = convert.load_flat_npz(str(tmp_path / "w.npz"), "bfloat16")
    np.testing.assert_array_equal(back["mar"]["a"]["kernel"], want)


def test_merge_params_matches_jax():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    init = {"a": {"kernel": r(3, 4), "bias": r(4)}, "b": {"scale": r(5)}, "c": r(2, 2),
            "head": {"w": r(6)}}
    imported = {"a": {"kernel": r(3, 4), "bias": r(5)}, "b": {"scale": r(5), "extra": r(1)},
                "c": r(3, 2), "gone": {"x": r(1)}}
    want, want_skipped = jax_merge_params(init, imported)
    got, got_skipped = convert.merge_params(init, imported)
    assert got_skipped == want_skipped and len(got_skipped) == 4
    w, g = convert.flatten_tree(want), convert.flatten_tree(got)
    assert w.keys() == g.keys()
    for path in w:
        np.testing.assert_array_equal(g[path], w[path], err_msg=str(path))


def _stage_kw(stage, path=None):
    kw = train_kw()
    if stage == 1:
        kw["selected_training_mode"] = "video_model"
        kw["action_model_params"] = dict(kw["action_model_params"], predict_action=False)
    kw["autoregressive_model_params"] = dict(kw["autoregressive_model_params"],
                                             pretrained_model_path=path)
    return kw


def test_stage_bootstrap_matches_jax(tmp_path, jax_shapes):
    jp1 = JaxPolicy(**_stage_kw(1))
    params1 = to_numpy(random_params(jax.eval_shape(jp1.init_params, jax.random.PRNGKey(0)), seed=3))
    tx = joptim.make_optimizer(**OPT)
    jstate = jts.create_train_state(jp1, jax.tree.map(jnp.asarray, params1), tx)
    jckpt.save_checkpoint(str(tmp_path / "jax1"), jstate)
    port1 = UnifiedVideoActionPolicy(**_stage_kw(1), train=True, device="cpu")
    port1.load_params(params1["mar"], params1["vae"])
    ckpt.save_checkpoint(str(tmp_path / "port1"), create_train_state(port1, EmaConfig(), **OPT))

    jp2 = JaxPolicy(**_stage_kw(2, str(tmp_path / "jax1")))
    jinit = to_numpy(random_params(jax_shapes, seed=5))
    want = convert.flatten_tree(to_numpy(jp2.load_pretrained(jinit)["mar"]))
    port2 = UnifiedVideoActionPolicy(**_stage_kw(2, str(tmp_path / "port1")), train=True, device="cpu")
    port2.init_params(0)
    got = convert.flatten_tree(convert.to_flax_tree(port2.mar))
    own = UnifiedVideoActionPolicy(**_stage_kw(2), train=True, device="cpu")
    own.init_params(0)
    init = convert.flatten_tree(convert.to_flax_tree(own.mar))

    stage1 = convert.flatten_tree(params1["mar"])
    assert got.keys() == want.keys() == init.keys()
    new = set(got) - set(stage1)
    assert new and {p[0] for p in new} == {"diffactloss"}
    for path in got:
        if path in stage1:
            np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
            np.testing.assert_array_equal(got[path], stage1[path], err_msg=str(path))
        else:  # kept at init, each side's own
            np.testing.assert_array_equal(got[path], init[path], err_msg=str(path))
            np.testing.assert_array_equal(want[path], convert.flatten_tree(jinit["mar"])[path])
    assert port2._last_mar_import_skipped == jp2._last_mar_import_skipped == 0
    assert port2._last_mar_import_kept_at_init == len(new)


def test_bootstrap_refuses_orbax_and_torch_files(tmp_path):
    port = UnifiedVideoActionPolicy(**_stage_kw(2), train=True, device="cpu")
    os.makedirs(tmp_path / "orbax" / "state")
    with pytest.raises(NotImplementedError, match="orbax.*ROADMAP"):
        port.load_pretrained(str(tmp_path / "orbax"))
    # a torch file is read as a reference checkpoint now
    # (tests/test_torch_checkpoint_import.py); one of neither reference
    # layout is refused
    torch.save({"state_dict": {}}, str(tmp_path / "ref.ckpt"))
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        port.load_pretrained(str(tmp_path / "ref.ckpt"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        port.load_pretrained(str(tmp_path / "empty"))


def test_offline_tracker_writes_jax_s_run_directory(tmp_path):
    from unified_video_action_tpu.training import trackers as jtrackers
    from unified_video_action_tpu_torch.training import trackers as ptrackers

    config = {"training": {"seed": 1}, "x": np.float32(0.5)}
    records = [({"train_loss": np.float32(0.25), "epoch": 0}, 3),
               ({"test_mean_score": 0.5, "v": np.arange(3)}, 6)]
    for name, module in (("jax", jtrackers), ("port", ptrackers)):
        tracker = module.OfflineRunTracker(str(tmp_path / name), config=config, name="n", project="p")
        for rec, step in records:
            tracker.log(rec, step=step)
        tracker.finish()
    for f in ("config.json", "metrics.jsonl", "summary.json"):
        assert (tmp_path / "port" / "tracker" / f).read_text() == \
            (tmp_path / "jax" / "tracker" / f).read_text(), f
    built = ptrackers.build_tracker({"mode": "offline"}, str(tmp_path / "built"))
    built.log({"a": 1.0}, step=1)
    built.finish()
    assert (tmp_path / "built" / "tracker" / "metrics.jsonl").read_text() == '{"a": 1.0, "_step": 1}\n'
    assert ptrackers.build_tracker({"mode": "disabled"}, str(tmp_path / "off")).trackers == []
