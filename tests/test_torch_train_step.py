"""The port's optimizer, EMA, initializer, train step and ``train_torch.py``
against the JAX package on the CPU, at the small size of
``tests/test_torch_train_losses.py``.

- ``decay_mask``: the same leaf set as JAX's (every flax leaf of ndim >= 2).
- The cosine-with-warmup and constant schedules at steps 0-600 against
  optax's (which evaluates them in float32: within a few of its ulps of the
  peak lr), and the lr the ``LambdaLR`` hands AdamW at each update.
- The global norm and its clipping against optax's.
- Three AdamW + EMA steps fed JAX's gradients against optax's ``adamw`` and
  JAX's ``ema_update``: parameters and EMA within ADAM_ATOL. (Adam's first
  update is lr·sign(g), so the optimizer is held on the same gradients;
  the gradients are held in their own tests.)
- Three ``train_step`` calls against JAX's jitted train step under JAX's
  keys, with ``grad_accum`` 1 and 2 (optax's ``MultiSteps``): each step's
  losses within 1e-5 and grad_norm within 1e-4 relative; the parameters and
  the EMA within STEP_ATOL, which allows a gradient element at noise level
  a flipped sign at each update (2·lr a step).
- ``init_params``: zero leaves exactly zero, norm scales exactly one, and
  every other leaf's standard deviation within 10 % of JAX's draw, plus three
  standard errors of the two samples' std.
- ``train_torch.py --device cpu`` for three steps on a tiny synthetic config,
  and the EMA weights it returns served by a serving policy.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_parity import to_numpy
from tests.test_torch_train_losses import (
    B,
    build_pair,
    jax_train_draws,
    make_batch,
    to_jax,
    to_torch,
    train_kw,
)
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu.training import ema as jema
from unified_video_action_tpu.training import optim as joptim
from unified_video_action_tpu.training import train_state as jts
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import ema as pema
from unified_video_action_tpu_torch.training import optim as poptim
from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "meta.json")
ADAM_ATOL = 1e-6
LR = 1e-3
OPT = dict(learning_rate=LR, weight_decay=0.02, betas=(0.9, 0.95), warmup_steps=1,
           total_steps=10)
EMA = dict(power=0.75, inv_gamma=1.0, max_value=0.9999)


def _leaves(tree):
    return convert.flatten_tree(to_numpy(tree))


def test_decay_mask_matches_jax():
    jp, params, port = build_pair(train_kw())
    want = _leaves(joptim.decay_mask(params["mar"]))
    paths = convert.flax_paths(port.mar)
    got = {paths[n][0]: v for n, v in poptim.decay_mask(port.mar).items()}
    assert got == {p: bool(v) for p, v in want.items()}
    # the raw parameters of more than one dimension decay, biases and norms do not
    assert got[("fake_latent_x",)] and got[("temporal_pos_embed",)]
    assert not got[("z_proj_ln", "scale")] and not got[("z_proj", "bias")]


@pytest.mark.parametrize("schedule, warmup, total", [("cosine", 500, 1000), ("cosine", 500, 600),
                                                     ("cosine", 0, 300), ("constant", 500, 0)])
def test_schedule_matches_optax(schedule, warmup, total):
    if schedule == "cosine":
        want = joptim.cosine_warmup_schedule(1e-4, warmup, total)
        got = poptim.cosine_warmup_schedule(1e-4, warmup, total)
    else:
        want = optax.join_schedules([optax.linear_schedule(0.0, 1e-4, warmup),
                                     optax.constant_schedule(1e-4)], [warmup])
        got = poptim.constant_warmup_schedule(1e-4, warmup)
    steps = np.arange(601)
    w = np.asarray(jax.vmap(want)(jnp.asarray(steps)), np.float64)
    g = np.array([got(int(s)) for s in steps])
    # optax evaluates in float32: a few of its ulps at the peak lr (1e-4 · 2^-23 ≈ 1.2e-11)
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=5e-11)
    assert g[0] == 0.0 or warmup == 0
    # the scheduler hands AdamW the schedule's value at each update's count
    opt, sched = poptim.make_optimizer(torch.nn.Linear(2, 2), learning_rate=1e-4,
                                       warmup_steps=warmup, total_steps=total, schedule=schedule)
    lrs = []
    for _ in range(5):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, g[:5], rtol=1e-12, atol=1e-15)


def _flax_to_port(tree, module):
    """A flax-layout tree as ``module``'s state (the bridge's layout change)."""
    flat = convert.flatten_tree(tree)
    out = {}
    for name, (path, change) in convert.flax_paths(module).items():
        out[name] = torch.tensor(convert._to_port_layout(np.asarray(flat[path], np.float32), change))
    return out


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(8)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    want = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)[0]
    got = [torch.tensor(g) for g in grads]
    np.testing.assert_allclose(poptim.global_norm(got).item(),
                               float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    poptim.clip_by_global_norm(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adamw_and_ema_three_steps_match_optax():
    jp, params, port = build_pair(train_kw(), seed=3)
    mar = params["mar"]
    tx = joptim.make_optimizer(**{k: v for k, v in OPT.items()})
    cfg_j, cfg_p = jema.EmaConfig(**EMA), pema.EmaConfig(**EMA)
    opt_state, ema_j = tx.init(mar), jax.tree.map(jnp.copy, mar)
    opt, sched = poptim.make_optimizer(port.mar, **OPT)
    ema_p = [p.detach().clone() for p in port.mar.parameters()]
    rng = np.random.default_rng(9)

    @jax.jit
    def jax_step(grads, opt_state, mar, ema, step):
        updates, opt_state = tx.update(grads, opt_state, mar)
        mar = optax.apply_updates(mar, updates)
        return opt_state, mar, jema.ema_update(ema, mar, step, cfg_j)

    for step in range(1, 4):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), mar)
        opt_state, mar, ema_j = jax_step(grads, opt_state, mar, ema_j, jnp.asarray(step))
        for p, g in zip(port.mar.parameters(), _flax_to_port(to_numpy(grads), port.mar).values()):
            p.grad = g
        opt.step()
        sched.step()
        pema.ema_update(ema_p, list(port.mar.parameters()), step, cfg_p)
        got = convert.flatten_tree(convert.to_flax_tree(port.mar))
        got_ema = convert.flatten_tree(convert.to_flax_tree(
            port.mar, dict(zip([n for n, _ in port.mar.named_parameters()], ema_p))))
        for path, w in _leaves(mar).items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=ADAM_ATOL, err_msg=str(path))
        for path, w in _leaves(ema_j).items():
            np.testing.assert_allclose(got_ema[path], w, rtol=0, atol=ADAM_ATOL, err_msg=str(path))
    assert pema.ema_decay(1, cfg_p) == 0.0
    np.testing.assert_allclose([pema.ema_decay(s, cfg_p) for s in (2, 10, 10**6)],
                               [float(jema.ema_decay(jnp.asarray(s), cfg_j)) for s in (2, 10, 10**6)],
                               rtol=1e-7)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_three_steps_match_jax(grad_accum):
    batch = make_batch(5)
    jp, params, port = build_pair(train_kw(), seed=4, batch=batch)
    tx = joptim.make_optimizer(**OPT, grad_accum=grad_accum)
    jstate = jts.create_train_state(jp, jax.tree.map(jnp.asarray, params), tx)
    jstep = jts.make_train_step(jp, tx, jema.EmaConfig(**EMA), donate=False)
    pstate = create_train_state(port, pema.EmaConfig(**EMA), grad_accum=grad_accum, **OPT)
    frames = np.arange(3, 32, 4)
    # a mode that leaves the video head and z_proj without gradients, then one
    # that reaches them, then the first again (one JAX program a mode)
    modes = ("policy_model", "full_dynamic_model", "policy_model") if grad_accum == 1 \
        else ("policy_model",) * 3
    for step, mode in enumerate(modes):
        key = jax.random.PRNGKey(60 + step)
        jstate, want = jstep(jstate, to_jax(batch), key, mode, frames)
        got = train_step(pstate, to_torch(batch), mode, frames, noise=jax_train_draws(key, port, B))
        for k in ("train_loss", "diffusion_loss", "action_loss"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    assert pstate.step == int(jstate.step) == 3
    updates = 3 // grad_accum
    atol = 2 * LR * updates + ADAM_ATOL
    got = convert.flatten_tree(convert.to_flax_tree(port.mar))
    for path, w in _leaves(jstate.mar_params).items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=str(path))
    got = convert.flatten_tree(pstate.ema_tree())
    for path, w in _leaves(jstate.ema_params).items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=str(path))


def _init_kw():
    kw = train_kw()
    kw["autoregressive_model_params"].update(encoder_embed_dim=256, decoder_embed_dim=256,
                                             diffloss_w=256, diffloss_act_w=256)
    return kw


def test_init_params_matches_jax_distributions():
    kw = _init_kw()
    jp = JaxPolicy(**kw)
    c = jp.mar_cfg
    lat = jnp.zeros((1, c.n_frames, c.vae_embed_dim, c.seq_hw, c.seq_hw))
    # the MAR half of JAX's init_params (policy.py:220-245)
    init = jax.jit(lambda k: jp.mar.init({"params": k, "dropout": k}, lat, lat, k,
                                         jnp.zeros((1, c.num_action_tokens, c.action_dim)),
                                         method=jm_.Mar.init_forward))
    want = _leaves(init(jax.random.PRNGKey(0))["params"])
    port = UnifiedVideoActionPolicy(**kw, train=True, device="cpu")
    port.init_params(0)
    got = convert.flatten_tree(convert.to_flax_tree(port.mar))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if not w.any() or (w == 1).all():
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        n = w.size
        allowance = 0.1 + 3 * np.sqrt(2.0 / (2 * (n - 1)))  # two samples' std errors, relative
        assert abs(g.std() / w.std() - 1) <= allowance, (path, g.std(), w.std())
        assert abs(g.mean()) <= 4 * w.std() / np.sqrt(n) + 1e-7, (path, g.mean())


def _tiny_run_config(tmp_path):
    with open(META) as f:
        cfg = json.load(f)["cfg"]
    from unified_video_action_tpu_torch.config import apply_overrides

    amp = "model.policy.autoregressive_model_params."
    apply_overrides(cfg, [
        f"{amp}model_size=custom", f"{amp}encoder_embed_dim=64", f"{amp}encoder_depth=1",
        f"{amp}encoder_num_heads=4", f"{amp}decoder_embed_dim=64", f"{amp}decoder_depth=1",
        f"{amp}decoder_num_heads=4", f"{amp}diffloss_d=1", f"{amp}diffloss_w=32",
        f"{amp}diffloss_act_d=1", f"{amp}diffloss_act_w=32", f"{amp}act_diff_testing_steps=ddim10",
        f"{amp}pretrained_model_path=null",
        f"model.policy.vae_model_params.autoencoder_path={REPO}/pretrained_models/vae/pusht_vae96.npz",
        "task.dataset.synthetic=2", "dataloader.batch_size=2", "training.num_epochs=1",
        "training.max_train_steps=3", "training.lr_warmup_steps=1", f"output_dir={tmp_path}",
        # the flagship's rollout (12 envs of 300 steps) is train_run's to test,
        # the video FVD of its sample_every test_torch_offline_eval's
        "training.rollout_every=0", "training.sample_every=0",
    ])
    return cfg


def test_train_torch_runs_three_steps_and_serves_its_ema(tmp_path):
    import train_torch

    cfg_path = tmp_path / "run.json"
    cfg = _tiny_run_config(tmp_path)
    cfg_path.write_text(json.dumps(cfg))
    (tmp_path / "logs.jsonl").write_text('{"epoch": 0, "from": "an earlier run"}\n')
    state = train_torch.main(["--run-config", str(cfg_path), "--device", "cpu",
                              "training.seed=3"])
    assert state.step == 3 and state.policy.task_modes == ("policy_model", "full_dynamic_model")
    lines = [json.loads(l) for l in (tmp_path / "logs.jsonl").read_text().splitlines()]
    assert len(lines) == 1 and lines[0]["global_step"] == 3
    assert all(np.isfinite(lines[0][k]) for k in ("train_loss", "action_loss", "grad_norm"))
    assert lines[0]["nonfinite_steps"] == 0
    assert (tmp_path / "normalizer.npz").exists()

    serve = UnifiedVideoActionPolicy.from_cfg(cfg, device="cpu", compute_dtype="float32")
    serve.load_params(state.ema_tree(), convert.load_flat_npz(
        cfg["model"]["policy"]["vae_model_params"]["autoencoder_path"]))
    serve.set_normalizer(state.policy.normalizer)
    frames = torch.randint(0, 256, (1, 4, 3, 96, 96), dtype=torch.uint8)
    act = serve.predict_action_frames(frames, generator=torch.Generator().manual_seed(0))
    stats = state.policy.normalizer["action"].input_stats
    assert torch.isfinite(act).all() and act.shape == (1, 16, 2)
    assert (act.numpy() >= stats["min"] - 1e-3).all() and (act.numpy() <= stats["max"] + 1e-3).all()
