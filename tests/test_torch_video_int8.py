"""The int8 video head: ``Mar.sample_video`` under ``MarConfig.quant`` (the
policy's ``serving_quant="int8"``: both stacks, the action denoiser and the
video head's denoiser W8A8; a wrist head, where one exists, unquantized, as
in JAX), against the JAX package's ``sample_video`` on the same tier, on the
CPU at tests/test_torch_video.py's small size (2+2 blocks, d=64, 4 frames of
4x4 latents), with JAX's draws replayed (``tests._torch_parity.video_draws``).

Tolerance (ROADMAP C4): int8 parity past one layer holds only chunk by
chunk. A float rounding difference can push an activation across an int8
step, and the sampler carries it on, so a chunk is either reproduced or
moved about as far as quantization itself moves it. The action chunks take
``assert_int8_chunks`` (normalized units, INT8_CHUNK_ATOL); the frames'
latents, which reach 1e4 under random weights (clip_denoised=False), are
chunked by frame and held on their own scale: at least ``FRAMES_MIN_EXACT``
frames within tests/test_torch_video.py's ``scaled_tol`` of JAX's int8
frames, and the mean over frames of mean |port - JAX int8| below the mean
of mean |JAX int8 - JAX float| (the int8-vs-float gap). That is one round
(num_iter 1). From the second round on, the MAR conditions on the first
round's sampled latents, so one crossed step reaches every frame and every
chunk: there the means alone are held. Measured: at num_iter 1, 7 of 16
frames within scaled_tol, the mean 0.36 of the gap, 2 of 4 action chunks
within 4e-7; at num_iter 2, no frame, the mean 0.62 of the gap, the action
chunks 0.0025-0.0092 apart against gaps of 0.0033-0.0114. Besides, the
video head's denoiser has the action head's W8A8 layers, and the wrist head
none.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_int8_chunks, to_numpy, video_draws
from tests.test_torch_video import SMALL, _jax_sample_video, _latents, _mars, scaled_tol
from unified_video_action_tpu.models import mar as jm_
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import mar as pm_
from unified_video_action_tpu_torch.models.transformer import QuantLinear

FRAMES_MIN_EXACT = 2


@pytest.fixture(scope="module")
def quant_video_mars():
    jm, params, _ = _mars(SMALL)
    jq = jm_.Mar(dataclasses.replace(jm.cfg, quant=True))
    pq = pm_.Mar(pm_.MarConfig(**SMALL, quant=True)).eval()
    convert.load_into(pq, to_numpy(params))
    return jm, jq, params, pq


def _frame_chunks(got, want, want_float):
    """Per frame: mean |got - want|, mean |want - want_float| and whether
    the frame is within scaled_tol of ``want``."""
    got, want, want_float = (np.asarray(a, np.float64) for a in (got, want, want_float))
    axes = tuple(range(1, got.ndim))
    d = np.abs(got - want).mean(axis=axes)
    gap = np.abs(want - want_float).mean(axis=axes)
    tol = scaled_tol(want)
    exact = np.array([np.allclose(g, w, **tol) for g, w in zip(got, want)])
    return d, gap, exact


@pytest.mark.parametrize("num_iter", [1, 2])
def test_int8_sample_video_matches_jax_chunk_by_chunk(quant_video_mars, num_iter):
    jm, jq, params, pq = quant_video_mars
    B = 4
    cond = _latents(B, seed=7)
    key = jax.random.PRNGKey(31 + num_iter)
    want, want_act = _jax_sample_video(jq, params, cond, key, num_iter=num_iter, temperature=0.95)
    want_f, want_f_act = _jax_sample_video(jm, params, cond, key, num_iter=num_iter,
                                           temperature=0.95)
    draws = video_draws(key, pq.video_draw_shapes(B, num_iter))
    with torch.no_grad():
        frames, act = pq.sample_video(torch.tensor(cond), draws, num_iter=num_iter,
                                      temperature=0.95)
    assert frames.shape == (B * 4, 8, 4, 4) and act.shape == (B, 16, 2)
    d, gap, exact = _frame_chunks(frames.numpy(), want, want_f)
    assert gap.min() > 0  # the int8 tier moves every frame: the float head reproduces none
    assert d.mean() < gap.mean(), (d, gap)
    if num_iter == 1:
        assert exact.sum() >= FRAMES_MIN_EXACT, (d, gap)
        assert_int8_chunks(act.numpy(), want_act, want_f_act, min_exact=1)
    else:
        axes = (1, 2)
        assert (np.abs(act.numpy() - want_act).mean(axis=axes).mean()
                < np.abs(want_act - want_f_act).mean(axis=axes).mean())


def test_the_video_head_is_w8a8_and_the_wrist_head_is_not():
    """The video head's denoiser takes the int8 layers where the action
    head's does (the same ``MlpDenoiser``), the wrist head none."""
    pq = pm_.Mar(pm_.MarConfig(**SMALL, quant=True, predict_wrist_img=True))
    quant = lambda head: sorted(n for n, m in head.named_modules() if isinstance(m, QuantLinear))
    assert quant(pq.diffloss) == quant(pq.diffactloss) != []
    assert quant(pq.diffloss_wrist) == []
