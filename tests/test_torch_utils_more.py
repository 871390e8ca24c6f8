"""The port's trajectory metrics (``utils/traj_eval.py``), nested-dict
helpers (``utils/tree.py``) and timing (``utils/profiling.py``) against the
JAX package's on the same inputs, on the CPU.

- ``umeyama_alignment``, ``ate`` and ``rpe`` within 1e-9 of JAX's (float64)
  on random tracks, with and without scale, a reflected cloud and several
  deltas; a similarity-transformed track aligns to zero error.
- ``dict_apply``, ``dict_apply_split`` and ``dict_apply_reduce`` equal to
  JAX's.
- ``Timer``'s statistics equal JAX's on the same readings; the host clock
  on the CPU; a CUDA timer raises without a card (no silent fallback) and an
  unknown device is refused; ``trace`` writes a Chrome trace;
  ``benchmark_fn`` counts its calls.
"""

import json

import numpy as np
import pytest
import torch

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.utils import profiling as jprof
from unified_video_action_tpu.utils import traj_eval as jte
from unified_video_action_tpu.utils import tree as jtree
from unified_video_action_tpu_torch.utils import profiling, traj_eval, tree

F64 = dict(rtol=0, atol=1e-9)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_trajectory_metrics_are_jaxs(seed):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.standard_normal((50, 3)) * 0.1, axis=0)
    est = 1.7 * gt @ _rotation(rng).T + rng.standard_normal(3) + rng.standard_normal((50, 3)) * 0.01
    for with_scale in (True, False):
        got, want = (m.umeyama_alignment(est, gt, with_scale) for m in (traj_eval, jte))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **F64)
        for align in (True, False):
            got, want = (m.ate(est, gt, align, with_scale) for m in (traj_eval, jte))
            assert got.keys() == want.keys()
            np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **F64)
    for delta in (1, 5):
        got, want = traj_eval.rpe(est, gt, delta), jte.rpe(est, gt, delta)
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], **F64)
    mirrored = gt * np.array([1.0, 1.0, -1.0])  # a reflection: the proper rotation nearest it
    for a, b in zip(traj_eval.umeyama_alignment(mirrored, gt), jte.umeyama_alignment(mirrored, gt)):
        np.testing.assert_allclose(a, b, **F64)
    R, t, s = traj_eval.umeyama_alignment(gt, 2.5 * gt @ _rotation(rng).T + 1.0)
    assert np.linalg.det(R) == pytest.approx(1.0) and s == pytest.approx(2.5)
    with pytest.raises(ValueError, match="N, 3"):
        traj_eval.umeyama_alignment(gt[:, :2], gt[:, :2])


def test_the_tree_helpers_are_jaxs():
    d = {"a": np.arange(3), "b": {"c": np.ones(2), "d": {"e": np.zeros(1)}}}
    f = lambda x: x * 2 + 1
    got, want = tree.dict_apply(d, f), jtree.dict_apply(d, f)
    flat = lambda t, p=(): sum((flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)]
                                for k, v in t.items()), [])
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (_, a), (_, b) in zip(flat(got), flat(want)):
        np.testing.assert_array_equal(a, b)
    split = lambda x: {"lo": x[:1], "hi": x[1:]}
    flat_d = {"a": np.arange(4), "b": np.arange(5)}
    g, w = tree.dict_apply_split(flat_d, split), jtree.dict_apply_split(flat_d, split)
    assert g.keys() == w.keys() and all(g[k].keys() == w[k].keys() for k in w)
    dicts = [{"x": i, "y": 2 * i} for i in range(4)]
    assert tree.dict_apply_reduce(dicts, sum) == jtree.dict_apply_reduce(dicts, sum)


def test_the_timer_statistics_are_jaxs():
    readings = [0.003, 0.010, 0.007, 0.0041, 0.020, 0.0055]
    timer, jtimer = profiling.Timer("cpu"), jprof.Timer()
    timer.records["stage"] = list(readings)
    jtimer.records["stage"] = list(readings)
    assert timer.stats() == jtimer.stats()
    assert timer.report() == jtimer.report()
    for _ in range(3):
        with timer.time("block"):
            sum(range(1000))
    assert timer.stats()["block"]["count"] == 3 and len(timer.seconds("block")) == 3
    assert all(s >= 0 for s in timer.seconds("block"))


def test_the_timer_names_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.Timer("cuda")
    with pytest.raises(ValueError, match="meta"):
        profiling.Timer("meta")


def test_trace_and_benchmark_fn(tmp_path):
    path = tmp_path / "trace" / "cpu.json"
    x = torch.randn(64, 64)
    with profiling.trace(str(path), "cpu") as prof:
        (x @ x).sum()
    assert prof is not None
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    calls = []
    out = profiling.benchmark_fn(lambda a: calls.append(a) or a @ a, x, device="cpu", warmup=2,
                                 iters=5)
    assert len(calls) == 7 and out["iters"] == 5
    assert out["min_s"] <= out["p50_s"] and set(out) == {"mean_s", "p50_s", "min_s", "iters"}
