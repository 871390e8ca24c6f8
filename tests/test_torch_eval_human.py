"""``eval_human_torch.py``, the port's live keypoint demo, against
``eval_human.py`` on the CPU.

- ``run_stream`` headless on a tiny human_pp policy (14-d keypoint actions,
  the weights of tests/test_torch_human_pp.py's ``tiny_pair``) against JAX's
  ``run_stream`` on the same capture: JAX splits its ``PRNGKey`` a frame and
  the port is given each split's draws (``noise(n)``); the windows the two
  policies receive bit-equal, the keypoints within the action parity's
  1e-4 (in [0, 512) pixels, scaled: 1e-4 x 512), and the overlaid frames
  equal wherever the keypoints round to the same pixel (every frame here).
- ``plot_keypoints`` pixel for pixel against ``cv2.circle`` (tests may
  import cv2; the port may not), at the border and outside the frame too;
  ``preprocess`` against ``cv2.resize`` and ``cv2.cvtColor``.
- ``main`` on the CPU: a tiny export served over a ``.npz`` of frames into
  a GIF; ``--device cuda`` without a card and a camera source without cv2
  raise, naming what is missing; the stages timed by ``utils/profiling.
  Timer`` on the host clock.
"""

import builtins
import os

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

import eval_human
import eval_human_torch
from tests._torch_parity import policy_draws
from tests.test_torch_human_pp import FRAME, tiny_pair
from tests.test_torch_umi_policy import to_jax
from unified_video_action_tpu_torch.utils.profiling import Timer

KP_ATOL = 1e-4 * 512


class FakeCap:
    """N seeded BGR frames of (h, w), then the end of the stream."""

    def __init__(self, n=4, h=48, w=64, seed=0):
        rng = np.random.default_rng(seed)
        self.frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
        self.i = 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]


class Recorded:
    """A policy wrapper recording the windows it is asked for."""

    def __init__(self, policy, jax_params=None):
        self.policy, self.jax_params, self.windows = policy, jax_params, []
        self.device = getattr(policy, "device", None)

    def predict_action(self, *args, **kwargs):
        obs = args[1] if self.jax_params is not None else args[0]
        self.windows.append(np.array(obs["image"]))
        return self.policy.predict_action(*args, **kwargs)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_run_stream_equals_jax(pair, monkeypatch):
    jp, params, port = pair
    # JAX's loop resizes every frame to 96 px; the tiny model reads 32 px frames
    monkeypatch.setattr(eval_human_torch, "FRAME_SIZE", FRAME)
    real_resize = cv2.resize
    monkeypatch.setattr(cv2, "resize", lambda img, size, **kw: real_resize(img, (FRAME, FRAME), **kw))
    seed, n = 3, 4
    keys, key = [], jax.random.PRNGKey(seed)
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    jrec, prec = Recorded(jp, to_jax(params)), Recorded(port)
    want, got = [], []
    jn = eval_human.run_stream(jrec, to_jax(params), FakeCap(n), display=False, seed=seed,
                               on_frame=lambda vis, kp: want.append((vis, np.asarray(kp))))
    pn = eval_human_torch.run_stream(
        prec, FakeCap(n), on_frame=lambda vis, kp: got.append((vis, kp)),
        noise=lambda i: policy_draws(keys[i], port.noise_shapes(1)))
    assert jn == pn == n and len(got) == len(want) == n
    for a, b in zip(prec.windows, jrec.windows):
        np.testing.assert_array_equal(a, b)
    assert prec.windows[0].shape == (1, 16, 3, FRAME, FRAME)
    for (vis, kp), (jvis, jkp) in zip(got, want):
        assert kp.shape == (14,)
        np.testing.assert_allclose(kp, jkp, rtol=0, atol=KP_ATOL)
        if np.array_equal(np.floor(kp.reshape(-1, 2) / 512 * [64, 48]),
                          np.floor(jkp.reshape(-1, 2) / 512 * [64, 48])):
            np.testing.assert_array_equal(vis, jvis)


def test_the_generator_route_is_seeded(pair):
    _, _, port = pair
    runs = []
    for _ in range(2):
        kps = []
        eval_human_torch.run_stream(port, FakeCap(3), seed=7,
                                    on_frame=lambda vis, kp: kps.append(kp))
        runs.append(np.stack(kps))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert eval_human_torch.run_stream(port, FakeCap(10), max_frames=2) == 2


@pytest.mark.parametrize("size", [(48, 64), (17, 23)])
def test_plot_keypoints_draws_cv2s_circles(size):
    rng = np.random.default_rng(sum(size))
    kps = np.concatenate([rng.uniform(0, 1, 10), [0.0, 0.0, 0.999, 0.999, -0.05, 0.5, 1.2, 0.3,
                                                  0.5, -0.1]])
    base = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    want = base.copy()
    h, w = size
    for x, y in kps.reshape(-1, 2):
        cv2.circle(want, (int(x * w), int(y * h)), 4, (0, 255, 0), -1)
    got = eval_human_torch.plot_keypoints(base.copy(), kps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eval_human.plot_keypoints(base.copy(), kps))


@pytest.mark.parametrize("size", [(48, 64), (480, 640), (96, 96)])
def test_preprocess_is_cv2s(size):
    frame = np.random.default_rng(1).integers(0, 256, (*size, 3), dtype=np.uint8)
    rgb = cv2.cvtColor(cv2.resize(frame, (96, 96)), cv2.COLOR_BGR2RGB)
    want = np.moveaxis(rgb.astype(np.float32) / 255.0, -1, 0)
    np.testing.assert_array_equal(eval_human_torch.preprocess(frame), want)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """A tiny human_pp run's slim export (train_torch.py on the CPU)."""
    import train_torch
    from tests.test_torch_human_pp import RUN, TINY
    from unified_video_action_tpu_torch.data.pusht_dataset import make_synthetic_pusht

    root = tmp_path_factory.mktemp("human")
    store = str(root / "human_replay.npz")
    make_synthetic_pusht(4, max_steps=40, seed=3, render_size=FRAME, agent_pos_dim=14).save(store)
    train_torch.main(["--config", "human_pp", "--device", "cpu", *TINY, *RUN,
                      "training.val_every=0", f"task.dataset.dataset_path={store}",
                      f"output_dir={root / 'run'}"])
    return str(root / "run" / "export")


def test_main_writes_a_gif_on_the_cpu(export, tmp_path, capsys):
    # few colors: the GIF keeps such frames losslessly
    levels = np.array([0, 85, 170, 255], np.uint8)
    frames = levels[np.random.default_rng(2).integers(0, 4, (5, 48, 64, 3))]
    src, out = str(tmp_path / "frames.npz"), str(tmp_path / "overlay.gif")
    np.savez(src, frames=frames)
    n = eval_human_torch.main(["-c", export, "--source", src, "--out", out, "--device", "cpu",
                               "--max-frames", "4"])
    assert n == 4 and "wrote 4 frames" in capsys.readouterr().out
    with Image.open(out) as im:
        assert im.n_frames == 4 and im.size == (64, 48)
        im.seek(0)
        first = np.asarray(im.convert("RGB"))
    # the GIF holds the overlaid frames in RGB (the capture's are BGR): the
    # first frame's pixels away from the circles are the capture's, reversed
    differ = (first != frames[0][..., ::-1]).any(axis=-1)
    assert 0 < differ.mean() < 0.5


def test_what_is_missing_is_named(export, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        eval_human_torch.load_policy(export, "cuda")
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        eval_human_torch.open_source("0")
    with pytest.raises(ImportError, match="OpenCV window.*cv2"):
        eval_human_torch._cv2("an OpenCV window")


def test_the_stages_are_timed(pair):
    _, _, port = pair
    timer = Timer("cpu")
    n = eval_human_torch.run_stream(port, FakeCap(3), timer=timer, seed=1)
    stats = timer.stats()
    assert n == 3 and sorted(stats) == ["overlay", "preprocess", "read", "request"]
    # the fourth read ends the stream
    assert {k: s["count"] for k, s in stats.items()} == {"read": 4, "preprocess": 3, "request": 3,
                                                        "overlay": 3}
    assert all(s["total_s"] >= 0 for s in stats.values())
    assert os.path.basename(eval_human_torch.__file__) == "eval_human_torch.py"
