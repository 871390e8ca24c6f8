"""The port's PushT env against the JAX package's, on the CPU.

- Physics: the same seeds and a seeded action sequence give bit-equal
  observations (agent position and block pose), rewards, ``done`` and infos:
  the port's ``envs/physics2d.py`` is a copy, and ``reset``/``step`` keep the
  JAX code.
- Frames: the port draws with ``envs/raster.py`` (numpy), the JAX env with
  OpenCV. Held on 240 frames of seeded rollouts at 512 px and at 96 px: the
  bound is at most 0.5 % of a 96 px frame's uint8 values differing and a mean
  |d| of at most 1 level on every frame; measured: 0 values differ on every
  frame at both sizes (bit-equal).
- The primitives against OpenCV itself on random shapes inside the canvas,
  and ``resize_linear_u8`` against ``cv2.resize`` on random images:
  bit-equal.
"""

import cv2
import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.envs.pusht import PushTEnv as JaxStateEnv
from unified_video_action_tpu.envs.pusht import PushTImageEnv as JaxEnv
from unified_video_action_tpu_torch.envs import raster
from unified_video_action_tpu_torch.envs.pusht import PushTEnv, PushTImageEnv

SEEDS = (100000, 100001, 100002, 7)
STEPS = 60
MAX_DIFF_SHARE = 0.005
MAX_MEAN_LEVELS = 1.0


def _actions(seed, start, n):
    """A seeded walk of agent targets that pushes the block now and then."""
    rng = np.random.default_rng(seed)
    goal = start + rng.normal(0, 60, (n, 2)).cumsum(axis=0) / np.sqrt(np.arange(1, n + 1))[:, None]
    return np.clip(goal, 0, 512)


def _rollout_pairs(seed, legacy):
    jax_env, port_env = JaxEnv(legacy=legacy), PushTImageEnv(legacy=legacy)
    jax_env.seed(seed)
    port_env.seed(seed)
    jo, _ = jax_env.reset()
    po, _ = port_env.reset()
    yield jax_env, port_env, (jo, None, False, None), (po, None, False, None)
    for a in _actions(seed, jo["agent_pos"].astype(np.float64), STEPS):
        j = jax_env.step(a)
        p = port_env.step(a)
        yield jax_env, port_env, j[:3] + (j[4],), p[:3] + (p[4],)


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_physics_is_bit_equal(seed, legacy):
    for _, _, (jo, jr, jd, ji), (po, pr, pd, pi) in _rollout_pairs(seed, legacy):
        np.testing.assert_array_equal(po["agent_pos"], jo["agent_pos"])
        assert pr == jr and pd == jd
        if ji is not None:
            assert ji.keys() == pi.keys()
            for k in ji:
                np.testing.assert_array_equal(pi[k], ji[k])


def test_state_env_is_bit_equal():
    jax_env, port_env = JaxStateEnv(), PushTEnv(render_action=False)
    for env in (jax_env, port_env):
        env.seed(3)
    np.testing.assert_array_equal(port_env.reset()[0], jax_env.reset()[0])
    for a in _actions(3, np.array([256.0, 256.0]), 40):
        j, p = jax_env.step(a), port_env.step(a)
        np.testing.assert_array_equal(p[0], j[0])
        assert p[1:3] == j[1:3]


def test_frames_are_bit_equal_at_512_and_96_px():
    n, worst = 0, {96: 0.0, 512: 0.0}
    for seed in SEEDS:
        for jax_env, port_env, (jo, *_), (po, *_) in _rollout_pairs(seed, legacy=True):
            for size in (96, 512):
                jax_env.render_size = port_env.render_size = size
                want = jax_env._render_frame("rgb_array")
                got = port_env._render_frame("rgb_array")
                assert got.shape == want.shape == (size, size, 3) and got.dtype == np.uint8
                d = np.abs(got.astype(np.int16) - want)
                assert (d > 0).mean() <= MAX_DIFF_SHARE and d.mean() <= MAX_MEAN_LEVELS
                worst[size] = max(worst[size], (d > 0).mean())
            jax_env.render_size = port_env.render_size = 96
            np.testing.assert_array_equal(po["image"], jo["image"])
            n += 1
    assert n >= 200
    assert worst == {96: 0.0, 512: 0.0}, worst


def test_the_image_env_leaves_out_the_action_marker():
    # the observed frame has no marker; render() and the state env's frame
    # draw it (envs/raster.draw_marker_cross), as JAX's cv2.drawMarker does
    env, jax_env = PushTImageEnv(), JaxEnv()
    for e in (env, jax_env):
        e.seed(0)
        e.reset()
    np.testing.assert_array_equal(env.render(), jax_env.render())
    obs = env.step(np.array([100.0, 100.0]))[0]
    jax_env.step(np.array([100.0, 100.0]))
    frame = env.render()
    np.testing.assert_array_equal(frame, jax_env.render())
    marker = (frame == (255, 0, 0)).all(-1)
    assert marker.any()
    assert not (np.moveaxis(obs["image"], 0, -1) * 255 == (255, 0, 0)).all(-1)[marker].all()
    state_env, jax_state_env = PushTEnv(), JaxStateEnv()
    for e in (state_env, jax_state_env):
        e.seed(0)
        e.reset()
    np.testing.assert_array_equal(state_env.render(), jax_state_env.render())  # no action yet
    state_env.step(np.array([100.0, 100.0]))
    jax_state_env.step(np.array([100.0, 100.0]))
    np.testing.assert_array_equal(state_env.render(), jax_state_env.render())


def _random_rectangle(rng):
    ang = rng.uniform(0, 2 * np.pi)
    c = rng.uniform(140, 370, 2)
    w, h = rng.uniform(1, 130, 2)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    return np.array([(-w / 2, h / 2), (w / 2, h / 2), (w / 2, -h / 2), (-w / 2, -h / 2)]) @ rot.T + c


def test_fill_poly_equals_opencv():
    rng = np.random.default_rng(0)
    for i in range(300):
        v = _random_rectangle(rng) if i % 3 else rng.uniform(0, 511, (rng.integers(3, 8), 2))
        pts = np.round(v).astype(np.int32)
        want = np.full((512, 512, 3), 255, np.uint8)
        got = want.copy()
        cv2.fillPoly(want, [pts.reshape(-1, 1, 2)], (10, 20, 30))
        raster.fill_poly(got, pts, (10, 20, 30))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_circles_and_thick_lines_equal_opencv():
    rng = np.random.default_rng(1)
    for i in range(200):
        want = np.full((512, 512, 3), 255, np.uint8)
        got = want.copy()
        center, radius = rng.integers(-20, 530, 2), int(rng.integers(0, 40))
        cv2.circle(want, tuple(int(x) for x in center), radius, (1, 2, 3), -1)
        raster.fill_circle(got, center, radius, (1, 2, 3))
        p0, p1 = rng.integers(10, 500, 2), rng.integers(10, 500, 2)
        if i % 2:
            p1[0] = p0[0]  # the walls are axis-aligned
        thickness = int(rng.integers(2, 9))
        cv2.line(want, tuple(int(x) for x in p0), tuple(int(x) for x in p1), (4, 5, 6), thickness)
        raster.thick_line(got, p0, p1, (4, 5, 6), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{center} {radius} {p0} {p1} {thickness}")


@pytest.mark.parametrize("shape,size", [((512, 512, 3), (96, 96)), ((512, 512), (96, 96)),
                                        ((100, 100, 3), (37, 37)), ((64, 80, 3), (30, 20)),
                                        ((200, 300, 3), (96, 96)), ((96, 96, 3), (96, 96))])
def test_resize_linear_u8_equals_opencv(shape, size):
    rng = np.random.default_rng(2)
    for _ in range(3):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(raster.resize_linear_u8(img, size), cv2.resize(img, size))
