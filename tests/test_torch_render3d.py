"""The port's software renderer (``envs/render3d.py``) against the JAX
package's, on the CPU.

- The rasterizer: the port's native build of ``native/raster3d.cpp`` against
  the port's and JAX's ``_raster_numpy`` on the three fixed scenes of JAX's
  ``tests/test_kitchen_env.py:26-122`` (one triangle, z-buffer occlusion in
  both drawing orders, near-plane clipping), held to JAX's own rule: at
  least 99.5 % of the pixels equal, and the lit pixels where JAX's tests
  expect them. The numpy rasterizer skips a triangle that touches the near
  plane (the native one clips it), so on the clipping scene it draws the
  soup of ``clip_near_plane``; measured here: every pixel equal on all three
  scenes, and the port's frames bit-equal to those of JAX's library.
- The build: into ``build/raster3d/`` under a name keyed by the source and
  the flags, nothing written under ``native/``; a source that does not
  compile raises with g++'s output (JAX's ``get_lib`` falls back to numpy).
- ``SceneRenderer``: the tessellation, the camera poses and the frames of
  the Fetch scene bit-equal to JAX's, markers included (the kitchen's in
  ``tests/test_torch_kitchen_env.py``).
"""

import os

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.envs import render3d as jr
from unified_video_action_tpu_torch.envs import render3d as pr

EQUAL_SHARE = 0.995  # JAX's own rule (tests/test_kitchen_env.py:52)
BLACK = np.zeros(3, np.uint8)
LIGHT = np.array([0.0, 0.0, 1.0], np.float32)

# (cam, faces, colours, size, focal, ambient, diffuse), as JAX's tests draw them
SCENES = {
    "one_triangle": ([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.6, 2.0]], [[0, 1, 2]],
                     [[1.0, 0.2, 0.1]], 64, 60.0, 0.5, 0.5),
    "zbuffer_occlusion": ([[-1, -1, 2.0], [1, -1, 2.0], [0, 1, 2.0], [-1, -1, 4.0], [1, -1, 4.0],
                           [0, 1, 4.0]], [[0, 1, 2], [3, 4, 5]], [[1, 0, 0], [0, 1, 0]], 48, 40.0,
                          1.0, 0.0),
    "near_plane_clipping": ([[-1, 0, -1.0], [1, -0.5, 2.0], [1, 0.5, 2.0]], [[0, 1, 2]],
                            [[1, 1, 1]], 48, 40.0, 1.0, 0.0),
}


def _jax_native(cam, faces, rgb, args):
    H, W, fx, fy, cx, cy, znear, light, ambient, diffuse, bg = args
    out, zbuf = np.empty((H, W, 3), np.uint8), np.empty((H, W), np.float32)
    jr.get_lib().uva_raster3d(cam, np.int32(len(cam)), faces, rgb, np.int32(len(faces)),
                              np.int32(H), np.int32(W), np.float32(fx), np.float32(fy),
                              np.float32(cx), np.float32(cy), np.float32(znear), light,
                              np.float32(ambient), np.float32(diffuse), bg, out, zbuf)
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_native_rasterizer_against_numpy_on_jax_scenes(name):
    cam, faces, rgb, size, focal, ambient, diffuse = SCENES[name]
    cam, faces, rgb = (np.asarray(cam, np.float32), np.asarray(faces, np.int32),
                       np.asarray(rgb, np.float32))
    args = (size, size, focal, focal, size / 2, size / 2, 0.02, LIGHT, ambient, diffuse, BLACK)
    for order in (([0, 1], [1, 0]) if len(faces) == 2 else ([0],)):
        f, c = np.ascontiguousarray(faces[order]), np.ascontiguousarray(rgb[order])
        got = pr.raster(cam, f, c, *args)
        np.testing.assert_array_equal(got, _jax_native(cam, f, c, args))
        soup = pr.clip_near_plane(cam, f, c, 0.02)
        want = pr._raster_numpy(*soup, *args)
        np.testing.assert_array_equal(want, jr._raster_numpy(*soup, *args))
        share = (got == want).mean()
        print(f"{name} order {order}: {share:.4f} of the pixels equal")
        assert share >= EQUAL_SHARE
        centre = got[size // 2, size // 2]
        if name == "one_triangle":
            assert got[:, :, 0].max() == 255 and centre[0] > 0 and (got[0, 0] == 0).all()
            np.testing.assert_array_equal(pr._raster_numpy(cam, f, c, *args), want)
        elif name == "zbuffer_occlusion":
            assert centre[0] > 200 and centre[1] == 0  # the near red wins in either order
        else:
            assert got.max() == 255  # the part in front survives clipping
            # the numpy rasterizer alone skips the clipped triangle
            assert pr._raster_numpy(cam, f, c, *args).max() == 0


def test_the_build_goes_under_build_and_leaves_native_alone():
    native = os.path.dirname(pr.SRC_PATH)
    before = sorted(os.listdir(native))
    pr.build()
    lib = pr.library_path()
    assert lib.exists() and lib.parent == pr.REPO / "build" / "raster3d"
    assert lib.name.startswith("libraster3d-") and sorted(os.listdir(native)) == before
    assert pr.build() == 0.0  # built once


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "raster3d.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(pr, "SRC_PATH", src)
    monkeypatch.setattr(pr, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pr.build()
    assert not any((tmp_path / "build").iterdir())


@pytest.mark.parametrize("size", [(6, 4), (0.05, 0.2), (0.3, 0.0, 0.1)])
def test_tessellation_equals_jax(size):
    for fn in ("_box", "_sphere", "_cylinder", "_capsule", "_plane"):
        if fn == "_box" and len(size) < 3:
            continue
        for got, want in zip(getattr(pr, fn)(size), getattr(jr, fn)(size)):
            np.testing.assert_array_equal(got, want, err_msg=fn)
    for got, want in zip(pr._MARKER_SPHERE, jr._MARKER_SPHERE):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fetch_model():
    gym = pytest.importorskip("gymnasium")
    gymnasium_robotics = pytest.importorskip("gymnasium_robotics")

    gym.register_envs(gymnasium_robotics)
    env = gym.make("FetchPickAndPlace-v4")
    env.reset(seed=3)
    yield env.unwrapped
    env.close()


def test_scene_renderer_equals_jax(fetch_model):
    """The Fetch scene from two free cameras and the model's first camera,
    with a marker: the geom soup and every frame bit-equal to JAX's."""
    m, d = fetch_model.model, fetch_model.data
    cams = [{"eye": [1.95, 0.40, 0.95], "target": [1.33, 0.78, 0.42], "fovy": 45.0},
            {"eye": [0.5, -0.3, 1.5], "target": [1.3, 0.75, 0.4], "fovy": 60.0, "up": [0, 0, 1]}]
    for cam in cams + [None]:
        port = pr.SceneRenderer(m, height=40, width=56, camera=cam)
        jax_ = jr.SceneRenderer(m, height=40, width=56, camera=cam)
        for k in ("local_verts", "faces", "face_rgb", "vert_geom"):
            np.testing.assert_array_equal(getattr(port, k), getattr(jax_, k), err_msg=k)
        markers = [{"pos": [1.3, 0.8, 0.5], "size": 0.05, "rgba": [0.1, 0.8, 0.2]}]
        for mk in ((), markers):
            got = port.render(d, markers=mk)
            np.testing.assert_array_equal(got, jax_.render(d, markers=mk))
            assert got.shape == (40, 56, 3) and len(np.unique(got)) > 10
