"""Headless software rendering of mujoco scenes (the port's own copy of the
JAX package's ``envs/render3d.py``: the tessellation at :79-173,
``SceneRenderer`` at :175-362 and ``_raster_numpy`` at :364-410).

Hosts without a GL stack cannot run mujoco's own ``Renderer``, yet every
image-conditioned policy needs RGB observations. This module renders
mjModel/mjData scenes from scratch:

* geoms (plane, box, sphere, cylinder, capsule, mesh) are tessellated once
  into a triangle soup in geom-local coordinates;
* each frame transforms the vertices world -> camera with one einsum over
  ``geom_xpos`` / ``geom_xmat``;
* the z-buffer rasterizer of ``native/raster3d.cpp`` clips, projects and
  flat-shades. It is built with ``g++`` at first use into
  ``build/raster3d/`` at the repository root (listed in ``.gitignore``),
  under a name keyed by a hash of the source and the flags, as
  ``ipc/shm.py`` builds ``native/shm_ipc.cpp``: nothing is written into
  ``native/``, and a failed build raises with the compiler's output.
  ``_raster_numpy`` is the same rasterizer in numpy (it skips a triangle
  that touches the near plane, where the native one clips it; on the soup
  of ``clip_near_plane`` it draws what the native one draws): the tests'
  oracle.

``mujoco`` is imported only inside the functions that read a model. The
float32 arithmetic follows the JAX package's order, so frames compare bit
for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SRC_PATH = REPO / "native" / "raster3d.cpp"
BUILD_DIR = REPO / "build" / "raster3d"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current ``native/raster3d.cpp`` lives."""
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(SRC_PATH.read_bytes())
    return BUILD_DIR / f"libraster3d-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile ``native/raster3d.cpp`` unless it is built already. Returns
    the seconds the build took (0.0 where the library was there). Raises
    with the compiler's output on a failure."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC_PATH), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC_PATH} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds


def get_lib() -> ctypes.CDLL:
    """The loaded rasterizer, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(library_path()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.uva_raster3d.restype = None
    lib.uva_raster3d.argtypes = [
        f32p, ctypes.c_int32, i32p, f32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p, ctypes.c_float, ctypes.c_float,
        u8p, u8p, f32p,
    ]
    _lib = lib
    return _lib


def raster(cam, faces, face_rgb, H, W, fx, fy, cx, cy, znear, light, ambient, diffuse,
           background, rgb: Optional[np.ndarray] = None,
           zbuf: Optional[np.ndarray] = None) -> np.ndarray:
    """The native rasterizer on camera-frame vertices ``cam`` (n, 3) float32
    (+z forward, +y down), ``faces`` (m, 3) int32 and ``face_rgb`` (m, 3)
    float32 in [0, 1]: an (H, W, 3) uint8 frame (``rgb``, written in place
    where given), the arguments as ``_raster_numpy`` takes them."""
    rgb = np.empty((H, W, 3), np.uint8) if rgb is None else rgb
    zbuf = np.empty((H, W), np.float32) if zbuf is None else zbuf
    get_lib().uva_raster3d(
        cam, np.int32(len(cam)), faces, face_rgb, np.int32(len(faces)), np.int32(H), np.int32(W),
        np.float32(fx), np.float32(fy), np.float32(cx), np.float32(cy), np.float32(znear),
        light, np.float32(ambient), np.float32(diffuse), np.ascontiguousarray(background),
        rgb, zbuf)
    return rgb


# ---------------------------------------------------------------------------
# primitive tessellation (geom-local coordinates, mujoco size conventions)
# ---------------------------------------------------------------------------

def _box(size) -> Tuple[np.ndarray, np.ndarray]:
    sx, sy, sz = [float(s) for s in size[:3]]
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy) for z in (-sz, sz)], np.float32)
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return v, f


def _uv_sphere(radius: float, stacks: int = 8, slices: int = 12, z_scale: float = 1.0,
               z_off: float = 0.0, phi0: float = -np.pi / 2, phi1: float = np.pi / 2):
    """UV-sphere section between latitudes [phi0, phi1] (radians)."""
    phis = np.linspace(phi0, phi1, stacks + 1)
    thetas = np.linspace(0, 2 * np.pi, slices, endpoint=False)
    verts = []
    for phi in phis:
        c, s = np.cos(phi), np.sin(phi)
        for th in thetas:
            verts.append([radius * c * np.cos(th), radius * c * np.sin(th),
                          radius * s * z_scale + z_off])
    v = np.asarray(verts, np.float32)
    faces = []
    for i in range(stacks):
        for j in range(slices):
            a = i * slices + j
            b = i * slices + (j + 1) % slices
            c2 = (i + 1) * slices + j
            d = (i + 1) * slices + (j + 1) % slices
            faces.append([a, b, d])
            faces.append([a, d, c2])
    return v, np.asarray(faces, np.int32)


def _sphere(size):
    return _uv_sphere(float(size[0]))


def _cylinder(size, slices: int = 12):
    r, hl = float(size[0]), float(size[1])
    thetas = np.linspace(0, 2 * np.pi, slices, endpoint=False)
    ring = np.stack([r * np.cos(thetas), r * np.sin(thetas)], -1)
    bot = np.concatenate([ring, np.full((slices, 1), -hl, np.float32)], -1)
    top = np.concatenate([ring, np.full((slices, 1), hl, np.float32)], -1)
    v = np.concatenate([bot, top, [[0, 0, -hl]], [[0, 0, hl]]], 0).astype(np.float32)
    cb, ct = 2 * slices, 2 * slices + 1
    faces = []
    for j in range(slices):
        jn = (j + 1) % slices
        faces += [[j, jn, slices + jn], [j, slices + jn, slices + j]]
        faces += [[cb, jn, j], [ct, slices + j, slices + jn]]
    return v, np.asarray(faces, np.int32)


def _capsule(size, slices: int = 12, stacks: int = 4):
    r, hl = float(size[0]), float(size[1])
    vc, fc = _cylinder(size, slices)
    vc = vc[:-2]  # drop the cap centres; keep the side quads only
    fc = fc.reshape(-1, 3)
    fc = fc[(fc < 2 * slices).all(axis=1)]
    vt, ft = _uv_sphere(r, stacks, slices, z_off=hl, phi0=0)
    vb, fb = _uv_sphere(r, stacks, slices, z_off=-hl, phi1=0)
    v = np.concatenate([vc, vt, vb], 0)
    f = np.concatenate([fc, ft + len(vc), fb + len(vc) + len(vt)], 0)
    return v.astype(np.float32), f.astype(np.int32)


def _plane(size, default_extent: float = 10.0):
    sx = float(size[0]) or default_extent
    sy = float(size[1]) or default_extent
    v = np.array([[-sx, -sy, 0], [sx, -sy, 0], [sx, sy, 0], [-sx, sy, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


#: the low-poly unit sphere of the markers injected at render time
_MARKER_SPHERE = _uv_sphere(1.0, stacks=6, slices=8)
#: the light direction, ambient and diffuse weights and near plane of every frame
_LIGHT = (0.25, -0.55, 0.8)
_AMBIENT, _DIFFUSE, _ZNEAR = 0.45, 0.55, 0.02


# ---------------------------------------------------------------------------
# scene extraction
# ---------------------------------------------------------------------------

class SceneRenderer:
    """Render an mjModel/mjData scene to HWC uint8 frames.

    ``camera`` may be a mujoco camera name, an int camera id, a dict
    ``{"eye": [3], "target": [3], "fovy": deg}`` free camera, or None
    (the model's first camera if any, else a free camera framing
    ``model.stat``).
    """

    def __init__(self, model, height: int = 96, width: int = 96,
                 camera: Union[str, int, dict, None] = None,
                 groups: Tuple[int, ...] = (0, 1, 2), background=(28, 32, 40)):
        import mujoco

        self.model = model
        self.height, self.width = int(height), int(width)
        self.camera = camera
        self.background = np.asarray(background, np.uint8)

        verts, faces, face_rgb, vert_geom = [], [], [], []
        nv = 0
        for g in range(model.ngeom):
            rgba = model.geom_rgba[g].copy()
            matid = int(model.geom_matid[g])
            # the material's colour unless the geom sets its own
            if matid >= 0 and np.allclose(rgba[:3], 0.5) and rgba[3] == 1.0:
                rgba = model.mat_rgba[matid].copy()
            if rgba[3] <= 0.25:  # invisible and debug geoms (no alpha blending here)
                continue
            if int(model.geom_group[g]) not in groups:
                continue
            t = int(model.geom_type[g])
            size = model.geom_size[g]
            if t == mujoco.mjtGeom.mjGEOM_PLANE:
                v, f = _plane(size)
            elif t == mujoco.mjtGeom.mjGEOM_SPHERE:
                v, f = _sphere(size)
            elif t == mujoco.mjtGeom.mjGEOM_CAPSULE:
                v, f = _capsule(size)
            elif t == mujoco.mjtGeom.mjGEOM_CYLINDER:
                v, f = _cylinder(size)
            elif t == mujoco.mjtGeom.mjGEOM_BOX:
                v, f = _box(size)
            elif t == mujoco.mjtGeom.mjGEOM_MESH:
                mid = int(model.geom_dataid[g])
                va, vn = int(model.mesh_vertadr[mid]), int(model.mesh_vertnum[mid])
                fa, fn = int(model.mesh_faceadr[mid]), int(model.mesh_facenum[mid])
                v = np.asarray(model.mesh_vert[va: va + vn], np.float32)
                f = np.asarray(model.mesh_face[fa: fa + fn], np.int32)
            else:  # ellipsoid, hfield, sdf: a coarse box
                v, f = _box(np.maximum(size, 1e-4))
            verts.append(v)
            faces.append(f + nv)
            face_rgb.append(np.tile(rgba[:3].astype(np.float32), (len(f), 1)))
            vert_geom.append(np.full(len(v), g, np.int32))
            nv += len(v)

        self.local_verts = np.concatenate(verts, 0) if verts else np.zeros((0, 3), np.float32)
        self.faces = (np.ascontiguousarray(np.concatenate(faces, 0)) if faces
                      else np.zeros((0, 3), np.int32))
        self.face_rgb = (np.ascontiguousarray(np.concatenate(face_rgb, 0)) if face_rgb
                         else np.zeros((0, 3), np.float32))
        self.vert_geom = np.concatenate(vert_geom, 0) if vert_geom else np.zeros(0, np.int32)
        self._zbuf = np.empty((self.height, self.width), np.float32)
        self._rgb = np.empty((self.height, self.width, 3), np.uint8)

    # -- cameras ------------------------------------------------------------

    def _camera_pose(self, data, camera):
        """-> (eye [3], R world->cam columns [x right, y up, z backward], fovy)."""
        import mujoco

        model = self.model
        if camera is None:
            camera = 0 if model.ncam > 0 else self._auto_camera()
        if isinstance(camera, str):
            camera = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_CAMERA, camera)
            if camera < 0:
                raise KeyError("unknown camera")
        if isinstance(camera, dict):
            eye = np.asarray(camera["eye"], np.float64)
            target = np.asarray(camera["target"], np.float64)
            fovy = float(camera.get("fovy", 45.0))
            fwd = target - eye
            fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
            up_w = np.asarray(camera.get("up", [0.0, 0.0, 1.0]), np.float64)
            right = np.cross(fwd, up_w)
            right /= np.linalg.norm(right) + 1e-12
            up = np.cross(right, fwd)
            R = np.stack([right, up, -fwd], axis=1)  # mujoco's camera convention
            return eye, R, fovy
        cid = int(camera)
        eye = np.asarray(data.cam_xpos[cid], np.float64)
        R = np.asarray(data.cam_xmat[cid], np.float64).reshape(3, 3)
        return eye, R, float(self.model.cam_fovy[cid])

    def _auto_camera(self) -> dict:
        center = np.asarray(self.model.stat.center, np.float64)
        extent = float(self.model.stat.extent)
        eye = center + extent * np.array([0.9, -1.1, 0.7])
        return {"eye": eye, "target": center, "fovy": 45.0}

    # -- rendering ----------------------------------------------------------

    def render(self, data, camera=None, markers=()) -> np.ndarray:
        """The scene as an (H, W, 3) uint8 frame; ``markers`` is a sequence
        of ``{"pos": [3], "size": r, "rgba": [3 or 4]}`` world-space spheres
        (e.g. goal sites, which are not geoms)."""
        if len(self.faces) == 0 and not markers:
            img = np.empty((self.height, self.width, 3), np.uint8)
            img[:] = self.background
            return img
        eye, R, fovy = self._camera_pose(data, camera or self.camera)

        gx = np.asarray(data.geom_xmat, np.float32).reshape(-1, 3, 3)
        gp = np.asarray(data.geom_xpos, np.float32)
        world = np.einsum("nij,nj->ni", gx[self.vert_geom], self.local_verts) + gp[self.vert_geom]
        faces, face_rgb = self.faces, self.face_rgb
        if markers:
            mv, mf, mc = [world], [faces], [face_rgb]
            nv = len(world)
            sv, sf = _MARKER_SPHERE
            for mk in markers:
                r = float(mk.get("size", 0.02))
                mv.append(sv * r + np.asarray(mk["pos"], np.float32))
                mf.append(sf + nv)
                mc.append(np.tile(np.asarray(mk["rgba"][:3], np.float32), (len(sf), 1)))
                nv += len(sv)
            world = np.concatenate(mv, 0)
            faces = np.ascontiguousarray(np.concatenate(mf, 0))
            face_rgb = np.ascontiguousarray(np.concatenate(mc, 0))
        # world -> camera (x right, y up, -z forward) -> the render frame
        # (+z forward, +y down, as image rows run)
        cam = (world - eye.astype(np.float32)) @ R.astype(np.float32)
        cam[:, 1] *= -1.0
        cam[:, 2] *= -1.0
        cam = np.ascontiguousarray(cam, np.float32)

        H, W = self.height, self.width
        fy = 0.5 * H / np.tan(np.deg2rad(fovy) / 2)
        light = np.asarray(_LIGHT, np.float32)
        light /= np.linalg.norm(light)
        raster(cam, faces, face_rgb, H, W, fy, fy, W / 2.0, H / 2.0, _ZNEAR, light, _AMBIENT,
               _DIFFUSE, self.background, self._rgb, self._zbuf)
        return self._rgb.copy()


def clip_near_plane(cam: np.ndarray, faces: np.ndarray, face_rgb: np.ndarray, znear: float):
    """The triangle soup clipped against z = ``znear`` as the native
    rasterizer clips it (Sutherland-Hodgman on one plane, the polygon
    fan-triangulated from its first vertex): ``(cam, faces, face_rgb)``
    that ``_raster_numpy`` draws as the native one draws the input."""
    verts, out_faces, cols = [np.asarray(cam, np.float32)], [], []
    n = len(cam)
    z0 = np.float32(znear)
    for t, face in enumerate(faces):
        tri = cam[face]
        if (tri[:, 2] >= z0).all():
            out_faces.append(face)
            cols.append(face_rgb[t])
            continue
        poly = []
        for i in range(3):
            a, b = tri[i], tri[(i + 1) % 3]
            if a[2] >= z0:
                poly.append(a)
            if (a[2] >= z0) != (b[2] >= z0):
                s = (z0 - a[2]) / (b[2] - a[2])
                poly.append(np.array([a[0] + s * (b[0] - a[0]), a[1] + s * (b[1] - a[1]), z0],
                                     np.float32))
        for i in range(2, len(poly)):
            out_faces.append([n, n + i - 1, n + i])
            cols.append(face_rgb[t])
        if poly:
            verts.append(np.stack(poly).astype(np.float32))
            n += len(poly)
    return (np.concatenate(verts, 0), np.asarray(out_faces, np.int32).reshape(-1, 3),
            np.asarray(cols, np.float32).reshape(-1, 3))


def _raster_numpy(cam, faces, face_rgb, H, W, fx, fy, cx, cy, znear, light, ambient, diffuse,
                  background) -> np.ndarray:
    """The rasterizer in numpy, with the native one's sampling and shading
    (slow: the tests' oracle)."""
    rgb = np.empty((H, W, 3), np.uint8)
    rgb[:] = background
    zbuf = np.full((H, W), np.inf, np.float32)
    tri = cam[faces]  # [nt, 3, 3]
    # skip the triangles that touch the near plane (this version draws the
    # all-in-front case; the native one clips)
    keep = (tri[:, :, 2] >= znear).all(axis=1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    shade = ambient + diffuse * np.abs((n / np.maximum(nn, 1e-12)) @ light)
    cols = np.clip(face_rgb * shade[:, None], 0, 1)
    iz = 1.0 / tri[:, :, 2]
    px = cx + fx * tri[:, :, 0] * iz
    py = cy + fy * tri[:, :, 1] * iz
    for t in np.nonzero(keep)[0]:
        x0 = max(0, int(np.floor(px[t].min())))
        x1 = min(W - 1, int(np.ceil(px[t].max())))
        y0 = max(0, int(np.floor(py[t].min())))
        y1 = min(H - 1, int(np.ceil(py[t].max())))
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = px[t, 1] - px[t, 0], py[t, 1] - py[t, 0]
        bx, by = px[t, 2] - px[t, 0], py[t, 2] - py[t, 0]
        area = ax * by - ay * bx
        if abs(area) < 1e-9:
            continue
        ys, xs = np.mgrid[y0: y1 + 1, x0: x1 + 1]
        pxc, pyc = xs + 0.5, ys + 0.5
        w0 = ((px[t, 1] - pxc) * (py[t, 2] - pyc) - (py[t, 1] - pyc) * (px[t, 2] - pxc)) / area
        w1 = ((px[t, 2] - pxc) * (py[t, 0] - pyc) - (py[t, 2] - pyc) * (px[t, 0] - pxc)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = 1.0 / (w0 * iz[t, 0] + w1 * iz[t, 1] + w2 * iz[t, 2])
        zwin = zbuf[y0: y1 + 1, x0: x1 + 1]
        upd = inside & (z < zwin)
        zwin[upd] = z[upd]
        rgb[y0: y1 + 1, x0: x1 + 1][upd] = (cols[t] * 255).astype(np.uint8)
    return rgb
