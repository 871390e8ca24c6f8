"""Rotation representation conversions (the port's own copy of
``utils/rotation.py``, numpy only).

Equivalent of the reference's pytorch3d-derived ``RotationTransformer``
(model/common/rotation_transformer.py:8-108) and ``umi/common/pose_util.py``:
conversions between axis_angle / quaternion (wxyz) / euler / rotation_6d /
matrix, plus pose <-> mat and pose10d helpers used by the UMI pipeline.

Pure numpy functions (vectorized over leading dims): they run in the host
data pipeline.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _np(x):
    return np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# axis-angle <-> matrix / quaternion
# ---------------------------------------------------------------------------


def axis_angle_to_matrix(aa) -> np.ndarray:
    aa = _np(aa)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-8
    k = np.where(theta > 1e-8, aa / np.maximum(theta, 1e-30), 0.0)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + s * K + (1 - c) * (K @ K)
    R = np.where(small[..., None, None], eye, R)
    return R


def matrix_to_axis_angle(R) -> np.ndarray:
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def axis_angle_to_quaternion(aa) -> np.ndarray:
    aa = _np(aa)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    half = theta / 2
    # stable sinc for small angles
    sinc = np.where(theta > 1e-8, np.sin(half) / np.maximum(theta, 1e-30), 0.5)
    w = np.cos(half)
    xyz = aa * sinc
    return np.concatenate([w, xyz], axis=-1)


def quaternion_to_axis_angle(q) -> np.ndarray:
    q = _np(q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w = np.clip(q[..., :1], -1.0, 1.0)
    theta = 2 * np.arccos(w)
    s = np.sqrt(np.maximum(1 - w * w, 0.0))
    axis = np.where(s > 1e-8, q[..., 1:] / np.maximum(s, 1e-30), 0.0)
    return axis * theta


def quaternion_to_matrix(q) -> np.ndarray:
    q = _np(q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def matrix_to_quaternion(R) -> np.ndarray:
    """Shepperd's method, vectorized (wxyz)."""
    R = _np(R)
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q = np.empty(R.shape[:-2] + (4,))

    def case0():  # w largest
        s = np.sqrt(np.maximum(1 + tr, 0)) * 2
        return np.stack(
            [
                s / 4,
                (R[..., 2, 1] - R[..., 1, 2]) / np.maximum(s, 1e-30),
                (R[..., 0, 2] - R[..., 2, 0]) / np.maximum(s, 1e-30),
                (R[..., 1, 0] - R[..., 0, 1]) / np.maximum(s, 1e-30),
            ],
            axis=-1,
        )

    def case1():
        s = np.sqrt(np.maximum(1 + m00 - m11 - m22, 0)) * 2
        return np.stack(
            [
                (R[..., 2, 1] - R[..., 1, 2]) / np.maximum(s, 1e-30),
                s / 4,
                (R[..., 0, 1] + R[..., 1, 0]) / np.maximum(s, 1e-30),
                (R[..., 0, 2] + R[..., 2, 0]) / np.maximum(s, 1e-30),
            ],
            axis=-1,
        )

    def case2():
        s = np.sqrt(np.maximum(1 + m11 - m00 - m22, 0)) * 2
        return np.stack(
            [
                (R[..., 0, 2] - R[..., 2, 0]) / np.maximum(s, 1e-30),
                (R[..., 0, 1] + R[..., 1, 0]) / np.maximum(s, 1e-30),
                s / 4,
                (R[..., 1, 2] + R[..., 2, 1]) / np.maximum(s, 1e-30),
            ],
            axis=-1,
        )

    def case3():
        s = np.sqrt(np.maximum(1 + m22 - m00 - m11, 0)) * 2
        return np.stack(
            [
                (R[..., 1, 0] - R[..., 0, 1]) / np.maximum(s, 1e-30),
                (R[..., 0, 2] + R[..., 2, 0]) / np.maximum(s, 1e-30),
                (R[..., 1, 2] + R[..., 2, 1]) / np.maximum(s, 1e-30),
                s / 4,
            ],
            axis=-1,
        )

    c0, c1, c2, c3 = case0(), case1(), case2(), case3()
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = np.where(
        (tr > 0)[..., None],
        c0,
        np.where(cond1[..., None], c1, np.where(cond2[..., None], c2, c3)),
    )
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign: w >= 0
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# rotation 6d (Zhou et al.)
# ---------------------------------------------------------------------------


def matrix_to_rotation_6d(R) -> np.ndarray:
    """First two ROWS of R flattened (pytorch3d convention:
    matrix_to_rotation_6d takes R[..., :2, :])."""
    R = _np(R)
    return R[..., :2, :].reshape(R.shape[:-2] + (6,)).copy()


def rotation_6d_to_matrix(d6) -> np.ndarray:
    d6 = _np(d6)
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.linalg.norm(a1, axis=-1, keepdims=True)
    b2 = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-2)


# ---------------------------------------------------------------------------
# euler
# ---------------------------------------------------------------------------


def euler_to_matrix(angles, convention: str = "XYZ") -> np.ndarray:
    angles = _np(angles)
    R = None
    for i, axis in enumerate(convention):
        a = angles[..., i]
        c, s = np.cos(a), np.sin(a)
        one = np.ones_like(a)
        zero = np.zeros_like(a)
        if axis == "X":
            m = np.stack(
                [one, zero, zero, zero, c, -s, zero, s, c], axis=-1
            )
        elif axis == "Y":
            m = np.stack(
                [c, zero, s, zero, one, zero, -s, zero, c], axis=-1
            )
        else:
            m = np.stack(
                [c, -s, zero, s, c, zero, zero, zero, one], axis=-1
            )
        m = m.reshape(a.shape + (3, 3))
        R = m if R is None else R @ m
    return R


def matrix_to_euler(R, convention: str = "XYZ") -> np.ndarray:
    """Inverse of ``euler_to_matrix`` (intrinsic rotations in convention
    order — scipy's uppercase-seq semantics, which the euler tests pin)."""
    from scipy.spatial.transform import Rotation

    R = _np(R)
    flat = Rotation.from_matrix(R.reshape(-1, 3, 3))
    out = flat.as_euler(convention).reshape(R.shape[:-2] + (3,))
    return out


# ---------------------------------------------------------------------------
# RotationTransformer facade (reference API)
# ---------------------------------------------------------------------------

_TO_MATRIX = {
    "axis_angle": axis_angle_to_matrix,
    "quaternion": quaternion_to_matrix,
    "rotation_6d": rotation_6d_to_matrix,
    "matrix": lambda x: _np(x),
}
_FROM_MATRIX = {
    "axis_angle": matrix_to_axis_angle,
    "quaternion": matrix_to_quaternion,
    "rotation_6d": matrix_to_rotation_6d,
    "matrix": lambda x: x,
}


class RotationTransformer:
    """``forward(x)`` converts from_rep -> to_rep; ``inverse`` the reverse
    (reference model/common/rotation_transformer.py API)."""

    valid_reps = ("axis_angle", "euler_angles", "quaternion", "rotation_6d", "matrix")

    def __init__(self, from_rep: str = "axis_angle", to_rep: str = "rotation_6d",
                 from_convention: str = "XYZ", to_convention: str = "XYZ"):
        self.from_rep, self.to_rep = from_rep, to_rep
        self.from_convention, self.to_convention = from_convention, to_convention

    def _to_mat(self, x, rep, convention):
        if rep == "euler_angles":
            return euler_to_matrix(x, convention)
        return _TO_MATRIX[rep](x)

    def _from_mat(self, R, rep, convention):
        if rep == "euler_angles":
            return matrix_to_euler(R, convention)
        return _FROM_MATRIX[rep](R)

    def forward(self, x):
        R = self._to_mat(x, self.from_rep, self.from_convention)
        out = self._from_mat(R, self.to_rep, self.to_convention)
        return out.astype(np.float32)

    def inverse(self, x):
        R = self._to_mat(x, self.to_rep, self.to_convention)
        out = self._from_mat(R, self.from_rep, self.from_convention)
        return out.astype(np.float32)
