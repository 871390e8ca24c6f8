"""SLAM trajectory evaluation (the port's copy of ``utils/traj_eval.py``):
Umeyama similarity alignment and the absolute and relative trajectory
errors of position tracks, in float64 numpy, as the UMI data pipeline's
check of SLAM tracks before training."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray,
                      with_scale: bool = True) -> Tuple[np.ndarray, np.ndarray, float]:
    """The similarity (R (3, 3), t (3,), s) minimizing ||y - (s R x + t)||²
    over (N, 3) point sets ``x`` (estimated) and ``y`` (ground truth)
    (Umeyama 1991)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != y.shape or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"two (N, 3) point sets, got {x.shape} and {y.shape}")
    n = x.shape[0]
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    U, d, Vt = np.linalg.svd(yc.T @ xc / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / ((xc ** 2).sum() / n)) if with_scale else 1.0
    return R, my - s * R @ mx, s


def ate(est: np.ndarray, gt: np.ndarray, align: bool = True,
        with_scale: bool = True) -> Dict[str, float]:
    """Absolute trajectory error of (N, 3) tracks, ``est`` aligned onto
    ``gt`` first under ``align`` (monocular SLAM: the scale is not
    observable): rmse, mean, median, max."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale=with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return {"rmse": float(np.sqrt((err ** 2).mean())), "mean": float(err.mean()),
            "median": float(np.median(err)), "max": float(err.max())}


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> Dict[str, float]:
    """Relative pose error of (N, 3) tracks: each displacement over
    ``delta`` frames against the ground truth's (the translation part):
    rmse, mean, max."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.linalg.norm((est[delta:] - est[:-delta]) - (gt[delta:] - gt[:-delta]), axis=1)
    return {"rmse": float(np.sqrt((err ** 2).mean())), "mean": float(err.mean()),
            "max": float(err.max())}
