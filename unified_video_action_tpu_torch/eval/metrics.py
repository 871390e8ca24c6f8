"""Offline evaluation metrics (the port's own copy of ``eval/metrics.py``,
numpy only): ``action_l2`` (:23), ``frechet_distance`` (:30),
``pixel_embeddings`` (:46), ``vae_latent_embeddings`` (:60),
``get_video_embedder`` (:80) and ``video_fvd`` (:91).

The Fréchet distance is the reference's (fvd/fvd.py:54-115): gaussians fit to
two embedding sets, the trace of the matrix square root of the product of
their covariances taken as a nuclear norm (``frechet_distance`` says why). The video embedder is the
Kinetics-400 I3D (``eval/i3d.py``) where its weights file exists; without it,
per-video pooled pixel statistics, and the metric is named
``video_fvd_pixel`` instead of ``video_fvd``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


def action_l2(pred: np.ndarray, target: np.ndarray, n_dims: int = 9) -> float:
    """RMSE over the first min(n_dims, A) action dims (eval/eval.py:364-368)."""
    n = min(pred.shape[-1], n_dims)
    d = pred[..., :n] - target[..., :n]
    return float(np.sqrt((d ** 2).mean()))


def frechet_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Fréchet distance between gaussians fit to two (N, D) embedding sets,
    in float64: |mu_x - mu_y|² + tr cov_x + tr cov_y - 2 tr sqrt(cov_x cov_y).

    With the centred sets scaled as cov_x = A^T A and cov_y = B^T B, the
    nonzero eigenvalues of cov_x cov_y are those of (A B^T)(A B^T)^T, so
    tr sqrt(cov_x cov_y) is the sum of the singular values of the (N_x, N_y)
    matrix A B^T: JAX's value (the eigenvalues of the (D, D) product) up to
    rounding, without a (D, D) eigendecomposition, which at D = 768 (the
    pixel embedding) takes seconds, and minutes where other processes hold
    the cores."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    diff = x.mean(axis=0) - y.mean(axis=0)
    a = (x - x.mean(axis=0)) / np.sqrt(len(x) - 1)
    b = (y - y.mean(axis=0)) / np.sqrt(len(y) - 1)
    sqrt_trace = np.linalg.svd(a @ b.T, compute_uv=False).sum()
    return float(diff @ diff + (a * a).sum() + (b * b).sum() - 2 * sqrt_trace)


def pixel_embeddings(videos: np.ndarray) -> np.ndarray:
    """(B, T, H, W, 3) videos in [0, 255] -> (B, 4·8·8·3) means over a 4x8x8
    grid of spatio-temporal cells: the embedding without I3D weights."""
    v = np.asarray(videos, np.float32)
    B = v.shape[0]
    v = v / 255.0
    T, H, W = v.shape[1:4]
    th, sh, sw = max(T // 4, 1), max(H // 8, 1), max(W // 8, 1)
    pooled = v[:, : th * 4, : sh * 8, : sw * 8]
    pooled = pooled.reshape(B, 4, th, 8, sh, 8, sw, 3).mean(axis=(2, 4, 6))
    return pooled.reshape(B, -1)


def vae_latent_embeddings(latents: np.ndarray) -> np.ndarray:
    """(B, T, C, h, w) VAE latents -> (B, 2·T·C): the spatial mean and std of
    each frame's channels. The frozen VAE's latent space tracks generation
    quality where raw-pixel statistics are noise; at T = 4 and C = 16 the
    128-d embedding is one whose covariance about 64 videos can estimate."""
    z = np.asarray(latents, np.float32)
    B, T, C = z.shape[:3]
    flat = z.reshape(B, T * C, -1)
    return np.concatenate([flat.mean(axis=-1), flat.std(axis=-1)], axis=-1)


def get_video_embedder(device: str = "cuda") -> Callable[[np.ndarray], np.ndarray]:
    """An (B, T, H, W, 3) -> (B, D) embedder: the I3D on ``device`` where its
    weights file exists (``eval.i3d.load_i3d_embedder``), else
    :func:`pixel_embeddings`."""
    from unified_video_action_tpu_torch.eval.i3d import load_i3d_embedder

    try:
        return load_i3d_embedder(device=device)
    except FileNotFoundError:
        return pixel_embeddings


def fvd_key(embedder: Callable) -> str:
    """The metric's name for an embedder: ``video_fvd`` (I3D) or
    ``video_fvd_pixel``."""
    return "video_fvd_pixel" if embedder is pixel_embeddings else "video_fvd"


def video_fvd(real_videos: np.ndarray, pred_videos: np.ndarray,
              embedder: Optional[Callable] = None) -> Dict[str, float]:
    embedder = embedder or get_video_embedder()
    return {fvd_key(embedder): frechet_distance(embedder(real_videos), embedder(pred_videos))}
