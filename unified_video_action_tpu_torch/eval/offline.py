"""Offline evaluation loops (port of ``eval/offline.py``): the video FVD of
generated frames (``test_video_fvd``, :41-137), the action chunks' L2
(``test_action_l2``, :140-171), and the media they write
(``_write_keypoint_overlay``, :174-205, and ``save_video_grid``, :207-241).

``test_video_fvd`` conditions ``Mar.sample_video`` on the first half of each
validation window's training frames, decodes the generated latents with the
VAE and holds them against the second half: in the frozen VAE's latent space
(``video_fvd_vae``) and by the video embedder (``video_fvd`` with I3D
weights, else ``video_fvd_pixel``). Its draws are the evaluation's own, one
generator per batch index from a fixed seed and never the trainer's, so that
epoch-to-epoch readings move only with the weights.

The media are written without PIL, imageio or OpenCV, which the card's
machine does not have: the real-vs-predicted grid as ``real_vs_pred.gif``
(``utils/media.write_gif``, JAX's file; JAX's extra mp4 is not written)
beside one PNG a frame (standard library ``zlib`` and ``struct``), the
keypoint overlay the same way (its GIF JAX's file).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from unified_video_action_tpu_torch.eval.metrics import (
    action_l2,
    frechet_distance,
    fvd_key,
    get_video_embedder,
    vae_latent_embeddings,
)
from unified_video_action_tpu_torch.models.vae import LATENT_SCALE
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils.frames import select_frame_indices, split_trajectory
from unified_video_action_tpu_torch.utils.media import write_gif

# the seed of the evaluation's draws; batch bi draws from EVAL_SEED + bi
EVAL_SEED = 0


def decode_frames(policy, latents: torch.Tensor) -> np.ndarray:
    """(N, C, h, w) scaled latents -> (N, H, W, 3) uint8 frames on the host:
    divided by ``LATENT_SCALE``, decoded, then (x + 1)·127.5 clipped to
    [0, 255] and truncated, as JAX's ``_decode_frames`` (:30-38)."""
    img = policy.vae.decode(latents / LATENT_SCALE)
    img = ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).cpu().numpy()


def video_eval_draws(policy, batch: int, n_cond: int, n_target: int, task_mode: str,
                     num_iter: int, generator: torch.Generator) -> Dict[str, object]:
    """One batch's draws of :func:`test_video_fvd` from ``generator``: the VAE
    posterior noise of the conditioning frames, ``sample_video``'s draws,
    and the posterior noise of the target frames, in that order."""
    c = policy.mar_cfg
    vae = lambda n: torch.randn((batch * n, c.vae_embed_dim, c.seq_hw, c.seq_hw),
                                generator=generator, device=policy.device)
    out = {"vae_cond": vae(n_cond)}
    out["video"] = policy.mar.sample_video_draws(batch, generator, policy.device, num_iter, task_mode)
    out["vae_target"] = vae(n_target)
    return out


@torch.no_grad()
def test_video_fvd(policy, val_batches: Iterable[Mapping], num_batches: int = 4,
                   num_iter: int = 1, output_dir: Optional[str] = None,
                   draws: Optional[Callable[[int, int], Mapping]] = None) -> Dict[str, float]:
    """FVD of generated future frames against the real ones, over the first
    ``num_batches`` of ``val_batches`` (``{"obs": {"image": (B, T, 3, H, W)
    uint8 or float in [0, 1]}}``, T = 32 for the training selection).

    Of each window's ``select_frame_indices(T, eval=False)`` frames, the
    first half conditions (VAE-encoded with posterior noise) and the second
    is the target. ``policy.mar.sample_video`` runs ``num_iter`` rounds in
    ``full_dynamic_model`` with the action head, else ``video_model``, at the
    policy's temperature; the latents are decoded (:func:`decode_frames`).
    ``draws(bi, B)`` gives batch bi's draws in :func:`video_eval_draws`'s
    form; by default they come from a generator seeded ``EVAL_SEED + bi``.
    The video embedder is ``get_video_embedder``'s on the policy's device.
    With ``output_dir``, the real and predicted videos go there side by side
    (:func:`save_video_grid`, ``real_vs_pred``). Returns ``video_fvd_vae``
    and ``video_fvd`` or ``video_fvd_pixel``."""
    c = policy.mar_cfg
    if c.use_proprioception:
        raise ValueError("test_video_fvd gives sample_video no proprioception, as JAX's does "
                         "(whose forward_encoder then fails its assertion)")
    task_mode = "full_dynamic_model" if c.predict_action else "video_model"
    real_videos, pred_videos, real_lat, pred_lat = [], [], [], []
    for bi, batch in enumerate(val_batches):
        if bi >= num_batches:
            break
        obs = image_util.remap_image_keys(policy.task_name, dict(batch["obs"]))
        image = torch.as_tensor(obs["image"]).to(policy.device)
        idx = select_frame_indices(image.shape[1], eval=False)
        if idx.max() >= image.shape[1]:  # JAX's gather clamps; a CUDA index would trap
            raise ValueError(f"frames {idx.tolist()} of a {image.shape[1]}-frame window")
        frames = image_util.to_unit_float(image[:, torch.as_tensor(idx, device=image.device)])
        frames = image_util.to_model_range(image_util.resize_video(frames, c.img_size))
        half = len(idx) // 2
        cond_f, target_f = frames[:, :half], frames[:, half:]
        B = frames.shape[0]
        if draws is None:
            gen = torch.Generator(device=policy.device).manual_seed(EVAL_SEED + bi)
            d = video_eval_draws(policy, B, half, len(idx) - half, task_mode, num_iter, gen)
        else:
            d = draws(bi, B)
        cond = policy._encode_frames(cond_f, d["vae_cond"])
        gen_latents, _ = policy.mar.sample_video(cond, d["video"], num_iter=num_iter,
                                                 temperature=policy.temperature,
                                                 task_mode=task_mode)
        pred = decode_frames(policy, gen_latents)
        pred_videos.append(pred.reshape(B, c.n_frames, *pred.shape[1:]))
        # the latent-space embedding: the real target frames through the
        # frozen encoder against the generated latents, in the same scale
        real_lat.append(policy._encode_frames(target_f, d["vae_target"]).float().cpu().numpy())
        pred_lat.append(gen_latents.reshape(B, c.n_frames, *gen_latents.shape[1:]).cpu().numpy())
        real = ((target_f.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8)
        real_videos.append(real.permute(0, 1, 3, 4, 2).cpu().numpy())
    real_videos = np.concatenate(real_videos, axis=0)
    pred_videos = np.concatenate(pred_videos, axis=0)
    if output_dir is not None:
        save_video_grid(np.concatenate([real_videos, pred_videos], axis=3),
                        os.path.join(output_dir, "real_vs_pred"))
    out = {"video_fvd_vae": frechet_distance(
        vae_latent_embeddings(np.concatenate(real_lat, axis=0)),
        vae_latent_embeddings(np.concatenate(pred_lat, axis=0)))}
    embedder = get_video_embedder(device=str(policy.device))
    out[fvd_key(embedder)] = frechet_distance(embedder(real_videos), embedder(pred_videos))
    return out


def test_action_l2(policy, val_batches: Iterable[Mapping], generator: torch.Generator = None,
                   num_batches: int = 8, keypoint_video_path: Optional[str] = None,
                   noise: Optional[Callable[[int, int], Mapping]] = None) -> Dict[str, float]:
    """The RMSE of ``policy.predict_action`` on the first half of each
    window against its future actions, over ``num_batches`` batches
    (``{"obs": {"image": (B, T, 3, H, W)}, "action": (B, T, A)}`` on the
    host). ``noise(bi, B)`` injects batch bi's predict draws; otherwise they
    come from ``generator``. With ``keypoint_video_path`` the first batch's
    frames are written with its keypoints (:func:`_write_keypoint_overlay`)."""
    dists = []
    for bi, batch in enumerate(val_batches):
        if bi >= num_batches:
            break
        obs = image_util.remap_image_keys(policy.task_name, dict(batch["obs"]))
        T = obs["image"].shape[1]
        obs_dict = {k: np.asarray(v[:, : T // 2]) for k, v in obs.items()}
        B = obs_dict["image"].shape[0]
        result = policy.predict_action(obs_dict, generator,
                                       noise=None if noise is None else noise(bi, B))
        _, future = split_trajectory(np.asarray(batch["action"]), T, policy.shift_action)
        dists.append(action_l2(result["action_pred"], future))
        if bi == 0 and keypoint_video_path is not None:
            _write_keypoint_overlay(np.asarray(obs["image"][0]), future[0],
                                    result["action_pred"][0], keypoint_video_path)
    return {"val_action_l2_distances": float(np.mean(dists))}


def _write_keypoint_overlay(frames: np.ndarray, gt_actions: np.ndarray, pred_actions: np.ndarray,
                            path: str, scale: float = 512.0) -> None:
    """(T, 3, H, W) frames and (T', K·2) keypoint chunks -> one frame a
    predicted step, each keypoint (in [0, ``scale``) pixels) a 3 x 3 square,
    ground truth green and prediction red (JAX's drawing,
    ``eval/offline.py:177-205``), written as an animated GIF at 5 fps
    (``<path stem>.gif``, JAX's file) and one PNG a frame
    (``<path stem>_<t>.png``)."""
    T = min(len(gt_actions), len(pred_actions), len(frames))
    H, W = frames.shape[-2:]
    out = []
    for t in range(T):
        fr = np.moveaxis(np.asarray(frames[t]), 0, -1)
        if fr.dtype != np.uint8:
            fr = (fr * 255.0).astype(np.uint8)
        img = np.ascontiguousarray(fr).copy()
        for kp, color in ((gt_actions[t], (0, 255, 0)), (pred_actions[t], (255, 0, 0))):
            for x, y in np.asarray(kp, np.float64).reshape(-1, 2) / scale:
                xi, yi = int(x * W), int(y * H)
                if 0 <= xi < W and 0 <= yi < H:
                    img[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] = color
        out.append(img)
    _write_frames(out, path)
    write_gif(os.path.splitext(path)[0] + ".gif", out, fps=5)


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (no filter, zlib level 6)."""
    H, W, _ = image.shape
    rows = b"".join(b"\x00" + np.ascontiguousarray(image[r], np.uint8).tobytes() for r in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def _write_frames(frames, path: str) -> None:
    """Each (H, W, 3) frame as ``<path without extension>_<t:02d>.png``."""
    stem = os.path.splitext(path)[0]
    os.makedirs(os.path.dirname(os.path.abspath(stem)), exist_ok=True)
    for t, frame in enumerate(frames):
        write_png(f"{stem}_{t:02d}.png", frame)


def save_video_grid(videos: np.ndarray, path: str, fps: int = 10) -> None:
    """(B, T, H, W, 3) uint8 -> a near-square grid of the B videos, blank
    cells last (the reference's utils/data_utils.py:429-458 grid), as an
    animated GIF at ``fps`` (``<path>.gif``) and as T PNG frames
    (``<path>_<t:02d>.png``)."""
    B, T, H, W, C = videos.shape
    gw = int(np.ceil(np.sqrt(B)))
    gh = int(np.ceil(B / gw))
    pad = gw * gh - B
    if pad:
        videos = np.concatenate([videos, np.zeros((pad, T, H, W, C), videos.dtype)], axis=0)
    grid = videos.reshape(gh, gw, T, H, W, C).transpose(2, 0, 3, 1, 4, 5).reshape(T, gh * H, gw * W, C)
    _write_frames(list(grid), path)
    write_gif(os.path.splitext(path)[0] + ".gif", grid, fps)
