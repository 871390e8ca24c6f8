#!/usr/bin/env python
"""Live human-video keypoint demo with the PyTorch/CUDA port (the port's
counterpart of ``eval_human.py``).

    python eval_human_torch.py -c OUT/export --source frames.npz --out overlay.gif \
        [--max-frames 64] [--device cpu]

A rolling window of the last ``--n-obs-steps`` camera frames (each resized
to 96 x 96 and turned from BGR to RGB; the first frame repeated until the
window is full) goes to the policy's ``predict_action``; the first predicted
step's hand keypoints (7 points of (x, y) in [0, 512) pixels for
``uva_human_pp.yaml``'s 14-d actions) are drawn as filled circles of radius 4
on the frame as it came. ``--source`` is a camera index or a video file
(read through OpenCV's ``VideoCapture``, imported only then: it raises
naming cv2 where OpenCV is absent) or a ``.npz`` of BGR frames (its
``frames`` array, (T, H, W, 3) uint8), which needs nothing beyond numpy.
``--out`` writes the overlaid frames as an animated GIF (the card's machine
has no video codec); without it they are shown in an OpenCV window.

The checkpoint is a port checkpoint directory or slim export
(``training/checkpoint.py``, ``train_torch.py``'s ``<output_dir>/export``):
its ``meta.json`` cfg builds the policy (``--config-name`` composes
``config/yaml/<name>.yaml`` instead, through the port's ``load_config``),
its weights load through the weight bridge and its ``normalizer.npz`` sets
the normalizer. The policy runs on ``--device`` (``cuda`` unless ``cpu`` is
given; ``cuda`` without a card raises); its draws come from a
``torch.Generator`` seeded with ``--seed``, where ``eval_human.py`` splits a
``PRNGKey``.
"""

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
FRAME_SIZE = 96  # the human_pp task's frames (task/human_pp.yaml's image_resolution)
KEYPOINT_SCALE = 512.0  # the keypoints' pixel range


def plot_keypoints(frame, keypoints, color=(0, 255, 0)):
    """Draw a (K, 2) keypoint set in [0, 1] of the frame's width and height
    as filled circles of radius 4 (``cv2.circle(frame, (int(x * w), int(y *
    h)), 4, color, -1)``, pixel for pixel), in place; returns the frame."""
    import numpy as np

    from unified_video_action_tpu_torch.envs.raster import fill_circle

    h, w = frame.shape[:2]
    for x, y in np.asarray(keypoints).reshape(-1, 2):
        fill_circle(frame, (int(x * w), int(y * h)), 4, color)
    return frame


def preprocess(frame):
    """A BGR (H, W, 3) uint8 camera frame -> (3, 96, 96) float32 RGB in [0,
    1]: OpenCV's bilinear resize (``envs/raster.resize_linear_u8``), then
    the channels reversed."""
    import numpy as np

    from unified_video_action_tpu_torch.envs.raster import resize_linear_u8

    rgb = resize_linear_u8(np.ascontiguousarray(frame), (FRAME_SIZE, FRAME_SIZE))[..., ::-1]
    return np.moveaxis(rgb.astype(np.float32) / 255.0, -1, 0)


def run_stream(policy, cap, n_obs_steps: int = 16, display: bool = False, max_frames: int = None,
               on_frame=None, seed: int = 0, generator=None, noise=None, timer=None) -> int:
    """The demo loop, headless unless ``display``: ``cap`` is anything with
    ``read() -> (ok, bgr_frame)``. Each frame: the window's request, then the
    first predicted step's keypoints drawn on a copy of the frame, passed to
    ``on_frame(vis, keypoints)``. The draws come from ``generator`` (a
    ``torch.Generator`` on the policy's device seeded with ``seed`` where
    none is given), or ``noise(n)`` gives frame n's (``predict_action``'s
    ``noise``). ``timer`` (``utils/profiling.Timer``) times each frame's
    stages: ``read``, ``preprocess``, ``request`` and ``overlay``. Returns
    the number of frames processed."""
    import contextlib

    import numpy as np
    import torch

    if generator is None and noise is None:
        generator = torch.Generator(device=policy.device).manual_seed(seed)
    stage = timer.time if timer is not None else (lambda name: contextlib.nullcontext())
    frames = collections.deque(maxlen=n_obs_steps)
    n = 0
    while max_frames is None or n < max_frames:
        with stage("read"):
            ok, frame = cap.read()
        if not ok:
            break
        with stage("preprocess"):
            frames.append(preprocess(frame))
            while len(frames) < n_obs_steps:
                frames.append(frames[-1])
            obs = {"image": np.stack(frames)[None]}
        t0 = time.time()
        with stage("request"):
            result = policy.predict_action(obs, generator,
                                           noise=None if noise is None else noise(n))
        kp = result["action"][0, 0]  # the first predicted step's keypoints
        print(f"inference {time.time() - t0:.3f}s", flush=True)
        with stage("overlay"):
            vis = plot_keypoints(frame.copy(), kp / KEYPOINT_SCALE)
        if on_frame is not None:
            on_frame(vis, kp)
        if display:
            cv2 = _cv2("an OpenCV window (pass --out to write a GIF)")
            cv2.imshow("uva_human", vis)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        n += 1
    return n


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed") from e
    return cv2


class FrameCapture:
    """``read() -> (ok, frame)`` over (T, H, W, 3) uint8 BGR frames, as a
    camera; ``(False, None)`` after the last."""

    def __init__(self, frames):
        import numpy as np

        self.frames = np.asarray(frames, dtype=np.uint8)
        if self.frames.ndim != 4 or self.frames.shape[-1] != 3:
            raise ValueError(f"frames must be (T, H, W, 3) uint8, got {self.frames.shape}")
        self.i = 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def release(self):
        pass


def open_source(source: str):
    """A ``.npz`` whose ``frames`` array holds the BGR frames
    (:class:`FrameCapture`), else OpenCV's ``VideoCapture`` of a camera index
    or a video file."""
    if source.endswith(".npz"):
        import numpy as np

        with np.load(source) as z:
            return FrameCapture(z["frames"])
    cv2 = _cv2(f"--source {source!r} (a camera or a video file)")
    return cv2.VideoCapture(int(source) if source.isdigit() else source)


def load_policy(checkpoint: str, device: str, config_name: str = None, overrides=()):
    """The port's policy of ``checkpoint`` (a port checkpoint or slim
    export) with its weights and normalizer, on ``device``."""
    import torch

    from eval_sim_torch import load_weights
    from unified_video_action_tpu_torch.config import apply_overrides, load_config
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"eval_human_torch: --device {device} but torch.cuda.is_available() is "
                         "False (pass --device cpu to run on the CPU)")
    if config_name:
        cfg = load_config(config_name)
    else:
        with open(os.path.join(checkpoint, "meta.json")) as f:
            cfg = json.load(f).get("cfg")
        if cfg is None:
            raise SystemExit("the checkpoint's meta.json has no cfg: pass --config-name")
    apply_overrides(cfg, overrides)
    policy = UnifiedVideoActionPolicy.from_cfg(cfg, device=device)
    policy.load_params(*load_weights(checkpoint))
    norm_path = os.path.join(checkpoint, "normalizer.npz")
    if os.path.exists(norm_path):
        policy.set_normalizer(LinearNormalizer.load(norm_path))
    return policy


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--source", default="0",
                        help="a camera index, a video file or a .npz of BGR frames")
    parser.add_argument("--n-obs-steps", type=int, default=16)
    parser.add_argument("--config-name", default=None,
                        help="compose config/yaml/<name>.yaml instead of the checkpoint's cfg")
    parser.add_argument("--out", default=None,
                        help="write the overlaid frames to this GIF instead of a window")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    policy = load_policy(args.checkpoint, args.device, args.config_name, args.overrides)
    cap = open_source(args.source)
    written = []
    n = run_stream(policy, cap, n_obs_steps=args.n_obs_steps, display=args.out is None,
                   max_frames=args.max_frames, seed=args.seed,
                   on_frame=(lambda vis, _kp: written.append(vis[..., ::-1].copy()))
                   if args.out else None)
    cap.release()
    if args.out:
        from unified_video_action_tpu_torch.utils.media import write_gif

        write_gif(args.out, written, fps=10)
        print(f"wrote {n} frames to {args.out}", flush=True)
    return n


if __name__ == "__main__":
    main()
