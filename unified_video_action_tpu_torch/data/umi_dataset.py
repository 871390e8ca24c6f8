"""The UMI datasets (the port's own copy of ``data/umi_dataset.py``:
``draw_mirror_mask``, ``UmiLazyDataset``, ``UmiMultiDataset``,
``make_synthetic_umi`` and ``build_umi_multi_from_config``, :48-334),
numpy only.

* ``UmiLazyDataset``: one task's episodes, a seeded train/validation split
  of the episodes, an index pool of (episode, frame) pairs within a
  starting-percentile window; each item gathers, clamped at the episode's
  edges, 8 camera frames at ``range(-12, 17, 4)`` (the 4 history frames
  drawn from [-15, 0] under ``random_img_sampling``, kept as
  ``img_indices``) and the 32-step proprioception window ``range(-15,
  17)``; the poses relative to the current frame as pose10d, the 32-step
  action (pose10d and gripper), the rotation relative to the jittered
  episode start. Per-item draws come from a generator keyed on (seed,
  epoch, index), so items do not depend on the loader's workers.
* ``UmiMultiDataset``: N such datasets behind one merged index pool, each
  item carrying its dataset's ``language_latents`` (the prompt through the
  hash text encoder) and its ``dataset_name``.
* ``draw_mirror_mask`` blacks out the fisheye frame's two side mirrors with
  the pixels ``cv2.fillPoly`` draws, by the port's numpy rasterizer (the
  card's machine has no OpenCV).

Stores are the reference's zarr stores (``tools/gen_synthetic_umi.py``
writes the synthetic corpus so), read lazily: an item decodes the chunks
its frames fall in (``ReplayBuffer.load(..., lazy=True)``, each array's
chunk cache bounded in bytes), never a whole key. A ``.npz`` or HDF5
replay buffer is read whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.envs.raster import fill_poly
from unified_video_action_tpu_torch.utils.language import HashTextEncoder
from unified_video_action_tpu_torch.utils.pose import (
    convert_pose_mat_rep,
    mat_to_pose10d,
    pose_to_mat,
)

CAMERA_KEY = "camera0_rgb"
PROPRIO_WINDOW = list(range(-15, 17))  # 32 steps around the current frame
CAMERA_INDICES = list(range(-12, 17, 4))  # 8 frames
ACTION_LEN = 32  # the whole window; the policy splits it
OBS_LEN = 16


def draw_mirror_mask(img: np.ndarray) -> np.ndarray:
    """A copy of the (H, W, C) fisheye frame with its two side mirrors black:
    the quadrilaterals along the left and right edges that JAX's cv2 branch
    fills (``umi_dataset.py:57-67``)."""
    h, w = img.shape[:2]
    out = img.copy()
    lw, top = int(w * 0.2), int(h * 0.25)
    left = [[0, top], [lw, int(h * 0.4)], [lw, int(h * 0.75)], [0, h - 1]]
    right = [[w - 1, top], [w - lw, int(h * 0.4)], [w - lw, int(h * 0.75)], [w - 1, h - 1]]
    black = np.zeros(img.shape[2:], img.dtype)
    fill_poly(out, left, black)
    fill_poly(out, right, black)
    return out


@dataclasses.dataclass
class UmiLazyDataset:
    """One UMI task's episodes."""

    replay_buffer: ReplayBuffer
    name: str = "umi"
    down_sample_steps: int = 1
    random_img_sampling: bool = False
    mask_mirror: bool = False
    use_relative_pose: bool = True
    start_pose_noise: float = 0.05
    val_ratio: float = 0.05
    seed: int = 42
    split: str = "train"
    starting_percentile_low: float = 0.0
    starting_percentile_high: float = 1.0

    def __post_init__(self):
        self.epoch = 0
        ends = self.replay_buffer.episode_ends
        self.episode_starts = np.concatenate([[0], ends[:-1]])
        self.episode_lengths = ends - self.episode_starts
        n_ep = self.replay_buffer.n_episodes
        rng = np.random.default_rng(self.seed)
        val = np.zeros(n_ep, dtype=bool)
        n_val = int(round(n_ep * self.val_ratio))
        if n_val > 0:
            val[rng.choice(n_ep, size=n_val, replace=False)] = True
        use = ~val if self.split == "train" else val
        pool = []
        for ep in range(n_ep):
            if not use[ep]:
                continue
            L = int(self.episode_lengths[ep])
            lo, hi = int(L * self.starting_percentile_low), int(L * self.starting_percentile_high)
            pool.extend((ep, t) for t in range(lo, hi))
        self.index_pool = np.asarray(pool, dtype=np.int64).reshape(-1, 2)

    def __len__(self) -> int:
        return len(self.index_pool)

    def split_val(self) -> "UmiLazyDataset":
        return dataclasses.replace(self, split="val")

    def get_validation_dataset(self) -> "UmiLazyDataset":
        return self.split_val()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _gather(self, key: str, ep: int, t: int, rel_indices: Sequence[int]) -> np.ndarray:
        L, start = int(self.episode_lengths[ep]), int(self.episode_starts[ep])
        idx = [min(max(t + i, 0), L - 1) + start for i in rel_indices]
        return np.asarray(self.replay_buffer[key][idx])

    def __getitem__(self, idx: int) -> Dict:
        ep, t = self.index_pool[idx]
        d = self.down_sample_steps
        item_rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        cam_rel = [i * d for i in CAMERA_INDICES]
        if self.random_img_sampling:
            hist = sorted(item_rng.choice(np.arange(-15, 1), size=4, replace=False) * d)
            cam_rel = list(hist) + cam_rel[4:]
        img_indices = (np.asarray(cam_rel, np.float64) / d + 15).astype(np.int32)
        frames = self._gather(CAMERA_KEY, ep, t, cam_rel)
        if self.mask_mirror:
            frames = np.asarray([draw_mirror_mask(f) for f in frames])
        prop_rel = [i * d for i in PROPRIO_WINDOW]
        pos = self._gather("robot0_eef_pos", ep, t, prop_rel)
        rot = self._gather("robot0_eef_rot_axis_angle", ep, t, prop_rel)
        grip = self._gather("robot0_gripper_width", ep, t, prop_rel)
        pose_mat = pose_to_mat(np.concatenate([pos, rot], axis=-1))
        if self.use_relative_pose:
            zero = PROPRIO_WINDOW.index(0)
            pose10d = mat_to_pose10d(convert_pose_mat_rep(pose_mat, pose_mat[zero], "relative"))
        else:
            pose10d = mat_to_pose10d(pose_mat)
        obs = {
            CAMERA_KEY: np.moveaxis(frames.astype(np.float32) / 255.0, -1, 1),
            "robot0_eef_pos": pose10d[:OBS_LEN, :3],
            "robot0_eef_rot_axis_angle": pose10d[:OBS_LEN, 3:],
            "robot0_gripper_width": grip[:OBS_LEN].astype(np.float32),
            "img_indices": img_indices[:, None].astype(np.float32),
        }
        if "robot0_demo_start_pose" in self.replay_buffer:
            # the rotation relative to the episode's start pose, jittered
            start_pose = np.array(self.replay_buffer["robot0_demo_start_pose"][
                int(self.episode_starts[ep])], dtype=np.float64)
            start_pose = start_pose + item_rng.normal(scale=self.start_pose_noise,
                                                      size=start_pose.shape)
            wrt = mat_to_pose10d(convert_pose_mat_rep(pose_mat, pose_to_mat(start_pose), "relative"))
            obs["robot0_eef_rot_axis_angle_wrt_start"] = wrt[:OBS_LEN, 3:]
        action = np.concatenate([pose10d[-ACTION_LEN:], grip[-ACTION_LEN:].astype(np.float32)],
                                axis=-1)
        return {"obs": obs, "action": action, "dataset_name": self.name}


class UmiMultiDataset:
    """N task datasets with a merged index pool and per-task language
    latents (``umi_dataset.py:164-254``)."""

    def __init__(self, datasets: Dict[str, UmiLazyDataset],
                 language_prompts: Optional[Dict[str, str]] = None, text_encoder=None,
                 seed: int = 42):
        self.datasets = datasets
        self.names = list(datasets)
        pool = [(di, i) for di, name in enumerate(self.names) for i in range(len(datasets[name]))]
        self.index_pool = np.asarray(pool, dtype=np.int64).reshape(-1, 2)
        self.language_latents: Dict[str, np.ndarray] = {}
        if language_prompts:
            text_encoder = text_encoder or HashTextEncoder()
            for name, prompt in language_prompts.items():
                self.language_latents[name] = text_encoder.encode(prompt)[0]

    def __len__(self) -> int:
        return len(self.index_pool)

    def set_epoch(self, epoch: int) -> None:
        for ds in self.datasets.values():
            ds.set_epoch(epoch)

    def __getitem__(self, idx: int) -> Dict:
        di, i = self.index_pool[idx]
        name = self.names[di]
        item = self.datasets[name][int(i)]
        if name in self.language_latents:
            item["language_latents"] = self.language_latents[name]
        return item

    def split_val(self) -> "UmiMultiDataset":
        """The validation episodes of every dataset, with the same latents."""
        val = UmiMultiDataset({k: v.split_val() for k, v in self.datasets.items()})
        val.language_latents = self.language_latents
        return val

    def get_validation_dataset(self) -> "UmiMultiDataset":
        return self.split_val()

    def get_normalizer(self) -> LinearNormalizer:
        """``normalizer_type: none``: the identity on the actions (the
        relative-pose data is already of unit scale)."""
        first = self.datasets[self.names[0]]
        return LinearNormalizer({"action": NormalizerField.identity(first[0]["action"].shape[-1])})


def make_synthetic_umi(n_episodes: int = 4, episode_len: int = 80, seed: int = 0,
                       image_size: int = 64) -> ReplayBuffer:
    """A small synthetic UMI-format buffer (smooth eef trajectories): JAX's,
    draw for draw."""
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer.create_empty()
    for _ in range(n_episodes):
        t = np.linspace(0, 2 * np.pi, episode_len)[:, None]
        pos = np.concatenate([np.sin(t), np.cos(t), 0.1 * t], axis=-1).astype(np.float32) \
            + rng.normal(0, 0.01, (episode_len, 3)).astype(np.float32)
        rot = (0.2 * np.concatenate([t, -t, 0.5 * t], axis=-1)).astype(np.float32)
        grip = np.abs(np.sin(t)).astype(np.float32)
        start_pose = np.concatenate([pos[0], rot[0]]).astype(np.float64)
        buf.add_episode({
            CAMERA_KEY: rng.integers(0, 255, (episode_len, image_size, image_size, 3), dtype=np.uint8),
            "robot0_eef_pos": pos,
            "robot0_eef_rot_axis_angle": rot,
            "robot0_gripper_width": grip,
            "robot0_demo_start_pose": np.tile(start_pose, (episode_len, 1)),
        })
    return buf


def build_umi_multi_from_config(datasets_cfg: Dict[str, dict], val_ratio: float = 0.02,
                                random_img_sampling: bool = False, seed: int = 42,
                                text_encoder=None, **kwargs) -> UmiMultiDataset:
    """``UmiMultiDataset`` from the task config's ``datasets`` block ({name:
    {path, mask_mirror, prompt, lazy}}); each path a replay buffer, a zarr
    store read lazily unless its ``lazy`` says otherwise. Other keyword
    arguments of the dataset block (``normalizer_type``) are read by the
    trainer."""
    datasets: Dict[str, UmiLazyDataset] = {}
    prompts: Dict[str, str] = {}
    for name, spec in datasets_cfg.items():
        lazy = bool(spec.get("lazy", ReplayBuffer._is_zarr(spec["path"])))
        datasets[name] = UmiLazyDataset(
            ReplayBuffer.load(spec["path"], lazy=lazy), name=name,
            mask_mirror=bool(spec.get("mask_mirror", False)),
            random_img_sampling=random_img_sampling, val_ratio=val_ratio, seed=seed)
        if "prompt" in spec:
            prompts[name] = spec["prompt"]
    return UmiMultiDataset(datasets, language_prompts=prompts, text_encoder=text_encoder, seed=seed)
