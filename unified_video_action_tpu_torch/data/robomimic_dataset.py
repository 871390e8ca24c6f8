"""The robomimic-format dataset (the port's own copy of the JAX package's
``data/robomimic_dataset.py``: ``convert_robomimic_actions`` at :39-52,
``load_robomimic_hdf5`` at :55-78, ``RobomimicReplayImageDataset`` at
:81-183 and ``_abs_action_normalizer`` at :186-208), numpy only.

A store holds ``data/demo_N/{obs/<key>, actions, states}``. Absolute
actions' axis-angle rotation becomes rot6d (10-D actions: pos3 + rot6d +
gripper; 20-D for two arms), per-key normalizers are fitted (the abs-action
scheme: position and gripper ranges, rotation identity), and horizon windows
are sampled with the seeded train/validation episode split.

Two store formats, chosen by the file's extension (never by what is
installed): an HDF5 file, read through ``h5py`` (imported where such a file
is opened; it raises where ``h5py`` is absent), and an ``.npz`` holding the
same arrays under the same paths as keys (``data/demo_0/obs/agentview_image``
...), read with numpy alone, which :func:`write_npz_store` writes and
``tools/gen_synthetic_suites.py`` uses.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from unified_video_action_tpu_torch.data.normalizer import (
    LinearNormalizer,
    NormalizerField,
    fit_field,
)
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.data.sampler import (
    SequenceSampler,
    downsample_mask,
    get_val_mask,
)
from unified_video_action_tpu_torch.utils.rotation import RotationTransformer

_DEMO = re.compile(r"^data/(demo_\d+)/")


class RobomimicStore:
    """A robomimic-layout store opened for reading: ``store[path]`` is the
    array at ``path`` (``"data/demo_0/actions"``), :meth:`demos` the demo
    names in the order of their numbers. An HDF5 file or an ``.npz``, by the
    file's extension. Use as a context manager."""

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".npz"):
            self._npz = np.load(path)
            self._h5 = None
        else:
            try:
                import h5py
            except ImportError as e:
                raise ImportError(f"reading {path} needs h5py, which is not installed; "
                                  "an .npz store of the same layout is read without it") from e
            self._h5 = h5py.File(path, "r")
            self._npz = None

    def demos(self) -> List[str]:
        if self._h5 is not None:
            names = list(self._h5["data"].keys())
        else:
            names = {m.group(1) for m in map(_DEMO.match, self._npz.files) if m}
        return sorted(names, key=lambda s: int(s.split("_")[-1]))

    def __contains__(self, path: str) -> bool:
        return path in self._h5 if self._h5 is not None else path in self._npz.files

    def __getitem__(self, path: str) -> np.ndarray:
        return self._h5[path][:] if self._h5 is not None else self._npz[path]

    def close(self) -> None:
        (self._h5 if self._h5 is not None else self._npz).close()

    def __enter__(self) -> "RobomimicStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_npz_store(path: str, demos: Sequence[Mapping[str, object]]) -> None:
    """Write ``demos`` (each ``{"obs": {key: array}, "actions": array}`` and
    optionally ``"states"``) as an uncompressed ``.npz`` robomimic-layout
    store, demo i at ``data/demo_i/...``."""
    if not path.endswith(".npz"):
        raise ValueError(f"an .npz store's path ends with .npz, got {path!r}")
    flat: Dict[str, np.ndarray] = {}
    for i, demo in enumerate(demos):
        for k, v in demo["obs"].items():
            flat[f"data/demo_{i}/obs/{k}"] = np.asarray(v)
        for k in ("actions", "states"):
            if k in demo:
                flat[f"data/demo_{i}/{k}"] = np.asarray(demo[k])
    with open(path, "wb") as f:
        np.savez(f, **flat)


def convert_robomimic_actions(raw_actions: np.ndarray, abs_action: bool = True) -> np.ndarray:
    """(N, 7) [pos3, axis_angle3, gripper1] -> (N, 10) [pos3, rot6d, gripper]
    when abs_action (reference _convert_actions, :241-260); (N, 14) -> (N, 20)
    for two arms."""
    if not abs_action:
        return raw_actions.astype(np.float32)
    tf = RotationTransformer("axis_angle", "rotation_6d")
    is_dual = raw_actions.shape[-1] == 14
    acts = raw_actions.reshape(-1, 2, 7) if is_dual else raw_actions[:, None]
    pos, rot, grip = acts[..., :3], acts[..., 3:6], acts[..., 6:]
    rot6 = tf.forward(rot)
    out = np.concatenate([pos, rot6, grip], axis=-1).astype(np.float32)
    return out.reshape(raw_actions.shape[0], -1)


def load_robomimic_hdf5(path: str, obs_keys: Sequence[str], abs_action: bool = True,
                        image_keys: Sequence[str] = ()) -> ReplayBuffer:
    """Every demo of the store at ``path`` (HDF5 or ``.npz``) in a
    ReplayBuffer: each obs key (float images in [0, 1] as uint8) and
    ``action``, converted by :func:`convert_robomimic_actions`."""
    buffer = ReplayBuffer.create_empty()
    with RobomimicStore(path) as store:
        for demo in store.demos():
            episode: Dict[str, np.ndarray] = {}
            for k in obs_keys:
                arr = store[f"data/{demo}/obs/{k}"]
                if k in image_keys and arr.dtype != np.uint8:
                    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
                episode[k] = arr
            episode["action"] = convert_robomimic_actions(store[f"data/{demo}/actions"],
                                                          abs_action=abs_action)
            buffer.add_episode(episode)
    return buffer


class RobomimicReplayImageDataset:
    def __init__(
        self,
        dataset_path: str,
        shape_meta: dict,
        horizon: int = 32,
        pad_before: int = 0,
        pad_after: int = 0,
        n_obs_steps: Optional[int] = None,
        abs_action: bool = True,
        seed: int = 42,
        val_ratio: float = 0.0,
        max_train_episodes: Optional[int] = None,
        normalizer_type: str = "all",
        **kwargs,
    ):
        obs_meta = shape_meta["obs"]
        self.rgb_keys = [k for k, v in obs_meta.items() if v.get("type") == "rgb"]
        self.lowdim_keys = [k for k, v in obs_meta.items() if v.get("type") == "low_dim"]
        self.replay_buffer = load_robomimic_hdf5(
            dataset_path, obs_keys=self.rgb_keys + self.lowdim_keys, abs_action=abs_action,
            image_keys=self.rgb_keys)
        val_mask = get_val_mask(self.replay_buffer.n_episodes, val_ratio, seed)
        train_mask = downsample_mask(~val_mask, max_train_episodes, seed)
        self.sampler = SequenceSampler(self.replay_buffer, sequence_length=horizon,
                                       pad_before=pad_before, pad_after=pad_after,
                                       episode_mask=train_mask)
        self.horizon = horizon
        self.pad_before, self.pad_after = pad_before, pad_after
        self.train_mask, self.val_mask = train_mask, val_mask
        self.abs_action = abs_action
        self.n_obs_steps = n_obs_steps
        self.normalizer_type = normalizer_type

    def get_validation_dataset(self) -> "RobomimicReplayImageDataset":
        val = object.__new__(RobomimicReplayImageDataset)
        val.__dict__.update(self.__dict__)
        val.sampler = SequenceSampler(self.replay_buffer, sequence_length=self.horizon,
                                      pad_before=self.pad_before, pad_after=self.pad_after,
                                      episode_mask=self.val_mask)
        val.train_mask = self.val_mask
        return val

    def get_normalizer(self) -> LinearNormalizer:
        """Per-key schemes (reference :159-198): the abs-action scheme, eef
        position and gripper ranges, quaternions identity, images [0, 1] to
        [-1, 1]."""
        n = LinearNormalizer()
        action = self.replay_buffer["action"]
        n.fields["action"] = _abs_action_normalizer(action) if self.abs_action else fit_field(action)
        for k in self.lowdim_keys:
            data = self.replay_buffer[k]
            if "pos" in k or "qpos" in k or "width" in k:
                n.fields[k] = fit_field(data)
            else:  # quaternions and other unit-norm features stay raw
                n.fields[k] = NormalizerField.identity(data.shape[-1])
        for k in self.rgb_keys:
            n.fields[k] = NormalizerField.image_range()
        return n

    def __len__(self) -> int:
        return len(self.sampler)

    def __getitem__(self, idx: int) -> Dict:
        sample = self.sampler.sample_sequence(idx)
        obs: Dict[str, np.ndarray] = {}
        for k in self.rgb_keys:
            img = sample[k].astype(np.float32) / 255.0
            obs[k] = np.moveaxis(img, -1, 1)  # (T, C, H, W)
        for k in self.lowdim_keys:
            obs[k] = sample[k].astype(np.float32)
        return {"obs": obs, "action": sample["action"].astype(np.float32)}

    def undo_transform_action(self, action: np.ndarray) -> np.ndarray:
        """rot6d abs actions back to axis-angle for the env
        (reference robomimic_image_runner.py:368-385)."""
        if not self.abs_action:
            return action
        from unified_video_action_tpu_torch.runners.base import undo_transform_action

        return undo_transform_action(action, RotationTransformer("axis_angle", "rotation_6d"))


def _abs_action_normalizer(action: np.ndarray) -> NormalizerField:
    """Position dims range-normalized, rotation dims identity, gripper range
    (reference robomimic_abs_action scheme, common/normalize_util.py)."""
    d = action.shape[-1]
    scale = np.ones(d, np.float32)
    offset = np.zeros(d, np.float32)
    stats = {"min": action.min(axis=0), "max": action.max(axis=0),
             "mean": action.mean(axis=0), "std": action.std(axis=0)}
    n_arm = 2 if d == 20 else 1
    per = d // n_arm
    for arm in range(n_arm):
        base = arm * per
        for dims in (slice(base, base + 3), slice(base + 9, base + per)):
            lo = action[:, dims].min(axis=0)
            hi = action[:, dims].max(axis=0)
            rng = np.maximum(hi - lo, 1e-4)
            scale[dims] = 2.0 / rng
            offset[dims] = -1.0 - scale[dims] * lo
    return NormalizerField(scale=scale, offset=offset, input_stats=stats)
