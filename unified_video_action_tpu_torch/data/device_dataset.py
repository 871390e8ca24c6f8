"""Device-resident replay dataset (the port's own copy of
``data/device_dataset.py``: ``window_index_table`` at :40 and
``DeviceReplayDataset`` at :176-293).

The whole uint8 frame store, the state and action tracks and the window
table live on the device: a PushT dataset's frames and ``agent_pos``, or a
robomimic-layout dataset's (``config.FETCH``'s) one camera and its low-dim
keys, each under its own key, as the host loader's items carry them; a
dataset with more than that (a second camera, host transforms, language) is
refused (:func:`check_device_layout`). A train step ships only the batch's sample
indices, the frame selection and, with augmentation, three scalars per
sample (``training/workspace.py:306-339``); the gather runs on the device.
``table[idx]`` replicates ``SequenceSampler``'s edge-replication padding, so
the gather equals ``sampler.sample_sequence(idx)``. A second split of the
same replay buffer (the validation windows) shares the store and keeps its
own window table (:meth:`DeviceReplayDataset.split`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch


def window_index_table(sampler) -> np.ndarray:
    """(n_samples, sequence_length) buffer step indices: row i lists the
    step of every slot of sample i's window, out-of-episode slots clamped to
    the episode's edge."""
    L = int(sampler.sequence_length)
    table = np.empty((len(sampler.indices), L), dtype=np.int64)
    for i, (bs, be, ss, se) in enumerate(sampler.indices):
        bs, be, ss, se = int(bs), int(be), int(ss), int(se)
        table[i, :ss] = bs
        table[i, ss:se] = np.arange(bs, be)
        table[i, se:] = be - 1
    return table


def check_device_layout(dataset) -> None:
    """Raise a ValueError where the device store would give other batches
    than the host loader: it holds a robomimic-layout dataset's one camera
    and its low-dim tracks, untransformed, and nothing else (a second
    camera, host transforms such as ColorJitter, ``data_aug`` or language
    fields would be dropped or changed)."""
    rgb_keys = getattr(dataset, "rgb_keys", None)
    if not rgb_keys:  # PushT: the frames and agent_pos, the device's own augmentation
        return
    found = []
    if len(rgb_keys) != 1:
        found.append(f"cameras {list(rgb_keys)}")
    if getattr(dataset, "transforms", None) is not None:
        found.append("host transforms")
    if getattr(dataset, "data_aug", False):
        found.append("data_aug")
    if not found and len(dataset):
        item = dataset[0]
        extra = sorted(set(item["obs"]) - {rgb_keys[0], *dataset.lowdim_keys})
        extra += sorted(set(item) - {"obs", "action"})
        if extra:
            found.append(f"item keys {extra}")
    if found:
        raise ValueError(
            f"dataloader.device_resident=true holds one camera and the low-dim tracks of a "
            f"robomimic-layout dataset; {type(dataset).__name__} has {', '.join(found)}. "
            "Train it from the host loader (dataloader.device_resident=false)")


class DeviceReplayDataset:
    """A PushT or robomimic-layout dataset's replay buffer and windows on
    ``device``."""

    def __init__(self, dataset, device: Union[str, torch.device], store=None):
        self.device = torch.device(device)
        check_device_layout(dataset)
        rgb_keys = getattr(dataset, "rgb_keys", None)
        # the obs key of the frames: PushT's "image", a robomimic dataset's camera
        self.image_key = rgb_keys[0] if rgb_keys else "image"
        if store is None:
            rb = dataset.replay_buffer
            to_dev = lambda a, dtype=None: torch.from_numpy(np.asarray(a, dtype=dtype)).to(self.device)
            if rgb_keys:
                img = rb[self.image_key]
                tracks = {k: to_dev(rb[k], np.float32) for k in dataset.lowdim_keys}
            else:
                img = rb["img"]
                d = getattr(dataset, "agent_pos_dim", 2)
                tracks = {"agent_pos": to_dev(np.asarray(rb["state"])[..., :d], np.float32)}
            store = (to_dev(img), tracks, to_dev(rb["action"], np.float32))  # img (N, H, W, C) uint8
        self.img, self.tracks, self.action = store
        self.table = torch.from_numpy(window_index_table(dataset.sampler)).to(self.device)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (self.img, self.action, self.table, *self.tracks.values()))
        self.horizon = int(dataset.horizon)
        self.data_aug = bool(getattr(dataset, "data_aug", False))

    def split(self, dataset) -> "DeviceReplayDataset":
        """``dataset``'s windows (another split of the same replay buffer,
        e.g. ``get_validation_dataset()``) over this store, which is not
        copied."""
        return DeviceReplayDataset(dataset, self.device, (self.img, self.tracks, self.action))

    def __len__(self) -> int:
        return self.table.shape[0]

    @property
    def frame_hw(self):
        return tuple(self.img.shape[1:3])

    def gather(self, idxs: np.ndarray, frame_indices: Optional[np.ndarray] = None,
               aug: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, Any]:
        """A batch, gathered on the device: the frames ``obs[image_key]``
        uint8 (B, F, C, H, W) at the window slots ``frame_indices`` (all when
        None), the full-window low-dim tracks (PushT's ``obs["agent_pos"]``)
        and ``action``, and with
        augmentation the per-sample ``aug_top``/``aug_left``/``aug_sigma``
        that ``aug`` carries (``compute_loss`` applies them)."""
        to_dev = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self.device, non_blocking=True)
        rows = self.table[to_dev(idxs, torch.int64)]  # (B, L)
        if frame_indices is not None:
            img_rows = rows[:, to_dev(frame_indices, torch.int64)]
        else:
            img_rows = rows
        obs = {self.image_key: self.img[img_rows].permute(0, 1, 4, 2, 3),
               **{k: track[rows] for k, track in self.tracks.items()}}
        if self.data_aug and aug is not None:
            obs["aug_top"] = to_dev(aug["aug_top"], torch.int64)
            obs["aug_left"] = to_dev(aug["aug_left"], torch.int64)
            obs["aug_sigma"] = to_dev(aug["aug_sigma"], torch.float32)
        return {"obs": obs, "action": self.action[rows]}
