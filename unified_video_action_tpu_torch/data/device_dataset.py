"""Device-resident replay dataset (the port's own copy of
``data/device_dataset.py``: ``window_index_table`` at :40 and
``DeviceReplayDataset`` at :176-293).

The whole uint8 frame store, the state and action tracks and the window
table live on the device. A train step ships only the batch's sample
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


class DeviceReplayDataset:
    """A PushT-style dataset's replay buffer and windows on ``device``."""

    def __init__(self, dataset, device: Union[str, torch.device], store=None):
        self.device = torch.device(device)
        if store is None:
            rb = dataset.replay_buffer
            store = tuple(torch.from_numpy(np.asarray(a)).to(self.device) for a in (
                rb["img"],  # (N, H, W, C) uint8
                np.asarray(rb["state"], dtype=np.float32),
                np.asarray(rb["action"], dtype=np.float32)))
        self.img, self.state, self.action = store
        self.table = torch.from_numpy(window_index_table(dataset.sampler)).to(self.device)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (self.img, self.state, self.action, self.table))
        self.horizon = int(dataset.horizon)
        self.agent_pos_dim = int(getattr(dataset, "agent_pos_dim", 2))
        self.data_aug = bool(getattr(dataset, "data_aug", False))

    def split(self, dataset) -> "DeviceReplayDataset":
        """``dataset``'s windows (another split of the same replay buffer,
        e.g. ``get_validation_dataset()``) over this store, which is not
        copied."""
        return DeviceReplayDataset(dataset, self.device, (self.img, self.state, self.action))

    def __len__(self) -> int:
        return self.table.shape[0]

    @property
    def frame_hw(self):
        return tuple(self.img.shape[1:3])

    def gather(self, idxs: np.ndarray, frame_indices: Optional[np.ndarray] = None,
               aug: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, Any]:
        """A batch, gathered on the device: ``obs["image"]`` uint8 (B, F, C,
        H, W) at the window slots ``frame_indices`` (all when None), the
        full-window ``obs["agent_pos"]`` and ``action``, and with
        augmentation the per-sample ``aug_top``/``aug_left``/``aug_sigma``
        that ``aug`` carries (``compute_loss`` applies them)."""
        to_dev = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self.device, non_blocking=True)
        rows = self.table[to_dev(idxs, torch.int64)]  # (B, L)
        if frame_indices is not None:
            img_rows = rows[:, to_dev(frame_indices, torch.int64)]
        else:
            img_rows = rows
        obs = {"image": self.img[img_rows].permute(0, 1, 4, 2, 3),
               "agent_pos": self.state[rows][..., : self.agent_pos_dim]}
        if self.data_aug and aug is not None:
            obs["aug_top"] = to_dev(aug["aug_top"], torch.int64)
            obs["aug_left"] = to_dev(aug["aug_left"], torch.int64)
            obs["aug_sigma"] = to_dev(aug["aug_sigma"], torch.float32)
        return {"obs": obs, "action": self.action[rows]}
