"""Sequence sampler over replay-buffer episodes (the port's own copy of
``data/sampler.py``): (buffer_start, buffer_end, sample_start, sample_end)
index rows over the episodes with ``pad_before``/``pad_after``, windows
with edge-replication padding, and seeded validation masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer


def create_indices(episode_ends: np.ndarray, sequence_length: int, episode_mask: np.ndarray,
                   pad_before: int = 0, pad_after: int = 0) -> np.ndarray:
    pad_before = min(max(pad_before, 0), sequence_length - 1)
    pad_after = min(max(pad_after, 0), sequence_length - 1)
    rows = []
    for i in range(len(episode_ends)):
        if not episode_mask[i]:
            continue
        start_idx = 0 if i == 0 else int(episode_ends[i - 1])
        episode_length = int(episode_ends[i]) - start_idx
        for idx in range(-pad_before, episode_length - sequence_length + pad_after + 1):
            buffer_start = max(idx, 0) + start_idx
            buffer_end = min(idx + sequence_length, episode_length) + start_idx
            sample_start = buffer_start - (idx + start_idx)
            sample_end = sequence_length - ((idx + sequence_length + start_idx) - buffer_end)
            rows.append((buffer_start, buffer_end, sample_start, sample_end))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def get_val_mask(n_episodes: int, val_ratio: float, seed: int = 0) -> np.ndarray:
    val_mask = np.zeros(n_episodes, dtype=bool)
    if val_ratio <= 0:
        return val_mask
    n_val = min(max(1, round(n_episodes * val_ratio)), n_episodes - 1)
    rng = np.random.default_rng(seed=seed)
    val_mask[rng.choice(n_episodes, size=n_val, replace=False)] = True
    return val_mask


def downsample_mask(mask: np.ndarray, max_n: Optional[int], seed: int = 0) -> np.ndarray:
    if max_n is None or mask.sum() <= max_n:
        return mask
    curr = np.nonzero(mask)[0]
    rng = np.random.default_rng(seed=seed)
    keep = curr[rng.choice(len(curr), size=int(max_n), replace=False)]
    out = np.zeros_like(mask)
    out[keep] = True
    return out


class SequenceSampler:
    def __init__(self, replay_buffer: ReplayBuffer, sequence_length: int, pad_before: int = 0,
                 pad_after: int = 0, keys=None, episode_mask: Optional[np.ndarray] = None):
        if episode_mask is None:
            episode_mask = np.ones(replay_buffer.n_episodes, dtype=bool)
        self.indices = (
            create_indices(replay_buffer.episode_ends, sequence_length, episode_mask,
                           pad_before=pad_before, pad_after=pad_after)
            if episode_mask.any() else np.zeros((0, 4), dtype=np.int64)
        )
        self.keys = list(replay_buffer.keys()) if keys is None else list(keys)
        self.sequence_length = sequence_length
        self.replay_buffer = replay_buffer

    def __len__(self) -> int:
        return len(self.indices)

    def sample_sequence(self, idx: int) -> Dict[str, np.ndarray]:
        buffer_start, buffer_end, sample_start, sample_end = self.indices[idx]
        result = {}
        for key in self.keys:
            arr = self.replay_buffer[key]
            sample = arr[buffer_start:buffer_end]
            if sample_start > 0 or sample_end < self.sequence_length:
                data = np.zeros((self.sequence_length,) + arr.shape[1:], dtype=arr.dtype)
                if sample_start > 0:
                    data[:sample_start] = sample[0]
                if sample_end < self.sequence_length:
                    data[sample_end:] = sample[-1]
                data[sample_start:sample_end] = sample
                sample = data
            result[key] = sample
        return result
