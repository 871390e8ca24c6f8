"""Frame-index selection and the action split (the port's own copy of
``utils/frames.py:15-74``): which frames of a window condition the policy or
train it, and which actions are its target. Runs on the host in numpy.

Serving (``eval=True``): a window of T frames yields ``select_timesteps``
frames at stride T / select_timesteps, ending at frame ``select_timesteps -
1`` of the last stride (for T = 16: frames 3, 7, 11, 15). Training: twice as
many at half the stride, the first half conditioning and the second the
target (for T = 32: 3, 7, ..., 31). With ``different_history_freq`` the
four history frames are one row of ``HISTORY_COMBINATIONS``, every
non-decreasing 4-tuple over 0..15 that ends at 15 (the reference's table,
data_utils.py:14-16), drawn from the caller's numpy generator.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Optional, Tuple

import numpy as np

HISTORY_COMBINATIONS = np.array(
    [c for c in combinations_with_replacement(range(16), 4) if c[-1] == 15], dtype=np.int64)


def select_frame_indices(total_frames: int, select_timesteps: int = 4, eval: bool = True,
                         different_history_freq: bool = False,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """``select_frame_indices(total_frames, eval, select_timesteps,
    different_history_freq, rng)`` of the JAX package; the history draw
    (training only) takes one integer from ``rng``, which must be given."""
    n = select_timesteps if eval else select_timesteps * 2
    idx = np.arange(0, total_frames, total_frames // n) + select_timesteps - 1
    if different_history_freq and not eval:
        if rng is None:
            raise ValueError("different_history_freq draws from rng: pass a numpy Generator")
        hist = HISTORY_COMBINATIONS[rng.integers(len(HISTORY_COMBINATIONS))]
        idx = np.concatenate([hist, idx[len(idx) // 2:]])
    return idx.astype(np.int64)


def split_trajectory(actions, total_frames: int, shift_action: bool,
                     use_history_action: bool = False) -> Tuple[Optional[object], object]:
    """(history, future) actions of a (B, T, A) window (reference
    get_trajectory, data_utils.py:368-388): with ``shift_action`` the future
    is the 16 actions from T/2 - 1, else the second half; the history is
    None without ``use_history_action``. Works on numpy arrays and tensors."""
    T = total_frames
    if use_history_action:
        if shift_action:
            return actions[:, : T // 2], actions[:, T // 2: -1]
        trimmed = actions[:, 1:]
        half = trimmed.shape[1] // 2
        return trimmed[:, :half], trimmed[:, half:]
    if shift_action:
        return None, actions[:, T // 2 - 1: -1]
    return None, actions[:, actions.shape[1] // 2:]
