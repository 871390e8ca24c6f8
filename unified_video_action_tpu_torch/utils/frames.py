"""Frame-index selection and the action split (the port's own copy of
``utils/frames.py:27-74``): which frames of a window condition the policy or
train it, and which actions are its target. Runs on the host in numpy.

Serving (``eval=True``): a window of T frames yields ``select_timesteps``
frames at stride T / select_timesteps, ending at frame ``select_timesteps -
1`` of the last stride (for T = 16: frames 3, 7, 11, 15). Training: twice as
many at half the stride, the first half conditioning and the second the
target (for T = 32: 3, 7, ..., 31). The random history frequency of
``different_history_freq`` waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def select_frame_indices(total_frames: int, select_timesteps: int = 4,
                         eval: bool = True) -> np.ndarray:
    """``select_frame_indices(total_frames, eval, select_timesteps)`` of the
    JAX package."""
    n = select_timesteps if eval else select_timesteps * 2
    idx = np.arange(0, total_frames, total_frames // n) + select_timesteps - 1
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
