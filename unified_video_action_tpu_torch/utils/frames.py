"""Frame-index selection (the port's own copy of the eval path of
``utils/frames.py:27-50``): which frames of an observation window condition
the policy. A window of T frames yields ``select_timesteps`` frames at stride
T / select_timesteps, ending at frame ``select_timesteps - 1`` of the last
stride (for T = 16: frames 3, 7, 11, 15). Runs on the host in numpy.
"""

from __future__ import annotations

import numpy as np


def select_frame_indices(total_frames: int, select_timesteps: int = 4) -> np.ndarray:
    """``select_frame_indices(total_frames, eval=True)`` of the JAX package;
    the training selection waits for the training slice."""
    idx = np.arange(0, total_frames, total_frames // select_timesteps) + select_timesteps - 1
    return idx.astype(np.int64)
