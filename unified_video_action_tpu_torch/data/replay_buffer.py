"""Episode replay buffer (the port's own copy of ``data/replay_buffer.py``,
held in memory): a time-major dict of ``data`` arrays plus the
``episode_ends``. It loads two formats: a ``.npz`` holding the ``data``
arrays and ``episode_ends`` (``tools/export_corpus.py`` writes one from a
committed HDF5 corpus, ``tools/gen_synthetic_umi.py`` the synthetic UMI
corpus; :meth:`ReplayBuffer.save` writes one), read with numpy alone, and
the JAX package's HDF5 format through ``h5py``, imported where such a file
is read, which raises where ``h5py`` is absent. The zarr stores and writing
HDF5 wait for a later slice.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, data: Optional[Dict[str, np.ndarray]] = None,
                 episode_ends: Optional[np.ndarray] = None):
        self.data: Dict[str, np.ndarray] = data or {}
        self.episode_ends = (np.asarray(episode_ends, dtype=np.int64) if episode_ends is not None
                             else np.zeros(0, dtype=np.int64))

    @property
    def n_episodes(self) -> int:
        return len(self.episode_ends)

    @property
    def n_steps(self) -> int:
        return 0 if self.n_episodes == 0 else int(self.episode_ends[-1])

    @classmethod
    def create_empty(cls) -> "ReplayBuffer":
        return cls()

    @property
    def episode_lengths(self) -> np.ndarray:
        return self.episode_ends - np.concatenate([[0], self.episode_ends[:-1]])

    def keys(self):
        return self.data.keys()

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]

    def add_episode(self, episode: Dict[str, np.ndarray]) -> None:
        lengths = {k: len(v) for k, v in episode.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged episode: {lengths}")
        n = next(iter(lengths.values()))
        for k, v in episode.items():
            v = np.asarray(v)
            if k not in self.data:
                if self.n_episodes:
                    raise ValueError(f"new key {k} after episodes exist")
                self.data[k] = v.copy()
            else:
                self.data[k] = np.concatenate([self.data[k], v], axis=0)
        self.episode_ends = np.append(self.episode_ends, self.n_steps + n)

    def save(self, path: str) -> None:
        """An uncompressed ``.npz`` of the ``data`` arrays and
        ``episode_ends``, which :meth:`load` reads."""
        if not path.endswith(".npz"):
            raise ValueError(f"the port writes .npz replay buffers only, got {path!r}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, episode_ends=self.episode_ends, **self.data)

    @classmethod
    def load(cls, path: str, keys: Optional[Iterable[str]] = None) -> "ReplayBuffer":
        """A ``.npz`` replay buffer (the ``data`` arrays and
        ``episode_ends``) or an HDF5 one (``data/<key>`` arrays,
        ``meta/episode_ends``)."""
        if path.endswith(".npz"):
            with np.load(path) as z:
                names = list(keys) if keys is not None else [k for k in z.files
                                                             if k != "episode_ends"]
                return cls({k: z[k] for k in names}, z["episode_ends"])
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {path} needs h5py, which is not installed") from e
        with h5py.File(path, "r") as f:
            names = list(keys) if keys is not None else list(f["data"].keys())
            data = {k: f["data"][k][:] for k in names}
            episode_ends = f["meta"]["episode_ends"][:]
        return cls(data, episode_ends)
