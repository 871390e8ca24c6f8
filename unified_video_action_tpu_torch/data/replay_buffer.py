"""Episode replay buffer (the port's own copy of ``data/replay_buffer.py``):
a time-major dict of ``data`` arrays plus the ``episode_ends``.

Three on-disk formats, told apart by the path:

- **zarr v2**, the reference's own (``data/<key>`` arrays and
  ``meta/episode_ends`` in a directory store or a ``*.zarr.zip``), through
  :mod:`.zarrlite`: :meth:`ReplayBuffer.save_zarr` writes one chunk row at
  a time, and ``load(..., lazy=True)`` keeps each array a
  :class:`zarrlite.ZarrArray` that decodes only the chunks an index covers;
- **HDF5**, the JAX package's converted format, through ``h5py``, imported
  where such a file is read or written (it raises where ``h5py`` is
  absent, as on the card's machine);
- **``.npz``**, the ``data`` arrays and ``episode_ends`` in one numpy
  archive (``tools/export_corpus.py`` writes the committed corpus so), read
  and written with numpy alone.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5 replay buffers need h5py, which is not installed") from e
    return h5py


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

    def get_episode(self, idx: int) -> Dict[str, np.ndarray]:
        """Episode ``idx``'s steps of every key (read from a lazy array
        without the rest of it)."""
        start = 0 if idx == 0 else int(self.episode_ends[idx - 1])
        end = int(self.episode_ends[idx])
        return {k: np.asarray(v[start:end]) for k, v in self.data.items()}

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

    def drop_episode(self) -> None:
        """Remove the last episode."""
        if not self.n_episodes:
            raise ValueError("no episode to drop")
        start = int(self.episode_ends[-2]) if self.n_episodes > 1 else 0
        for k in self.data:
            self.data[k] = self.data[k][:start]
        self.episode_ends = self.episode_ends[:-1]

    # -- persistence --

    def save(self, path: str, compression: Optional[str] = "gzip") -> None:
        """An uncompressed ``.npz`` where ``path`` ends so, else HDF5 (the
        JAX package's layout: each ``data`` array chunked along time,
        ``compression`` on those over 64 KiB)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if path.endswith(".npz"):
            np.savez(path, episode_ends=self.episode_ends, **self.data)
            return
        with _h5py().File(path, "w") as f:
            g = f.create_group("data")
            for k, v in self.data.items():
                v = np.asarray(v)
                g.create_dataset(k, data=v, chunks=self._optimal_chunks(v),
                                 compression=compression if v.nbytes > 1 << 16 else None)
            f.create_group("meta").create_dataset("episode_ends", data=self.episode_ends)

    def save_zarr(self, path: str, compressors: Optional[Dict[str, object]] = None) -> None:
        """A reference-layout zarr v2 store (a directory, or a zip file where
        ``path`` ends in ``.zip``). ``compressors`` maps a key to its codec
        config (``{"img": {"id": "imagecodecs_jpeg2k", "level": 50}}``; such
        a key gets one frame a chunk); a key it does not list, and every key
        where it is None, gets the blosc default (JAX's meaning, ROADMAP
        C3). The arrays are written one chunk row at a time, so a lazy
        source is converted without being read whole."""
        from unified_video_action_tpu_torch.data import zarrlite

        root = zarrlite.open_group(path, mode="w" if str(path).endswith(".zip") else "a")
        g = root.require_group("data")
        compressors = compressors or {}
        for k, v in self.data.items():
            chunks = self._optimal_chunks(v)
            if k in compressors:
                chunks = (1,) + tuple(v.shape[1:])
            arr = g.create_dataset(k, shape=v.shape, dtype=v.dtype, chunks=chunks,
                                   compressor=compressors.get(k, "default"))
            t_chunk = max(chunks[0] if chunks else len(v), 1)
            for t0 in range(0, len(v), t_chunk):
                arr[t0:t0 + t_chunk] = np.asarray(v[t0:t0 + t_chunk])
        root.require_group("meta").create_dataset("episode_ends", data=self.episode_ends,
                                                  compressor=None)
        root.store.close()

    @staticmethod
    def _is_zarr(path: str) -> bool:
        p = str(path)
        if p.endswith((".zip", ".zarr")):
            return True
        return os.path.isdir(p) and (os.path.exists(os.path.join(p, ".zgroup"))
                                     or os.path.exists(os.path.join(p, "data", ".zgroup")))

    @classmethod
    def load(cls, path: str, keys: Optional[Iterable[str]] = None,
             lazy: bool = False) -> "ReplayBuffer":
        """A zarr store, a ``.npz`` or an HDF5 file. ``lazy`` (zarr only)
        keeps each array a :class:`zarrlite.ZarrArray`."""
        if cls._is_zarr(path):
            from unified_video_action_tpu_torch.data import zarrlite

            root = zarrlite.open_group(path, mode="r")
            group = root["data"]
            names = list(keys) if keys is not None else group.keys()
            data = {k: group[k] if lazy else group[k][:] for k in names}
            return cls(data, np.asarray(root["meta"]["episode_ends"][:]))
        if path.endswith(".npz"):
            with np.load(path) as z:
                names = list(keys) if keys is not None else [k for k in z.files
                                                             if k != "episode_ends"]
                return cls({k: z[k] for k in names}, z["episode_ends"])
        with _h5py().File(path, "r") as f:
            names = list(keys) if keys is not None else list(f["data"].keys())
            data = {k: f["data"][k][:] for k in names}
            episode_ends = f["meta"]["episode_ends"][:]
        return cls(data, episode_ends)

    copy_from_path = load  # the reference's name

    @staticmethod
    def _optimal_chunks(arr, target_bytes: int = 2 << 20):
        """Chunks along time only, about ``target_bytes`` each, every other
        axis whole (the reference's ``get_optimal_chunks``)."""
        if arr.ndim == 0 or arr.size == 0:
            return None
        item = arr.dtype.itemsize * int(np.prod(arr.shape[1:]))
        return (max(1, min(len(arr), target_bytes // max(item, 1))),) + tuple(arr.shape[1:])
