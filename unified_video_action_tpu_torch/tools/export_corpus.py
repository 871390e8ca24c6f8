#!/usr/bin/env python3
"""Write a numpy copy of a committed HDF5 replay buffer, which the port reads
with numpy alone (``ReplayBuffer.load`` of a ``.npz``).

    python3 unified_video_action_tpu_torch/tools/export_corpus.py \
        data_release/pusht_demos_r5b.h5.zst corpora/pusht_demos_r5b.npz

The source is an HDF5 replay buffer (``data/<key>`` arrays and
``meta/episode_ends``), zstd-compressed where its name ends in ``.zst``. It
needs ``h5py`` (and ``zstandard`` for a ``.zst``), which only this tool
imports: the card's machine has neither. The copy is an
``np.savez_compressed`` archive holding ``img``, ``state``, ``action`` and
``episode_ends``. The tool prints one JSON line: the episodes, the steps,
each array's shape and dtype, the copy's bytes and the seconds taken.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import time
from typing import Dict, Sequence

import numpy as np

KEYS = ("img", "state", "action")


def read_hdf5(path: str, keys: Sequence[str] = KEYS) -> Dict[str, np.ndarray]:
    """``keys`` of an HDF5 replay buffer at ``path`` (a ``.zst`` is
    decompressed in memory) and its ``episode_ends``, as numpy arrays."""
    import h5py

    if path.endswith(".zst"):
        import zstandard

        with open(path, "rb") as f:
            source = io.BytesIO(zstandard.ZstdDecompressor().stream_reader(f).read())
    else:
        source = path
    with h5py.File(source, "r") as f:
        out = {k: f["data"][k][:] for k in keys}
        out["episode_ends"] = f["meta"]["episode_ends"][:].astype(np.int64)
    return out


def export_corpus(src: str, dst: str, keys: Sequence[str] = KEYS) -> dict:
    """Write ``src``'s ``keys`` and ``episode_ends`` to ``dst`` (a
    compressed ``.npz``, written beside it and renamed into place)."""
    t0 = time.perf_counter()
    arrays = read_hdf5(src, keys)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = dst + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, dst)
    ends = arrays["episode_ends"]
    return {"src": src, "dst": dst, "episodes": int(len(ends)),
            "steps": int(ends[-1]) if len(ends) else 0,
            "arrays": {k: [list(v.shape), str(v.dtype)] for k, v in arrays.items()},
            "bytes": os.path.getsize(dst), "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="an HDF5 replay buffer, .h5 or .h5.zst")
    ap.add_argument("dst", help="the .npz to write")
    args = ap.parse_args(argv)
    print(json.dumps(export_corpus(args.src, args.dst)))


if __name__ == "__main__":
    main()
