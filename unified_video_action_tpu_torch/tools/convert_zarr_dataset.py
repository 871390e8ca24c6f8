#!/usr/bin/env python3
"""Convert a replay buffer between its formats: a zarr v2 store (a
directory ``*.zarr`` or a ``*.zip``), HDF5 and ``.npz`` (the port's own
copy of the JAX package's ``scripts/convert_zarr_dataset.py``). The source
is read lazily where it is zarr, and a zarr destination is written one
chunk row at a time, so a store larger than memory converts to zarr.

    python3 unified_video_action_tpu_torch/tools/convert_zarr_dataset.py in.zarr out.h5 [--keys img state action]
    python3 unified_video_action_tpu_torch/tools/convert_zarr_dataset.py in.h5 out.zarr
    python3 unified_video_action_tpu_torch/tools/convert_zarr_dataset.py in.zarr.zip out.npz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer  # noqa: E402


def convert(src: str, dst: str, keys=None) -> ReplayBuffer:
    """``src`` written to ``dst`` in the format its path names; returns the
    source buffer."""
    buf = ReplayBuffer.copy_from_path(src, keys=keys, lazy=ReplayBuffer._is_zarr(src))
    if dst.endswith((".zarr", ".zip")):
        buf.save_zarr(dst)
    else:
        buf.save(dst)
    return buf


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--keys", nargs="*", default=None)
    args = p.parse_args(argv)
    buf = convert(args.src, args.dst, args.keys)
    print(f"wrote {args.dst}: {buf.n_episodes} episodes, {buf.n_steps} steps, "
          f"keys={list(buf.keys())}")


if __name__ == "__main__":
    main()
