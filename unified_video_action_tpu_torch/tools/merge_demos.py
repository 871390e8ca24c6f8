#!/usr/bin/env python3
"""Merge replay buffers of demos into one (the port's own copy of the JAX
package's ``scripts/merge_demos.py``): every episode of each input in
order, a missing input skipped, the result written through a temporary
file and renamed, with ``<out stem>_meta.json`` beside it (the episode and
step counts and the inputs). Inputs are any format ``ReplayBuffer.load``
reads; the output's path names its format (``.npz``, zarr, else HDF5).

    python3 unified_video_action_tpu_torch/tools/merge_demos.py --out data/pusht_demos_merged.npz \\
        data/pusht_demos.npz data/pusht_demos_extra.npz
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer  # noqa: E402


def _tmp_path(out: str) -> str:
    """``out`` with ``.tmp`` before its format's suffix, so the temporary
    file is written in the same format."""
    for suffix in (".npz", ".zarr.zip", ".zarr", ".zip"):
        if out.endswith(suffix):
            return out[:-len(suffix)] + ".tmp" + suffix
    return out + ".tmp"


def merge(inputs, out: str) -> dict:
    """Write the merged buffer to ``out``; returns its meta."""
    merged = ReplayBuffer.create_empty()
    for path in inputs:
        if not os.path.exists(path):
            print(f"skip (missing): {path}")
            continue
        buf = ReplayBuffer.load(path, lazy=ReplayBuffer._is_zarr(path))
        for i in range(buf.n_episodes):
            merged.add_episode(buf.get_episode(i))
        print(f"{path}: +{buf.n_episodes} episodes ({buf.n_steps} steps)")
    tmp = _tmp_path(out)
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    if ReplayBuffer._is_zarr(out):
        merged.save_zarr(tmp)
    else:
        merged.save(tmp)
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.replace(tmp, out)
    meta = {"episodes": merged.n_episodes, "steps": merged.n_steps, "sources": list(inputs)}
    with open(os.path.splitext(out)[0] + "_meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    print(json.dumps(merge(args.inputs, args.out)))


if __name__ == "__main__":
    main()
