#!/usr/bin/env python3
"""Write the three-dataset synthetic UMI corpus (cup, towel, mouse) as
reference-layout zarr v2 stores ``<root>/<name>.zarr``: the counterpart of
the JAX package's ``scripts/gen_synthetic_umi.py``, the same episodes
(``make_synthetic_umi`` with seeds 100, 101, 102) written through
``ReplayBuffer.save_zarr``. ``config.UMI_MULTI`` names these paths.

    python3 unified_video_action_tpu_torch/tools/gen_synthetic_umi.py --root data/umi --episodes 12
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from unified_video_action_tpu_torch.data.umi_dataset import make_synthetic_umi  # noqa: E402

NAMES = ("cup", "towel", "mouse")


def write_corpus(root: str, episodes: int = 12, episode_len: int = 120,
                 image_size: int = 224, compressors: Optional[dict] = None,
                 suffixes: Optional[dict] = None) -> dict:
    """{name: path} of the three stores written under ``root``.
    ``compressors`` is ``save_zarr``'s ({key: codec config}; keys it does
    not list get the blosc default); ``suffixes`` gives a dataset another
    store than ``.zarr`` (``{"mouse": ".zarr.zip"}``)."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for i, name in enumerate(NAMES):
        t0 = time.perf_counter()
        buf = make_synthetic_umi(n_episodes=episodes, episode_len=episode_len, seed=100 + i,
                                 image_size=image_size)
        paths[name] = os.path.join(root, name + (suffixes or {}).get(name, ".zarr"))
        buf.save_zarr(paths[name], compressors=compressors)
        print(f"{paths[name]}: {episodes} episodes, {buf.n_steps} steps, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="data/umi")
    p.add_argument("--episodes", type=int, default=12)
    p.add_argument("--episode-len", type=int, default=120)
    p.add_argument("--image-size", type=int, default=224)
    args = p.parse_args(argv)
    write_corpus(args.root, args.episodes, args.episode_len, args.image_size)


if __name__ == "__main__":
    main()
