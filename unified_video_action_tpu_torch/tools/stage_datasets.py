#!/usr/bin/env python3
"""Stage dataset archives onto local storage (the ``extract`` command of
the JAX package's ``scripts/stage_datasets.py``): every archive in a
directory unpacked under ``--out`` by a pool of threads. ``.zip``, ``.tar``,
``.tar.gz`` (``.tgz``) and ``.tar.lz4`` (the reference's UMI archives, the
lz4 tool's frame format, streamed through ``utils/lz4f.py``); another file
is skipped and named so. Tar members pass the standard library's ``data``
filter (no absolute paths, links out of ``--out`` or device files).

    python3 unified_video_action_tpu_torch/tools/stage_datasets.py extract data/raw --out /dev/shm/uva_data
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import os
import sys
import tarfile
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from unified_video_action_tpu_torch.utils import lz4f  # noqa: E402


def extract_one(path: str, out_dir: str) -> str:
    """``path`` unpacked under ``out_dir``; returns a line saying so."""
    os.makedirs(out_dir, exist_ok=True)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(out_dir)
    elif path.endswith(".tar.lz4"):
        with lz4f.open_frame(path) as stream, tarfile.open(fileobj=stream, mode="r|") as t:
            t.extractall(out_dir, filter="data")
    elif path.endswith((".tar", ".tar.gz", ".tgz")):
        with tarfile.open(path) as t:
            t.extractall(out_dir, filter="data")
    else:
        return path + " (skipped: unknown format)"
    return path + " -> " + out_dir


def extract_all(src_dir: str, out_dir: str, jobs: int = 4) -> list:
    paths = [os.path.join(src_dir, p) for p in sorted(os.listdir(src_dir)) if not p.startswith(".")]
    with futures.ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(lambda p: extract_one(p, out_dir), paths))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("extract")
    e.add_argument("src_dir")
    e.add_argument("--out", default="/dev/shm/uva_data")
    e.add_argument("--jobs", type=int, default=4)
    args = p.parse_args(argv)
    for line in extract_all(args.src_dir, args.out, args.jobs):
        print(line)


if __name__ == "__main__":
    main()
