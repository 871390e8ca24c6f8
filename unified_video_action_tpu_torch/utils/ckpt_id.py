"""Checkpoint identity digests (the port's copy of the JAX package's
``utils/ckpt_id.py``).

Quality evidence (50-seed eval logs) is only meaningful if it describes the
exact weights evaluated: ``eval_sim_torch.py`` stamps ``ckpt_digest`` into
every eval log, as the JAX package's ``eval_sim.py`` does, so the port's
logs and the JAX package's name the same checkpoint by the same digest.

The digest is a sha256 over every file under the checkpoint directory
(sorted relative paths + contents), so any change to the stored weights,
embedded config, or normalizer changes the identity. For a single-file
checkpoint the digest is over that file.
"""

from __future__ import annotations

import hashlib
import os


def ckpt_digest(path: str) -> str:
    """Content digest of a checkpoint directory (or single file)."""
    h = hashlib.sha256()
    if os.path.isfile(path):
        _update_file(h, path, os.path.basename(path))
        return h.hexdigest()
    entries = []
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            entries.append((os.path.relpath(p, path), p))
    for rel, p in sorted(entries):
        _update_file(h, p, rel)
    return h.hexdigest()


def _update_file(h: "hashlib._Hash", path: str, rel: str) -> None:
    h.update(rel.encode())
    h.update(b"\0")
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    h.update(b"\0")
