"""Language goals as 512-d text latents (port of ``utils/language.py``:
``CLIP_DIM``, ``HashTextEncoder`` at :25-43 and ``get_text_encoder`` at
:116-129).

The JAX package encodes a goal with the CLIP text tower
(``openai/clip-vit-base-patch32``, max_length 30, 77 for libero) where the
tower's weights and tokenizer are on the host, and otherwise with
``HashTextEncoder``: a fixed unit-norm 512-d vector per string, drawn from a
generator seeded by the string's sha256. The port has no CLIP tower yet, so
``get_text_encoder`` returns the hash encoder, bit-equal to the JAX
package's, with the max_length the JAX function gives; that is the JAX
package's own encoder on a host without the CLIP weights.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

CLIP_DIM = 512


class HashTextEncoder:
    """A fixed unit-norm 512-d vector for each string, from its sha256: the
    first 8 bytes, little-endian, seed ``np.random.default_rng``, whose
    standard normal draw is normalized. No learned weights."""

    dim = CLIP_DIM

    def encode(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """A string or a sequence of n strings -> (n, 512) float32."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


def get_text_encoder(task_name: Optional[str],
                     language_emb_model: Optional[str]) -> Tuple[Optional[HashTextEncoder], Optional[int]]:
    """``(encoder, max_length)``, or ``(None, None)`` when no language model
    is configured (PushT). ``language_emb_model`` must be ``"clip"``; the
    encoder is :class:`HashTextEncoder` (the CLIP tower is not ported) and
    max_length is CLIP's token budget, 77 for libero tasks and 30 otherwise."""
    if language_emb_model is None:
        return None, None
    if language_emb_model != "clip":
        raise ValueError(f"language_emb_model must be 'clip' or None, got {language_emb_model!r}")
    max_length = 77 if (task_name and "libero" in task_name) else 30
    return HashTextEncoder(), max_length
