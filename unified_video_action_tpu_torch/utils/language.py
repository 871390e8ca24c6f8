"""Language goals as 512-d text latents (port of ``utils/language.py``:
``CLIP_DIM``, ``HashTextEncoder`` at :25-43, ``ClipTextEncoder`` at
:46-113 and ``get_text_encoder`` at :116-129).

The JAX package encodes a goal with the CLIP text tower
(``openai/clip-vit-base-patch32``, max_length 30, 77 for libero) where the
tower's weights and tokenizer are on the host, and otherwise with
``HashTextEncoder``: a fixed unit-norm 512-d vector per string, drawn from a
generator seeded by the string's sha256 (bit-equal to the JAX package's).
``get_text_encoder`` returns ``ClipTextEncoder`` when it is given the
tower's weights and the hash encoder otherwise: an explicit argument
decides, where JAX's function tries the tower and falls back on any
exception. The tower runs on token ids (``encode_ids``); its BPE tokenizer
waits for the vocabulary files (``vocab.json``, ``merges.txt``), so
``encode`` on strings raises.
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models.clip import ClipTextConfig, ClipTextModel
from unified_video_action_tpu_torch.utils.device import resolve_device

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


class ClipTextEncoder:
    """The CLIP text tower (``models/clip.ClipTextModel``), frozen, on
    ``device`` in ``dtype``, its weights the JAX tower's parameter tree
    (flax layout, numpy) through the weight bridge. It encodes token ids
    (:meth:`encode_ids`); strings wait for the tokenizer (:meth:`encode`)."""

    dim = CLIP_DIM

    def __init__(self, weights: Mapping, cfg=None, max_length: int = 30,
                 device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.cfg = cfg or ClipTextConfig()
        with torch.device(self.device):
            self.model = ClipTextModel(self.cfg)
        convert.load_into(self.model, weights)
        self.model.to(dtype).eval().requires_grad_(False)
        self.max_length = max_length

    @torch.no_grad()
    def encode_ids(self, input_ids) -> np.ndarray:
        """(n, N) token ids -> (n, 512) float32 text embeddings."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        return self.model(ids).float().cpu().numpy()

    def encode(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        raise NotImplementedError(
            "ClipTextEncoder.encode needs the CLIP BPE tokenizer, whose vocabulary (vocab.json, "
            "merges.txt) is not in the repository; pass token ids to encode_ids")


def get_text_encoder(task_name: Optional[str], language_emb_model: Optional[str],
                     clip_weights: Optional[Mapping] = None, **clip_kwargs
                     ) -> Tuple[Optional[Union[HashTextEncoder, ClipTextEncoder]], Optional[int]]:
    """``(encoder, max_length)``, or ``(None, None)`` when no language model
    is configured (PushT). ``language_emb_model`` must be ``"clip"``;
    max_length is CLIP's token budget, 77 for libero tasks and 30 otherwise.
    The encoder is :class:`ClipTextEncoder` on ``clip_weights`` (with
    ``clip_kwargs``) where they are given, else :class:`HashTextEncoder`."""
    if language_emb_model is None:
        return None, None
    if language_emb_model != "clip":
        raise ValueError(f"language_emb_model must be 'clip' or None, got {language_emb_model!r}")
    max_length = 77 if (task_name and "libero" in task_name) else 30
    if clip_weights is not None:
        return ClipTextEncoder(clip_weights, max_length=max_length, **clip_kwargs), max_length
    return HashTextEncoder(), max_length
