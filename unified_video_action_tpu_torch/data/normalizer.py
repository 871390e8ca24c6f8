"""Linear normalizer for actions (the port's own copy of the parts of
``data/normalizer.py`` that serving reads).

A field maps x to ``x * scale + offset`` over its last dimension; the policy
unnormalizes sampled actions with ``(x - offset) / scale``. Fields load from
the ``normalizer.npz`` that the JAX package's ``LinearNormalizer.save`` writes
(flat keys ``<field>.scale``, ``<field>.offset``, ``<field>.input_stats.*``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class NormalizerField:
    scale: np.ndarray
    offset: np.ndarray
    input_stats: Dict[str, np.ndarray]

    def _coeffs(self, x: torch.Tensor):
        scale = torch.as_tensor(self.scale, dtype=x.dtype, device=x.device)
        offset = torch.as_tensor(self.offset, dtype=x.dtype, device=x.device)
        return scale, offset

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        scale, offset = self._coeffs(x)
        return (x.reshape(-1, scale.shape[0]) * scale + offset).reshape(x.shape)

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        scale, offset = self._coeffs(x)
        return ((x.reshape(-1, scale.shape[0]) - offset) / scale).reshape(x.shape)

    @classmethod
    def identity(cls, dim: int = 1) -> "NormalizerField":
        return cls(
            scale=np.ones(dim, np.float32),
            offset=np.zeros(dim, np.float32),
            input_stats={
                "min": -np.ones(dim, np.float32),
                "max": np.ones(dim, np.float32),
                "mean": np.zeros(dim, np.float32),
                "std": np.ones(dim, np.float32),
            },
        )


@dataclasses.dataclass
class LinearNormalizer:
    fields: Dict[str, NormalizerField] = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> NormalizerField:
        return self.fields[key]

    def __contains__(self, key: str) -> bool:
        return key in self.fields

    @classmethod
    def from_flat_dict(cls, flat: Mapping[str, np.ndarray]) -> "LinearNormalizer":
        fields: Dict[str, NormalizerField] = {}
        for name in sorted({k.split(".")[0] for k in flat}):
            fields[name] = NormalizerField(
                scale=np.asarray(flat[f"{name}.scale"]),
                offset=np.asarray(flat[f"{name}.offset"]),
                input_stats={
                    sk: np.asarray(flat[f"{name}.input_stats.{sk}"])
                    for sk in ("min", "max", "mean", "std")
                    if f"{name}.input_stats.{sk}" in flat
                },
            )
        return cls(fields)

    @classmethod
    def load(cls, path: str) -> "LinearNormalizer":
        with np.load(path) as z:
            return cls.from_flat_dict(dict(z))
