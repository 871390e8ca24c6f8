"""Linear normalizer (the port's own copy of ``data/normalizer.py``: the
fields, ``fit_field`` and ``LinearNormalizer.fit`` at :68-140 in the
"limits" mode the datasets fit, and the npz format).

A field maps x to ``x * scale + offset`` over its last dimension; the policy
normalizes training actions with it and unnormalizes sampled actions with
``(x - offset) / scale``. ``fit`` maps each channel's range onto [-1, 1].
Fields load from and save to the ``normalizer.npz`` that the JAX package's
``LinearNormalizer.save`` writes (flat keys ``<field>.scale``,
``<field>.offset``, ``<field>.input_stats.*``).
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


    @classmethod
    def image_range(cls) -> "NormalizerField":
        """[0, 1] -> [-1, 1] (normalize_util.get_image_range_normalizer)."""
        return cls(
            scale=np.asarray([2.0], np.float32),
            offset=np.asarray([-1.0], np.float32),
            input_stats={
                "min": np.asarray([0.0], np.float32),
                "max": np.asarray([1.0], np.float32),
                "mean": np.asarray([0.5], np.float32),
                "std": np.asarray([np.sqrt(1 / 12)], np.float32),
            },
        )


def fit_field(data: np.ndarray, last_n_dims: int = 1, output_max: float = 1.0,
              output_min: float = -1.0, range_eps: float = 1e-4) -> NormalizerField:
    """A field fitted to ``data`` in JAX's "limits" mode: each channel of the
    last ``last_n_dims`` dimensions mapped from its range onto [output_min,
    output_max]; a channel whose range is below ``range_eps`` is shifted to
    the output's centre instead of scaled."""
    data = np.asarray(data, dtype=np.float32)
    dim = int(np.prod(data.shape[-last_n_dims:])) if last_n_dims > 0 else 1
    flat = data.reshape(-1, dim)
    input_min, input_max = flat.min(axis=0), flat.max(axis=0)
    input_range = input_max - input_min
    ignore = input_range < range_eps
    input_range = np.where(ignore, output_max - output_min, input_range)
    scale = (output_max - output_min) / input_range
    offset = output_min - scale * input_min
    offset = np.where(ignore, (output_max + output_min) / 2 - input_min, offset)
    return NormalizerField(
        scale=scale.astype(np.float32),
        offset=offset.astype(np.float32),
        input_stats={"min": input_min, "max": input_max, "mean": flat.mean(axis=0),
                     "std": flat.std(axis=0, ddof=1)},
    )


@dataclasses.dataclass
class LinearNormalizer:
    fields: Dict[str, NormalizerField] = dataclasses.field(default_factory=dict)

    def __getitem__(self, key: str) -> NormalizerField:
        return self.fields[key]

    def __contains__(self, key: str) -> bool:
        return key in self.fields

    def fit(self, data: Mapping[str, np.ndarray], last_n_dims: int = 1) -> None:
        """Fit a field to each array of ``data`` in "limits" mode."""
        for k, v in data.items():
            self.fields[k] = fit_field(v, last_n_dims=last_n_dims)

    def to_flat_dict(self) -> Dict[str, np.ndarray]:
        out = {}
        for k, f in self.fields.items():
            out[f"{k}.scale"] = f.scale
            out[f"{k}.offset"] = f.offset
            for sk, sv in f.input_stats.items():
                out[f"{k}.input_stats.{sk}"] = sv
        return out

    def save(self, path: str) -> None:
        np.savez(path, **self.to_flat_dict())

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
