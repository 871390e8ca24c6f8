"""Nested-dict utilities (the port's copy of ``utils/tree.py``; the
reference's ``common/pytorch_util.py``). The port's loops move batches to
the device with ``training/workspace.to_device_batch``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping


def dict_apply(d: Mapping[str, Any], fn: Callable) -> Dict[str, Any]:
    """``fn`` on every leaf that is not a dict, through nested dicts."""
    return {k: dict_apply(v, fn) if isinstance(v, dict) else fn(v) for k, v in d.items()}


def dict_apply_split(d: Mapping[str, Any],
                     split_fn: Callable[[Any], Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Every leaf split into named parts: ``{part: {key: value}}``."""
    results: Dict[str, Dict[str, Any]] = {}
    for key, value in d.items():
        for rk, rv in split_fn(value).items():
            results.setdefault(rk, {})[key] = rv
    return results


def dict_apply_reduce(dicts, reduce_fn: Callable) -> Dict[str, Any]:
    """The dicts reduced key by key (the first dict's keys)."""
    return {key: reduce_fn([d[key] for d in dicts]) for key in dicts[0]}
