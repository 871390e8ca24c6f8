"""Dotted config overrides (the port's minimal counterpart of the JAX
package's ``config/__init__.py:130-145``): ``apply_overrides(cfg,
["a.b=3", "c.d=ddim10"])`` sets nested keys of a plain dict, creating the
missing levels. Values are read as YAML scalars are: ``null``/``~``, ``true``
/``false``, integers, floats, JSON lists and maps, and otherwise the string.
Composing a config from the JAX package's yaml files is not ported: the
port reads the ``cfg`` that an exported checkpoint's ``meta.json`` embeds.
"""

from __future__ import annotations

import json
from typing import Any, Iterable


def parse_value(s: str) -> Any:
    low = s.strip().lower()
    if low in ("", "null", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.strip()[:1] in ("[", "{"):
        return json.loads(s)
    return s


def apply_overrides(cfg: dict, overrides: Iterable[str]) -> None:
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = parse_value(val)
