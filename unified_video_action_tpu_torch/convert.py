"""Weight bridge: the JAX package's flax parameter trees -> the port's
``state_dict``.

The port's modules carry the flax module names, so a flax leaf at path
``(a, b, c, leaf)`` becomes the ``state_dict`` entry ``a.b.c.<name>``:

* Dense ``kernel`` (in, out)        -> ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw)
* LayerNorm / GroupNorm ``scale``   -> ``weight``
* ``bias`` and raw parameters (position embeddings, fake latents) keep
  their name and shape.
* Dense ``kernel`` bound for a W8A8 ``QuantLinear`` -> ``weight_q`` (out, in)
  int8 and ``w_scale`` (out,) fp32, quantized by ``ops.quant.quantize_weight``
  from the fp32 value before any cast to the compute dtype, as JAX's
  ``QuantDense`` quantizes its fp32 parameter inside the program. The int8
  model reads the same tree as the float one.

These are the inverses of ``linear_kernel`` and ``conv_kernel`` in the JAX
package's ``models/torch_import.py``, kept here as the port's own copy.
:func:`to_flax_tree` is the reverse map: a float module's parameters (or a
state of the same keys, such as the trainer's EMA) back to the flax tree,
as numpy; :func:`merge_params` overlays one flax tree on another where the
shapes match (the stage-1 -> stage-2 bootstrap), and :func:`save_flat_npz`
and :func:`load_flat_npz` write and read flat ``"a/b/c"``-keyed archives,
in fp32 or as bf16 bit patterns.

The bridge is strict: a leaf it cannot place (no such parameter, or another
shape) raises, and so does a port parameter that no leaf sets (the error
counts them by subtree). Subtrees of a JAX model that the port does not
build are named in ``skip`` by the caller. It writes nothing: no converted
checkpoint is stored; trees are converted when they are loaded.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from unified_video_action_tpu_torch.ops.quant import quantize_weight

Path = Tuple[str, ...]


def flatten_tree(tree: Mapping, prefix: Path = ()) -> Dict[Path, object]:
    """Nested dict -> {path tuple: leaf}."""
    out: Dict[Path, object] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten_tree(flat: Mapping[str, object]) -> Dict[str, Dict]:
    """{``"a/b/c"``: leaf} -> nested dict."""
    tree: Dict[str, Dict] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> the uint16 bit patterns of its bf16 rounding (to nearest
    even, as ``torch.Tensor.to(torch.bfloat16)``); numpy has no bf16."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the fp32 values they hold (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def save_flat_npz(path: str, trees: Mapping[str, Mapping], dtype: str = "float32") -> None:
    """Write ``{prefix: flax tree}`` as one uncompressed ``.npz`` keyed
    ``"<prefix>/a/b/c"``: fp32 arrays, or under ``dtype="bfloat16"`` their
    bf16 roundings as uint16 bit patterns (:func:`load_flat_npz` needs the
    same ``dtype`` to read them back)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
    cast = to_bf16_bits if dtype == "bfloat16" else (lambda x: np.asarray(x, np.float32))
    flat = {"/".join((prefix,) + path): cast(v) for prefix, tree in trees.items()
            for path, v in flatten_tree(tree).items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_flat_npz(path: str, dtype: str = "float32") -> Dict[str, Dict]:
    """A flat ``"a/b/c"``-keyed ``.npz`` (as ``scripts/train_vae.py`` writes
    the VAE, read by ``policy.py:267-283``, or :func:`save_flat_npz` an
    export) -> nested dict of arrays. Under ``dtype="bfloat16"`` the arrays
    are uint16 bf16 bit patterns and come back as the fp32 values they
    hold."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
    with np.load(path) as z:
        flat = {k: from_bf16_bits(z[k]) if dtype == "bfloat16" else z[k] for k in z.files}
    return unflatten_tree(flat)


def merge_params(init_tree: Mapping, imported: Mapping) -> Tuple[Dict, list]:
    """Overlay ``imported``'s leaves onto ``init_tree`` where the key exists
    and the shapes match (the JAX package's ``merge_params``,
    ``models/torch_import.py:296-321``). Returns ``(merged, skipped)``:
    ``skipped`` names each imported leaf left out, ``"<path> (unexpected)"``
    or ``"<path> (shape <imported> vs <init>)"``. A leaf of ``init_tree``
    that ``imported`` lacks keeps its value and is not listed."""
    skipped = []

    def rec(dst, src, path):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                skipped.append("/".join(path + (k,)) + " (unexpected)")
                continue
            if isinstance(v, Mapping):
                out[k] = rec(dst[k], v, path + (k,))
            elif tuple(np.shape(dst[k])) != tuple(np.shape(v)):
                skipped.append("/".join(path + (k,)) + f" (shape {np.shape(v)} vs {np.shape(dst[k])})")
            else:
                out[k] = v
        return out

    return rec(init_tree, imported, ()), skipped


def port_key(path: Path, ndim: int) -> Tuple[str, str]:
    """(state_dict key, layout change) of the flax leaf at ``path`` with
    ``ndim`` dimensions. The change is ``"linear"``, ``"conv"`` or ``"none"``."""
    *mods, leaf = path
    if leaf == "kernel":
        if ndim == 2:
            return ".".join(mods + ["weight"]), "linear"
        if ndim == 4:
            return ".".join(mods + ["weight"]), "conv"
        raise ValueError(f"kernel {'/'.join(path)} has {ndim} dims; only Dense and 2-D Conv map")
    if leaf == "scale":
        return ".".join(mods + ["weight"]), "none"
    return ".".join(path), "none"


def _port_shape(shape: Tuple[int, ...], change: str) -> Tuple[int, ...]:
    if change in ("linear", "quant"):
        return (shape[1], shape[0])
    if change == "quant_scale":
        return (shape[1],)
    if change == "conv":
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(shape)


def _to_port_layout(x: np.ndarray, change: str) -> np.ndarray:
    if change == "linear":
        return np.ascontiguousarray(x.T)
    if change == "conv":
        return np.ascontiguousarray(np.transpose(x, (3, 2, 0, 1)))
    return np.asarray(x)


def _skipped(path: Path, skip: Iterable[Path]) -> bool:
    return any(path[: len(s)] == tuple(s) for s in skip)


def plan(flax_shapes: Mapping[Path, Tuple[int, ...]],
         port_shapes: Mapping[str, Tuple[int, ...]],
         skip: Iterable[Path] = ()) -> Dict[str, Tuple[Path, str]]:
    """Check that every flax leaf (outside ``skip``) lands on a port
    parameter of the right shape and that every port parameter is set.
    A Dense kernel whose layer holds ``weight_q`` instead of ``weight`` (a
    ``QuantLinear``) sets both ``weight_q`` and ``w_scale``.
    Returns {state_dict key: (flax path, layout change)}; raises ValueError
    listing every leaf left unmapped and every parameter left unset."""
    skip = [tuple(s) for s in skip]
    mapping: Dict[str, Tuple[Path, str]] = {}
    unmapped = []
    for path, shape in flax_shapes.items():
        if _skipped(path, skip):
            continue
        key, change = port_key(path, len(shape))
        targets = [(key, change)]
        stem = key[: -len("weight")]
        if change == "linear" and key not in port_shapes and stem + "weight_q" in port_shapes:
            targets = [(stem + "weight_q", "quant"), (stem + "w_scale", "quant_scale")]
        wants = [port_shapes.get(k) for k, _ in targets]
        if any(w is None or tuple(w) != _port_shape(tuple(shape), c)
               for w, (_, c) in zip(wants, targets)):
            unmapped.append(f"{'/'.join(path)} {tuple(shape)} -> {targets[0][0]} {wants[0]}")
            continue
        mapping.update((k, (path, c)) for k, c in targets)
    unset = sorted(set(port_shapes) - set(mapping))
    if unmapped or unset:
        # the subtrees whose parameters no leaf sets, e.g. a VAE tree without
        # its decoder: {"decoder": 164, "post_quant_conv": 2}
        subtrees: Dict[str, int] = {}
        for key in unset:
            subtrees[key.split(".")[0]] = subtrees.get(key.split(".")[0], 0) + 1
        raise ValueError(
            f"{len(unmapped)} flax leaves unmapped: {unmapped[:8]}; "
            f"{len(unset)} port parameters unset, by subtree {subtrees}: {unset[:8]}"
        )
    return mapping


def module_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def load_into(module: nn.Module, tree: Mapping, skip: Iterable[Path] = ()) -> nn.Module:
    """Set every parameter of ``module`` from the flax-layout ``tree`` of
    numpy arrays, casting to the parameters' dtype and device."""
    flat = flatten_tree(tree)
    mapping = plan({p: np.shape(v) for p, v in flat.items()}, module_shapes(module), skip)
    quantized: Dict[Path, Tuple[torch.Tensor, torch.Tensor]] = {}

    def value(path: Path, change: str) -> torch.Tensor:
        x = np.asarray(flat[path], dtype=np.float32)
        if change in ("quant", "quant_scale"):
            if path not in quantized:
                quantized[path] = quantize_weight(torch.from_numpy(x))
            w_q, scale = quantized[path]
            return w_q.T.contiguous() if change == "quant" else scale
        return torch.tensor(_to_port_layout(x, change))

    state = {key: value(path, change) for key, (path, change) in mapping.items()}
    module.load_state_dict(state, strict=True)
    return module


def flax_paths(module: nn.Module) -> Dict[str, Tuple[Path, str]]:
    """{state_dict key: (flax path, layout change)} of every entry of
    ``module`` that a flax leaf sets (a QuantLinear's ``w_scale`` is derived
    from its kernel and left out): the inverse of :func:`port_key`."""
    out: Dict[str, Tuple[Path, str]] = {}
    norm_types = (nn.LayerNorm, nn.GroupNorm)
    owners = dict(module.named_modules())
    for key in module.state_dict():
        *mods, leaf = key.split(".")
        owner = owners[".".join(mods)]
        if leaf == "weight" and isinstance(owner, norm_types):
            out[key] = (tuple(mods) + ("scale",), "none")
        elif leaf == "weight" and isinstance(owner, nn.Linear):
            out[key] = (tuple(mods) + ("kernel",), "linear")
        elif leaf == "weight_q":
            out[key] = (tuple(mods) + ("kernel",), "quant")
        elif leaf == "w_scale":
            continue
        elif leaf == "weight" and isinstance(owner, nn.Conv2d):
            out[key] = (tuple(mods) + ("kernel",), "conv")
        else:
            out[key] = (tuple(mods) + (leaf,), "none")
    return out


def _flax_shape(shape: Tuple[int, ...], change: str) -> Tuple[int, ...]:
    if change in ("linear", "quant"):
        return (shape[1], shape[0])
    if change == "conv":
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


def flax_layout_shapes(module: nn.Module) -> Dict[Path, Tuple[int, ...]]:
    """The flax tree layout (path -> shape) that ``module`` loads from."""
    shapes = module_shapes(module)
    return {path: _flax_shape(shapes[key], change)
            for key, (path, change) in flax_paths(module).items()}


def from_flax_tree(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The flax-layout ``tree`` as fp32 CPU tensors under ``module``'s
    parameter names, in the port's layout (the inverse of
    :func:`to_flax_tree`, exact); every name must have its leaf."""
    flat = flatten_tree(tree)
    return {key: torch.from_numpy(_to_port_layout(np.asarray(flat[path], np.float32), change))
            for key, (path, change) in flax_paths(module).items()}


def to_flax_tree(module: nn.Module, state: Mapping[str, torch.Tensor] = None) -> Dict[str, Dict]:
    """``module``'s parameters, or ``state`` (tensors under ``module``'s
    state_dict keys), as the flax tree of fp32 numpy arrays that
    :func:`load_into` reads. A W8A8 ``QuantLinear`` holds no float kernel to
    return and raises."""
    state = module.state_dict() if state is None else state
    tree: Dict[str, Dict] = {}
    for key, (path, change) in flax_paths(module).items():
        if change == "quant":
            raise ValueError(f"{key}: a QuantLinear holds no float kernel")
        x = state[key].detach().float().cpu().numpy()
        if change == "linear":
            x = x.T
        elif change == "conv":
            x = np.transpose(x, (2, 3, 1, 0))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return tree


def seeded_tree(module: nn.Module, seed: int) -> Dict[str, Dict]:
    """A flax-layout tree of random weights for ``module``, made with numpy
    from ``seed``: kernels N(0, 1/fan_in), biases N(0, 0.02²), norm scales
    1 + N(0, 0.02²), raw parameters N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Dict] = {}
    for path, shape in sorted(flax_layout_shapes(module).items()):
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            value = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)
        elif leaf == "scale":
            value = 1.0 + 0.02 * rng.standard_normal(shape, dtype=np.float32)
        else:
            value = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = value.astype(np.float32)
    return tree
