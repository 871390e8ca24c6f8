"""Checkpoints, the slim export, top-k management and the metric log (the
port's counterpart of ``training/checkpoint.py:1-248``).

A checkpoint is a directory:

* ``state.pt`` (``torch.save``): the step, the MAR's fp32 parameters and
  their EMA, each as ``{"a/b/c": tensor}`` in the flax layout (so a
  checkpoint names its leaves without the module that wrote it, and the
  stage bootstrap can merge it into another model), AdamW's state dict (its
  moments), the scheduler's state dict, and the frozen VAE's fp32 flax tree
  (encoder and decoder), so a checkpoint serves without ``autoencoder_path``;
* ``meta.json``: ``epoch``, ``step`` and ``cfg``;
* ``normalizer.npz``.

The slim export (:func:`export_slim`) is a directory of ``weights.npz``
(the EMA weights and the VAE under ``mar/<flax path>`` and ``vae/<flax
path>``, in fp32 or as bf16 bit patterns, ``convert.save_flat_npz``),
``meta.json`` (``cfg``, ``slim: true``, ``export_dtype``, ``epoch``,
``step``) and ``normalizer.npz``: what ``eval_sim_torch.py -c`` serves.

Every write goes to ``<path>.tmp`` and is published by renaming the old
directory aside to ``<path>.old`` first, so at no instant is there neither;
:func:`load_checkpoint` falls back to ``.old``, then ``.tmp``. With
``blocking=False`` the device-to-host copy is taken before
:func:`save_checkpoint` returns and the disk write runs in a background
thread (JAX's orbax write overlaps the next epoch the same way);
:func:`wait_for_checkpoints` waits for it and raises what it raised.

    python -m unified_video_action_tpu_torch.training.checkpoint export CKPT OUT [--dtype float32]

writes the slim export of a checkpoint directory (its EMA weights).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer

PAYLOAD = "state.pt"
WEIGHTS = "weights.npz"

# the background writes of non-blocking saves: [thread, [exception or None]]
_PENDING: List[Tuple[threading.Thread, list]] = []


def _publish(tmp: str, final: str) -> None:
    """Rename-aside publish: ``final`` moves to ``final.old`` before ``tmp``
    takes its place, so a crash between the renames leaves the previous
    checkpoint at ``.old``."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.replace(final, old)
    os.replace(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)


def wait_for_checkpoints() -> None:
    """Wait for every background write; re-raise the first that failed."""
    errors = []
    while _PENDING:
        thread, error = _PENDING.pop(0)
        thread.join()
        errors += error
    if errors:
        raise errors[0]


def _write_dir(path: str, files: Mapping[str, Any], blocking: bool) -> None:
    """Write ``files`` ({name: writer(file path)}) into ``path.tmp`` and
    publish it at ``path``, now or in a background thread."""
    def write():
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, writer in files.items():
            writer(os.path.join(tmp, name))
        _publish(tmp, path)

    if blocking:
        write()
        return
    error: list = []

    def run():
        try:
            write()
        except BaseException as e:  # raised again by wait_for_checkpoints
            error.append(e)

    thread = threading.Thread(target=run, name=f"checkpoint {os.path.basename(path)}")
    thread.start()
    _PENDING.append((thread, error))


def _json_writer(obj):
    def write(p):
        with open(p, "w") as f:
            json.dump(obj, f, indent=2, default=str)
    return write


def _common_files(meta: dict, normalizer: Optional[LinearNormalizer]) -> dict:
    files = {"meta.json": _json_writer(meta)}
    if normalizer is not None:
        flat = {k: np.array(v, copy=True) for k, v in normalizer.to_flat_dict().items()}
        files["normalizer.npz"] = lambda p: np.savez(p, **flat)
    return files


@torch.no_grad()
def _flax_tensors(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (``module``'s parameter names, port layout) as fp32 CPU
    tensors in the flax layout keyed ``"a/b/c"``: transposed on their
    device, then copied to the host."""
    out = {}
    for key, (path, change) in convert.flax_paths(module).items():
        x = tensors[key].detach().float()
        if change == "linear":
            x = x.t()
        elif change == "conv":
            x = x.permute(2, 3, 1, 0)
        elif change != "none":
            raise ValueError(f"{key}: a {change} leaf holds no float weight")
        out["/".join(path)] = x.contiguous().to("cpu", copy=True)
    return out


def _host_tree_tensors(tree: Mapping) -> Dict[str, torch.Tensor]:
    return {"/".join(p): torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for p, v in convert.flatten_tree(tree).items()}


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def host_payload(state) -> Dict[str, Any]:
    """``state``'s payload with every tensor copied to the host."""
    mar = state.mar
    return {
        "step": int(state.step),
        "mar": _flax_tensors(mar, dict(mar.named_parameters())),
        "ema": _flax_tensors(mar, state.ema),
        "optimizer": _to_host(state.optimizer.state_dict()),
        "scheduler": _to_host(state.scheduler.state_dict()),
        "vae": _host_tree_tensors(state.policy.vae_params()),
    }


def save_checkpoint(path: str, state, cfg: Optional[dict] = None,
                    normalizer: Optional[LinearNormalizer] = None, epoch: int = 0,
                    blocking: bool = True) -> None:
    """Write ``state`` (a ``TrainState``) as the checkpoint directory
    ``path``. The host copy is taken before this returns; with
    ``blocking=False`` the disk write and the publish run in a background
    thread. A save first waits for the one before it."""
    path = os.path.abspath(path)
    wait_for_checkpoints()
    payload = host_payload(state)
    meta = {"epoch": int(epoch), "step": int(state.step)}
    if cfg is not None:
        meta["cfg"] = json.loads(json.dumps(cfg, default=str))  # as it is now
    files = {PAYLOAD: lambda p: torch.save(payload, p), **_common_files(meta, normalizer)}
    _write_dir(path, files, blocking)


def export_slim(path: str, mar_tree: Mapping, vae_tree: Mapping, cfg: Optional[dict] = None,
                normalizer: Optional[LinearNormalizer] = None, dtype: str = "bfloat16",
                epoch: int = 0, step: int = 0) -> None:
    """Write the slim export directory ``path``: ``weights.npz`` of
    ``mar_tree`` (the EMA weights) and ``vae_tree`` in ``dtype``,
    ``meta.json`` and ``normalizer.npz``. Blocking."""
    path = os.path.abspath(path)
    meta = {"epoch": int(epoch), "step": int(step), "slim": True, "export_dtype": dtype}
    if cfg is not None:
        meta["cfg"] = cfg
    files = {WEIGHTS: lambda p: convert.save_flat_npz(p, {"mar": mar_tree, "vae": vae_tree}, dtype),
             **_common_files(meta, normalizer)}
    _write_dir(path, files, blocking=True)


def _existing(path: str) -> str:
    """``path``, or where it is absent the ``.old`` or ``.tmp`` that a crash
    mid-publish left."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        for cand in (path + ".old", path + ".tmp"):
            if os.path.exists(cand):
                return cand
    return path


def read_meta(path: str) -> dict:
    with open(os.path.join(_existing(path), "meta.json")) as f:
        return json.load(f)


def is_port_checkpoint(path: str) -> bool:
    """Whether ``path`` (or the ``.old`` or ``.tmp`` beside it, where it is
    absent) is a checkpoint directory of the port, full or slim."""
    path = _existing(path)
    return any(os.path.exists(os.path.join(path, n)) for n in (PAYLOAD, WEIGHTS))


def _numpy_tree(flat: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    return convert.unflatten_tree({k: v.numpy() for k, v in flat.items()})


def read_weights(path: str) -> Tuple[Dict[str, Dict], Dict[str, Dict]]:
    """``(mar_tree, vae_tree)`` of a checkpoint directory as fp32 numpy flax
    trees: the EMA weights (the parameters where a payload has no EMA) and
    the VAE."""
    wait_for_checkpoints()
    path = _existing(path)
    meta = read_meta(path)
    if meta.get("slim"):
        tree = convert.load_flat_npz(os.path.join(path, WEIGHTS), meta.get("export_dtype", "float32"))
        return tree["mar"], tree["vae"]
    payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True,
                         mmap=True)
    return _numpy_tree(payload.get("ema") or payload["mar"]), _numpy_tree(payload["vae"])


@torch.no_grad()
def load_checkpoint(path: str, state):
    """Restore the checkpoint directory ``path`` into ``state`` (a
    ``TrainState`` of the same model) in place; returns ``(state, meta,
    normalizer)``. A full checkpoint restores the parameters, the EMA,
    AdamW's moments, the scheduler, the step and the VAE exactly. A slim
    export sets the parameters and the EMA to its weights and the step to
    its step, and leaves the optimizer and the scheduler at their start."""
    wait_for_checkpoints()  # the path may have a write in flight
    path = _existing(path)
    meta = read_meta(path)
    norm_path = os.path.join(path, "normalizer.npz")
    normalizer = LinearNormalizer.load(norm_path) if os.path.exists(norm_path) else None
    mar, policy = state.mar, state.policy
    if meta.get("slim"):
        mar_tree, vae_tree = read_weights(path)
        weights = ema = convert.from_flax_tree(mar, mar_tree)
        step = int(meta.get("step", 0))
    else:
        payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)
        tree = lambda key: convert.unflatten_tree(payload[key])
        weights = convert.from_flax_tree(mar, tree("mar"))
        ema = convert.from_flax_tree(mar, tree("ema"))
        vae_tree = _numpy_tree(payload["vae"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        step = int(payload["step"])
    for name, p in mar.named_parameters():
        p.copy_(weights[name])
        state.ema[name].copy_(ema[name])
    policy.vae_tree = vae_tree
    convert.load_into(policy.vae, vae_tree)
    state.step = step
    return state, meta, normalizer


class TopKCheckpointManager:
    """Keep the k best checkpoints by a monitored metric (mode max or min,
    names from ``format_str``); JAX's, path for path."""

    def __init__(self, save_dir: str, monitor_key: str, mode: str = "max", k: int = 1,
                 format_str: str = "epoch={epoch:04d}-{monitor:.3f}"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.save_dir = save_dir
        self.monitor_key = monitor_key
        self.mode = mode
        self.k = k
        self.format_str = format_str
        self.kept: Dict[str, float] = {}

    def get_ckpt_path(self, data: Dict[str, Any]) -> Optional[str]:
        """The path to save ``data``'s checkpoint at, or None where it is not
        among the k best; the checkpoint it displaces is deleted."""
        if self.k <= 0 or self.monitor_key not in data:
            return None
        value = float(data[self.monitor_key])
        path = os.path.join(self.save_dir, self.format_str.format(**data))
        if len(self.kept) < self.k:
            self.kept[path] = value
            return path
        worst_path, worst_val = sorted(self.kept.items(), key=lambda kv: kv[1],
                                       reverse=(self.mode == "min"))[0]
        better = value > worst_val if self.mode == "max" else value < worst_val
        if not better:
            return None
        del self.kept[worst_path]
        if os.path.exists(worst_path):
            shutil.rmtree(worst_path, ignore_errors=True)
        self.kept[path] = value
        return path


class JsonLogger:
    """Line-buffered jsonl metric log, appended to; JAX's line for line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {k: (float(v) if isinstance(v, (int, float, np.floating)) or hasattr(v, "item") else v)
               for k, v in data.items()}
        if step is not None:
            rec["_step"] = int(step)
        self._f.write(json.dumps(rec, default=float) + "\n")

    def close(self) -> None:
        self._f.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write the slim export of a checkpoint directory.")
    sub = ap.add_subparsers(dest="command", required=True)
    ex = sub.add_parser("export", help="CKPT's EMA weights, VAE, cfg and normalizer to OUT")
    ex.add_argument("checkpoint")
    ex.add_argument("out")
    ex.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    meta = read_meta(args.checkpoint)
    mar_tree, vae_tree = read_weights(args.checkpoint)
    norm_path = os.path.join(_existing(args.checkpoint), "normalizer.npz")
    normalizer = LinearNormalizer.load(norm_path) if os.path.exists(norm_path) else None
    export_slim(args.out, mar_tree, vae_tree, meta.get("cfg"), normalizer, args.dtype,
                meta.get("epoch", 0), meta.get("step", 0))
    print(json.dumps({"export": os.path.abspath(args.out), "from": args.checkpoint,
                      "epoch": meta.get("epoch"), "step": meta.get("step"),
                      "bytes": os.path.getsize(os.path.join(args.out, WEIGHTS))}))


if __name__ == "__main__":
    main()
