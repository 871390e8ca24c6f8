"""Experiment trackers (the port's copy of ``training/trackers.py``): the
step log's metrics to a run directory, or to ``wandb`` where it imports.

- :class:`OfflineRunTracker` writes ``<output_dir>/tracker/`` with
  ``config.json``, ``metrics.jsonl`` (one line per logged step: the metrics
  and ``_step``, wandb's history format) and ``summary.json`` (the last value
  of each key); ``log_video(key, path, step)`` copies a GIF into its
  ``media/`` as ``<step>_<key>.gif`` and logs ``{key: {"_type":
  "video-file", "path": ...}}``, the row wandb's videos take (JAX's
  ``log_video``).
- :class:`WandbTracker` logs through ``wandb``, imported where it is built.
- :class:`MultiTracker` fans out to several sinks; ``logging.mode:
  disabled`` gives one with none.

:func:`build_tracker` always writes the offline run directory, and under
``logging.mode: online`` (or ``wandb``) logs to ``wandb`` beside it where
``wandb`` imports. Under ``offline`` the JAX package logs to ``wandb``'s own
offline run where the package is installed; the port writes only its run
directory, which holds the same history, and starts no ``wandb`` service.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    # one odd metric or config leaf never stops the epoch loop: arrays become
    # lists, anything else its repr
    try:
        return float(v)
    except Exception:
        if hasattr(v, "tolist"):
            try:
                return v.tolist()
            except Exception:
                pass
        return str(v)


class Tracker:
    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        raise NotImplementedError

    def log_video(self, key: str, path: str, step: Optional[int] = None) -> None:
        pass

    def finish(self) -> None:
        pass


class OfflineRunTracker(Tracker):
    """A wandb-like run directory, with no dependency."""

    def __init__(self, output_dir: str, config: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None, project: Optional[str] = None):
        self.run_dir = os.path.join(output_dir, "tracker")
        os.makedirs(self.run_dir, exist_ok=True)
        meta = {"name": name, "project": project}
        if config is not None:
            meta["config"] = _jsonable(config)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        self._hist = open(os.path.join(self.run_dir, "metrics.jsonl"), "a", buffering=1)
        self._summary: Dict[str, Any] = {}

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {k: _jsonable(v) for k, v in data.items()}
        if step is not None:
            rec["_step"] = int(step)
        self._hist.write(json.dumps(rec, default=str) + "\n")
        self._summary.update(rec)
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=2, default=str)

    def log_video(self, key: str, path: str, step: Optional[int] = None) -> None:
        if not os.path.exists(path):
            return
        media = os.path.join(self.run_dir, "media")
        os.makedirs(media, exist_ok=True)
        dst = os.path.join(media, f"{step if step is not None else 0}_{key.replace('/', '_')}"
                                  f"{os.path.splitext(path)[1]}")
        shutil.copyfile(path, dst)
        self.log({key: {"_type": "video-file", "path": os.path.relpath(dst, self.run_dir)}},
                 step=step)

    def finish(self) -> None:
        self._hist.close()


class WandbTracker(Tracker):
    def __init__(self, output_dir: str, config=None, name=None, project=None,
                 mode: str = "offline"):
        import wandb

        self.run = wandb.init(dir=output_dir, config=_jsonable(config) if config else None,
                              name=name, project=project, mode=mode)

    def log(self, data, step=None):
        self.run.log({k: _jsonable(v) for k, v in data.items()}, step=step)

    def log_video(self, key, path, step=None):
        if os.path.exists(path):
            import wandb

            self.run.log({key: wandb.Video(path)}, step=step)

    def finish(self):
        self.run.finish()


class MultiTracker(Tracker):
    def __init__(self, *trackers: Tracker):
        self.trackers = [t for t in trackers if t is not None]

    def log(self, data, step=None):
        for t in self.trackers:
            t.log(data, step=step)

    def log_video(self, key, path, step=None):
        for t in self.trackers:
            t.log_video(key, path, step=step)

    def finish(self):
        for t in self.trackers:
            t.finish()


def build_tracker(logging_cfg: Optional[Dict[str, Any]], output_dir: str,
                  config: Optional[Dict[str, Any]] = None) -> Tracker:
    """The tracker of the config's ``logging`` block (``name``, ``project``,
    ``mode``): none under ``disabled``; else the offline run directory, and
    ``wandb`` online beside it under ``online``/``wandb`` where it
    imports."""
    cfg = dict(logging_cfg or {})
    mode = str(cfg.get("mode", "offline"))
    name, project = cfg.get("name"), cfg.get("project")
    if mode == "disabled":
        return MultiTracker()
    trackers = [OfflineRunTracker(output_dir, config=config, name=name, project=project)]
    if mode in ("online", "wandb"):
        try:
            trackers.append(WandbTracker(output_dir, config=config, name=name, project=project,
                                         mode="online"))
        except ImportError:
            print("[tracker] wandb is not installed: logging to the offline run directory only",
                  flush=True)
    return MultiTracker(*trackers)
