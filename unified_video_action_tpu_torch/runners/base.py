"""Runner interface and env-runner loader (the port's counterpart of the JAX
package's ``runners/base.py``).

Equivalents of the reference's ``BaseImageRunner`` (env_runner/
base_image_runner.py:1-10) and ``load_env_runner`` / ``env_rollout``
(utils/load_env.py:7-60). The port runs PushT only: the libero and robomimic
runners are refused until their slices come.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


class BaseImageRunner:
    def __init__(self, output_dir: Optional[str] = None):
        self.output_dir = output_dir

    def run(self, policy, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        raise NotImplementedError


def load_env_runner(cfg, output_dir: Optional[str] = None):
    """Instantiate the env runner for ``cfg["task"]`` (a plain nested dict,
    e.g. an exported checkpoint's ``meta.json`` ``cfg``)."""
    task = cfg["task"]
    er_cfg = dict(task.get("env_runner", {}))
    target = er_cfg.pop("_target_", "")
    name = task.get("name", "")

    if "pusht" in name or "pusht" in target:
        from unified_video_action_tpu_torch.runners.pusht_runner import PushTImageRunner

        return PushTImageRunner(output_dir=output_dir, **er_cfg)
    if ("libero" in name or "libero" in target or "robomimic" in target
            or name in ("toolhang", "square", "can", "lift")):
        raise NotImplementedError(f"the {name!r} runner is not ported yet; only pusht")
    raise ValueError(f"no runner for task {name!r} (target {target!r})")


def env_rollout(policy, runners, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Run one or many runners and average their per-task test scores into
    ``test_mean_score`` (reference utils/load_env.py:33-60, eval_sim.py:57-70).
    Every log names its env backend (``env_backend``)."""
    if not isinstance(runners, (list, tuple)):
        runners = [runners]
    log: Dict[str, Any] = {}
    test_scores: List[float] = []
    backends = set()
    for runner in runners:
        r = runner.run(policy, generator)
        prefix = getattr(runner, "log_prefix", "")
        backends.add(getattr(runner, "env_backend", "real"))
        for k, v in r.items():
            log[prefix + k] = v
        if "test/mean_score" in r:
            test_scores.append(r["test/mean_score"])
    if test_scores:
        log["test_mean_score"] = float(sum(test_scores) / len(test_scores))
    log["env_backend"] = "+".join(sorted(backends))
    return log
