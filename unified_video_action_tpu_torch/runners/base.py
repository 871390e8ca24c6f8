"""Runner interface and env-runner loader (the port's counterpart of the JAX
package's ``runners/base.py``).

Equivalents of the reference's ``BaseImageRunner`` (env_runner/
base_image_runner.py:1-10) and ``load_env_runner`` / ``env_rollout``
(utils/load_env.py:7-60): the task's runner, LIBERO expanding into one runner
per task store whose scores average into ``test_mean_score``
(eval_sim.py:57-70); and ``undo_transform_action``, the rot6d -> axis-angle
undo that the robomimic and LIBERO runners apply before stepping.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


class BaseImageRunner:
    env_backend = "real"

    def __init__(self, output_dir: Optional[str] = None):
        self.output_dir = output_dir

    def run(self, policy, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        raise NotImplementedError


def require_mujoco(what: str) -> None:
    """Raise an ImportError naming mujoco, gymnasium and gymnasium_robotics
    where one of them does not import: ``what`` (a runner's real-physics
    backend, ``envs/kitchen_env.py`` or ``envs/fetch_env.py``) needs all
    three."""
    from unified_video_action_tpu_torch.envs.kitchen_env import missing_physics_packages

    missing = missing_physics_packages()
    if missing:
        raise ImportError(f"{what} needs mujoco, gymnasium and gymnasium_robotics; "
                          f"{', '.join(missing)} is not installed. env_backend='stub' runs the "
                          "runner without them (its scores measure nothing)")


def env_action_dim(shape_meta: Optional[dict], abs_action: bool) -> int:
    """The width of the actions a runner steps its env with, the one rule of
    both runners' stubs: the task's action width as the policy makes it
    (the kitchen's 9-d joint velocities, Fetch's 4-d deltas), or after the
    rot6d undo 7 an arm; 7 (the LIBERO arm's, the width of JAX's stubs)
    where no shape_meta names an action."""
    shape = (shape_meta or {}).get("action", {}).get("shape")
    if not shape:
        return 7
    return (int(shape[0]) // 10) * 7 if abs_action else int(shape[0])


def undo_transform_action(action: np.ndarray, rot_tf) -> np.ndarray:
    """Abs-action (..., 10) pos3 + rot6d + grip -> (..., 7) pos3 +
    axis_angle + grip for env stepping; two arms (..., 20) -> (..., 14)
    (reference robomimic_image_runner.py:368-385, shared by the libero
    runner via libero_image_runner.py:110-118,352-355)."""
    d = action.shape[-1]
    is_dual = d == 20
    a = action.reshape(*action.shape[:-1], 2, 10) if is_dual else action[..., None, :]
    pos, rot6, grip = a[..., :3], a[..., 3:9], a[..., 9:]
    rot = rot_tf.inverse(rot6)
    out = np.concatenate([pos, rot, grip], axis=-1)
    return out.reshape(*action.shape[:-1], -1)


def load_env_runner(cfg, output_dir: Optional[str] = None):
    """Instantiate the env runner(s) for ``cfg["task"]`` (a plain nested
    dict, e.g. an exported checkpoint's ``meta.json`` ``cfg``): one runner,
    or a list for libero and the kitchen (one per task store); Fetch takes
    the robomimic runner."""
    task = cfg["task"]
    er_cfg = dict(task.get("env_runner", {}))
    target = er_cfg.pop("_target_", "")
    name = task.get("name", "")

    if "pusht" in name or "pusht" in target:
        from unified_video_action_tpu_torch.runners.pusht_runner import PushTImageRunner

        return PushTImageRunner(output_dir=output_dir, **er_cfg)
    if "libero" in name or "kitchen" in name or "libero" in target:
        from unified_video_action_tpu_torch.runners.libero_runner import make_libero_runners

        er_cfg.setdefault("shape_meta", task.get("shape_meta"))  # the stubs' action width
        return make_libero_runners(output_dir=output_dir, **er_cfg)
    if "robomimic" in target or "fetch" in name or name in ("toolhang", "square", "can", "lift"):
        from unified_video_action_tpu_torch.runners.robomimic_runner import RobomimicImageRunner

        return RobomimicImageRunner(output_dir=output_dir, **er_cfg)
    raise ValueError(f"no runner for task {name!r} (target {target!r})")


def env_rollout(policy, runners, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Run one or many runners and average their per-task test scores into
    ``test_mean_score`` (reference utils/load_env.py:33-60, eval_sim.py:57-70).
    Every log names its env backend (``env_backend``); a stub backend's log
    also holds ``STUB_SCORES_NOT_REAL`` (its scores are a seed schedule,
    whatever the policy does), and a warning is printed."""
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
    if "stub" in backends:
        log["STUB_SCORES_NOT_REAL"] = True
        print("=" * 70 + "\nWARNING: one or more env runners used the 'stub' backend —"
              "\nscores below are a fixed seed schedule, NOT a policy evaluation.\n" + "=" * 70)
    return log
