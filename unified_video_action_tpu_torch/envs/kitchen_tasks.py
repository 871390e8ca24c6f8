"""The kitchen suite's task names and language prompts (the port's own copy
of the pure-data helpers of the JAX package's ``envs/kitchen_env.py:30-56``:
``KITCHEN_TASK_PROMPTS``, ``_slug`` and ``task_from_name``).

They stay apart from the kitchen env (``envs/kitchen_env.py``, which needs
mujoco and gymnasium_robotics), so that a dataset or runner named after a
kitchen task resolves the same prompt as in the JAX package where mujoco is
not installed.
"""

from __future__ import annotations

from typing import Optional

#: language prompts per kitchen subtask
KITCHEN_TASK_PROMPTS = {
    "microwave": "open the microwave door",
    "kettle": "move the kettle to the back left burner",
    "light switch": "turn on the light switch",
    "slide cabinet": "slide open the cabinet door",
    "hinge cabinet": "open the hinge cabinet door",
    "bottom burner": "turn the oven knob that activates the bottom burner",
    "top burner": "turn the oven knob that activates the top burner",
}


def _slug(task: str) -> str:
    return task.replace(" ", "_")


def task_from_name(name: str) -> Optional[str]:
    """kitchen_microwave_demo.hdf5 / kitchen_light_switch -> task key."""
    base = name.rsplit("/", 1)[-1]
    for task in KITCHEN_TASK_PROMPTS:
        if _slug(task) in base:
            return task
    return None
