"""A LIBERO-style benchmark registry over the executable env backends (the
port's own copy of the JAX package's ``envs/benchmark.py``).

The reference organizes its evaluation suites through a registry
(env/libero/benchmark/__init__.py:1-219): a case-insensitive
``register_benchmark`` / ``get_benchmark_dict`` / ``get_benchmark`` map, a
``Task`` NamedTuple (name, language, problem, problem_folder, bddl_file,
init_states_file) and a ``Benchmark`` base class with the task enumeration
(``get_num_tasks`` / ``get_task_names`` / ``get_task``), the init states of
a task (``get_task_init_states``), its demonstration path
(``get_task_demonstration``) and the language embeddings
(``set_task_embs`` / ``get_task_emb``). The suites:

* ``KITCHEN``: the 7 Franka-kitchen subtasks (mujoco physics, software
  rendering; ``envs/kitchen_env.py``). Init states are mujoco ``qpos`` +
  ``qvel`` vectors recorded from seeded resets.
* ``FETCH``: pick-and-place and push over mujoco's Fetch scene
  (``envs/fetch_env.py``), init states by the env's ``get_state`` after
  resets with ``np.random`` seeded (JAX's calls ``env.seed``, which its
  FetchImageEnv lacks).
* ``LIBERO_SPATIAL``, ``LIBERO_OBJECT``, ``LIBERO_GOAL``, ``LIBERO_90``,
  ``LIBERO_10`` and ``LIBERO_100``: the upstream ``libero`` package's task
  map where it is installed, an ImportError naming ``libero`` where it is
  not. ``libero_manifest.json`` beside this module pins that task map
  (``load_manifest``).

``task_order(index, n)``: order 0 is the identity, order ``i > 0`` the
shuffle of ``numpy.random.RandomState(i)`` (the reference ships a table of
21 permutations instead). The envs, and so ``mujoco``, are imported where a
task's env is built.
"""

from __future__ import annotations

import abc
import json
import os
from typing import Dict, List, NamedTuple, Type

import numpy as np

from unified_video_action_tpu_torch.envs.kitchen_tasks import KITCHEN_TASK_PROMPTS, _slug

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "libero_manifest.json")

BENCHMARK_MAPPING: Dict[str, Type["Benchmark"]] = {}


def load_manifest() -> dict:
    """The pinned upstream LIBERO task map: ``{"suites": {suite: {"tasks",
    "bddl_files", "n_tasks"}}}``."""
    with open(MANIFEST_PATH) as f:
        return json.load(f)


def register_benchmark(target_class):
    """A case-insensitive registry, the reference's contract."""
    BENCHMARK_MAPPING[target_class.__name__.lower()] = target_class
    return target_class


def get_benchmark_dict(help=False):
    if help:
        print("Available benchmarks:")
        for benchmark_name in BENCHMARK_MAPPING:
            print(f"\t{benchmark_name}")
    return BENCHMARK_MAPPING


def get_benchmark(benchmark_name: str) -> Type["Benchmark"]:
    return BENCHMARK_MAPPING[benchmark_name.lower()]


def print_benchmark():
    print(BENCHMARK_MAPPING)


class Task(NamedTuple):
    name: str
    language: str
    problem: str
    problem_folder: str
    bddl_file: str
    init_states_file: str


def grab_language_from_filename(x: str) -> str:
    """A LIBERO file name -> its language goal (the reference's rule: a
    LIBERO-100 name drops its SCENE prefix, a lowercase suite takes the whole
    stem; the '.bddl' suffix trimmed)."""
    if x and x[0].isupper():  # LIBERO-100 style
        idx = x.find("SCENE")
        if idx >= 0:
            offset = 8 if "SCENE10" in x else 7
            language = " ".join(x[idx + offset:].split("_"))
        else:
            language = " ".join(x.split("_"))
    else:
        language = " ".join(x.split("_"))
    en = language.find(".bddl")
    return language[:en] if en >= 0 else language


def task_order(index: int, n_tasks: int) -> List[int]:
    """The task permutation of ``task_order_index``."""
    if index == 0:
        return list(range(n_tasks))
    perm = np.arange(n_tasks)
    np.random.RandomState(index).shuffle(perm)
    return perm.tolist()


class Benchmark(abc.ABC):
    """A benchmark: an ordered list of tasks with init states and language."""

    name: str = "benchmark"

    def __init__(self, task_order_index: int = 0):
        self.task_embs = None
        self.task_order_index = int(task_order_index)

    def _make_benchmark(self):
        tasks = self._suite_tasks()
        if len(tasks) == 10 or self.task_order_index:
            tasks = [tasks[i] for i in task_order(self.task_order_index, len(tasks))]
        self.tasks = tasks
        self.n_tasks = len(self.tasks)

    @abc.abstractmethod
    def _suite_tasks(self) -> List[Task]:
        """The suite's tasks in canonical order."""

    # -- enumeration (the reference's Benchmark surface) -------------------

    def get_num_tasks(self) -> int:
        return self.n_tasks

    def get_task_names(self) -> List[str]:
        return [task.name for task in self.tasks]

    def get_task_problems(self) -> List[str]:
        return [task.problem for task in self.tasks]

    def get_task_bddl_files(self) -> List[str]:
        return [task.bddl_file for task in self.tasks]

    def get_task(self, i: int) -> Task:
        return self.tasks[i]

    def get_task_demonstration(self, i: int) -> str:
        assert 0 <= i < self.n_tasks, f"[error] task number {i} is outside of range {self.n_tasks}"
        t = self.tasks[i]
        return f"{t.problem_folder}/{t.name}_demo.hdf5"

    # -- language embeddings ---------------------------------------------

    def get_task_emb(self, i: int):
        return self.task_embs[i]

    def set_task_embs(self, task_embs):
        self.task_embs = task_embs

    # -- init states and envs -----------------------------------------------

    def get_task_init_states(self, i: int, n: int = 8) -> np.ndarray:
        """(n, state_dim) simulator states for repeatable evaluation resets,
        recorded from resets of task ``i``'s env at seeds 1000 i + k."""
        env = self.make_task_env(i)
        try:
            states = []
            for k in range(n):
                self._seed_env(env, 1000 * i + k)
                env.reset()
                states.append(np.asarray(self._env_state(env), np.float64))
            return np.stack(states)
        finally:
            env.close()

    @staticmethod
    def _seed_env(env, seed: int) -> None:
        env.seed(seed)

    @staticmethod
    def _env_state(env) -> np.ndarray:
        if hasattr(env, "get_sim_state"):
            return env.get_sim_state()
        return env.get_state()["states"]

    def make_task_env(self, i: int, camera_heights: int = 128, camera_widths: int = 128):
        """The executable env of task ``i``."""
        raise NotImplementedError(f"{type(self).__name__} has no executable env backend here")


# --------------------------------------------------------------------------
# the executable suites (mujoco physics)
# --------------------------------------------------------------------------


@register_benchmark
class KITCHEN(Benchmark):
    """The Franka-kitchen suite: 7 language-conditioned subtasks."""

    def __init__(self, task_order_index: int = 0):
        super().__init__(task_order_index=task_order_index)
        self.name = "kitchen"
        self._make_benchmark()

    def _suite_tasks(self) -> List[Task]:
        return [Task(name=f"kitchen_{_slug(t)}", language=prompt, problem="FrankaKitchen",
                     problem_folder="kitchen",
                     bddl_file="",  # kitchen tasks are defined by predicates, not BDDL
                     init_states_file=f"kitchen_{_slug(t)}.init")
                for t, prompt in KITCHEN_TASK_PROMPTS.items()]

    def make_task_env(self, i, camera_heights=128, camera_widths=128):
        from unified_video_action_tpu_torch.envs.kitchen_env import KitchenImageEnv

        subtask = self.tasks[i].name[len("kitchen_"):].replace("_", " ")
        return KitchenImageEnv(tasks=[subtask], camera_heights=camera_heights,
                               camera_widths=camera_widths)


@register_benchmark
class FETCH(Benchmark):
    """mujoco's Fetch tabletop suite (the pick-and-place family)."""

    TASKS = (
        ("fetch_pick_and_place", "pick up the block and move it to the goal",
         "FetchPickAndPlace-v4"),
        ("fetch_push", "push the block to the goal", "FetchPush-v4"),
    )

    def __init__(self, task_order_index: int = 0):
        super().__init__(task_order_index=task_order_index)
        self.name = "fetch"
        self._make_benchmark()

    def _suite_tasks(self) -> List[Task]:
        return [Task(name=name, language=lang, problem="Fetch", problem_folder="fetch",
                     bddl_file="", init_states_file=f"{name}.init")
                for name, lang, _env_id in self.TASKS]

    def make_task_env(self, i, camera_heights=84, camera_widths=84):
        from unified_video_action_tpu_torch.envs.fetch_env import FetchImageEnv

        env_id = {n: e for n, _l, e in self.TASKS}[self.tasks[i].name]
        return FetchImageEnv(env_id=env_id, camera_heights=camera_heights,
                             camera_widths=camera_widths)

    @staticmethod
    def _seed_env(env, seed: int) -> None:
        # EnvRobosuite's contract: reset draws its episode seed from np.random
        # (JAX's FETCH calls env.seed, which its FetchImageEnv lacks)
        np.random.seed(seed)

    @staticmethod
    def _env_state(env) -> np.ndarray:
        return env.get_state()["states"]


# --------------------------------------------------------------------------
# the upstream LIBERO suites (where the libero package is installed)
# --------------------------------------------------------------------------


class _UpstreamLiberoBenchmark(Benchmark):
    """The tasks of the installed ``libero`` package's task map (the
    reference registry's source)."""

    def __init__(self, task_order_index: int = 0):
        super().__init__(task_order_index=task_order_index)
        self.name = type(self).__name__.lower()
        self._make_benchmark()

    def _suite_tasks(self) -> List[Task]:
        try:
            from libero.libero.benchmark.libero_suite_task_map import libero_task_map
        except ImportError as e:
            raise ImportError(f"benchmark {self.name!r} needs the LIBERO benchmark package "
                              "(libero), which is not installed") from e
        suites = ["libero_90", "libero_10"] if self.name == "libero_100" else [self.name]
        return [Task(name=task, language=grab_language_from_filename(task + ".bddl"),
                     problem="Libero", problem_folder=suite, bddl_file=f"{task}.bddl",
                     init_states_file=f"{task}.pruned_init")
                for suite in suites for task in libero_task_map[suite]]

    def get_task_init_states(self, i: int, n: int = 8) -> np.ndarray:
        import torch
        from libero.libero import get_libero_path

        path = os.path.join(get_libero_path("init_states"), self.tasks[i].problem_folder,
                            self.tasks[i].init_states_file)
        return np.asarray(torch.load(path))

    def make_task_env(self, i, camera_heights=128, camera_widths=128):
        from libero.libero import get_libero_path
        from libero.libero.envs import OffScreenRenderEnv

        bddl = os.path.join(get_libero_path("bddl_files"), self.tasks[i].problem_folder,
                            self.tasks[i].bddl_file)
        return OffScreenRenderEnv(bddl_file_name=bddl, camera_heights=camera_heights,
                                  camera_widths=camera_widths)


@register_benchmark
class LIBERO_SPATIAL(_UpstreamLiberoBenchmark):
    pass


@register_benchmark
class LIBERO_OBJECT(_UpstreamLiberoBenchmark):
    pass


@register_benchmark
class LIBERO_GOAL(_UpstreamLiberoBenchmark):
    pass


@register_benchmark
class LIBERO_90(_UpstreamLiberoBenchmark):
    pass


@register_benchmark
class LIBERO_10(_UpstreamLiberoBenchmark):
    pass


@register_benchmark
class LIBERO_100(_UpstreamLiberoBenchmark):
    pass
