"""The port's benchmark registry (``envs/benchmark.py`` and its
``libero_manifest.json``) against the JAX package's, on the CPU.

Held equal to JAX's: the registry's names, every suite's ``Task`` tuples
(names, languages, files) at every ``task_order_index`` from 0 to 4,
``task_order``'s permutations, ``grab_language_from_filename``, the demo
paths, the kitchen's ``get_task_init_states(0, n=2)`` (mujoco states of
seeded resets, bit-equal; Fetch's, which JAX's registry cannot make, against
JAX's env), the six upstream LIBERO suites resolved
through a stand-in ``libero`` package built from the port's manifest (the
same task map as JAX's manifest) and, without it, an ImportError naming
``libero``.
"""

import json
import sys
import types

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.envs import benchmark as jb
from unified_video_action_tpu_torch.envs import benchmark as pb
from unified_video_action_tpu_torch.envs import kitchen_env

UPSTREAM = ("libero_spatial", "libero_object", "libero_goal", "libero_90", "libero_10",
            "libero_100")


def test_the_registries_name_the_same_suites():
    assert sorted(pb.get_benchmark_dict()) == sorted(jb.get_benchmark_dict())
    assert set(UPSTREAM) | {"kitchen", "fetch"} == set(pb.get_benchmark_dict())
    assert pb.get_benchmark("KITCHEN") is pb.get_benchmark("kitchen")
    assert pb.Task._fields == jb.Task._fields


@pytest.mark.parametrize("index", range(5))
@pytest.mark.parametrize("n", [7, 10, 90])
def test_task_order_equals_jax(index, n):
    got = pb.task_order(index, n)
    assert got == jb.task_order(index, n) and sorted(got) == list(range(n))


@pytest.mark.parametrize("name", ["KITCHEN_SCENE3_turn_on_the_stove.bddl",
                                  "KITCHEN_SCENE10_put_the_bowl_in_the_drawer.bddl",
                                  "LIVING_ROOM_put_the_cream_cheese.bddl", "pick_up_the_mug.bddl",
                                  "open_the_top_drawer", ""])
def test_language_from_filename_equals_jax(name):
    assert pb.grab_language_from_filename(name) == jb.grab_language_from_filename(name)


@pytest.mark.parametrize("suite", ["kitchen", "fetch"])
def test_executable_suites_equal_jax(suite):
    for index in range(5):
        ours, theirs = (pb.get_benchmark(suite)(task_order_index=index),
                        jb.get_benchmark(suite)(task_order_index=index))
        assert [tuple(t) for t in ours.tasks] == [tuple(t) for t in theirs.tasks]
        assert ours.name == theirs.name == suite and ours.get_num_tasks() == theirs.get_num_tasks()
        for i in range(ours.n_tasks):
            assert ours.get_task_demonstration(i) == theirs.get_task_demonstration(i)
        assert ours.get_task_problems() == theirs.get_task_problems()
        assert ours.get_task_bddl_files() == theirs.get_task_bddl_files()
    embs = [np.zeros(3)] * ours.get_num_tasks()
    ours.set_task_embs(embs)
    assert ours.get_task_emb(1) is embs[1]


@pytest.mark.skipif(not kitchen_env.available(), reason="mujoco/gymnasium-robotics absent")
@pytest.mark.parametrize("suite", ["kitchen", "fetch"])
def test_init_states_equal_jax(suite):
    """The kitchen's against JAX's registry (its reset is the same at every
    seed). JAX's FETCH calls ``env.seed``, which its FetchImageEnv lacks
    (AttributeError): the port seeds np.random, as the env's contract says,
    and its states are those of JAX's env reset so."""
    ours = pb.get_benchmark(suite)().get_task_init_states(0, n=2)
    assert ours.shape == ((2, 59) if suite == "kitchen" else (2, 46)) and ours.dtype == np.float64
    if suite == "kitchen":
        np.testing.assert_array_equal(ours, jb.get_benchmark(suite)().get_task_init_states(0, n=2))
        return
    with pytest.raises(AttributeError, match="seed"):
        jb.get_benchmark(suite)().get_task_init_states(0, n=2)
    from unified_video_action_tpu.envs.fetch_env import FetchImageEnv

    env = FetchImageEnv(env_id="FetchPickAndPlace-v4")
    for k in range(2):
        np.random.seed(k)
        env.reset()
        np.testing.assert_array_equal(ours[k], env.get_state()["states"])
    assert not np.array_equal(ours[0], ours[1])  # two seeds, two goals


def test_the_manifest_is_jax_manifest():
    import os

    ours = pb.load_manifest()
    with open(os.path.join(os.path.dirname(jb.__file__), "libero_manifest.json")) as f:
        theirs = json.load(f)
    assert ours["suites"] == theirs["suites"]
    assert {s: v["n_tasks"] for s, v in ours["suites"].items()} == {
        "libero_spatial": 10, "libero_object": 10, "libero_goal": 10, "libero_10": 10,
        "libero_90": 90}


@pytest.fixture()
def stand_in_libero(monkeypatch):
    """A ``libero`` package whose task map is the port's manifest."""
    task_map = {s: list(v["tasks"]) for s, v in pb.load_manifest()["suites"].items()}
    names = ["libero", "libero.libero", "libero.libero.benchmark",
             "libero.libero.benchmark.libero_suite_task_map"]
    mods = {n: types.ModuleType(n) for n in names}
    mods[names[-1]].libero_task_map = task_map
    for parent, child in zip(names, names[1:]):
        setattr(mods[parent], child.rsplit(".", 1)[1], mods[child])
    for n, m in mods.items():
        monkeypatch.setitem(sys.modules, n, m)
    return task_map


@pytest.mark.parametrize("name", UPSTREAM)
def test_upstream_suites_equal_jax(stand_in_libero, name):
    for index in (0, 3):
        ours = pb.get_benchmark(name)(task_order_index=index)
        theirs = jb.get_benchmark(name)(task_order_index=index)
        assert [tuple(t) for t in ours.tasks] == [tuple(t) for t in theirs.tasks]
    assert ours.get_num_tasks() == (100 if name == "libero_100" else len(stand_in_libero[name]))


@pytest.mark.parametrize("name", UPSTREAM)
def test_upstream_suites_raise_naming_libero_without_it(name):
    assert not any(m == "libero" or m.startswith("libero.") for m in sys.modules)
    with pytest.raises(ImportError, match="libero"):
        pb.get_benchmark(name)()
