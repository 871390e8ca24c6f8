"""Environment vectorization and multi-step wrappers (the port's copy of
the JAX package's ``envs/wrappers.py``, numpy only).

Equivalents of the reference's forked gym utilities (SURVEY.md §2.7):
* ``MultiStepWrapper`` (gym_util/multistep_wrapper.py:73-183): stacks the last
  n observations, steps an n-action chunk with early termination, aggregates
  reward with max.
* ``AsyncVectorEnv`` (gym_util/async_vector_env.py:43-668): one process per
  env over pipes with ``call_each`` (per-env function calls) and ``render``;
  autoreset disabled. ``SyncVectorEnv`` is its in-process twin, and the two
  collate the same observations bit for bit.

The port's ``AsyncVectorEnv`` differs from JAX's on purpose: its children are
*spawned* (``real/controller.py`` says why a process that holds a CUDA
context is never forked) from factories that pickle with the standard
``pickle`` (a module-level function, or a ``functools.partial`` of one, in
a module that imports no torch: ``envs/pusht.make_runner_env``), where JAX
ships ``dill``'d closures, which the card's machine cannot load; a child
that raises sends its traceback, which the parent raises; every receive
waits at most ``timeout`` seconds; and ``close`` terminates the children
that do not exit. ``run_dill_function`` is not ported.

A spawned child runs the parent's ``__main__`` again before it unpickles
its target (``multiprocessing.spawn``), which for ``chip_smoke.py`` or
``train_torch.py`` means importing torch: on the card 16 env processes
took 21 s to start and held 4.8 GB each. ``AsyncVectorEnv`` starts its
children with the parent's main module hidden from that preparation
(:func:`_main_module_hidden`), so a child imports numpy and the env's
modules only; a factory must therefore live in an importable module, not
in ``__main__``.
"""

from __future__ import annotations

import collections
import contextlib
import multiprocessing as mp
import sys
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

# the longest a parent waits for one child's answer to a command, s
RECV_TIMEOUT_S = 120.0
# the longest a parent waits for a spawned child to import its modules and
# build its env, s; apart from the command timeout, which a caller may set
# short to catch a hung step (a child's start under a loaded host took more
# than 1 s)
START_TIMEOUT_S = 300.0


def stack_repeated(x, n):
    return np.repeat(np.expand_dims(x, axis=0), n, axis=0)


def _stack_last_n(deque_obs, n_steps):
    """Stack the last n observations, replicating the oldest to fill the
    window at episode start (reference stack_last_n_obs semantics)."""
    assert len(deque_obs) > 0
    items = list(deque_obs)[-n_steps:]
    while len(items) < n_steps:
        items.insert(0, items[0])
    if isinstance(items[0], dict):
        return {k: np.stack([o[k] for o in items], axis=0) for k in items[0]}
    return np.stack(items, axis=0)


class MultiStepWrapper:
    """Obs stacking + action chunk stepping (reference semantics: reward
    aggregation 'max', done = any, early exit on termination)."""

    def __init__(
        self,
        env,
        n_obs_steps: int,
        n_action_steps: int,
        max_episode_steps: Optional[int] = None,
        reward_agg_method: str = "max",
    ):
        self.env = env
        self.n_obs_steps = n_obs_steps
        self.n_action_steps = n_action_steps
        self.max_episode_steps = max_episode_steps
        self.reward_agg_method = reward_agg_method
        self.obs: collections.deque = collections.deque(maxlen=n_obs_steps + 1)
        self.reward: List[float] = []
        self.done: List[bool] = []
        self.info: collections.defaultdict = collections.defaultdict(
            lambda: collections.deque(maxlen=n_obs_steps + 1)
        )
        self._elapsed = 0

    def reset(self):
        obs, _ = self.env.reset()
        self.obs = collections.deque([obs], maxlen=self.n_obs_steps + 1)
        self.reward = []
        self.done = []
        self.info = collections.defaultdict(
            lambda: collections.deque(maxlen=self.n_obs_steps + 1)
        )
        self._elapsed = 0
        return _stack_last_n(self.obs, self.n_obs_steps)

    def step(self, action_chunk):
        """action_chunk: (n_action_steps, action_dim)."""
        for act in action_chunk:
            if len(self.done) > 0 and self.done[-1]:
                # termination
                break
            observation, reward, terminated, truncated, info = self.env.step(act)
            self.obs.append(observation)
            self.reward.append(reward)
            self._elapsed += 1
            done = terminated
            if (
                self.max_episode_steps is not None
                and self._elapsed >= self.max_episode_steps
            ):
                done = True
            self.done.append(done)
            self._add_info(info)

        observation = _stack_last_n(self.obs, self.n_obs_steps)
        reward = self._agg_reward()
        done = bool(np.any(self.done))
        info = dict(self.info)
        return observation, reward, done, info

    def _agg_reward(self):
        if not self.reward:
            return 0.0
        if self.reward_agg_method == "max":
            return float(np.max(self.reward))
        if self.reward_agg_method == "sum":
            return float(np.sum(self.reward))
        return float(self.reward[-1])

    def _add_info(self, info):
        for k, v in info.items():
            self.info[k].append(v)

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)

    def seed(self, seed=None):
        return self.env.seed(seed)

    def get_rewards(self):
        return self.reward

    def get_attr(self, name):
        return getattr(self, name)

    def close(self):
        self.env.close()


@contextlib.contextmanager
def _main_module_hidden():
    """While a child is started: no ``__file__`` and a ``__spec__`` of None
    on the parent's ``__main__``, the two things ``multiprocessing.spawn``
    reads to run it again in the child."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    saved = {k: vars(main)[k] for k in ("__file__", "__spec__") if k in vars(main)}
    vars(main).pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        vars(main).pop("__spec__", None)
        vars(main).update(saved)


def _worker(remote, parent_remote, env_fn) -> None:
    """A child's loop: build the env, then answer each command with
    ``("ok", result)`` or ``("error", traceback)`` until ``close``."""
    parent_remote.close()
    env = None
    try:
        env = env_fn()
        remote.send(("ok", None))
        while True:
            cmd, data = remote.recv()
            try:
                if cmd == "reset":
                    out = env.reset()
                elif cmd == "step":
                    out = env.step(data)
                elif cmd == "render":
                    out = env.render(*data[0], **data[1])
                elif cmd == "call":
                    name, args, kwargs = data
                    fn = getattr(env, name)
                    out = fn(*args, **kwargs) if callable(fn) else fn
                elif cmd == "close":
                    break
                else:
                    raise ValueError(f"unknown command {cmd!r}")
            except Exception:
                remote.send(("error", traceback.format_exc()))
                continue
            remote.send(("ok", out))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    except Exception:  # the factory raised
        try:
            remote.send(("error", traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
    finally:
        if env is not None:
            env.close()
        remote.close()


class AsyncVectorEnv:
    """Process-per-env vector env over pipes: each of ``env_fns`` (picklable)
    is called in a spawned child, which then serves ``reset``, ``step``,
    ``render`` and ``call``. The constructor returns once every child has
    built its env, within ``START_TIMEOUT_S``; each command's answer is
    waited for ``timeout`` seconds."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]], timeout: float = RECV_TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.n_envs = len(env_fns)
        self.timeout = float(timeout)
        self.remotes, self.procs = [], []
        self._closed = False
        try:
            for fn in env_fns:
                remote, work_remote = ctx.Pipe()
                self.remotes.append(remote)
                p = ctx.Process(target=_worker, args=(work_remote, remote, fn), daemon=True)
                with _main_module_hidden():
                    p.start()
                work_remote.close()
                self.procs.append(p)
            self._gather(START_TIMEOUT_S)  # each child's env is built
        except BaseException:
            self.close()
            raise

    def _recv(self, i: int, timeout: float):
        """Child i's answer: ("ok", result) or ("error", its traceback)."""
        remote, proc = self.remotes[i], self.procs[i]
        if not remote.poll(timeout):
            raise TimeoutError(f"env process {proc.pid} sent nothing in {timeout:.0f}s")
        try:
            return remote.recv()
        except EOFError:
            proc.join(1.0)
            raise RuntimeError(f"env process {proc.pid} died (exit code {proc.exitcode})") from None

    def _gather(self, timeout: Optional[float] = None) -> list:
        """Every child's result; where some raised, every answer is read
        first (the pipes stay in step) and the first traceback raised."""
        timeout = self.timeout if timeout is None else timeout
        answers = [self._recv(i, timeout) for i in range(self.n_envs)]
        for i, (status, payload) in enumerate(answers):
            if status == "error":
                raise RuntimeError(f"env process {self.procs[i].pid} raised:\n{payload}")
        return [payload for _, payload in answers]

    def reset(self):
        for r in self.remotes:
            r.send(("reset", None))
        return _collate(self._gather())

    def step(self, actions):
        for r, a in zip(self.remotes, actions):
            r.send(("step", a))
        obs, rewards, dones, infos = zip(*self._gather())
        return _collate(list(obs)), np.asarray(rewards), np.asarray(dones), list(infos)

    def render(self, *args, **kwargs):
        for r in self.remotes:
            r.send(("render", (args, kwargs)))
        return self._gather()

    def call(self, name, *args, **kwargs):
        for r in self.remotes:
            r.send(("call", (name, args, kwargs)))
        return self._gather()

    def call_each(self, name, args_list=None, kwargs_list=None):
        args_list = args_list or [[]] * self.n_envs
        kwargs_list = kwargs_list or [{}] * self.n_envs
        for r, a, kw in zip(self.remotes, args_list, kwargs_list):
            r.send(("call", (name, a, kw)))
        return self._gather()

    def close(self, timeout: float = 5.0) -> None:
        """Ask every child to close its env and exit, join them, and
        terminate (then kill) any still alive after ``timeout`` seconds: a
        child that raised, or one blocked sending an answer nobody read."""
        if self._closed:
            return
        self._closed = True
        for r in self.remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join()
        for r in self.remotes:
            r.close()


class SyncVectorEnv:
    """In-process vector env (the twin of :class:`AsyncVectorEnv`)."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.n_envs = len(self.envs)

    def reset(self):
        return _collate([e.reset() for e in self.envs])

    def step(self, actions):
        results = [e.step(a) for e, a in zip(self.envs, actions)]
        obs, rewards, dones, infos = zip(*results)
        return _collate(list(obs)), np.asarray(rewards), np.asarray(dones), list(infos)

    def render(self, *args, **kwargs):
        return [e.render(*args, **kwargs) for e in self.envs]

    def call(self, name, *args, **kwargs):
        out = []
        for e in self.envs:
            fn = getattr(e, name)
            out.append(fn(*args, **kwargs) if callable(fn) else fn)
        return out

    def call_each(self, name, args_list=None, kwargs_list=None):
        args_list = args_list or [[]] * self.n_envs
        kwargs_list = kwargs_list or [{}] * self.n_envs
        out = []
        for e, a, kw in zip(self.envs, args_list, kwargs_list):
            fn = getattr(e, name)
            out.append(fn(*a, **kw) if callable(fn) else fn)
        return out

    def close(self):
        for e in self.envs:
            e.close()


def _collate(items):
    """Stack a list of (possibly dict) observations into batched arrays."""
    if isinstance(items[0], dict):
        return {k: _collate([it[k] for it in items]) for k in items[0]}
    return np.stack(items, axis=0)
