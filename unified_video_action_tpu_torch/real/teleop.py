"""Teleoperation inputs (the port's copy of ``real/teleop.py``): a 6-DoF
spacemouse streamed into a shared-memory ring, and a keystroke counter.

The reference's demonstration-collection inputs
(umi/real_world/spacemouse_shared_memory.py:14-167: a process polling a
6-DoF HID device into a shared-memory ring with deadzone filtering and axis
remapping; keystroke_counter.py:6-48: a pynput listener queuing key events).
The spacemouse process is a spawned device of the port's
(``real/controller.SpawnedDevice``: no fork of a process that holds CUDA)
over the ``ipc/shm`` ring, which the parent creates and unlinks in
``stop_wait``. A real HID backend needs hardware;
``ScriptedSpacemouseBackend`` replays a script in its place. The keystroke
counter's listener needs ``pynput`` (imported in :meth:`KeystrokeCounter.
attach_pynput`, which raises naming it where it is absent); its queue takes
events from any thread through :meth:`KeystrokeCounter.push`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unified_video_action_tpu_torch.ipc.shm import SharedMemoryRingBuffer
from unified_video_action_tpu_torch.real.controller import SpawnedDevice, _unique_name


class ScriptedSpacemouseBackend:
    """A software spacemouse: replays a fixed sequence of (motion6,
    buttons2), its last entry from then on."""

    def __init__(self, script: Sequence[Tuple[np.ndarray, np.ndarray]]):
        self.script = list(script)
        self._i = 0

    def open(self) -> None:
        pass

    def read(self) -> Tuple[np.ndarray, np.ndarray]:
        motion, buttons = self.script[min(self._i, len(self.script) - 1)]
        self._i += 1
        return np.asarray(motion, np.float64), np.asarray(buttons, np.int64)

    def close(self) -> None:
        pass


def filter_motion(motion: np.ndarray, max_value: float, deadzone: float) -> np.ndarray:
    """The raw 6-DoF reading scaled by ``max_value`` into [-1, 1], each axis
    under ``deadzone`` set to 0."""
    m = np.clip(np.asarray(motion, np.float64) / max_value, -1.0, 1.0)
    return np.where(np.abs(m) < deadzone, 0.0, m)


class SpacemouseProcess(SpawnedDevice):
    """Polls a 6-DoF input backend into the shared ring at ``frequency``.

    The ring's records are JAX's: ``motion_event`` = [tx ty tz rx ry rz] in
    [-1, 1] after the deadzone (:func:`filter_motion`), ``button_state`` (2
    ints) and ``receive_timestamp``. ``get_motion_state`` reads the latest
    motion and ``is_button_pressed(i)`` the latest buttons. The backend is
    pickled into the spawned child, so it must be importable there.
    """

    def __init__(self, backend, frequency: float = 200.0, deadzone: float = 0.05,
                 max_value: float = 1.0, get_max_k: int = 64):
        super().__init__()
        self.backend = backend
        self.frequency = float(frequency)
        self.deadzone = float(deadzone)
        self.max_value = float(max_value)
        self.ring = SharedMemoryRingBuffer(
            _unique_name("spacemouse"),
            {"motion_event": np.zeros(6, np.float64), "button_state": np.zeros(2, np.int64),
             "receive_timestamp": np.zeros((), np.float64)},
            get_max_k=get_max_k)

    # -- parent-side API --------------------------------------------------

    def stop_wait(self, timeout: float = 5.0) -> None:
        """Stop the loop, join the child and unlink the ring."""
        self._join(timeout)
        self.ring.close(unlink=True)

    def get_motion_state(self) -> np.ndarray:
        return self.ring.get_last_k(1)["motion_event"][0]

    def get_motion_state_transformed(self, rotation: Optional[np.ndarray] = None) -> np.ndarray:
        """The motion with its translation and rotation axes each mapped by a
        3 x 3 matrix (the reference applies a fixed frame rotation per robot
        mount)."""
        m = self.get_motion_state()
        if rotation is None:
            return m
        return np.concatenate([rotation @ m[:3], rotation @ m[3:]])

    def is_button_pressed(self, idx: int) -> bool:
        return bool(self.ring.get_last_k(1)["button_state"][0][idx])

    # -- the child's loop ---------------------------------------------------

    def run(self):  # pragma: no cover - runs in the spawned child
        self.backend.open()
        dt = 1.0 / self.frequency
        t0 = time.monotonic()
        i = 0
        while not self._stop_event.is_set():
            motion, buttons = self.backend.read()
            self.ring.put({"motion_event": filter_motion(motion, self.max_value, self.deadzone),
                           "button_state": np.asarray(buttons, np.int64),
                           "receive_timestamp": np.float64(time.time())})
            if i == 0:
                self.ready_event.set()
            i += 1
            sleep = (t0 + i * dt) - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)
        self.backend.close()


class KeystrokeCounter:
    """Counts key events: ``push(key)`` from any thread (a keyboard
    listener's callback), ``count(key)`` the presses seen so far and
    ``get_press_events()`` drains the queue of events, the two reads the
    reference's recording loop uses to start, stop and drop an episode."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._events: List[str] = []

    def push(self, key: str) -> None:
        with self._lock:
            self._counts[key] += 1
            self._events.append(key)

    def count(self, key: str) -> int:
        with self._lock:
            return self._counts[key]

    def get_press_events(self) -> List[str]:
        with self._lock:
            out, self._events = self._events, []
            return out

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._events.clear()

    def attach_pynput(self):
        """A started ``pynput`` keyboard listener feeding :meth:`push` (a
        key's character, else its name); raises ImportError naming pynput
        where it is not installed."""
        try:
            from pynput import keyboard
        except ImportError as e:
            raise ImportError("KeystrokeCounter.attach_pynput needs pynput, which is not "
                              "installed") from e

        def on_press(key):
            self.push(getattr(key, "char", None) or str(key))

        listener = keyboard.Listener(on_press=on_press)
        listener.start()
        return listener
