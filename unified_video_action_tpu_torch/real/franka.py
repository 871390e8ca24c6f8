"""Franka arm middle-layer RPC (the port's copy of ``real/franka.py``): the
client, the controller backend and a scripted fake server.

The arm is driven through an RPC middle layer (a NUC running a
polymetis-style server; the reference's ``FrankaInterface`` and
``FrankaInterpolationController``, umi/real_world/
franka_interpolation_controller.py:40-70, 112-376) with the methods

    get_ee_pose() -> flange pose6 (axis-angle)
    get_joint_positions() / get_joint_velocities() -> 7-vectors
    move_to_joint_positions(joints, time_to_go)
    start_cartesian_impedance(Kx, Kxd)
    update_desired_ee_pose(pose6)
    terminate_current_policy()

over ZMQ REQ-REP with JSON frames ``["method", [args...]]`` -> ``["ok",
result] | ["err", message]``, JAX's wire byte for byte. ``zmq`` is imported
inside the functions that open sockets (as ``serving/zmq_server.py``), so
the module imports without it. ``get_ee_pose`` returns the TIP pose and
setpoints go back to FLANGE poses before the wire (the reference's
convention, :25-37, :46-48). ``FakeFrankaServer`` emulates the NUC (the
impedance-mode gate, first-order tracking of the setpoint), so the path runs
without hardware.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from unified_video_action_tpu_torch.utils.pose import mat_to_pose, pose_to_mat
from unified_video_action_tpu_torch.utils.rotation import euler_to_matrix

__all__ = [
    "tx_flange_tip",
    "FrankaRpcClient",
    "FrankaArmBackend",
    "FakeFrankaServer",
    "FrankaRpcError",
]


def _default_tx_flange_tip() -> np.ndarray:
    """Flange→tip transform of the UMI gripper mount: 45° z, 90° x, then the
    tip offset (reference franka_interpolation_controller.py:25-37)."""
    tx_rot90_tip = np.eye(4)
    tx_rot90_tip[:3, 3] = (-0.0336, 0.0, 0.247)
    tx_rot45_rot90 = np.eye(4)
    tx_rot45_rot90[:3, :3] = euler_to_matrix(np.array([np.pi / 2, 0, 0]), "XYZ")
    tx_flange_rot45 = np.eye(4)
    tx_flange_rot45[:3, :3] = euler_to_matrix(np.array([0, 0, np.pi / 4]), "XYZ")
    return tx_flange_rot45 @ tx_rot45_rot90 @ tx_rot90_tip


tx_flange_tip = _default_tx_flange_tip()


class FrankaRpcError(RuntimeError):
    pass


class FrankaRpcClient:
    """Blocking JSON-RPC client over ZMQ REQ (zerorpc-equivalent surface)."""

    def __init__(self, hostname: str, port: int = 4242,
                 timeout_ms: int = 5000):
        self.endpoint = f"tcp://{hostname}:{port}"
        self.timeout_ms = timeout_ms
        self._ctx = None
        self._sock = None

    def connect(self) -> None:
        import zmq

        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.setsockopt(zmq.RCVTIMEO, self.timeout_ms)
        self._sock.setsockopt(zmq.SNDTIMEO, self.timeout_ms)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(self.endpoint)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def call(self, method: str, *args):
        import zmq

        if self._sock is None:
            raise FrankaRpcError(f"RPC {method}: the client is not connected")
        try:
            self._sock.send_string(json.dumps([method, list(args)]))
            status, result = json.loads(self._sock.recv_string())
        except zmq.error.Again as e:
            raise FrankaRpcError(f"RPC {method} timed out") from e
        if status != "ok":
            raise FrankaRpcError(f"RPC {method} failed: {result}")
        return result

    # -- reference FrankaInterface surface (:45-69) --------------------------
    def get_ee_pose(self) -> np.ndarray:
        """TIP pose6 (the wire carries the FLANGE pose, reference :46-48)."""
        flange = np.asarray(self.call("get_ee_pose"), np.float64)
        return mat_to_pose(pose_to_mat(flange) @ tx_flange_tip)

    def get_joint_positions(self) -> np.ndarray:
        return np.asarray(self.call("get_joint_positions"), np.float64)

    def get_joint_velocities(self) -> np.ndarray:
        return np.asarray(self.call("get_joint_velocities"), np.float64)

    def move_to_joint_positions(self, positions, time_to_go: float) -> None:
        self.call("move_to_joint_positions",
                  np.asarray(positions, np.float64).tolist(),
                  float(time_to_go))

    def start_cartesian_impedance(self, Kx, Kxd) -> None:
        self.call("start_cartesian_impedance",
                  np.asarray(Kx, np.float64).tolist(),
                  np.asarray(Kxd, np.float64).tolist())

    def update_desired_ee_pose(self, tip_pose) -> None:
        flange = mat_to_pose(
            pose_to_mat(np.asarray(tip_pose, np.float64))
            @ np.linalg.inv(tx_flange_tip)
        )
        self.call("update_desired_ee_pose", flange.tolist())

    def terminate_current_policy(self) -> None:
        self.call("terminate_current_policy")


class FrankaArmBackend:
    """``PoseInterpolationController`` backend over the Franka RPC layer.

    Gains default to the reference's (franka_interpolation_controller.py:
    111-112): Kx = [750,750,750,15,15,15]·scale, Kxd = [37,37,37,2,2,2]·scale.
    """

    def __init__(self, hostname: str, port: int = 4242,
                 Kx_scale: float = 1.0, Kxd_scale: float = 1.0,
                 joints_init: Optional[np.ndarray] = None,
                 joints_init_duration: float = 3.0):
        self.client = FrankaRpcClient(hostname, port)
        self.Kx = np.array([750.0, 750.0, 750.0, 15.0, 15.0, 15.0]) * Kx_scale
        self.Kxd = np.array([37.0, 37.0, 37.0, 2.0, 2.0, 2.0]) * Kxd_scale
        self.joints_init = (
            None if joints_init is None
            else np.asarray(joints_init, np.float64).reshape(7)
        )
        self.joints_init_duration = joints_init_duration

    def connect(self) -> None:
        self.client.connect()
        if self.joints_init is not None:
            self.client.move_to_joint_positions(
                self.joints_init, self.joints_init_duration
            )
        self.client.start_cartesian_impedance(self.Kx, self.Kxd)

    def servo_pose(self, pose) -> None:
        self.client.update_desired_ee_pose(np.asarray(pose).reshape(6))

    def get_pose(self) -> np.ndarray:
        return self.client.get_ee_pose()

    def close(self) -> None:
        try:
            self.client.terminate_current_policy()
        except FrankaRpcError:
            pass
        self.client.close()


class FakeFrankaServer:
    """Threaded ZMQ REP server emulating the NUC middle layer: the RPC
    method table, an impedance-mode gate (setpoints are rejected until
    ``start_cartesian_impedance``), and first-order flange-pose tracking
    toward the desired setpoint."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 initial_flange_pose=(0.4, 0.0, 0.4, 0.0, np.pi, 0.0),
                 tau: float = 0.05):
        import zmq

        self.tau = tau
        self.flange_pose = np.asarray(initial_flange_pose, np.float64).copy()
        self.desired: Optional[np.ndarray] = None
        self.joints = np.zeros(7)
        self.joint_vel = np.zeros(7)
        self.impedance_active = False
        self.calls: List[str] = []
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        self._sock.setsockopt(zmq.RCVTIMEO, 50)
        self._sock.setsockopt(zmq.LINGER, 0)
        if port == 0:
            self.port = self._sock.bind_to_random_port(f"tcp://{host}")
        else:
            self._sock.bind(f"tcp://{host}:{port}")
            self.port = port
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._last_step = time.monotonic()

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- dynamics -------------------------------------------------------------
    def _step(self) -> None:
        now = time.monotonic()
        dt = min(now - self._last_step, 0.1)
        self._last_step = now
        if self.impedance_active and self.desired is not None:
            alpha = min(dt / self.tau, 1.0)
            self.flange_pose += alpha * (self.desired - self.flange_pose)

    # -- RPC dispatch -----------------------------------------------------------
    def _dispatch(self, method: str, args: List):
        self._step()
        self.calls.append(method)
        if method == "get_ee_pose":
            return self.flange_pose.tolist()
        if method == "get_joint_positions":
            return self.joints.tolist()
        if method == "get_joint_velocities":
            return self.joint_vel.tolist()
        if method == "move_to_joint_positions":
            positions, _ = args
            self.joints = np.asarray(positions, np.float64).reshape(7)
            return None
        if method == "start_cartesian_impedance":
            Kx, Kxd = args
            if len(Kx) != 6 or len(Kxd) != 6:
                raise ValueError("Kx/Kxd must be 6-vectors")
            self.impedance_active = True
            return None
        if method == "update_desired_ee_pose":
            if not self.impedance_active:
                raise RuntimeError("no cartesian impedance policy running")
            (pose,) = args
            self.desired = np.asarray(pose, np.float64).reshape(6)
            return None
        if method == "terminate_current_policy":
            self.impedance_active = False
            self.desired = None
            return None
        raise AttributeError(f"unknown RPC method {method!r}")

    def _serve(self):
        import zmq

        while not self._stop.is_set():
            try:
                raw = self._sock.recv_string()
            except zmq.error.Again:
                continue
            except zmq.error.ZMQError:
                return
            try:
                method, args = json.loads(raw)
                reply = ["ok", self._dispatch(method, args)]
            except Exception as e:  # fault contract: errors travel back
                reply = ["err", f"{type(e).__name__}: {e}"]
            try:
                self._sock.send_string(json.dumps(reply))
            except zmq.error.ZMQError:
                return
