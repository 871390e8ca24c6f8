"""UR RTDE wire protocol: framing, recipe negotiation, data streaming (the
port's own copy of ``real/rtde.py``, standard library and numpy only).

The reference drives Universal Robots arms through the ``ur_rtde`` C++
library (``rtde_interpolation_controller.py:247`` ``getActualTCPPose``,
``:268-273`` ``servoL(pose, vel, acc, dt, lookahead_time, gain)``), which
itself rides UR's Real-Time Data Exchange TCP protocol on port 30004. This
module implements that wire protocol directly from the public spec — no
vendor library — so the arm path is protocol-level testable without
hardware, exactly like the WSG gripper protocol (real/wsg.py):

    packet   := [size u16-be] [type u8] [payload...]
    handshake: REQUEST_PROTOCOL_VERSION(2) -> accepted
    outputs  : CONTROL_PACKAGE_SETUP_OUTPUTS(freq f64 + "a,b,c")
               -> recipe id + "VECTOR6D,DOUBLE,..." (NOT_FOUND on unknowns)
    inputs   : CONTROL_PACKAGE_SETUP_INPUTS("x,y") -> recipe id + types
    stream   : CONTROL_PACKAGE_START, then DATA_PACKAGE frames both ways

Setpoints travel the same way ur_rtde's servoL does under the hood: the
controller-side URScript polls input registers, so the client writes
``input_double_register_0..5`` (target pose) + ``input_int_register_0``
(command flag) in an input DATA_PACKAGE. ``URArmBackend`` adapts this to the
``PoseInterpolationController`` backend interface (real/controller.py), and
``FakeURServer`` emulates the controller box (negotiation, register file,
first-order pose dynamics) for tests and bring-up (tests/test_torch_real_wire.py).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PacketType",
    "RTDE_TYPES",
    "encode_packet",
    "read_packet",
    "RtdeError",
    "RtdeClient",
    "URArmBackend",
    "FakeURServer",
]


class PacketType:
    REQUEST_PROTOCOL_VERSION = 86   # 'V'
    GET_URCONTROL_VERSION = 118     # 'v'
    TEXT_MESSAGE = 77               # 'M'
    DATA_PACKAGE = 85               # 'U'
    CONTROL_PACKAGE_SETUP_OUTPUTS = 79  # 'O'
    CONTROL_PACKAGE_SETUP_INPUTS = 73   # 'I'
    CONTROL_PACKAGE_START = 83      # 'S'
    CONTROL_PACKAGE_PAUSE = 80      # 'P'


#: RTDE value types -> (struct format, element count). All big-endian.
RTDE_TYPES: Dict[str, Tuple[str, int]] = {
    "BOOL": ("?", 1),
    "UINT8": ("B", 1),
    "INT32": ("i", 1),
    "UINT32": ("I", 1),
    "UINT64": ("Q", 1),
    "DOUBLE": ("d", 1),
    "VECTOR3D": ("ddd", 3),
    "VECTOR6D": ("dddddd", 6),
    "VECTOR6INT32": ("iiiiii", 6),
}


class RtdeError(RuntimeError):
    pass


def encode_packet(ptype: int, payload: bytes = b"") -> bytes:
    return struct.pack(">HB", 3 + len(payload), ptype) + payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise RtdeError("connection closed mid-packet")
        buf += chunk
    return buf


def read_packet(sock: socket.socket) -> Tuple[int, bytes]:
    size, ptype = struct.unpack(">HB", _recv_exact(sock, 3))
    if size < 3:
        raise RtdeError(f"invalid packet size {size}")
    return ptype, _recv_exact(sock, size - 3)


def _pack_values(types: Sequence[str], values: Sequence) -> bytes:
    out = b""
    for t, v in zip(types, values):
        fmt, n = RTDE_TYPES[t]
        vals = np.atleast_1d(np.asarray(v)).tolist()
        if len(vals) != n:
            raise RtdeError(f"{t} expects {n} values, got {len(vals)}")
        if t in ("BOOL",):
            vals = [bool(x) for x in vals]
        elif t in ("UINT8", "INT32", "UINT32", "UINT64", "VECTOR6INT32"):
            vals = [int(x) for x in vals]
        else:
            vals = [float(x) for x in vals]
        out += struct.pack(">" + fmt, *vals)
    return out


def _unpack_values(types: Sequence[str], data: bytes) -> List:
    out, off = [], 0
    for t in types:
        fmt, n = RTDE_TYPES[t]
        size = struct.calcsize(">" + fmt)
        vals = struct.unpack(">" + fmt, data[off:off + size])
        off += size
        out.append(np.array(vals) if n > 1 else vals[0])
    if off != len(data):
        raise RtdeError(f"data package size {len(data)} != recipe size {off}")
    return out


class _Recipe:
    def __init__(self, rid: int, names: List[str], types: List[str]):
        self.id = rid
        self.names = names
        self.types = types


class RtdeClient:
    """Blocking RTDE client: handshake, recipe setup, start/pause, data IO."""

    def __init__(self, hostname: str, port: int = 30004, timeout: float = 5.0):
        self.hostname = hostname
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.output_recipe: Optional[_Recipe] = None
        self.input_recipes: Dict[int, _Recipe] = {}

    # -- lifecycle -----------------------------------------------------------
    def connect(self) -> None:
        self.sock = socket.create_connection(
            (self.hostname, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if not self.negotiate_protocol_version(2):
            raise RtdeError("controller rejected RTDE protocol v2")

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport -----------------------------------------------------------
    def _request(self, ptype: int, payload: bytes = b"") -> bytes:
        assert self.sock is not None, "not connected"
        self.sock.sendall(encode_packet(ptype, payload))
        while True:
            rtype, rpayload = read_packet(self.sock)
            if rtype == PacketType.TEXT_MESSAGE:
                continue  # async controller log lines may interleave
            if rtype != ptype:
                raise RtdeError(f"response type {rtype} != request {ptype}")
            return rpayload

    # -- handshake -----------------------------------------------------------
    def negotiate_protocol_version(self, version: int = 2) -> bool:
        r = self._request(
            PacketType.REQUEST_PROTOCOL_VERSION, struct.pack(">H", version)
        )
        return bool(r[0])

    def get_controller_version(self) -> Tuple[int, int, int, int]:
        r = self._request(PacketType.GET_URCONTROL_VERSION)
        return struct.unpack(">IIII", r)

    # -- recipes -------------------------------------------------------------
    def setup_outputs(self, names: Sequence[str],
                      frequency: float = 125.0) -> _Recipe:
        payload = struct.pack(">d", float(frequency)) + ",".join(names).encode()
        r = self._request(PacketType.CONTROL_PACKAGE_SETUP_OUTPUTS, payload)
        rid, types = r[0], r[1:].decode().split(",")
        bad = [n for n, t in zip(names, types) if t == "NOT_FOUND"]
        if bad:
            raise RtdeError(f"unknown output variables: {bad}")
        self.output_recipe = _Recipe(rid, list(names), types)
        return self.output_recipe

    def setup_inputs(self, names: Sequence[str]) -> _Recipe:
        r = self._request(
            PacketType.CONTROL_PACKAGE_SETUP_INPUTS, ",".join(names).encode()
        )
        rid, types = r[0], r[1:].decode().split(",")
        bad = [n for n, t in zip(names, types)
               if t in ("NOT_FOUND", "IN_USE")]
        if bad:
            raise RtdeError(f"rejected input variables: {bad}")
        recipe = _Recipe(rid, list(names), types)
        self.input_recipes[rid] = recipe
        return recipe

    # -- streaming -----------------------------------------------------------
    def start(self) -> None:
        r = self._request(PacketType.CONTROL_PACKAGE_START)
        if not r[0]:
            raise RtdeError("controller refused CONTROL_PACKAGE_START")

    def pause(self) -> None:
        r = self._request(PacketType.CONTROL_PACKAGE_PAUSE)
        if not r[0]:
            raise RtdeError("controller refused CONTROL_PACKAGE_PAUSE")

    def send_inputs(self, recipe: _Recipe, values: Sequence) -> None:
        assert self.sock is not None, "not connected"
        payload = bytes([recipe.id]) + _pack_values(recipe.types, values)
        self.sock.sendall(encode_packet(PacketType.DATA_PACKAGE, payload))

    def receive(self) -> Dict[str, np.ndarray]:
        """Block for the next output DATA_PACKAGE, decoded by the recipe."""
        assert self.sock is not None and self.output_recipe is not None
        while True:
            rtype, payload = read_packet(self.sock)
            if rtype != PacketType.DATA_PACKAGE:
                continue
            if payload[0] != self.output_recipe.id:
                raise RtdeError(
                    f"data package recipe {payload[0]} != "
                    f"{self.output_recipe.id}"
                )
            vals = _unpack_values(self.output_recipe.types, payload[1:])
            return dict(zip(self.output_recipe.names, vals))


class URArmBackend:
    """``PoseInterpolationController`` backend over the RTDE wire protocol.

    Mirrors the reference's split (rtde_interpolation_controller.py:247,268):
    state comes from the streamed ``actual_TCP_pose`` output; servo setpoints
    go out as ``input_double_register_0..5`` + ``input_int_register_0=1``
    (the register convention ur_rtde's servoL URScript consumes).
    """

    OUTPUTS = ["timestamp", "actual_TCP_pose", "actual_TCP_speed",
               "robot_mode"]
    INPUTS = [f"input_double_register_{i}" for i in range(6)] + [
        "input_int_register_0"
    ]

    def __init__(self, hostname: str, port: int = 30004,
                 frequency: float = 125.0):
        self.client = RtdeClient(hostname, port)
        self.frequency = frequency
        self._in_recipe: Optional[_Recipe] = None
        self._state_lock = threading.Lock()
        self._state: Dict[str, np.ndarray] = {}
        self._reader: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def __getstate__(self):
        """A backend pickles unconnected, as its host, port and rate (a
        spawned controller connects in its child); the lock, the event and
        the reader thread are made anew on the other side."""
        if self.client.sock is not None:
            raise RuntimeError("a connected URArmBackend cannot be pickled")
        return {"hostname": self.client.hostname, "port": self.client.port,
                "frequency": self.frequency}

    def __setstate__(self, state):
        self.__init__(state["hostname"], state["port"], state["frequency"])

    def connect(self) -> None:
        self.client.connect()
        self.client.setup_outputs(self.OUTPUTS, frequency=self.frequency)
        self._in_recipe = self.client.setup_inputs(self.INPUTS)
        self.client.start()
        # block until the first state arrives so get_pose is valid from t0
        self._state = self.client.receive()
        self._stop.clear()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        while not self._stop.is_set():
            try:
                state = self.client.receive()
            except (RtdeError, OSError):
                return
            with self._state_lock:
                self._state = state

    def servo_pose(self, pose) -> None:
        vals = [float(x) for x in np.asarray(pose).reshape(6)] + [1]
        self.client.send_inputs(self._in_recipe, vals)

    def get_pose(self) -> np.ndarray:
        with self._state_lock:
            return np.asarray(self._state["actual_TCP_pose"], np.float64)

    def get_state(self) -> Dict[str, np.ndarray]:
        with self._state_lock:
            return dict(self._state)

    def close(self) -> None:
        self._stop.set()
        try:
            # idle the servo loop (reference :367 servoStop) then pause
            if self._in_recipe is not None:
                self.client.send_inputs(
                    self._in_recipe, [0.0] * 6 + [0]
                )
            self.client.pause()
        except (RtdeError, OSError):
            pass
        self.client.close()
        if self._reader is not None:
            self._reader.join(timeout=2.0)


# ---------------------------------------------------------------------------
# scripted fake controller box (tests / bring-up without hardware)
# ---------------------------------------------------------------------------


def _fake_registry() -> Dict[str, str]:
    reg = {
        "timestamp": "DOUBLE",
        "actual_TCP_pose": "VECTOR6D",
        "actual_TCP_speed": "VECTOR6D",
        "actual_q": "VECTOR6D",
        "robot_mode": "INT32",
        "safety_mode": "INT32",
    }
    for i in range(24):
        reg[f"output_double_register_{i}"] = "DOUBLE"
        reg[f"output_int_register_{i}"] = "INT32"
    return reg


def _fake_input_registry() -> Dict[str, str]:
    reg = {"speed_slider_mask": "UINT32", "speed_slider_fraction": "DOUBLE"}
    for i in range(24):
        reg[f"input_double_register_{i}"] = "DOUBLE"
        reg[f"input_int_register_{i}"] = "INT32"
    return reg


class FakeURServer:
    """Threaded TCP server emulating a UR controller's RTDE endpoint:
    protocol-v2 negotiation, recipe validation against the variable registry
    (NOT_FOUND on unknowns), the input register file, and streamed output
    packages with first-order TCP-pose dynamics toward the register setpoint
    while ``input_int_register_0 == 1``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 initial_pose=(0.4, 0.0, 0.3, 0.0, 3.14, 0.0),
                 max_speed: float = 1.0, min_protocol: int = 2):
        self.host = host
        self.max_speed = max_speed
        self.min_protocol = min_protocol
        self.pose = np.asarray(initial_pose, np.float64).copy()
        self.speed = np.zeros(6)
        self.robot_mode = 7  # RUNNING
        self.in_regs: Dict[str, float] = {}
        self.received_setpoints: list = []
        self._out_registry = _fake_registry()
        self._in_registry = _fake_input_registry()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        # accept() wakes every 50 ms to see the stop flag: closing a listening
        # socket does not wake a thread blocked in accept(), so stop() would
        # wait out its join timeout
        self._srv.settimeout(0.05)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- dynamics ------------------------------------------------------------
    def _step(self, dt: float) -> None:
        if int(self.in_regs.get("input_int_register_0", 0)) != 1:
            self.speed[:] = 0.0
            return
        target = np.array(
            [self.in_regs.get(f"input_double_register_{i}", self.pose[i])
             for i in range(6)]
        )
        delta = target - self.pose
        step = self.max_speed * dt
        move = np.clip(delta, -step, step)
        self.pose += move
        self.speed = move / max(dt, 1e-9)

    # -- protocol ------------------------------------------------------------
    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    self._session(conn)
                except (RtdeError, OSError, struct.error):
                    continue

    def _session(self, conn):
        conn.settimeout(0.05)
        out_recipe: Optional[_Recipe] = None
        in_recipes: Dict[int, _Recipe] = {}
        next_rid = 1
        streaming = False
        frequency = 125.0
        last_emit = time.monotonic()
        t0 = time.monotonic()
        while not self._stop.is_set():
            try:
                ptype, payload = read_packet(conn)
            except socket.timeout:
                ptype = None
            except (RtdeError, OSError):
                return
            if ptype == PacketType.REQUEST_PROTOCOL_VERSION:
                (ver,) = struct.unpack(">H", payload)
                ok = ver >= self.min_protocol
                conn.sendall(encode_packet(ptype, bytes([int(ok)])))
            elif ptype == PacketType.GET_URCONTROL_VERSION:
                conn.sendall(
                    encode_packet(ptype, struct.pack(">IIII", 5, 12, 0, 1101))
                )
            elif ptype == PacketType.CONTROL_PACKAGE_SETUP_OUTPUTS:
                frequency = struct.unpack(">d", payload[:8])[0]
                names = payload[8:].decode().split(",")
                types = [self._out_registry.get(n, "NOT_FOUND")
                         for n in names]
                out_recipe = _Recipe(next_rid, names, types)
                next_rid += 1
                conn.sendall(encode_packet(
                    ptype, bytes([out_recipe.id]) + ",".join(types).encode()
                ))
            elif ptype == PacketType.CONTROL_PACKAGE_SETUP_INPUTS:
                names = payload.decode().split(",")
                types = [self._in_registry.get(n, "NOT_FOUND")
                         for n in names]
                recipe = _Recipe(next_rid, names, types)
                next_rid += 1
                if "NOT_FOUND" not in types:
                    in_recipes[recipe.id] = recipe
                conn.sendall(encode_packet(
                    ptype, bytes([recipe.id]) + ",".join(types).encode()
                ))
            elif ptype == PacketType.CONTROL_PACKAGE_START:
                ok = out_recipe is not None
                streaming = streaming or ok
                last_emit = time.monotonic()
                conn.sendall(encode_packet(ptype, bytes([int(ok)])))
            elif ptype == PacketType.CONTROL_PACKAGE_PAUSE:
                streaming = False
                conn.sendall(encode_packet(ptype, bytes([1])))
            elif ptype == PacketType.DATA_PACKAGE:
                rid = payload[0]
                recipe = in_recipes.get(rid)
                if recipe is None:
                    continue  # real controllers drop unknown input packages
                vals = _unpack_values(recipe.types, payload[1:])
                for n, v in zip(recipe.names, vals):
                    self.in_regs[n] = float(np.asarray(v).reshape(-1)[0])
                if int(self.in_regs.get("input_int_register_0", 0)) == 1:
                    self.received_setpoints.append(np.array(
                        [self.in_regs.get(f"input_double_register_{i}", 0.0)
                         for i in range(6)]
                    ))

            if streaming and out_recipe is not None:
                now = time.monotonic()
                if now - last_emit >= 1.0 / frequency:
                    self._step(now - last_emit)
                    last_emit = now
                    values = []
                    for name in out_recipe.names:
                        if name == "timestamp":
                            values.append(now - t0)
                        elif name == "actual_TCP_pose":
                            values.append(self.pose)
                        elif name == "actual_TCP_speed":
                            values.append(self.speed)
                        elif name == "actual_q":
                            values.append(np.zeros(6))
                        elif name == "robot_mode":
                            values.append(self.robot_mode)
                        else:
                            values.append(0)
                    body = bytes([out_recipe.id]) + _pack_values(
                        out_recipe.types, values
                    )
                    try:
                        conn.sendall(
                            encode_packet(PacketType.DATA_PACKAGE, body)
                        )
                    except OSError:
                        return
