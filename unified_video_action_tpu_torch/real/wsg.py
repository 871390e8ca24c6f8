"""WSG-50 gripper binary TCP protocol: framing, CRC16, command layer (the
port's own copy of ``real/wsg.py``, standard library only).

Capability parity with the reference's binary WSG client (its
umi/real_world module, lines 266-631): the Schunk WSG command set rides a
binary TCP stream of frames

    [AA AA AA] [cmd u8] [size u16-le] [payload...] [crc16 u16-le]

where the CRC-16/CCITT (poly 0x1021, reflected table update, init 0xFFFF)
covers the whole frame including the preamble, and a receiver verifying the
CRC over header+payload+crc gets 0 on an intact frame.

This implementation is protocol-level testable without hardware: a scripted
``FakeWsgServer`` (threading TCP server emulating the firmware's state
machine, including E_CMD_PENDING sequences and the cmd_measure.lua custom
script) drives the full stack in tests/test_torch_real_wire.py.
``WsgGripperBackend`` adapts the client to the ``WidthController`` backend
interface (real/controller.py) so the gripper process loop runs unmodified
on real hardware or the fake.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from enum import IntEnum
from typing import Dict, Optional

__all__ = [
    "crc16_ccitt",
    "encode_frame",
    "WsgError",
    "StatusCode",
    "Cmd",
    "WsgClient",
    "WsgGripperBackend",
    "FakeWsgServer",
]


def _build_crc_table():
    # CRC-16/CCITT as the WSG firmware computes it: the classic MSB-first
    # table for polynomial 0x1021 combined with a reflected (LSB-index)
    # update step. Generated, not transcribed.
    table = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x1021) if (c & 0x8000) else (c << 1)
        table.append(c & 0xFFFF)
    return table


_CRC_TABLE = _build_crc_table()

PREAMBLE = b"\xaa\xaa\xaa"


def crc16_ccitt(data: bytes, crc: int = 0xFFFF) -> int:
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc & 0xFFFF


class StatusCode(IntEnum):
    E_SUCCESS = 0
    E_NOT_AVAILABLE = 1
    E_NO_SENSOR = 2
    E_NOT_INITIALIZED = 3
    E_ALREADY_RUNNING = 4
    E_FEATURE_NOT_SUPPORTED = 5
    E_INCONSISTENT_DATA = 6
    E_TIMEOUT = 7
    E_READ_ERROR = 8
    E_WRITE_ERROR = 9
    E_INSUFFICIENT_RESOURCES = 10
    E_CHECKSUM_ERROR = 11
    E_NO_PARAM_EXPECTED = 12
    E_NOT_ENOUGH_PARAMS = 13
    E_CMD_UNKNOWN = 14
    E_CMD_FORMAT_ERROR = 15
    E_ACCESS_DENIED = 16
    E_ALREADY_OPEN = 17
    E_CMD_FAILED = 18
    E_CMD_ABORTED = 19
    E_INVALID_HANDLE = 20
    E_NOT_FOUND = 21
    E_NOT_OPEN = 22
    E_IO_ERROR = 23
    E_INVALID_PARAMETER = 24
    E_INDEX_OUT_OF_BOUNDS = 25
    E_CMD_PENDING = 26
    E_OVERRUN = 27
    RANGE_ERROR = 28
    E_AXIS_BLOCKED = 29
    E_FILE_EXIST = 30


class Cmd(IntEnum):
    DISCONNECT = 0x07
    HOMING = 0x20
    PRE_POSITION = 0x21
    STOP = 0x22
    FAST_STOP = 0x23
    ACK_FAST_STOP = 0x24
    # cmd_measure.lua custom script ids
    SCRIPT_QUERY = 0xB0
    SCRIPT_POSITION_PD = 0xB1


class WsgError(RuntimeError):
    pass


def encode_frame(cmd_id: int, payload: bytes = b"") -> bytes:
    body = PREAMBLE + bytes([cmd_id & 0xFF]) + struct.pack("<H", len(payload)) + payload
    return body + struct.pack("<H", crc16_ccitt(body))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WsgError("connection closed mid-frame")
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Dict:
    """Read one frame: sync on the 3-byte preamble, verify CRC, split payload
    into (status_code, parameters)."""
    run = 0
    while run != 3:
        b = _recv_exact(sock, 1)
        run = run + 1 if b == b"\xaa" else 0
    header = _recv_exact(sock, 3)
    cmd_id = header[0]
    (size,) = struct.unpack("<H", header[1:3])
    payload = _recv_exact(sock, size)
    crc_b = _recv_exact(sock, 2)
    # CRC over everything after the preamble, seeded with the preamble's CRC,
    # including the transmitted CRC bytes: an intact frame yields 0
    if crc16_ccitt(header + payload + crc_b, crc=crc16_ccitt(PREAMBLE)) != 0:
        raise WsgError("corrupted frame (CRC mismatch)")
    status = struct.unpack("<H", payload[:2])[0] if len(payload) >= 2 else None
    return {"cmd_id": cmd_id, "status": status, "params": payload[2:],
            "payload": payload}


class WsgClient:
    """Blocking command client over the WSG binary TCP protocol."""

    def __init__(self, hostname: str, port: int = 1000, timeout: float = 5.0):
        self.hostname = hostname
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None

    # -- lifecycle ---------------------------------------------------------
    def connect(self) -> None:
        self.sock = socket.create_connection(
            (self.hostname, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def close(self) -> None:
        if self.sock is not None:
            try:
                # fire-and-forget: tell the firmware we are leaving
                self.sock.sendall(encode_frame(Cmd.DISCONNECT))
            except OSError:
                pass
            self.sock.close()
            self.sock = None

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport ---------------------------------------------------------
    def submit(self, cmd_id: int, payload: bytes = b"", pending: bool = True,
               ignore_other: bool = False) -> Dict:
        """Send one command frame and wait for its final response, skipping
        E_CMD_PENDING acknowledgements when ``pending``."""
        assert self.sock is not None, "not connected"
        self.sock.sendall(encode_frame(cmd_id, payload))
        while True:
            msg = read_frame(self.sock)
            if msg["cmd_id"] != cmd_id:
                if ignore_other:
                    continue
                raise WsgError(
                    f"response id {msg['cmd_id']:#04x} != sent {cmd_id:#04x}"
                )
            if pending and msg["status"] == StatusCode.E_CMD_PENDING:
                continue
            return msg

    def _act(self, cmd_id: int, payload: bytes = b"", wait: bool = True,
             ignore_other: bool = False) -> Dict:
        msg = self.submit(cmd_id, payload, pending=wait,
                          ignore_other=ignore_other)
        if msg["status"] != StatusCode.E_SUCCESS:
            raise WsgError(
                f"command {Cmd(cmd_id).name} failed: "
                f"{StatusCode(msg['status']).name}"
            )
        return msg

    # -- command set -------------------------------------------------------
    def homing(self, positive_direction: Optional[bool] = True,
               wait: bool = True) -> Dict:
        arg = 0 if positive_direction is None else (1 if positive_direction else 2)
        return self._act(Cmd.HOMING, bytes([arg]), wait=wait)

    def pre_position(self, width_mm: float, speed_mm_s: float,
                     clamp_on_block: bool = True, wait: bool = True) -> Dict:
        payload = bytes([0 if clamp_on_block else 1]) + struct.pack(
            "<ff", float(width_mm), float(speed_mm_s)
        )
        return self._act(Cmd.PRE_POSITION, payload, wait=wait)

    def stop_cmd(self) -> Dict:
        return self._act(Cmd.STOP, wait=False, ignore_other=True)

    def ack_fault(self) -> Dict:
        return self._act(Cmd.ACK_FAST_STOP, b"ack", wait=False,
                         ignore_other=True)

    # -- cmd_measure.lua custom script -------------------------------------
    def _script(self, cmd_id: int, *floats: float) -> Dict[str, float]:
        payload = b"\x00" + b"".join(struct.pack("<f", float(f)) for f in floats)
        msg = self.submit(cmd_id, payload, pending=False)
        if msg["status"] == StatusCode.E_CMD_UNKNOWN:
            raise WsgError(
                "custom command unknown — measurement script not running"
            )
        if msg["status"] != StatusCode.E_SUCCESS:
            raise WsgError(f"script command failed: {StatusCode(msg['status']).name}")
        params = msg["params"]
        if len(params) != 17:
            raise WsgError(f"script response payload length {len(params)} != 17")
        state = params[0]
        pos, vel, force, ts = struct.unpack("<4f", params[1:])
        return {
            "state": state,
            "position": pos,
            "velocity": vel,
            "force_motor": force,
            "measure_timestamp": ts,
            "is_moving": bool(state & 0x02),
        }

    def script_query(self) -> Dict[str, float]:
        return self._script(Cmd.SCRIPT_QUERY)

    def script_position_pd(self, position_mm: float, velocity_mm_s: float,
                           kp: float = 15.0, kd: float = 1e-3,
                           travel_force_limit: float = 80.0,
                           blocked_force_limit: Optional[float] = None
                           ) -> Dict[str, float]:
        if blocked_force_limit is None:
            blocked_force_limit = travel_force_limit
        if kp <= 0 or kd < 0:
            raise ValueError("kp must be > 0 and kd >= 0")
        return self._script(
            Cmd.SCRIPT_POSITION_PD, position_mm, velocity_mm_s, kp, kd,
            travel_force_limit, blocked_force_limit,
        )


class WsgGripperBackend:
    """``WidthController`` backend riding the WSG binary protocol.

    Widths cross the interface in meters (framework convention); the wire
    protocol speaks millimeters (firmware convention, reference
    wsg_controller.py:43 ``scale``).
    """

    def __init__(self, hostname: str, port: int = 1000,
                 move_max_speed_m_s: float = 0.2, home: bool = True):
        self.client = WsgClient(hostname, port)
        self.move_max_speed = move_max_speed_m_s * 1000.0
        self.home = home
        self._last_width_m = 0.0

    def connect(self) -> None:
        self.client.connect()
        self.client.ack_fault()
        if self.home:
            self.client.homing(positive_direction=True, wait=True)
        self._last_width_m = self.client.script_query()["position"] / 1000.0

    def servo_width(self, width: float) -> None:
        info = self.client.script_position_pd(
            position_mm=width * 1000.0, velocity_mm_s=self.move_max_speed
        )
        self._last_width_m = info["position"] / 1000.0

    def get_width(self) -> float:
        try:
            self._last_width_m = self.client.script_query()["position"] / 1000.0
        except WsgError:
            pass
        return self._last_width_m

    def close(self) -> None:
        try:
            self.client.stop_cmd()
        except (WsgError, OSError):
            pass
        self.client.close()


# ---------------------------------------------------------------------------
# scripted fake firmware (tests / bring-up without hardware)
# ---------------------------------------------------------------------------


class FakeWsgServer:
    """Threaded TCP server emulating the WSG firmware's protocol state
    machine: CRC validation, E_CMD_PENDING acknowledgement before a completed
    HOMING/PRE_POSITION, the cmd_measure.lua script responses, and simple
    first-order width dynamics so PD servoing converges like real hardware."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 width_range_mm=(0.0, 110.0), corrupt_every: int = 0):
        self.host = host
        self.width_min, self.width_max = width_range_mm
        self.corrupt_every = corrupt_every  # inject a bad CRC every Nth reply
        self._reply_count = 0
        self.position = self.width_max
        self.target = self.width_max
        self.speed = 0.0
        self.homed = False
        self.received: list = []  # (cmd_id, payload) log for assertions
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
        self._last_step = time.monotonic()

    # -- lifecycle ---------------------------------------------------------
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

    # -- dynamics ----------------------------------------------------------
    def _step_dynamics(self):
        now = time.monotonic()
        dt = min(now - self._last_step, 0.1)
        self._last_step = now
        if self.speed > 0:
            delta = self.target - self.position
            step = self.speed * dt
            if abs(delta) <= step:
                self.position = self.target
                self.speed = 0.0
            else:
                self.position += step if delta > 0 else -step
        self.position = min(max(self.position, self.width_min), self.width_max)

    # -- protocol ----------------------------------------------------------
    def _send(self, conn, cmd_id: int, status: int, params: bytes = b""):
        frame = encode_frame(cmd_id, struct.pack("<H", status) + params)
        self._reply_count += 1
        if self.corrupt_every and self._reply_count % self.corrupt_every == 0:
            frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
        conn.sendall(frame)

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
                except (WsgError, OSError, struct.error):
                    continue

    def _session(self, conn):
        conn.settimeout(0.2)
        while not self._stop.is_set():
            try:
                msg = read_frame(conn)
            except socket.timeout:
                continue
            except WsgError as e:
                if "CRC" in str(e):
                    # firmware NAKs a corrupted frame
                    self._send(conn, 0x00, StatusCode.E_CHECKSUM_ERROR)
                    continue
                return
            cmd, payload = msg["cmd_id"], msg["payload"]
            self.received.append((cmd, payload))
            self._step_dynamics()
            if cmd == Cmd.DISCONNECT:
                return
            elif cmd == Cmd.HOMING:
                self._send(conn, cmd, StatusCode.E_CMD_PENDING)
                self.position = self.target = self.width_max
                self.homed = True
                self._send(conn, cmd, StatusCode.E_SUCCESS)
            elif cmd == Cmd.PRE_POSITION:
                if len(payload) != 9:
                    self._send(conn, cmd, StatusCode.E_NOT_ENOUGH_PARAMS)
                    continue
                width, speed = struct.unpack("<ff", payload[1:9])
                if not (self.width_min <= width <= self.width_max):
                    self._send(conn, cmd, StatusCode.RANGE_ERROR)
                    continue
                self._send(conn, cmd, StatusCode.E_CMD_PENDING)
                self.target, self.speed = width, abs(speed)
                self._send(conn, cmd, StatusCode.E_SUCCESS)
            elif cmd in (Cmd.STOP, Cmd.FAST_STOP):
                self.speed = 0.0
                self._send(conn, cmd, StatusCode.E_SUCCESS)
            elif cmd == Cmd.ACK_FAST_STOP:
                self._send(conn, cmd, StatusCode.E_SUCCESS)
            elif cmd == Cmd.SCRIPT_QUERY:
                self._send(conn, cmd, StatusCode.E_SUCCESS,
                           self._script_state())
            elif cmd == Cmd.SCRIPT_POSITION_PD:
                if len(payload) != 1 + 6 * 4:
                    self._send(conn, cmd, StatusCode.E_CMD_FORMAT_ERROR)
                    continue
                pos, vel = struct.unpack("<2f", payload[1:9])
                self.target = min(max(pos, self.width_min), self.width_max)
                self.speed = abs(vel)
                self._send(conn, cmd, StatusCode.E_SUCCESS,
                           self._script_state())
            else:
                self._send(conn, cmd, StatusCode.E_CMD_UNKNOWN)

    def _script_state(self) -> bytes:
        moving = 0x02 if self.speed > 0 and self.position != self.target else 0
        return bytes([moving]) + struct.pack(
            "<4f", self.position,
            self.speed if moving else 0.0, 0.0, time.time() % 1e6,
        )
