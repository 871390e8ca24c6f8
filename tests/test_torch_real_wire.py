"""The UR RTDE and WSG-50 wire protocols of the port (``real/rtde.py``,
``real/wsg.py``) against their fakes on loopback TCP, on the CPU:

- the port's client against the port's fake and against JAX's, and JAX's
  client against the port's fake: the
  handshake, recipes (an unknown variable refused), the streamed state
  decoded by the recipe, servo setpoints moving the fake arm to its target
  within 1e-3; homing, pre-positioning, the script's PD servo to 0.5 mm, a
  width out of range refused, a corrupted reply detected and a corrupted
  request answered with E_CHECKSUM_ERROR. The two sides are byte-compatible
  (the packets and frames themselves are held byte for byte in
  ``tests/test_torch_real_numpy.py``);
- the backends inside spawned controller processes (a ``URArmBackend``
  pickles unconnected and connects in the child): a scheduled arm waypoint
  reached within 1e-2, a width waypoint within 5 mm, each through the
  protocol (setpoints the fake received);
- the port's fakes stop in well under their 2 s join timeout (JAX's WSG
  fake waits it out in ``accept``).
"""

import pickle
import socket
import time

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.real import rtde as jrtde
from unified_video_action_tpu.real import wsg as jwsg
from unified_video_action_tpu_torch.real import rtde, wsg
from unified_video_action_tpu_torch.real.controller import PoseInterpolationController, WidthController

PAIRS = [(rtde, rtde), (rtde, jrtde), (jrtde, rtde)]  # (client's module, fake's module)
WSG_PAIRS = [(wsg, wsg), (wsg, jwsg), (jwsg, wsg)]
IDS = ["port-port", "port-jax", "jax-port"]


@pytest.mark.parametrize("cli_mod,srv_mod", PAIRS, ids=IDS)
def test_rtde_client_against_fake(cli_mod, srv_mod):
    target = np.array([0.5, 0.1, 0.3, 0.0, 3.14, 0.0])
    with srv_mod.FakeURServer(initial_pose=(1, 2, 3, 0.1, 0.2, 0.3), max_speed=20.0) as srv:
        with cli_mod.RtdeClient("127.0.0.1", srv.port) as cli:
            assert cli.get_controller_version()[:2] == (5, 12)
            with pytest.raises(cli_mod.RtdeError, match="no_such_var"):
                cli.setup_outputs(["actual_TCP_pose", "no_such_var"])
            cli.setup_outputs(["timestamp", "actual_TCP_pose", "robot_mode"], frequency=250.0)
            cli.start()
            s1, s2 = cli.receive(), cli.receive()
            np.testing.assert_allclose(s1["actual_TCP_pose"], [1, 2, 3, 0.1, 0.2, 0.3])
            assert s2["timestamp"] > s1["timestamp"] and s1["robot_mode"] == 7
            cli.pause()
        backend = cli_mod.URArmBackend("127.0.0.1", srv.port, frequency=250.0)
        backend.connect()
        try:
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and not np.allclose(backend.get_pose(), target, atol=1e-4):
                backend.servo_pose(target)
                time.sleep(0.01)
            np.testing.assert_allclose(backend.get_pose(), target, atol=1e-3)
            np.testing.assert_allclose(srv.received_setpoints[-1], target)
        finally:
            backend.close()


def _stop(srv):
    """Stop a fake WSG server with a connection open: JAX's thread waits in
    ``accept`` and would hold ``stop`` for its 2 s join timeout."""
    with socket.create_connection(("127.0.0.1", srv.port), timeout=2.0):
        srv.stop()


@pytest.mark.parametrize("cli_mod,srv_mod", WSG_PAIRS, ids=IDS)
def test_wsg_client_against_fake(cli_mod, srv_mod):
    srv = srv_mod.FakeWsgServer().start()
    try:
        with cli_mod.WsgClient("127.0.0.1", srv.port) as cli:
            assert cli.homing()["status"] == cli_mod.StatusCode.E_SUCCESS and srv.homed
            cli.pre_position(width_mm=40.0, speed_mm_s=1e6)
            time.sleep(0.02)
            assert cli.script_query()["position"] == pytest.approx(40.0, abs=1.0)
            with pytest.raises(cli_mod.WsgError, match="RANGE_ERROR"):
                cli.pre_position(width_mm=500.0, speed_mm_s=50.0)
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                info = cli.script_position_pd(position_mm=25.0, velocity_mm_s=400.0)
                if abs(info["position"] - 25.0) < 0.5 and not info["is_moving"]:
                    break
                time.sleep(0.01)
            assert info["position"] == pytest.approx(25.0, abs=0.5)
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=2.0)
        try:
            frame = bytearray(cli_mod.encode_frame(cli_mod.Cmd.SCRIPT_QUERY, b"\x00"))
            frame[-1] ^= 0xFF  # corrupt the CRC
            sock.sendall(bytes(frame))
            assert cli_mod.read_frame(sock)["status"] == cli_mod.StatusCode.E_CHECKSUM_ERROR
        finally:
            sock.close()
        srv.corrupt_every = 1  # every reply of the next session corrupted
        with cli_mod.WsgClient("127.0.0.1", srv.port) as cli:
            with pytest.raises(cli_mod.WsgError, match="CRC"):
                cli.script_query()
    finally:
        _stop(srv)


def test_backends_drive_spawned_controllers():
    target = np.array([0.6, -0.1, 0.4, 0.0, 3.0, 0.1])
    with rtde.FakeURServer(max_speed=10.0) as ur, wsg.FakeWsgServer() as grip:
        arm_backend = rtde.URArmBackend("127.0.0.1", ur.port, frequency=250.0)
        again = pickle.loads(pickle.dumps(arm_backend))  # unconnected: host, port and rate
        assert (again.client.hostname, again.client.port, again.frequency) == ("127.0.0.1", ur.port, 250.0)
        robot = PoseInterpolationController(arm_backend, frequency=60.0, max_pos_speed=2.0,
                                            max_rot_speed=4.0)
        gripper = WidthController(wsg.WsgGripperBackend("127.0.0.1", grip.port, move_max_speed_m_s=0.5),
                                  frequency=30.0, max_speed=0.5)
        try:
            robot.start()
            gripper.start()
            robot.wait_ready()
            gripper.wait_ready()
            t0 = time.time()
            robot.schedule_waypoint(target, t0 + 0.4)
            gripper.schedule_waypoint(0.03, t0 + 0.4)
            time.sleep(t0 + 1.0 - time.time())
            pose = robot.get_state()["ActualTCPPose"][-1]
            width = float(gripper.get_state()["gripper_position"][-1])
        finally:
            robot.stop_wait()
            gripper.stop_wait()
    np.testing.assert_allclose(pose, target, atol=1e-2)
    assert len(ur.received_setpoints) > 10
    assert width == pytest.approx(0.03, abs=0.005)
    assert sum(c == wsg.Cmd.SCRIPT_POSITION_PD for c, _ in grip.received) > 3
    with pytest.raises(RuntimeError, match="connected"):
        backend = rtde.URArmBackend("127.0.0.1", 1)
        backend.client.sock = object()
        pickle.dumps(backend)


@pytest.mark.parametrize("fake", [rtde.FakeURServer, wsg.FakeWsgServer])
def test_fakes_stop_promptly(fake):
    srv = fake().start()
    t0 = time.perf_counter()
    srv.stop()
    assert time.perf_counter() - t0 < 0.5
    assert not srv._thread.is_alive()
