"""The port's Franka RPC (``real/franka.py``), teleop inputs
(``real/teleop.py``) and SLAM-pipeline utilities (``real/slam_pipeline.py``)
against the JAX package's on the same inputs, on the CPU.

- Franka: the flange-to-tip transform equal to JAX's; the port's client
  against JAX's fake server and JAX's client against the port's (one wire:
  the same JSON frames), the tip pose read and the flange setpoint sent
  within 1e-9 of JAX's; the fault contract (an unknown method, the
  impedance gate, a timeout naming the method); the backend in the port's
  spawned ``PoseInterpolationController`` reaching a waypoint.
- Teleop: the deadzone filter equal to JAX's; the spawned spacemouse's ring
  holding the script's filtered motion and buttons, its segment unlinked at
  ``stop_wait``; the keystroke counter's counts and queue equal to JAX's
  under threads; pynput's listener raising ImportError naming it.
- SLAM pipeline: the polygons, masks (numpy against JAX's cv2, pixel for
  pixel; the anti-aliased mask through cv2), crops, the tag inpainting and
  ``image_transform`` (equal at the rig's sizes, at most one level off at
  others: OpenCV sums its area weights in float32); ArUco detection and the
  gripper width equal to JAX's (the same cv2 calls); the TUM, SLAM-CSV and
  OptiTrack loaders' outputs exactly equal; timecodes and the latency
  estimate within 1e-9; cv2, pandas and av named where they are missing.
"""

import builtins
import datetime
import glob
import threading
import time

import cv2
import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.real import franka as jfranka
from unified_video_action_tpu.real import slam_pipeline as jsp
from unified_video_action_tpu.real import teleop as jteleop
from unified_video_action_tpu_torch.real import franka, slam_pipeline as sp, teleop

F64 = dict(rtol=0, atol=1e-9)


def hide(monkeypatch, *modules):
    """Make ``import <module>`` fail for each of ``modules``."""
    real_import = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] in modules:
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)


# -- Franka ---------------------------------------------------------------------------

def test_the_flange_tip_transform_is_jaxs():
    np.testing.assert_array_equal(franka.tx_flange_tip, jfranka.tx_flange_tip)


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_one_wire_for_both_clients(client_side):
    server_mod = jfranka if client_side == "port" else franka
    client_mod = franka if client_side == "port" else jfranka
    tip = np.array([0.35, 0.05, 0.3, 0.1, -3.0, 0.2])
    read, sent = {}, {}
    for side, (srv_mod, cli_mod) in {"mixed": (server_mod, client_mod),
                                     "jax": (jfranka, jfranka)}.items():
        with srv_mod.FakeFrankaServer() as srv:
            cli = cli_mod.FrankaRpcClient("127.0.0.1", srv.port)
            cli.connect()
            try:
                read[side] = cli.get_ee_pose()
                cli.move_to_joint_positions(np.arange(7.0), 1.0)
                np.testing.assert_array_equal(cli.get_joint_positions(), np.arange(7.0))
                cli.start_cartesian_impedance(np.ones(6), np.ones(6))
                cli.update_desired_ee_pose(tip)
                sent[side] = srv.desired.copy()
                cli.terminate_current_policy()
            finally:
                cli.close()
    np.testing.assert_allclose(read["mixed"], read["jax"], **F64)
    np.testing.assert_allclose(sent["mixed"], sent["jax"], **F64)


def test_the_fault_contract():
    with franka.FakeFrankaServer() as srv:
        cli = franka.FrankaRpcClient("127.0.0.1", srv.port)
        cli.connect()
        try:
            with pytest.raises(franka.FrankaRpcError, match="unknown RPC method"):
                cli.call("no_such_method")
            with pytest.raises(franka.FrankaRpcError, match="impedance"):
                cli.update_desired_ee_pose(np.zeros(6))
        finally:
            cli.close()
    with pytest.raises(franka.FrankaRpcError, match="not connected"):
        franka.FrankaRpcClient("127.0.0.1", 1).call("get_ee_pose")
    import zmq

    ctx = zmq.Context.instance()
    quiet = ctx.socket(zmq.REP)  # bound, never answers
    port = quiet.bind_to_random_port("tcp://127.0.0.1")
    try:
        cli = franka.FrankaRpcClient("127.0.0.1", port, timeout_ms=100)
        cli.connect()
        with pytest.raises(franka.FrankaRpcError, match="get_ee_pose timed out"):
            cli.get_ee_pose()
        cli.close()
    finally:
        quiet.close()


def test_the_backend_in_the_spawned_pose_controller():
    from unified_video_action_tpu_torch.real import PoseInterpolationController

    with franka.FakeFrankaServer(tau=0.02) as srv:
        robot = PoseInterpolationController(franka.FrankaArmBackend("127.0.0.1", srv.port),
                                            frequency=60.0, max_pos_speed=2.0, max_rot_speed=4.0)
        robot.start_wait()
        try:
            start = np.ravel(robot.get_state()["ActualTCPPose"])
            target = start + np.array([0.04, 0.02, -0.02, 0, 0, 0.05])
            robot.schedule_waypoint(target, time.time() + 0.5)
            time.sleep(1.2)
            np.testing.assert_allclose(np.ravel(robot.get_state()["ActualTCPPose"]), target,
                                       atol=5e-2)
        finally:
            robot.stop_wait()
    assert "start_cartesian_impedance" in srv.calls and "terminate_current_policy" in srv.calls


# -- teleop ----------------------------------------------------------------------------

def test_the_deadzone_filter_is_jaxs():
    rng = np.random.default_rng(0)
    for _ in range(20):
        motion = rng.uniform(-2, 2, 6) * rng.choice([0.01, 1.0], 6)
        m = np.clip(motion / 1.5, -1.0, 1.0)
        want = np.where(np.abs(m) < 0.05, 0.0, m)  # JAX's loop, real/teleop.py:137-138
        np.testing.assert_array_equal(teleop.filter_motion(motion, 1.5, 0.05), want)


def test_the_spawned_spacemouse():
    script = [(np.array([0.5, -0.3, 0.0, 0.01, 0.0, 0.9]), np.array([1, 0]))] * 200
    sm = teleop.SpacemouseProcess(teleop.ScriptedSpacemouseBackend(script), frequency=100.0,
                                  deadzone=0.05)
    name = sm.ring.name.decode()
    sm.start_wait()
    try:
        time.sleep(0.2)
        np.testing.assert_array_equal(sm.get_motion_state(), [0.5, -0.3, 0.0, 0.0, 0.0, 0.9])
        assert sm.is_button_pressed(0) and not sm.is_button_pressed(1)
        rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
        np.testing.assert_array_equal(sm.get_motion_state_transformed(rot),
                                      [0.3, 0.5, 0.0, 0.0, 0.0, 0.9])
        states = sm.ring.get_last_k(4)
        assert states["motion_event"].shape == (4, 6) and np.all(np.diff(states["receive_timestamp"]) > 0)
    finally:
        sm.stop_wait()
    assert not glob.glob(f"/dev/shm/{name}*")


def test_the_keystroke_counter_is_jaxs():
    counters = teleop.KeystrokeCounter(), jteleop.KeystrokeCounter()
    for kc in counters:
        threads = [threading.Thread(target=lambda k=k: [kc.push(k) for _ in range(100)])
                   for k in "abc"]
        [t.start() for t in threads]
        [t.join() for t in threads]
    port, jax_kc = counters
    assert [port.count(k) for k in "abcd"] == [jax_kc.count(k) for k in "abcd"] == [100] * 3 + [0]
    assert sorted(port.get_press_events()) == sorted(jax_kc.get_press_events())
    assert port.get_press_events() == jax_kc.get_press_events() == []
    for kc in counters:
        kc.push("q")
        kc.clear()
    assert port.count("q") == jax_kc.count("q") == 0


def test_the_keyboard_listener_names_pynput(monkeypatch):
    hide(monkeypatch, "pynput")
    with pytest.raises(ImportError, match="pynput"):
        teleop.KeystrokeCounter().attach_pynput()


# -- the SLAM pipeline ------------------------------------------------------------------

def test_the_rig_polygons_are_jaxs():
    for name in ("mirror_polygons", "gripper_polygons", "finger_polygon"):
        np.testing.assert_allclose(getattr(sp, name)(), getattr(jsp, name)(), **F64)
    pts = np.random.default_rng(0).uniform(0, 2000, (9, 2))
    np.testing.assert_allclose(sp.pixel_to_canonical(pts, (1080, 1920)),
                               jsp.pixel_to_canonical(pts, (1080, 1920)), **F64)
    np.testing.assert_allclose(sp.canonical_to_pixel(pts / 2000, (1080, 1920)),
                               jsp.canonical_to_pixel(pts / 2000, (1080, 1920)), **F64)
    for shape in ((1080, 1920), (224, 224)):
        for left in (True, False):
            assert sp.mirror_crop_slices(shape, left) == jsp.mirror_crop_slices(shape, left)


@pytest.mark.parametrize("shape", [(507, 676, 3), (224, 224, 3), (1080, 1920, 3)])
def test_the_masks_are_jaxs(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    for kw in ({}, {"mirror": False}, {"gripper": False, "color": (10, 200, 30)}):
        np.testing.assert_array_equal(sp.draw_predefined_mask(img.copy(), **kw),
                                      jsp.draw_predefined_mask(img.copy(), **kw))
    np.testing.assert_array_equal(sp.draw_predefined_mask(img.copy(), use_aa=True),
                                  jsp.draw_predefined_mask(img.copy(), use_aa=True))


def test_the_tag_inpainting_is_jaxs():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    for corners in (np.array([[20, 20], [40, 20], [40, 40], [20, 40]], np.float64),
                    np.array([[50.4, 60.2], [120.7, 55.1], [125.3, 101.9], [45.5, 110.6]]),
                    np.array([[-5, 2], [30, -4], [35, 30], [0, 33]], np.float64)):
        np.testing.assert_array_equal(sp.inpaint_tag(img.copy(), corners),
                                      jsp.inpaint_tag(img.copy(), corners))


@pytest.mark.parametrize("case", [((1920, 1080), (224, 224), 1.0, True),
                                  ((1920, 1080), (640, 480), 0.9, True),
                                  ((640, 480), (224, 224), 1.0, False),
                                  ((320, 240), (96, 96), 1.0, True),
                                  ((160, 120), (100, 100), 1.0, False)])
def test_image_transform_is_jaxs(case):
    in_res, out_res, crop, bgr = case
    img = np.random.default_rng(3).integers(0, 256, (in_res[1], in_res[0], 3), dtype=np.uint8)
    got = sp.image_transform(in_res, out_res, crop, bgr)(img)
    want = jsp.image_transform(in_res, out_res, crop, bgr)(img)
    assert got.shape == want.shape == (out_res[1], out_res[0], 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    if in_res[1] % out_res[1] == 0 or case[:2] != ((160, 120), (100, 100)):
        assert d.max() == 0
    else:  # a 1.2 area ratio: OpenCV sums in float32, the port in float64
        assert d.max() <= 1 and (d > 0).mean() < 0.01


def _intr(f=600.0, cx=320.0, cy=240.0):
    return {"K": np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64), "D": np.zeros((4, 1))}


def test_aruco_and_the_gripper_width_are_jaxs():
    cfg = sp.parse_aruco_config({"aruco_dict": {"predefined": "DICT_4X4_50"},
                                 "marker_size_map": {"default": 0.1, 3: 0.05}})
    jcfg = jsp.parse_aruco_config({"aruco_dict": {"predefined": "DICT_4X4_50"},
                                   "marker_size_map": {"default": 0.1, 3: 0.05}})
    assert cfg["marker_size_map"] == jcfg["marker_size_map"]
    img = np.full((480, 640), 255, np.uint8)
    img[180:300, 260:380] = cv2.aruco.generateImageMarker(cfg["aruco_dict"], 7, 120)
    img[40:100, 40:100] = cv2.aruco.generateImageMarker(cfg["aruco_dict"], 3, 60)
    for intr in ({"fisheye_intr": _intr()}, {"pinhole_intr": {"K": _intr()["K"]}}):
        got = sp.detect_aruco_tags(img, cfg["aruco_dict"], cfg["marker_size_map"], **intr)
        want = jsp.detect_aruco_tags(img, jcfg["aruco_dict"], jcfg["marker_size_map"], **intr)
        assert sorted(got) == sorted(want) == [3, 7]
        for tag in want:
            for k in ("rvec", "tvec", "corners"):
                np.testing.assert_array_equal(got[tag][k], want[tag][k])
        np.testing.assert_allclose(got[7]["tvec"], [0, 0, 0.5], atol=0.01)
    with pytest.raises(ValueError, match="exactly one"):
        sp.detect_aruco_tags(img, cfg["aruco_dict"], cfg["marker_size_map"])
    mk = lambda x, z: {"tvec": np.array([x, 0.0, z])}
    for tags in ({0: mk(-0.04, 0.072), 1: mk(0.041, 0.07)}, {0: mk(-0.04, 0.072)},
                 {1: mk(0.03, 0.075)}, {0: mk(-0.04, 0.3)}, {}):
        assert sp.gripper_width_from_tags(tags, 0, 1) == jsp.gripper_width_from_tags(tags, 0, 1)


def test_the_loaders_are_jaxs(tmp_path):
    rng = np.random.default_rng(4)
    quat = rng.standard_normal((6, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rows = np.column_stack([np.arange(6) * 0.05, rng.uniform(-1, 1, (6, 3)), quat])
    tum = tmp_path / "traj.txt"
    np.savetxt(tum, rows, delimiter=" ")
    got, want = sp.load_tum_trajectory(str(tum)), jsp.load_tum_trajectory(str(tum))
    for k in ("timestamp", "pose"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    csv = tmp_path / "camera_trajectory.csv"
    lines = ["timestamp,x,y,z,q_x,q_y,q_z,q_w,is_lost"] + [
        ",".join([f"{r[0]:.3f}", *(f"{v:.6f}" for v in r[1:8]), str(i % 3 == 1)])
        for i, r in enumerate(rows)]
    csv.write_text("\n".join(lines) + "\n")
    got, want = sp.load_slam_csv_trajectory(str(csv)), jsp.load_slam_csv_trajectory(str(csv))
    for k in ("timestamp", "pose"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["raw_data"].equals(want["raw_data"]) and len(got["pose"]) == 4
    take = tmp_path / "take.csv"
    body = "\n".join(",".join([str(i), f"{i / 120:.6f}", *(f"{v:.6f}" for v in (*q, *p))])
                     for i, (q, p) in enumerate(zip(quat, rows[:, 1:4])))
    take.write_text(
        "Format Version,1.23,Capture Start Time,2024-03-01 02.30.15.123 PM\n\n"
        "Type,," + ",".join(["Rigid Body"] * 7) + "\n"
        "Name,," + ",".join(["gripper"] * 7) + "\n"
        "ID,," + ",".join(["1"] * 7) + "\n"
        ",," + ",".join(["Rotation"] * 4 + ["Position"] * 3) + "\n"
        "Frame,Time (Seconds),X,Y,Z,W,X,Y,Z\n" + body + "\n")
    got, want = sp.load_mocap_data(str(take), "gripper"), jsp.load_mocap_data(str(take), "gripper")
    for k in ("time_since_start", "pose"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["pose"].shape == (6, 4, 4)
    assert sp.mocap_start_datetime(str(take)) == jsp.mocap_start_datetime(str(take)) == \
        datetime.datetime(2024, 3, 1, 14, 30, 15, 123000)


def test_timecodes_and_latency_are_jaxs():
    for tc, rate in (("00:00:01:00", 30), ("01:00:00:00", 29.97), ("12:34:56:17", 59.94)):
        assert sp.timecode_to_seconds(tc, rate) == jsp.timecode_to_seconds(tc, rate)
    t = np.arange(0, 2, 0.005)
    t2 = t + 0.0013
    x_cmd = np.sin(2 * np.pi * 3 * t)
    x_act = np.sin(2 * np.pi * 3 * (t2 - 0.037))
    for positive in (False, True):
        got, info = sp.measure_latency(x_cmd, t, x_act, t2, force_positive=positive)
        want, jinfo = jsp.measure_latency(x_cmd, t, x_act, t2, force_positive=positive)
        assert got == pytest.approx(want, abs=1e-9) and got == pytest.approx(0.037, abs=0.002)
        for k in jinfo:
            np.testing.assert_allclose(info[k], jinfo[k], **F64)


def test_what_is_missing_is_named(tmp_path, monkeypatch):
    csv = tmp_path / "camera_trajectory.csv"
    csv.write_text("timestamp,x,y,z,q_x,q_y,q_z,q_w,is_lost\n0.0,0,0,0,0,0,0,1,False\n")
    hide(monkeypatch, "cv2", "pandas", "av")
    with pytest.raises(ImportError, match="cv2"):
        sp.get_aruco_dict("DICT_4X4_50")
    with pytest.raises(ImportError, match="cv2"):
        sp.detect_aruco_tags(np.zeros((8, 8), np.uint8), None, {}, pinhole_intr={"K": np.eye(3)})
    with pytest.raises(ImportError, match="cv2"):
        sp.draw_predefined_mask(np.zeros((8, 8, 3), np.uint8), use_aa=True)
    with pytest.raises(ImportError, match="pandas"):
        sp.load_slam_csv_trajectory(str(csv))
    with pytest.raises(ImportError, match="pandas"):
        sp.load_mocap_data(str(csv), "gripper")
    with pytest.raises(ImportError, match="av"):
        sp.mp4_start_datetime(str(csv))
    # the numpy paths need none of them
    assert sp.draw_predefined_mask(np.full((64, 64, 3), 255, np.uint8)).min() == 0
    assert sp.image_transform((64, 48), (32, 32))(np.zeros((48, 64, 3), np.uint8)).shape == (32, 32, 3)
