"""The real-robot stack's numpy parts, the port against the JAX package on
the same numpy-seeded inputs:

- ``PoseTrajectory`` / ``ScalarTrajectory`` evaluation, ``trim``,
  ``schedule_waypoint`` (with and without speed limits and
  ``last_waypoint_time``) and ``drive_to_waypoint``: equal to 1e-12 (the
  same float64 arithmetic; scipy's slerp on both sides), and the width
  trajectory's ``last_waypoint_time``, which JAX's lacks, keeping a chunk's
  earlier waypoints;
- ``get_real_umi_obs_dict`` and ``get_real_umi_action``: equal to 1e-6
  (float32 outputs of the same float64 pose arithmetic);
- ``smooth_action``, ``select_align_camera``, ``tile_grid``,
  ``parse_fisheye_intrinsics``: exactly equal; the fisheye rectify map and
  remap (OpenCV on both sides) exactly equal;
- the RTDE packets and value codecs and the WSG frames and their CRC16:
  byte for byte;
- the episode accumulator on a single put equal to JAX's, and on the
  overlapping puts of several control cycles keeping each sample once and
  letting a later chunk replace the actions it replaced (JAX's appends
  them all), and ``_unique_name``'s format.
"""

import struct

import numpy as np
import pytest

from unified_video_action_tpu.real import bimanual as jbim
from unified_video_action_tpu.real import env as jenv
from unified_video_action_tpu.real import fisheye as jfish
from unified_video_action_tpu.real import rtde as jrtde
from unified_video_action_tpu.real import trajectory as jtraj
from unified_video_action_tpu.real import visualizer as jvis
from unified_video_action_tpu.real import wsg as jwsg
from unified_video_action_tpu.serving import real_inference as jri
from unified_video_action_tpu.serving.zmq_server import smooth_action as jax_smooth_action
from unified_video_action_tpu_torch.real import bimanual, env, fisheye, rtde, trajectory, visualizer, wsg
from unified_video_action_tpu_torch.real.controller import _unique_name
from unified_video_action_tpu_torch.serving import real_inference
from unified_video_action_tpu_torch.serving.zmq_server import smooth_action

TRAJ_TOL = dict(rtol=0, atol=1e-12)


def _poses(rng, n):
    return np.concatenate([rng.standard_normal((n, 3)), rng.uniform(-1.5, 1.5, (n, 3))], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_trajectory_equals_jax(seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.3, 5))
    poses = _poses(rng, 5)
    got, want = trajectory.PoseTrajectory(times, poses), jtraj.PoseTrajectory(times, poses)
    t = np.linspace(times[0] - 0.5, times[-1] + 0.5, 37)
    np.testing.assert_allclose(got(t), want(t), **TRAJ_TOL)
    np.testing.assert_allclose(got(times[2]), want(times[2]), **TRAJ_TOL)
    mid = 0.5 * (times[1] + times[2])
    for a, b in ((got.trim(mid), want.trim(mid)),
                 (got.schedule_waypoint(poses[0], times[3], curr_time=mid),
                  want.schedule_waypoint(poses[0], times[3], curr_time=mid)),
                 (got.schedule_waypoint(poses[1], times[1], curr_time=mid, max_pos_speed=0.5,
                                        max_rot_speed=0.6, last_waypoint_time=times[3]),
                  want.schedule_waypoint(poses[1], times[1], curr_time=mid, max_pos_speed=0.5,
                                         max_rot_speed=0.6, last_waypoint_time=times[3])),
                 (got.schedule_waypoint(poses[2], times[-1] + 1.0, curr_time=mid, max_pos_speed=0.5,
                                        max_rot_speed=0.6, last_waypoint_time=times[3]),
                  want.schedule_waypoint(poses[2], times[-1] + 1.0, curr_time=mid, max_pos_speed=0.5,
                                         max_rot_speed=0.6, last_waypoint_time=times[3])),
                 (got.drive_to_waypoint(poses[3], mid + 0.1, mid, max_pos_speed=0.25),
                  want.drive_to_waypoint(poses[3], mid + 0.1, mid, max_pos_speed=0.25))):
        np.testing.assert_allclose(a.times, b.times, **TRAJ_TOL)
        np.testing.assert_allclose(a.poses, b.poses, **TRAJ_TOL)
        np.testing.assert_allclose(a(t), b(t), **TRAJ_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_trajectory_equals_jax(seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.3, 4))
    values = rng.uniform(0.0, 0.1, (4, 1))
    got, want = trajectory.ScalarTrajectory(times, values), jtraj.ScalarTrajectory(times, values)
    t = np.linspace(times[0] - 0.5, times[-1] + 0.5, 23)
    np.testing.assert_allclose(got(t), want(t), **TRAJ_TOL)
    mid = 0.5 * (times[0] + times[1])
    for kw in ({}, {"max_speed": 0.05}):
        a = got.schedule_waypoint(0.02, times[2], curr_time=mid, **kw)
        b = want.schedule_waypoint(0.02, times[2], curr_time=mid, **kw)
        np.testing.assert_allclose(a.times, b.times, **TRAJ_TOL)
        np.testing.assert_allclose(a.values, b.values, **TRAJ_TOL)
        np.testing.assert_allclose(a(t), b(t), **TRAJ_TOL)


def test_width_waypoints_of_a_chunk_all_stay():
    """A chunk's waypoints scheduled one after another: with
    ``last_waypoint_time`` (the port's width controller) each stays, as the
    arm's do; without it (JAX's) each replaces the one before."""
    t0, stamps, widths = 0.0, 0.1 * np.arange(1, 5), np.array([0.08, 0.02, 0.06, 0.04])
    kept, replaced = trajectory.ScalarTrajectory([t0], [[0.05]]), jtraj.ScalarTrajectory([t0], [[0.05]])
    last = t0
    for w, t in zip(widths, stamps):
        kept = kept.schedule_waypoint(w, t, curr_time=t0, last_waypoint_time=last)
        replaced = replaced.schedule_waypoint(w, t, curr_time=t0)
        last = max(last, t)
    np.testing.assert_allclose(np.ravel(kept(stamps)), widths, atol=1e-12)
    np.testing.assert_allclose(replaced.times, [t0, stamps[-1]])


def _env_obs(rng, T=16, px=24):
    return {"camera0_rgb": rng.integers(0, 256, (T, px, px, 3), dtype=np.uint8),
            "robot0_eef_pos": rng.standard_normal((T, 3)),
            "robot0_eef_rot_axis_angle": rng.uniform(-1.5, 1.5, (T, 3)),
            "robot0_gripper_width": rng.uniform(0, 0.08, (T, 1))}


@pytest.mark.parametrize("seed", [0, 1])
def test_real_umi_obs_dict_and_action_equal_jax(seed):
    rng = np.random.default_rng(seed)
    obs = _env_obs(rng)
    start = _poses(rng, 1)[0]
    for kw in ({}, {"episode_start_pose": start}, {"obs_pose_repr": "abs", "episode_start_pose": start}):
        got, want = real_inference.get_real_umi_obs_dict(obs, **kw), jri.get_real_umi_obs_dict(obs, **kw)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    pred = rng.uniform(-1, 1, (16, 10)).astype(np.float32)
    for repr_ in ("relative", "abs"):
        got = real_inference.get_real_umi_action(pred, start, repr_)
        want = jri.get_real_umi_action(pred, start, repr_)
        assert got.dtype == want.dtype == np.float32 and got.shape == (16, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [1, 3, 5])
def test_smooth_action_equals_jax(window):
    a = np.random.default_rng(window).standard_normal((2, 16, 10)).astype(np.float32)
    np.testing.assert_array_equal(smooth_action(a, window), jax_smooth_action(a, window))


def test_select_align_camera_and_tile_grid_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        data = [{"timestamp": np.sort(rng.uniform(0, 1, rng.integers(1, 6)))} for _ in range(3)]
        for n in (1, 2, 3):
            assert bimanual.select_align_camera(data, n) == jbim.select_align_camera(data, n)
    frames = [rng.integers(0, 256, (6, 8, 3), dtype=np.uint8) for _ in range(5)]
    for row, col, bgr in ((2, 3, False), (1, 2, True), (3, 3, True)):
        np.testing.assert_array_equal(visualizer.tile_grid(frames, row, col, 7, bgr),
                                      jvis.tile_grid(frames, row, col, 7, bgr))
    with pytest.raises(ValueError):
        visualizer.tile_grid([frames[0], frames[1][:4]], 1, 2)


CAL = {"intrinsic_type": "FISHEYE_KANNALA_BRANDT",
       "intrinsics": {"fx": 180.0, "fy": 181.0, "cx": 160.0, "cy": 120.0,
                      "k1": 0.05, "k2": 0.01, "k3": -0.002, "k4": 0.0005},
       "image_width": 320, "image_height": 240}


def test_fisheye_equals_jax():
    flat = {"intrinsic_type": "FISHEYE", "fx": 90.0, "cx": 40.0, "cy": 30.0, "k1": 0.1,
            "image_width": 80, "image_height": 60}
    for cal in (CAL, flat):
        got, want = fisheye.parse_fisheye_intrinsics(cal), jfish.parse_fisheye_intrinsics(cal)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        fisheye.parse_fisheye_intrinsics({"intrinsic_type": "PINHOLE", "intrinsics": {}})
    pytest.importorskip("cv2")
    p = fisheye.parse_fisheye_intrinsics(CAL)
    args = (p["K"], p["D"], (160, 120))
    kw = dict(out_size=(48, 48), out_fov=100.0, cal_size=(320, 240))
    got, want = fisheye.FisheyeRectConverter(*args, **kw), jfish.FisheyeRectConverter(*args, **kw)
    img = np.random.default_rng(3).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    np.testing.assert_array_equal(got.map1, want.map1)
    np.testing.assert_array_equal(got(img), want(img))


def test_rtde_packets_equal_jax():
    types = ["DOUBLE", "VECTOR6D", "INT32", "UINT64", "VECTOR3D", "BOOL", "UINT8", "VECTOR6INT32",
             "UINT32"]
    values = [1.5, np.arange(6.0) - 2.5, -7, 2**40, np.array([0.1, 0.2, 0.3]), True, 200,
              np.arange(6) - 3, 12345]
    blob = rtde._pack_values(types, values)
    assert blob == jrtde._pack_values(types, values)
    for g, w in zip(rtde._unpack_values(types, blob), jrtde._unpack_values(types, blob)):
        np.testing.assert_array_equal(g, w)
    for ptype in (rtde.PacketType.DATA_PACKAGE, rtde.PacketType.CONTROL_PACKAGE_SETUP_OUTPUTS,
                  rtde.PacketType.REQUEST_PROTOCOL_VERSION):
        for payload in (b"", struct.pack(">H", 2), struct.pack(">d", 125.0) + b"timestamp,actual_q"):
            assert rtde.encode_packet(ptype, payload) == jrtde.encode_packet(ptype, payload)
    assert rtde.RTDE_TYPES == jrtde.RTDE_TYPES
    with pytest.raises(rtde.RtdeError):
        rtde._pack_values(["VECTOR6D"], [np.zeros(5)])


def test_wsg_frames_and_crc_equal_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 300):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert wsg.crc16_ccitt(data) == jwsg.crc16_ccitt(data)
        assert wsg.encode_frame(0xB1, data) == jwsg.encode_frame(0xB1, data)
    assert wsg.crc16_ccitt(b"\xaa\xaa\xaa") == 0x50F5  # the reference's header seed
    frame = wsg.encode_frame(wsg.Cmd.PRE_POSITION, b"\x00" + struct.pack("<ff", 40.0, 100.0))
    assert wsg.crc16_ccitt(frame) == 0  # an intact frame checks to 0
    assert {c.name: c.value for c in wsg.Cmd} == {c.name: c.value for c in jwsg.Cmd}
    assert {c.name: c.value for c in wsg.StatusCode} == {c.name: c.value for c in jwsg.StatusCode}


def test_accumulator_single_put_equals_jax_and_overlaps_are_kept_once():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.uniform(0.005, 0.01, 40))
    poses = rng.standard_normal((40, 6))
    got, want = env._Accumulator(), jenv._Accumulator()
    for acc in (got, want):
        acc.put({"pose": poses[:30]}, ts[:30])
        acc.put({"width": np.array([0.05, 0.06])}, ts[:1])  # one row broadcast over the stamps
    for k, v in want.arrays().items():
        np.testing.assert_array_equal(got.arrays()[k], v, err_msg=k)
    # the overlapping window of a later get_obs: each sample recorded once
    got.put({"pose": poses[10:]}, ts[10:])
    np.testing.assert_array_equal(got.arrays()["pose"], poses)
    np.testing.assert_array_equal(got.arrays()["pose_timestamp"], ts)
    # actions: a later chunk replaces the recorded rows from its first stamp on
    acts = env._Accumulator(supersede=True)
    acts.put({"action": np.ones((4, 7))}, np.array([1.0, 1.1, 1.2, 1.3]))
    acts.put({"action": np.zeros((0, 7))}, np.zeros(0))  # a chunk whose actions were all stale
    acts.put({"action": 2 * np.ones((3, 7))}, np.array([1.15, 1.25, 1.35]))
    out = acts.arrays()
    np.testing.assert_array_equal(out["action_timestamp"], [1.0, 1.1, 1.15, 1.25, 1.35])
    np.testing.assert_array_equal(out["action"][:, 0], [1, 1, 2, 2, 2])


def test_unique_name_format():
    import os

    a, b = _unique_name("cam"), _unique_name("cam")
    assert a != b and a.startswith(f"uva_cam_{os.getpid()}_")
    assert int(b.rsplit("_", 1)[1]) == int(a.rsplit("_", 1)[1]) + 1
