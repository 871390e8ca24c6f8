"""The port's real-robot runtime in software, on the CPU: spawned controller
and camera processes over the port's shared-memory library, with the
simulated backends of ``real/sim.py``.

- ``UmiRealEnv``: the obs window aligned on the camera's newest frame
  (stamps 1 / frequency apart, the pose and width interpolated at them
  equal to JAX's trajectory interpolation of the same state stream, to
  1e-12), timed execution (the arm mid-way at half the schedule, then on the
  target within 1e-3 m, the gripper within 1e-3 m), stale actions dropped,
  the arm's ``TargetTCPPose`` its trajectory's value, every waypoint of a
  gripper chunk kept, and an episode of two overlapping chunks recorded as
  the controllers kept them, with increasing timestamps; stop unlinks every
  segment;
- ``BimanualUmiEnv``: per-arm namespacing and interleaved 14-d actions;
- ``MultiCameraVisualizer`` (ring and file sinks) and
  ``VideoRecorderProcess`` (an mp4 that OpenCV reads back) on a ring the
  test writes.

Each process is joined in its test (about 0.1 s each); the file takes
about 15 s alone.
"""

import os
import time
import types

import numpy as np
import pytest

from unified_video_action_tpu.real import trajectory as jtraj
from unified_video_action_tpu_torch.ipc.shm import SharedMemoryRingBuffer
from unified_video_action_tpu_torch.real import (CameraProcess, PoseInterpolationController,
                                                 UmiRealEnv, WidthController)
from unified_video_action_tpu_torch.real.bimanual import BimanualUmiEnv
from unified_video_action_tpu_torch.real.controller import _unique_name
from unified_video_action_tpu_torch.real.sim import SimArmBackend, SimCameraBackend, SimGripperBackend
from unified_video_action_tpu_torch.real.visualizer import MultiCameraVisualizer


def _devices(init_x=0.0, cam_seed=1):
    robot = PoseInterpolationController(SimArmBackend(init_pose=np.r_[init_x, 0, 0, 0, 0, 0], tau=0.005),
                                        frequency=200.0, max_pos_speed=2.0, max_rot_speed=4.0)
    gripper = WidthController(SimGripperBackend(init_width=0.08, max_speed=1.0), frequency=60.0,
                              max_speed=1.0)
    cam = CameraProcess(SimCameraBackend((24, 24), seed=cam_seed), resolution=(24, 24), fps=60.0)
    return robot, gripper, cam


def _names(*devices):
    return [os.path.join("/dev/shm", seg.name.decode()) for d in devices
            for seg in (d.ring, getattr(d, "input_queue", None)) if seg is not None]


def test_umi_real_env_obs_timed_execution_and_episode():
    robot, gripper, cam = _devices()
    env = UmiRealEnv(robot, gripper, [cam], frequency=10.0, camera_obs_horizon=3,
                     robot_obs_horizon=3, gripper_obs_horizon=3)
    names = _names(robot, gripper, cam)
    with env:
        time.sleep(0.35)  # the state streams cover the window
        obs = env.get_obs()
        state, gstate = robot.get_all_state(), gripper.get_all_state()
        assert obs["camera0_rgb"].shape == (3, 24, 24, 3)
        assert {k: obs[k].shape for k in ("robot0_eef_pos", "robot0_eef_rot_axis_angle",
                                          "robot0_gripper_width")} == {
            "robot0_eef_pos": (3, 3), "robot0_eef_rot_axis_angle": (3, 3), "robot0_gripper_width": (3, 1)}
        np.testing.assert_allclose(np.diff(obs["timestamp"]), 0.1, atol=1e-6)  # float64 wall clock
        assert abs(obs["timestamp"][-1] - time.time()) < 0.5
        # the pose at the aligned stamps: JAX's interpolation of the state the
        # env read (the ring's newest 128 states, a superset of those read)
        k = np.searchsorted(state["timestamp"], obs["timestamp"][0]) - 1
        if k >= 0:
            want = jtraj.PoseTrajectory(state["timestamp"], state["ActualTCPPose"])(obs["timestamp"])
            np.testing.assert_allclose(obs["robot0_eef_pos"], want[:, :3], rtol=0, atol=1e-12)
        assert gstate["gripper_position"].shape[0] > 5

        env.start_episode()
        t0 = time.time()
        stamps = t0 + 0.2 + np.arange(4) * 0.1
        target = np.array([0.10, 0.0, 0.0, 0.0, 0.0, 0.3])
        widths = np.array([0.06, 0.02, 0.05, 0.03])
        first = np.concatenate([np.linspace(np.zeros(6), target, 4), widths[:, None]], axis=1)
        assert env.exec_actions(first, stamps) == 4
        assert env.exec_actions(first, stamps - 100.0) == 0  # stale: dropped
        # a second chunk 50 ms after stamps[2] replaces the first's last action
        second = first[2:].copy()
        second[:, 0] += 0.05
        assert env.exec_actions(second, stamps[2:] + 0.05) == 2
        time.sleep(stamps[1] - time.time())
        mid = robot.get_state()
        time.sleep(stamps[-1] + 0.05 - time.time() + 0.3)
        env.get_obs()
        end, gend = robot.get_state(), gripper.get_state()
        episode = env.end_episode()
    assert not any(os.path.exists(n) for n in names), "segments left in /dev/shm"

    # on schedule: at the second waypoint's time the arm is on its way, near
    # its setpoint (the lag is about the speed times tau, 2 mm)
    assert first[0, 0] <= mid["TargetTCPPose"][-1, 0] <= second[0, 0], mid
    np.testing.assert_allclose(mid["ActualTCPPose"][-1], mid["TargetTCPPose"][-1], atol=5e-3)
    np.testing.assert_allclose(end["ActualTCPPose"][-1], second[-1, :6], atol=1e-3)
    np.testing.assert_allclose(end["TargetTCPPose"][-1], second[-1, :6], atol=1e-9)
    assert abs(gend["gripper_position"][-1] - widths[-1]) < 1e-3
    # the episode: the first chunk's actions before the second's first stamp,
    # then the second chunk (the last of the first chunk was replaced)
    np.testing.assert_allclose(episode["action_timestamp"], [*stamps[:3], *(stamps[2:] + 0.05)])
    np.testing.assert_allclose(episode["action"], np.concatenate([first[:3], second]))
    for key in ("robot0_eef_pose", "robot0_gripper_width", "action"):
        assert np.all(np.diff(episode[key + "_timestamp"]) > 0), key
    assert len(episode["robot0_eef_pose"]) > 100


def test_gripper_keeps_every_waypoint_of_a_chunk():
    gripper = WidthController(SimGripperBackend(init_width=0.08, max_speed=5.0), frequency=100.0,
                              max_speed=5.0)
    gripper.start_wait()
    try:
        t0 = time.time() + 0.1
        stamps, widths = t0 + 0.3 * np.arange(1, 4), [0.02, 0.07, 0.03]
        for w, t in zip(widths, stamps):
            gripper.schedule_waypoint(w, t)
        time.sleep(stamps[-1] + 0.1 - time.time())
        state = gripper.get_all_state()  # 1.28 s of the width, read after the fact
    finally:
        gripper.stop_wait()
    seen = np.interp(stamps, state["timestamp"], state["gripper_position"])
    # each waypoint reached at its time; JAX's width controller keeps only
    # the last and would read about 0.06 and 0.045 at the first two
    np.testing.assert_allclose(seen, widths, atol=0.01)


def test_bimanual_env_namespacing_and_interleaved_actions():
    (r0, g0, c0), (r1, g1, c1) = _devices(0.0, 1), _devices(0.1, 2)
    env = BimanualUmiEnv([r0, r1], [g0, g1], [c0, c1], frequency=10.0)
    with env:
        time.sleep(0.25)
        obs = env.get_obs()
        for i in range(2):
            assert obs[f"camera{i}_rgb"].shape == (2, 24, 24, 3)
            assert obs[f"robot{i}_eef_pos"].shape == (2, 3)
            assert obs[f"robot{i}_gripper_width"].shape == (2, 1)
        assert abs(obs["robot1_eef_pos"][-1, 0] - 0.1) < 1e-6
        targets = np.zeros((2, 14))
        targets[:, 0], targets[:, 6], targets[:, 7], targets[:, 13] = 0.3, 0.08, -0.2, 0.02
        t0 = time.time()
        assert env.exec_actions(targets, t0 + np.array([0.2, 0.3])) == 2
        with pytest.raises(AssertionError):
            env.exec_actions(np.zeros((1, 7)), np.array([t0 + 1]))
        time.sleep(t0 + 0.9 - time.time())
        obs = env.get_obs()
    assert obs["robot0_eef_pos"][-1, 0] == pytest.approx(0.3, abs=1e-3)
    assert obs["robot1_eef_pos"][-1, 0] == pytest.approx(-0.2, abs=1e-3)
    assert obs["robot1_gripper_width"][-1, 0] == pytest.approx(0.02, abs=1e-3)


def test_visualizer_and_recorder_follow_a_ring(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from unified_video_action_tpu_torch.real.video_recorder import VideoRecorderProcess

    rings = [SharedMemoryRingBuffer(_unique_name("test_cam"),
                                    {"color": np.zeros((16, 16, 3), np.uint8),
                                     "timestamp": np.zeros((), np.float64)}, get_max_k=8)
             for _ in range(2)]
    cams = [types.SimpleNamespace(ring=r) for r in rings]
    for i, r in enumerate(rings):
        r.put({"color": np.full((16, 16, 3), 40 * (i + 1), np.uint8), "timestamp": time.time()})
    out = str(tmp_path / "grid.npy")
    vis = MultiCameraVisualizer(cams, row=2, col=2, vis_fps=50.0, sink="file", out_path=out,
                                rgb_to_bgr=False)
    rec = VideoRecorderProcess(rings[0], fps=30.0)
    path = str(tmp_path / "ep" / "video.mp4")
    try:
        rec.start_wait()
        rec.start_recording(path)
        with vis:
            deadline = time.time() + 10
            i = 0
            while (rec.n_written < 8 or not os.path.exists(out)) and time.time() < deadline:
                rings[0].put({"color": np.full((16, 16, 3), i % 200, np.uint8), "timestamp": time.time()})
                i += 1
                time.sleep(1 / 25)
            grid = vis.get(1)["grid"][-1]
        rec.stop_recording()
        time.sleep(0.2)
        assert rec.n_written >= 8
    finally:
        rec.stop_wait()
        for r in rings:
            r.close(unlink=True)
    assert grid.shape == (32, 32, 3)
    assert (grid[:16, 16:] == 80).all() and (grid[16:] == 0).all()  # camera 1, then empty cells
    assert np.load(out).shape == (32, 32, 3)
    reader = cv2.VideoCapture(path)
    frames = 0
    while reader.read()[0]:
        frames += 1
    reader.release()
    assert frames >= 8
