"""The real-robot serving path of the port on the CPU, against the JAX package
where it has a counterpart, on a narrow UMI-shaped policy (2+2 ViT blocks of
d = 32 over 2 heads, a 32 px VAE with ch = 32, 1-block heads, 4 sampler
steps; history actions, the 16-d state and language latents on), fp32,
numpy-drawn weights shared by both:

- ``PolicyInferenceNode.infer`` on the obs dict that ``get_real_umi_obs_dict``
  makes of a raw 16-step robot window, under the draws of the key JAX's node
  splits for each request: equal to JAX's node (``predict_action`` then
  ``smooth_action``) within 1e-4 over two requests, with the task's language
  latent routed by name; the node's own generator reproducible from its seed;
- ``eval_real_torch.py`` serving a checkpoint over a ZMQ REQ/REP socket on
  loopback (``--device cpu``, the deploy convention's 100 steps, a latents
  pickle): the reply is the chunk the node computes in-process, equal, and a
  malformed request gets a traceback string; ``--device cuda`` without a
  card refuses to start;
- a closed loop of three control cycles with the sim-backed ``UmiRealEnv``
  (spawned processes, a 32 px camera, the 16-step window at 2 Hz): get_obs, the obs
  bridge, ``infer``, ``get_real_umi_action``, timed ``exec_actions``; every
  action finite, fresh actions scheduled each cycle, the episode's actions
  those the controllers kept.

About 30 s alone.
"""

import functools
import json
import pickle
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import eval_real_torch
from tests._torch_parity import policy_draws, random_params, to_numpy
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu.serving.zmq_server import PolicyInferenceNode as JaxNode
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.real import (CameraProcess, PoseInterpolationController,
                                                 UmiRealEnv, WidthController)
from unified_video_action_tpu_torch.real.sim import SimArmBackend, SimCameraBackend, SimGripperBackend
from unified_video_action_tpu_torch.serving.real_inference import get_real_umi_action, get_real_umi_obs_dict
from unified_video_action_tpu_torch.serving.zmq_server import PolicyInferenceNode

AMP = {
    "model_size": "custom",
    "encoder_embed_dim": 32, "encoder_depth": 2, "encoder_num_heads": 2,
    "decoder_embed_dim": 32, "decoder_depth": 2, "decoder_num_heads": 2,
    "img_size": 32, "vae_stride": 8, "vae_embed_dim": 8,
    "diffloss_d": 1, "diffloss_w": 16, "diffloss_act_d": 1, "diffloss_act_w": 16,
    "num_sampling_steps": "2", "act_diff_testing_steps": "4",
    "attn_dropout": 0.0, "proj_dropout": 0.0, "pretrained_model_path": None,
    "temperature": 0.95,
}
UMI_KW = dict(shape_meta={"action": {"shape": [10]}},
              vae_model_params={"autoencoder_path": None,
                                "ddconfig": {"vae_embed_dim": 8, "ch_mult": [1, 1, 2, 2], "ch": 32}},
              autoregressive_model_params=AMP,
              action_model_params={"predict_action": True, "act_model_type": "conv_fc"},
              task_name="umi", normalizer_type="none", shift_action=False, use_proprioception=True,
              use_history_action=True, different_history_freq=True, language_emb_model="clip",
              compute_dtype="float32")
GOAL = np.random.default_rng(7).standard_normal((1, 512)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params():
    jp = JaxPolicy(**UMI_KW)
    return to_numpy(random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=9))


def _port(**overrides):
    port = UnifiedVideoActionPolicy(**{**UMI_KW, **overrides}, device="cpu")
    port.load_params(_params()["mar"], _params()["vae"])
    return port


def _request(seed, T=16, px=32):
    """A raw 16-step robot window through the obs bridge, batched."""
    rng = np.random.default_rng(seed)
    raw = {"camera0_rgb": rng.integers(0, 256, (T, px, px, 3), dtype=np.uint8),
           "robot0_eef_pos": 0.1 * rng.standard_normal((T, 3)),
           "robot0_eef_rot_axis_angle": rng.uniform(-1, 1, (T, 3)),
           "robot0_gripper_width": rng.uniform(0, 0.08, (T, 1))}
    start = np.concatenate([raw["robot0_eef_pos"][0], raw["robot0_eef_rot_axis_angle"][0]])
    return {k: v[None] for k, v in get_real_umi_obs_dict(raw, episode_start_pose=start).items()}


def test_node_infer_equals_jax_node():
    params = _params()
    jax_node = JaxNode(JaxPolicy(**UMI_KW), jax.tree_util.tree_map(jax.numpy.asarray, params),
                       language_latents={"cup": GOAL}, smooth_window=3, seed=5)
    port = _port()
    node = PolicyInferenceNode(port, language_latents={"cup": GOAL}, smooth_window=3)
    key = jax.random.PRNGKey(5)
    for i in range(2):
        req = _request(i)
        key, sub = jax.random.split(key)  # as JAX's node splits its key per request
        want = jax_node.infer(req, "cup")
        got = node.infer(req, "cup", noise=policy_draws(sub, port.noise_shapes(1)))
        assert got.shape == want.shape == (1, 16, 10)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the language latent is routed by task name: another task gets no goal
    other = node.infer(req, "unknown", noise=policy_draws(sub, port.noise_shapes(1)))
    assert np.abs(other - got).max() > 1e-4
    # the node's own draws: reproducible from its seed, other with another seed
    a = PolicyInferenceNode(port, seed=3).infer(req)
    b = PolicyInferenceNode(port, seed=3).infer(req)
    c = PolicyInferenceNode(port, seed=4).infer(req)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a - c).max() > 1e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("real_ckpt")
    ckpt = root / "umi_tiny"
    ckpt.mkdir()
    policy = {k: v for k, v in UMI_KW.items() if k != "task_name"}
    (ckpt / "meta.json").write_text(json.dumps(  # a slim export of the port
        {"cfg": {"task": {"name": "umi"}, "model": {"policy": dict(policy, _target_="policy")}},
         "slim": True, "export_dtype": "float32"}))
    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
        return out

    np.savez(ckpt / "weights.npz", **flat(_params()["mar"], "mar/"), **flat(_params()["vae"], "vae/"))
    with open(root / "latents.pkl", "wb") as f:
        pickle.dump({"cup": GOAL[0]}, f)  # (512,), as the reference's pickles hold them
    return ckpt, root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_eval_real_torch_serves_over_zmq(checkpoint):
    zmq = pytest.importorskip("zmq")
    ckpt, root = checkpoint
    bind = f"tcp://127.0.0.1:{_free_port()}"
    argv = ["-c", str(ckpt), "--device", "cpu", "--language-latents", str(root / "latents.pkl"),
            "--bind", bind]
    if not torch.cuda.is_available():  # the default device, and no fallback to the CPU
        with pytest.raises(SystemExit, match="cuda"):
            eval_real_torch.build_node(eval_real_torch.parse_args(argv[:2]))
    args = eval_real_torch.parse_args(argv)
    node = eval_real_torch.build_node(args)
    assert node.policy.mar.diffactloss.num_steps == 100  # the deploy convention
    server = threading.Thread(target=node.serve, args=(args.bind, 2), daemon=True)
    server.start()
    ctx = zmq.Context()
    sock = ctx.socket(zmq.REQ)
    sock.setsockopt(zmq.RCVTIMEO, 60000)
    sock.connect(bind)
    req = _request(3)
    try:
        sock.send(pickle.dumps({"obs": req, "task_name": "cup"}))
        served = pickle.loads(sock.recv())
        sock.send(pickle.dumps({"obs": {"camera0_rgb": "not an array"}}))
        err = pickle.loads(sock.recv())
    finally:
        sock.close(linger=0)
        ctx.term()
    server.join(timeout=30)
    assert not server.is_alive()
    assert isinstance(err, str) and "Traceback" in err
    # the same request in-process on a node built alike: the same first draws
    again = eval_real_torch.build_node(args)
    assert served.shape == (1, 16, 10)
    np.testing.assert_array_equal(served, again.infer(req, "cup"))


def test_closed_loop_with_the_sim_env():
    port = _port()
    node = PolicyInferenceNode(port, language_latents={"cup": GOAL}, smooth_window=3, seed=1)
    robot = PoseInterpolationController(SimArmBackend(init_pose=np.array([0.4, 0, 0.3, 0, 3.0, 0]),
                                                      tau=0.01),
                                        frequency=100.0, max_pos_speed=100.0, max_rot_speed=100.0)
    gripper = WidthController(SimGripperBackend(init_width=0.08, max_speed=100.0), frequency=30.0,
                              max_speed=100.0)
    cam = CameraProcess(SimCameraBackend((32, 32), seed=0), resolution=(32, 32), fps=20.0, get_max_k=32)
    # 2 Hz: the chunk spans 7.5 s, so a request slowed by a loaded CPU still
    # leaves fresh actions (the card's loop runs at 10 Hz)
    hz = 2.0
    env = UmiRealEnv(robot, gripper, [cam], frequency=hz, camera_obs_horizon=16,
                     robot_obs_horizon=16, gripper_obs_horizon=16)
    rows, fresh = [], []
    with env:
        time.sleep(0.2)
        obs = env.get_obs()
        start = np.concatenate([obs["robot0_eef_pos"][-1], obs["robot0_eef_rot_axis_angle"][-1]])
        env.start_episode()
        for _ in range(3):
            obs = env.get_obs()
            assert obs["camera0_rgb"].shape == (16, 32, 32, 3)
            req = {k: v[None] for k, v in get_real_umi_obs_dict(obs, episode_start_pose=start).items()}
            chunk = node.infer(req, "cup")
            current = np.concatenate([obs["robot0_eef_pos"][-1], obs["robot0_eef_rot_axis_angle"][-1]])
            actions = get_real_umi_action(chunk[0], current)
            assert actions.shape == (16, 7) and np.isfinite(actions).all()
            stamps = obs["timestamp"][-1] + np.arange(16) / hz
            n = env.exec_actions(actions, stamps)
            assert n > 0
            fresh.append(n)
            new = list(stamps[16 - n:])
            rows = [t for t in rows if t < new[0]] + new
            time.sleep(0.3)
        episode = env.end_episode()
    np.testing.assert_allclose(episode["action_timestamp"], rows)
    assert np.all(np.diff(episode["robot0_eef_pose_timestamp"]) > 0)
