"""The port stands alone: importing unified_video_action_tpu_torch and every
module in it (the offline evaluation of ``eval/`` too, and the real-robot
stack of ``ipc/``, ``real/`` and ``serving/``, and the robomimic and LIBERO
suites: their stub envs, runners, datasets and augmentation, and the CLIP
text tower), and train_torch.py, loads no
JAX, no flax, no optax, no orbax and nothing of the JAX package, and no
OpenCV, PIL, dill, h5py, zstandard or zmq (which the card's machine lacks;
h5py, zstandard and zmq are imported only inside the functions that need
them); chip_smoke.py, train_torch.py and the card's tests import none of
them either. OpenCV appears only in ``real/``, and there only inside the
functions of a real camera, the fisheye remap, the visualizer's window and
the video recorder, never at a module's top level. chip_smoke.py refuses to
run without a CUDA device or without the package beside it.
eval_sim_torch.py and eval_real_torch.py import nothing of the JAX package
(orbax, to read an orbax checkpoint, only inside the function that reads
it; zmq only inside the server).

The import check runs in a fresh interpreter, since this test process has
JAX loaded already.
"""

import ast
import os
import shutil
import subprocess
import sys

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "unified_video_action_tpu")
NOT_ON_THE_CARD = ("cv2", "PIL", "dill")
# not on the card either: imported only inside the functions that read a file
# with them (ReplayBuffer.load of HDF5, tools/export_corpus.py) or serve with
# them (zmq: serving/zmq_server.py's serve)
LAZY_ONLY = ("h5py", "zstandard", "zmq")
# the real-robot stack, where OpenCV may be imported inside a function (the
# card's machine never calls one of those)
REAL = os.path.join(REPO, "unified_video_action_tpu_torch", "real")

_PROBE = r"""
import importlib, json, pkgutil, sys
import numpy, torch
torch_roots = sorted({m.split(".")[0] for m in sys.modules})
import unified_video_action_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
names.append(pkg.__name__ + ".tools.gen_pusht_demos")  # tools/ is no package; the demo tool imports the env
for name in names:
    importlib.import_module(name)
import train_torch
roots = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"modules": names, "roots": roots, "torch_roots": torch_roots}))
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    import json

    env = dict(os.environ, PYTHONPATH=REPO)
    out = _run(["-c", _PROBE], cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for expected in ("ops.attention", "ops._build", "ops.int8_mm", "ops.quant", "convert",
                     "models.mar", "models.vae", "models.heads", "models.denoiser",
                     "models.transformer", "models.diffusion.gaussian", "policy.policy",
                     "utils.image", "utils.obs_codec", "utils.frames", "utils.device",
                     "data.normalizer", "envs.physics2d", "envs.raster", "envs.pusht",
                     "envs.wrappers", "runners.base", "runners.pusht_runner", "utils.ckpt_id",
                     "utils.language", "config", "models.initializers", "data.replay_buffer",
                     "data.sampler", "data.pusht_dataset", "data.device_dataset",
                     "training.optim", "training.ema", "training.train_state",
                     "training.workspace", "training.checkpoint", "training.trackers",
                     "eval.metrics", "eval.offline", "eval.i3d", "utils.rotation",
                     "utils.pose", "data.umi_dataset", "data.loader", "ipc.shm",
                     "real", "real.trajectory", "real.controller", "real.camera", "real.sim",
                     "real.env", "real.bimanual", "real.visualizer", "real.video_recorder",
                     "real.fisheye", "real.rtde", "real.wsg", "serving.real_inference",
                     "serving.zmq_server", "envs.stub", "envs.kitchen_tasks",
                     "runners.robomimic_runner", "runners.libero_runner", "data.augmentation",
                     "data.robomimic_dataset", "data.libero_dataset", "models.clip",
                     "envs.pusht_expert", "envs.video_recording", "utils.media",
                     "tools.gen_pusht_demos"):
        assert f"unified_video_action_tpu_torch.{expected}" in result["modules"]
    loaded = set(result["roots"])
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
    # torch itself imports dill where dill is installed; the port adds neither
    added = loaded - set(result["torch_roots"])
    assert not added & set(NOT_ON_THE_CARD + LAZY_ONLY), sorted(added & set(NOT_ON_THE_CARD + LAZY_ONLY))
    assert "cv2" not in loaded and "PIL" not in loaded


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_the_port_and_its_card_tests_import_no_jax():
    # all of them run on the machine with the card, which has no JAX
    sources = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "train_torch.py"),
               os.path.join(REPO, "tests", "test_torch_attention_cuda.py"),
               os.path.join(REPO, "tests", "test_torch_int8_cuda.py")]
    for root, _, files in os.walk(os.path.join(REPO, "unified_video_action_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        in_real = os.path.dirname(path) == REAL
        bad = _imported_roots(path) & set(FORBIDDEN + NOT_ON_THE_CARD) - ({"cv2"} if in_real else set())
        bad |= _module_level_roots(path) & set(LAZY_ONLY + NOT_ON_THE_CARD)
        assert not bad, (path, bad)
    lazy_cv2 = sorted(os.path.basename(p) for p in sources if "cv2" in _imported_roots(p))
    assert lazy_cv2 == ["fisheye.py", "sim.py", "visualizer.py"], lazy_cv2


def _module_level_roots(path):
    """The roots imported at the top level of a file (not inside a function)."""
    tree = ast.parse(open(path).read())
    roots = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_eval_sim_torch_imports_nothing_of_the_jax_package():
    path = os.path.join(REPO, "eval_sim_torch.py")
    everywhere = _imported_roots(path)
    assert not everywhere & {"jax", "jaxlib", "flax", "optax", "unified_video_action_tpu",
                             *NOT_ON_THE_CARD}, everywhere
    assert "orbax" not in _module_level_roots(path)
    out = _run([path, "--help"], cwd=REPO)
    assert out.returncode == 0 and "--weights" in out.stdout, out.stderr


def test_eval_real_torch_imports_nothing_of_the_jax_package():
    path = os.path.join(REPO, "eval_real_torch.py")
    everywhere = _imported_roots(path)
    assert not everywhere & {"jax", "jaxlib", "flax", "optax", "orbax", "unified_video_action_tpu",
                             *NOT_ON_THE_CARD, *LAZY_ONLY}, everywhere
    out = _run([path, "--help"], cwd=REPO)
    assert out.returncode == 0 and "--language-latents" in out.stdout, out.stderr


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["chip_smoke.py"], cwd=REPO, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["chip_smoke.py"], cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
