"""The port's robomimic and LIBERO datasets (``data/robomimic_dataset.py``,
``data/libero_dataset.py``) against the JAX package's, on tiny stores
written with h5py, on the CPU.

- Robomimic: every training and validation item, the normalizer's fields
  and the validation split bit-equal to JAX's (numpy only on both sides;
  tolerance 0), the action conversion on one and two arms and its undo.
- LIBERO: the same for a directory of per-task stores, with the vertical
  flip and rot6d actions, and the per-episode text latents; only the
  ``language`` token rows differ, by design: JAX's fallback tokenizer hashes
  words with the salted ``hash`` (ROADMAP C14), the port's with sha256, so
  the port's rows are held to their own definition and the masks to JAX's.
  Under ``data_aug`` the items go through ``ColorJitter``, whose hue shift
  JAX computes with OpenCV: within AUG_ATOL (the augmentation test's).
- The ``.npz`` store of the same arrays gives the HDF5's items bit for bit.
- A kitchen-named store resolves the kitchen prompt, as JAX's.

JAX's datasets are built with ``transformers`` hidden, as on a host without
it (the card's machine): JAX's tokenizer and text encoder then take their
fallbacks at once (importing transformers to find no local CLIP files takes
seconds).
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.data import libero_dataset as jlib
from unified_video_action_tpu.data import robomimic_dataset as jrm
from unified_video_action_tpu_torch.data import libero_dataset as plib
from unified_video_action_tpu_torch.data import robomimic_dataset as prm
from unified_video_action_tpu_torch.runners.base import undo_transform_action
from unified_video_action_tpu_torch.utils.rotation import RotationTransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG_ATOL = 5e-6

RM_META = {
    "action": {"shape": [10]},
    "obs": {
        "sideview_image": {"shape": [3, 24, 24], "type": "rgb"},
        "robot0_eye_in_hand_image": {"shape": [3, 24, 24], "type": "rgb"},
        "robot0_eef_pos": {"shape": [3], "type": "low_dim"},
        "robot0_eef_quat": {"shape": [4], "type": "low_dim"},
        "robot0_gripper_qpos": {"shape": [2], "type": "low_dim"},
    },
}
LIBERO_META = {
    "action": {"shape": [10]},
    "obs": {
        "agentview_rgb": {"shape": [3, 16, 16], "type": "rgb"},
        "language": {"shape": [15], "type": "low_dim"},
    },
}
LIBERO_FILES = ("KITCHEN_SCENE1_open_the_top_drawer_demo", "LIVING_ROOM_SCENE2_pick_up_the_book_demo",
                "kitchen_light_switch_demo")


def _demos(rng, n_demos, lengths, image_keys, size, lowdim=True):
    demos = []
    for i in range(n_demos):
        n = lengths[i % len(lengths)]
        obs = {k: rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for k in image_keys}
        if lowdim:
            q = rng.standard_normal((n, 4))
            obs.update(robot0_eef_pos=rng.standard_normal((n, 3)).astype(np.float32),
                       robot0_eef_quat=(q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
                       robot0_gripper_qpos=rng.uniform(size=(n, 2)).astype(np.float32))
        demos.append({"obs": obs, "actions": rng.standard_normal((n, 7)).astype(np.float32),
                      "states": rng.standard_normal((n, 5))})
    return demos


def _write_hdf5(path, demos):
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for i, d in enumerate(demos):
            g = data.create_group(f"demo_{i}")
            for k, v in d["obs"].items():
                g.create_dataset(f"obs/{k}", data=v)
            g.create_dataset("actions", data=d["actions"])
            g.create_dataset("states", data=d["states"])


@pytest.fixture(autouse=True)
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both suites' stores, each as HDF5 and as .npz of the same arrays."""
    root = tmp_path_factory.mktemp("suites")
    rng = np.random.default_rng(0)
    rm = _demos(rng, 5, (40, 45, 37), ("sideview_image", "robot0_eye_in_hand_image"), 24)
    _write_hdf5(root / "rm.hdf5", rm)
    prm.write_npz_store(str(root / "rm.npz"), rm)
    for fmt in ("hdf5", "npz"):
        (root / f"libero_{fmt}").mkdir()
    for name in LIBERO_FILES:
        demos = _demos(rng, 2, (30, 26), ("agentview_rgb",), 16, lowdim=False)
        _write_hdf5(root / "libero_hdf5" / f"{name}.hdf5", demos)
        prm.write_npz_store(str(root / "libero_npz" / f"{name}.npz"), demos)
    return root


RM_KW = dict(horizon=16, pad_before=1, pad_after=7, val_ratio=0.4, seed=3)


def _same_items(a, b, n, skip=()):
    assert len(a) == len(b) == n
    for i in range(n):
        x, y = a[i], b[i]
        assert x.keys() == y.keys() and x["obs"].keys() == y["obs"].keys()
        for k in x["obs"]:
            if k in skip:
                continue
            assert x["obs"][k].dtype == y["obs"][k].dtype, k
            np.testing.assert_array_equal(x["obs"][k], y["obs"][k], err_msg=f"{i} {k}")
        np.testing.assert_array_equal(x["action"], y["action"])


def _same_normalizer(a, b):
    assert a.fields.keys() == b.fields.keys()
    for k in a.fields:
        np.testing.assert_array_equal(a[k].scale, b[k].scale, err_msg=k)
        np.testing.assert_array_equal(a[k].offset, b[k].offset, err_msg=k)
        for s in a[k].input_stats:
            np.testing.assert_array_equal(a[k].input_stats[s], b[k].input_stats[s], err_msg=k)


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
def test_robomimic_dataset_equals_jax(stores, fmt):
    want = jrm.RobomimicReplayImageDataset(str(stores / "rm.hdf5"), RM_META, **RM_KW)
    got = prm.RobomimicReplayImageDataset(str(stores / f"rm.{fmt}"), RM_META, **RM_KW)
    np.testing.assert_array_equal(got.val_mask, want.val_mask)
    assert 0 < got.val_mask.sum() < len(got.val_mask)
    _same_items(got, want, len(want))
    _same_items(got.get_validation_dataset(), want.get_validation_dataset(),
                len(want.get_validation_dataset()))
    _same_normalizer(got.get_normalizer(), want.get_normalizer())
    a = got[3]["action"]
    np.testing.assert_allclose(got.undo_transform_action(a), want.undo_transform_action(a),
                               rtol=0, atol=1e-6)


def test_action_conversion_one_and_two_arms():
    rng = np.random.default_rng(4)
    tf = RotationTransformer("axis_angle", "rotation_6d")
    for width in (7, 14):
        raw = rng.standard_normal((12, width)).astype(np.float32)
        got, want = prm.convert_robomimic_actions(raw), jrm.convert_robomimic_actions(raw)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (12, width // 7 * 10)
        back = undo_transform_action(got, tf)
        np.testing.assert_allclose(back[..., :3], raw[..., :3], atol=1e-6)
        np.testing.assert_array_equal(prm.convert_robomimic_actions(raw, abs_action=False), raw)
    dual = rng.standard_normal((50, 20)).astype(np.float32)
    a, b = prm._abs_action_normalizer(dual), jrm._abs_action_normalizer(dual)
    np.testing.assert_array_equal(a.scale, b.scale)
    np.testing.assert_array_equal(a.offset, b.offset)


LIBERO_KW = dict(horizon=16, pad_before=1, pad_after=7, val_ratio=0.34, seed=5)


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
def test_libero_dataset_equals_jax(stores, fmt):
    want = jlib.LiberoReplayImageDataset(str(stores / "libero_hdf5"), LIBERO_META,
                                         emit_language_latents=True, **LIBERO_KW)
    got = plib.LiberoReplayImageDataset(str(stores / f"libero_{fmt}"), LIBERO_META,
                                        emit_language_latents=True, **LIBERO_KW)
    np.testing.assert_array_equal(got.val_mask, want.val_mask)
    _same_items(got, want, len(want), skip=("language",))
    val_j, val_p = want.get_validation_dataset(), got.get_validation_dataset()
    _same_items(val_p, val_j, len(val_j), skip=("language",))
    np.testing.assert_array_equal(got.episode_latents, want.episode_latents)
    for i in (0, len(got) - 1):
        np.testing.assert_array_equal(got[i]["language_latents"], want[i]["language_latents"])
    _same_normalizer(got.get_normalizer(), want.get_normalizer())
    # the language rows: the port's stable ids, JAX's masks
    prompts = [plib.prompt_from_filename(f) for f in plib.task_stores(str(stores / f"libero_{fmt}"))]
    assert prompts == [jlib.prompt_from_filename(f + ".hdf5") for f in sorted(LIBERO_FILES)]
    assert "turn on the light switch" in prompts  # the kitchen store's prompt
    ends = got.replay_buffer.episode_ends
    for ep, start in enumerate(np.concatenate([[0], ends[:-1]])):
        rows = got.replay_buffer["language"][start]
        np.testing.assert_array_equal(rows, plib.tokenize_language(prompts[ep // 2], 77))
        np.testing.assert_array_equal(rows[1], want.replay_buffer["language"][start][1])


def test_libero_color_jitter_matches_jax(stores):
    want = jlib.LiberoReplayImageDataset(str(stores / "libero_hdf5"), LIBERO_META, data_aug=True,
                                         **LIBERO_KW)
    got = plib.LiberoReplayImageDataset(str(stores / "libero_npz"), LIBERO_META, data_aug=True,
                                        **LIBERO_KW)
    plain = plib.LiberoReplayImageDataset(str(stores / "libero_npz"), LIBERO_META, **LIBERO_KW)
    moved = 0
    for i in range(0, len(got), 7):
        g, w = got[i]["obs"]["agentview_rgb"], want[i]["obs"]["agentview_rgb"]
        assert g.dtype == w.dtype == np.float32 and g.shape == (16, 3, 16, 16)
        np.testing.assert_allclose(g, w, rtol=0, atol=AUG_ATOL)
        moved += not np.allclose(g, plain[i]["obs"]["agentview_rgb"] / 255.0)
    assert moved > 0
    assert got.get_validation_dataset().transforms is None


def test_filenames_and_tokens():
    for name in LIBERO_FILES + ("STUDY_SCENE1_pick_up_the_book_and_place_it_demo",):
        for ext in (".hdf5", ".npz"):
            assert plib.language_from_filename(name + ext) == jlib.language_from_filename(name + ".hdf5")
            assert plib.prompt_from_filename(name + ext) == jlib.prompt_from_filename(name + ".hdf5")
        assert plib.store_stem(f"/a/b/{name}.npz") == name
    assert plib.prompt_from_filename("kitchen_microwave_demo.npz") == "open the microwave door"
    toks = plib.tokenize_language("put the bowl on the plate", 8)
    assert toks.shape == (2, 8) and toks.dtype == np.int64
    np.testing.assert_array_equal(toks[1], [1, 1, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(toks[1], jlib.tokenize_language("put the bowl on the plate", 8)[1])
    assert toks[0, 1] == toks[0, 4] and (toks[0, :6] >= 1).all() and (toks[0, :6] <= 30000).all()
    # the same ids in processes of other hash seeds (C14: JAX's differ)
    code = ("from unified_video_action_tpu_torch.data.libero_dataset import tokenize_language;"
            "print(tokenize_language('put the bowl on the plate', 8)[0].tolist())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONHASHSEED="1", PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(toks[0].tolist())
