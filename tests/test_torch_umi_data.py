"""The UMI data path of the port against the JAX package on the CPU, bit for
bit (numpy on both sides):

- the rotation and pose maths (``utils/rotation.py``, ``utils/pose.py``) on
  seeded inputs, every public function;
- ``select_frame_indices`` with the random history frequency under the
  same numpy generator, and ``HISTORY_COMBINATIONS``;
- ``main_image_key`` for umi and robomimic;
- ``make_synthetic_umi``, array for array, and its ``.npz`` round trip;
- ``draw_mirror_mask`` against JAX's cv2 branch (skipped where cv2 is
  absent);
- ``UmiLazyDataset`` and ``UmiMultiDataset`` items over several indices,
  epochs, both splits, ``random_img_sampling`` and ``mask_mirror``, with
  the language latents of the hash encoder, and ``build_umi_multi_from_config``;
- the host ``DataLoader``'s batches (thread and process workers, shuffled by
  seed and epoch, the string field kept).
"""

import numpy as np
import pytest

from unified_video_action_tpu.data import loader as jloader
from unified_video_action_tpu.data import umi_dataset as jumi
from unified_video_action_tpu.utils import frames as jframes
from unified_video_action_tpu.utils import image as jimage
from unified_video_action_tpu.utils import pose as jpose
from unified_video_action_tpu.utils import rotation as jrot
from unified_video_action_tpu_torch.data import loader as ploader
from unified_video_action_tpu_torch.data import umi_dataset as pumi
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.utils import frames as pframes
from unified_video_action_tpu_torch.utils import image as pimage
from unified_video_action_tpu_torch.utils import pose as ppose
from unified_video_action_tpu_torch.utils import rotation as prot


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_rotation_and_pose_maths_bit_equal():
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(7, 3))
    q = rng.normal(size=(7, 4))
    R = jrot.axis_angle_to_matrix(aa)
    d6 = rng.normal(size=(7, 6))
    pose = rng.normal(size=(7, 6))
    mats = jpose.pose_to_mat(pose)
    calls = [("axis_angle_to_matrix", aa), ("matrix_to_axis_angle", R),
             ("axis_angle_to_quaternion", aa), ("quaternion_to_axis_angle", q),
             ("quaternion_to_matrix", q), ("matrix_to_quaternion", R),
             ("matrix_to_rotation_6d", R), ("rotation_6d_to_matrix", d6)]
    for name, x in calls:
        np.testing.assert_array_equal(getattr(prot, name)(x), getattr(jrot, name)(x), err_msg=name)
    for conv in ("XYZ", "ZYX"):
        np.testing.assert_array_equal(prot.euler_to_matrix(aa, conv), jrot.euler_to_matrix(aa, conv))
        np.testing.assert_array_equal(prot.matrix_to_euler(R, conv), jrot.matrix_to_euler(R, conv))
    for name, x in [("pose_to_mat", pose), ("mat_to_pose", mats), ("mat_to_pose10d", mats),
                    ("pose10d_to_mat", rng.normal(size=(7, 9))), ("mat_inverse", mats)]:
        np.testing.assert_array_equal(getattr(ppose, name)(x), getattr(jpose, name)(x), err_msg=name)
    np.testing.assert_array_equal(ppose.compute_relative_pose(mats, mats[2]),
                                  jpose.compute_relative_pose(mats, mats[2]))
    for rep in ("relative", "abs", "delta"):
        np.testing.assert_array_equal(ppose.convert_pose_mat_rep(mats, mats[3], rep),
                                      jpose.convert_pose_mat_rep(mats, mats[3], rep), err_msg=rep)


@pytest.mark.parametrize("total", [8, 16, 32])
def test_history_frequency_draws_as_jax(total):
    np.testing.assert_array_equal(pframes.HISTORY_COMBINATIONS, jframes.HISTORY_COMBINATIONS)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        got = pframes.select_frame_indices(total, eval=False, different_history_freq=True, rng=a)
        want = jframes.select_frame_indices(total, eval=False, different_history_freq=True, rng=b)
        np.testing.assert_array_equal(got, want)
    assert a.integers(1 << 30) == b.integers(1 << 30)  # the same draws taken
    np.testing.assert_array_equal(pframes.select_frame_indices(total, eval=False),
                                  jframes.select_frame_indices(total, eval=False))
    with pytest.raises(ValueError, match="rng"):
        pframes.select_frame_indices(total, eval=False, different_history_freq=True)


def test_main_image_key():
    for task, obs in [("umi", {"camera0_rgb": 0}), ("toolhang", {"sideview_image": 0,
                                                                "robot0_eye_in_hand_image": 0}),
                      ("pusht", {"image": 0}), ("kitchen", {"agentview_rgb": 0})]:
        assert pimage.main_image_key(task, obs) == jimage.main_image_key(task, obs)
        assert_tree_equal(pimage.remap_image_keys(task, obs), jimage.remap_image_keys(task, obs))


def test_synthetic_corpus_bit_equal_and_npz_round_trip(tmp_path):
    got = pumi.make_synthetic_umi(3, 30, seed=101, image_size=24)
    want = jumi.make_synthetic_umi(3, 30, seed=101, image_size=24)
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert_tree_equal(dict(got.data), dict(want.data))
    got.save(str(tmp_path / "towel.npz"))
    back = ReplayBuffer.load(str(tmp_path / "towel.npz"))
    np.testing.assert_array_equal(back.episode_ends, want.episode_ends)
    assert_tree_equal(dict(back.data), dict(want.data))
    assert "robot0_demo_start_pose" in back and "absent" not in back


@pytest.mark.parametrize("hw", [(224, 224), (64, 48), (31, 57)])
def test_mirror_mask_equals_cv2(hw):
    pytest.importorskip("cv2")
    img = np.random.default_rng(1).integers(1, 255, (*hw, 3), dtype=np.uint8)
    got = pumi.draw_mirror_mask(img)
    np.testing.assert_array_equal(got, jumi.draw_mirror_mask(img))
    assert (got == 0).all(axis=-1).sum() > 0 and (img != 0).all()


def _pair(random_img_sampling, mask_mirror, split="train"):
    kw = dict(val_ratio=0.34, seed=7, random_img_sampling=random_img_sampling,
              mask_mirror=mask_mirror, split=split)
    return (pumi.UmiLazyDataset(pumi.make_synthetic_umi(3, 40, seed=5, image_size=24), **kw),
            jumi.UmiLazyDataset(jumi.make_synthetic_umi(3, 40, seed=5, image_size=24), **kw))


@pytest.mark.parametrize("random_img_sampling,mask_mirror", [(False, False), (True, True)])
def test_lazy_dataset_items_bit_equal(random_img_sampling, mask_mirror):
    if mask_mirror:
        pytest.importorskip("cv2")  # JAX's mirror mask takes the cv2 branch
    for split in ("train", "val"):
        got, want = _pair(random_img_sampling, mask_mirror, split)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.index_pool, want.index_pool)
        for epoch in (0, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for idx in (0, 1, len(want) // 2, len(want) - 1):
                assert_tree_equal(got[idx], want[idx], f"{split} epoch {epoch} item {idx}")


def test_multi_dataset_items_and_config_builder(tmp_path):
    cfg_p, cfg_j = {}, {}
    for i, name in enumerate(("cup", "towel")):
        pumi.make_synthetic_umi(3, 40, seed=10 + i, image_size=24).save(str(tmp_path / f"{name}.npz"))
        spec = {"mask_mirror": False, "prompt": f"do {name}"}
        cfg_p[name] = dict(spec, path=str(tmp_path / f"{name}.npz"))
        cfg_j[name] = spec
    jds = {name: jumi.UmiLazyDataset(jumi.make_synthetic_umi(3, 40, seed=10 + i, image_size=24),
                                     name=name, val_ratio=0.34, seed=42, random_img_sampling=True)
           for i, name in enumerate(cfg_j)}
    want = jumi.UmiMultiDataset(jds, {n: s["prompt"] for n, s in cfg_j.items()})
    got = pumi.build_umi_multi_from_config(cfg_p, val_ratio=0.34, random_img_sampling=True,
                                           normalizer_type="none")
    for g, w in ((got, want), (got.split_val(), want.split_val())):
        assert len(g) == len(w) > 0
        g.set_epoch(2)
        w.set_epoch(2)
        for idx in (0, len(w) // 2, len(w) - 1):
            item = g[idx]
            assert item["language_latents"].shape == (512,)
            assert_tree_equal(item, w[idx], f"item {idx}")
    np.testing.assert_array_equal(got.get_normalizer()["action"].scale,
                                  want.get_normalizer()["action"].scale)


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_batches_equal_jax(worker_mode):
    got_ds, want_ds = _pair(True, False)
    kw = dict(batch_size=3, shuffle=True, seed=4, num_workers=2, worker_mode=worker_mode)
    got_l, want_l = ploader.DataLoader(got_ds, **kw), jloader.DataLoader(want_ds, **kw)
    assert len(got_l) == len(want_l) > 1
    # two epochs with threads (the shuffle and the items' draws move on), one
    # with spawned processes (each epoch starts its workers anew)
    for _ in range(2 if worker_mode == "thread" else 1):
        n = 0
        for got, want in zip(got_l, want_l):
            assert list(got["dataset_name"]) == list(want["dataset_name"]) == ["umi"] * 3
            assert_tree_equal({k: v for k, v in got.items() if k != "dataset_name"},
                              {k: v for k, v in want.items() if k != "dataset_name"})
            n += 1
        assert n == len(want_l)
    with pytest.raises(ValueError, match="worker_mode"):
        ploader.DataLoader(got_ds, 2, worker_mode="fiber")
