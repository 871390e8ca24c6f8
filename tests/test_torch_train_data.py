"""The port's training data path against the JAX package on the CPU: the
frame selection and the action split, the device-side augmentation, the
sampler's windows and validation masks, the normalizer's fit and its npz,
the synthetic PushT buffer (rolled out in the port's env against the JAX
env: bit-equal states and actions, frames within ``tests/test_torch_env.py``'s
bound), the window table and the device
gather against ``SequenceSampler.sample_sequence``.

Tolerances: integer and uint8 data bit-equal; fp32 statistics and the
augmentation FP32_TOL (the same arithmetic in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL
from unified_video_action_tpu.data import device_dataset as jdd
from unified_video_action_tpu.data import normalizer as jn
from unified_video_action_tpu.data import pusht_dataset as jpd
from unified_video_action_tpu.data import sampler as js
from unified_video_action_tpu.utils import frames as jf
from unified_video_action_tpu.utils import image as ji
from unified_video_action_tpu_torch.data import device_dataset as pdd
from unified_video_action_tpu_torch.data import normalizer as pn
from unified_video_action_tpu_torch.data import pusht_dataset as ppd
from unified_video_action_tpu_torch.data import sampler as ps
from unified_video_action_tpu_torch.utils import frames as pf
from unified_video_action_tpu_torch.utils import image as pi

SYNTH = dict(n_episodes=3, max_steps=40, seed=5)


@pytest.mark.parametrize("total, eval_", [(32, False), (16, True), (32, True), (64, False)])
def test_select_frame_indices_match_jax(total, eval_):
    got = pf.select_frame_indices(total, eval=eval_)
    np.testing.assert_array_equal(got, jf.select_frame_indices(total, eval=eval_))
    assert got.max() < total


@pytest.mark.parametrize("shift, history", [(True, False), (False, False), (True, True),
                                            (False, True)])
def test_split_trajectory_matches_jax(shift, history):
    actions = np.random.default_rng(0).standard_normal((2, 32, 2)).astype(np.float32)
    want = jf.split_trajectory(actions, 32, shift, history)
    got = pf.split_trajectory(torch.from_numpy(actions), 32, shift, history)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert history or got[1].shape[1] == 16  # the action head's 16-step chunk


@pytest.mark.parametrize("size", [96, 32])
def test_augment_video_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.uniform(0, 1, (3, 4, 3, size, size)).astype(np.float32)
    m_h, m_w = pi.aug_margins(size, size)
    assert (m_h, m_w) == ji.aug_margins(size, size)
    top = rng.integers(0, m_h, 3).astype(np.int32)
    left = rng.integers(0, m_w, 3).astype(np.int32)
    sigma = rng.uniform(0.1, 2.0, 3).astype(np.float32)
    want = ji.augment_video(jnp.asarray(x), jnp.asarray(top), jnp.asarray(left), jnp.asarray(sigma))
    got = pi.augment_video(torch.tensor(x), torch.tensor(top), torch.tensor(left), torch.tensor(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_to_unit_float_matches_jax():
    x = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(pi.to_unit_float(torch.tensor(x)).numpy(),
                                  np.asarray(ji.to_unit_float(jnp.asarray(x))))
    f = torch.rand(3)
    assert pi.to_unit_float(f) is f


@pytest.mark.parametrize("pads", [(0, 0), (1, 7), (40, 40)])
def test_sampler_windows_match_jax(pads):
    ends = np.array([20, 45, 53, 90])
    mask = np.array([True, False, True, True])
    for L in (8, 32):
        np.testing.assert_array_equal(
            ps.create_indices(ends, L, mask, *pads), js.create_indices(ends, L, mask, *pads))


@pytest.mark.parametrize("n, ratio, max_n", [(6, 0.02, None), (50, 0.1, 20), (3, 0.5, 1), (4, 0.0, None)])
def test_val_and_downsample_masks_match_jax(n, ratio, max_n):
    val = ps.get_val_mask(n, ratio, seed=42)
    np.testing.assert_array_equal(val, js.get_val_mask(n, ratio, seed=42))
    np.testing.assert_array_equal(ps.downsample_mask(~val, max_n, seed=42),
                                  js.downsample_mask(~val, max_n, seed=42))


@pytest.mark.parametrize("last_n_dims", [1, 2])
def test_normalizer_fit_matches_jax(last_n_dims, tmp_path):
    rng = np.random.default_rng(1)
    # a constant channel takes the range_eps branch
    data = {"action": rng.uniform(-50, 500, (300, 2)).astype(np.float32),
            "agent_pos": np.concatenate([rng.normal(0, 3, (300, 1)), np.full((300, 1), 7.0)],
                                        axis=1).astype(np.float32)}
    want, got = jn.LinearNormalizer(), pn.LinearNormalizer()
    want.fit(data, last_n_dims=last_n_dims, mode="limits")
    got.fit(data, last_n_dims=last_n_dims)
    flat_want, flat_got = want.to_flat_dict(), got.to_flat_dict()
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], flat_want[k], **FP32_TOL, err_msg=k)
    got.save(str(tmp_path / "n.npz"))
    back = jn.LinearNormalizer.load(str(tmp_path / "n.npz"))
    x = data["action"]
    np.testing.assert_allclose(back["action"].normalize(x),
                               got["action"].normalize(torch.tensor(x)).numpy(), **FP32_TOL)


@pytest.fixture(scope="module")
def synthetic():
    return jpd.make_synthetic_pusht(**SYNTH), ppd.make_synthetic_pusht(**SYNTH)


def test_synthetic_pusht_matches_jax(synthetic):
    want, got = synthetic
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert set(got.keys()) == {"img", "state", "action"}
    for k in ("state", "action"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["img"].shape == want["img"].shape and got["img"].dtype == np.uint8
    # the port draws with envs/raster.py, JAX with OpenCV: tests/test_torch_env.py's
    # bound on every frame (measured here: 6 of 3.3 M values differ)
    d = np.abs(got["img"].astype(np.int32) - want["img"].astype(np.int32))
    frames = d.reshape(len(d), -1)
    assert (frames > 0).mean(axis=1).max() <= 0.005 and frames.mean(axis=1).max() <= 1.0


@pytest.fixture(scope="module")
def buffer_path(synthetic, tmp_path_factory):
    """The synthetic buffer as an HDF5 file, which both datasets read."""
    path = str(tmp_path_factory.mktemp("buffer") / "pusht.h5")
    synthetic[0].save(path)
    return path


def _datasets(buffer_path, **kw):
    """The JAX and the port's PushTImageDataset over the same file."""
    args = dict(horizon=32, pad_before=1, pad_after=7, seed=5, val_ratio=0.3, **kw)
    return jpd.PushTImageDataset(buffer_path, **args), ppd.PushTImageDataset(buffer_path, **args)


def test_dataset_normalizer_and_windows_match_jax(buffer_path):
    jds, pds = _datasets(buffer_path)
    np.testing.assert_array_equal(pds.val_mask, jds.val_mask)
    np.testing.assert_array_equal(pds.sampler.indices, jds.sampler.indices)
    want, got = jds.get_normalizer().to_flat_dict(), pds.get_normalizer().to_flat_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **FP32_TOL, err_msg=k)
    for idx in (0, len(pds) // 2, len(pds) - 1):
        w, g = jds.sampler.sample_sequence(idx), pds.sampler.sample_sequence(idx)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_window_table_matches_jax(buffer_path):
    jds, pds = _datasets(buffer_path)
    np.testing.assert_array_equal(pdd.window_index_table(pds.sampler),
                                  jdd.window_index_table(jds.sampler))


@pytest.mark.parametrize("aug", [False, True])
def test_device_gather_matches_sample_sequence(buffer_path, aug):
    _, pds = _datasets(buffer_path, data_aug=aug)
    store = pdd.DeviceReplayDataset(pds, "cpu")
    assert len(store) == len(pds.sampler) and store.data_aug == aug
    idxs = np.array([0, 3, len(store) // 2, len(store) - 1])
    frames = pf.select_frame_indices(32, eval=False)
    draws = {"aug_top": np.array([0, 1, 2, 3], np.int32), "aug_left": np.array([3, 2, 1, 0], np.int32),
             "aug_sigma": np.array([0.5, 1.0, 1.5, 2.0], np.float32)}
    batch = store.gather(idxs, frames, draws if aug else None)
    for row, idx in enumerate(idxs):
        want = pds.sampler.sample_sequence(int(idx))
        np.testing.assert_array_equal(batch["obs"]["image"][row].numpy(),
                                      np.moveaxis(want["img"][frames], -1, 1))
        np.testing.assert_array_equal(batch["action"][row].numpy(), want["action"])
        np.testing.assert_array_equal(batch["obs"]["agent_pos"][row].numpy(), want["state"][:, :2])
    assert ("aug_top" in batch["obs"]) == aug
    if aug:
        np.testing.assert_array_equal(batch["obs"]["aug_sigma"].numpy(), draws["aug_sigma"])


def test_unported_sources_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="host"):
        ppd.PushTImageDataset(synthetic=1, data_aug=True, device_aug=False)
    with pytest.raises(FileNotFoundError):
        ppd.PushTImageDataset(str(tmp_path / "absent.h5"))
    with pytest.raises(NotImplementedError, match="2-d"):
        ppd.PushTImageDataset(synthetic=1, agent_pos_dim=14)
