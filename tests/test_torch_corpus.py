"""The port's corpus on the card: ``tools/export_corpus.py``'s numpy copy of
an HDF5 replay buffer, the ``.npz`` branch of ``ReplayBuffer.load``, and the
validation split with its device-resident store, against the JAX package on
the CPU.

- ``export_corpus`` of a small zstd-compressed HDF5 buffer written by JAX's
  ``ReplayBuffer.save`` gives arrays and ``episode_ends`` equal to JAX's
  ``ReplayBuffer.load`` of the same HDF5.
- The committed ``corpora/pusht_demos_r5b.npz`` holds the 300 episodes and
  74,256 steps of ``data_release/pusht_demos_r5b.h5.zst``: ``state``,
  ``action`` and ``episode_ends`` equal, and ``img`` equal too, compared in
  chunks of 3,000 frames streamed from the archive (peak memory about
  0.5 GB, about 8 s).
- ``get_validation_dataset``: the windows of JAX's validation dataset, no
  augmentation; the store's ``split`` shares the frames and gathers the
  validation windows as ``sample_sequence`` gives them.

Everything compared is integer or copied data: bit-equal.
"""

import importlib.util
import io
import os
import zipfile

import numpy as np
import pytest

from unified_video_action_tpu.data import pusht_dataset as jpd
from unified_video_action_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from unified_video_action_tpu_torch.data import device_dataset as pdd
from unified_video_action_tpu_torch.data import pusht_dataset as ppd
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_NPZ = os.path.join(REPO, "corpora", "pusht_demos_r5b.npz")
CORPUS_ZST = os.path.join(REPO, "data_release", "pusht_demos_r5b.h5.zst")
CHUNK = 3000  # frames compared at a time


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_corpus", os.path.join(REPO, "unified_video_action_tpu_torch", "tools", "export_corpus.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def small_buffer(tmp_path_factory):
    """A 4-episode buffer saved by JAX's ReplayBuffer as HDF5 and as .h5.zst."""
    import zstandard

    rng = np.random.default_rng(3)
    buf = JaxReplayBuffer()
    for n in (40, 33, 51, 37):
        buf.add_episode({"img": rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8),
                         "state": rng.standard_normal((n, 5)).astype(np.float32),
                         "action": rng.uniform(0, 512, (n, 2)).astype(np.float32)})
    root = tmp_path_factory.mktemp("corpus")
    h5 = str(root / "small.h5")
    buf.save(h5)
    zst = h5 + ".zst"
    with open(h5, "rb") as src, open(zst, "wb") as dst:
        zstandard.ZstdCompressor().copy_stream(src, dst)
    return h5, zst, root


def test_export_corpus_equals_jax_load(small_buffer):
    h5, zst, root = small_buffer
    out = str(root / "small.npz")
    info = _export_tool().export_corpus(zst, out)
    want = JaxReplayBuffer.load(h5, keys=["img", "state", "action"])
    got = ReplayBuffer.load(out)
    assert info["episodes"] == want.n_episodes == got.n_episodes == 4
    assert info["steps"] == want.n_steps == got.n_steps
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert set(got.keys()) == set(want.keys()) == {"img", "state", "action"}
    for k in want.keys():
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a key subset, as PushTImageDataset asks for it
    assert set(ReplayBuffer.load(out, keys=["img", "action"]).keys()) == {"img", "action"}


def _npz_member(z: zipfile.ZipFile, name: str):
    """An open stream of ``name``'s array data in the archive, its shape and
    dtype (numpy's .npy header read by hand, so the array is never whole in
    memory)."""
    m = z.open(name + ".npy")
    version = np.lib.format.read_magic(m)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(m)
    assert not fortran
    return m, shape, dtype


def test_committed_corpus_equals_the_zst_corpus():
    import h5py
    import zstandard

    with open(CORPUS_ZST, "rb") as f:
        raw = zstandard.ZstdDecompressor().stream_reader(f).read()
    with h5py.File(io.BytesIO(raw), "r") as f, zipfile.ZipFile(CORPUS_NPZ) as z:
        assert sorted(z.namelist()) == ["action.npy", "episode_ends.npy", "img.npy", "state.npy"]
        ends = f["meta"]["episode_ends"][:]
        assert len(ends) == 300 and int(ends[-1]) == 74256
        for key, want in (("state", f["data"]["state"][:]), ("action", f["data"]["action"][:]),
                          ("episode_ends", ends)):
            with z.open(key + ".npy") as m:
                got = np.lib.format.read_array(m)
            assert got.dtype == want.dtype or key == "episode_ends"
            np.testing.assert_array_equal(got, want, err_msg=key)
        m, shape, dtype = _npz_member(z, "img")
        assert shape == (74256, 96, 96, 3) and dtype == np.uint8
        frame = int(np.prod(shape[1:]))
        img = f["data"]["img"]
        with m:
            for start in range(0, shape[0], CHUNK):
                n = min(CHUNK, shape[0] - start)
                got = np.frombuffer(m.read(n * frame), dtype=np.uint8).reshape((n,) + shape[1:])
                want = img[start:start + n]
                if not np.array_equal(got, want):  # the quick check; the slow one reports
                    np.testing.assert_array_equal(got, want, err_msg=f"img[{start}:]")


def test_validation_split_matches_jax(small_buffer):
    h5, _, _ = small_buffer
    args = dict(horizon=16, pad_before=1, pad_after=7, seed=5, val_ratio=0.5, data_aug=True)
    jds, pds = jpd.PushTImageDataset(h5, **args), ppd.PushTImageDataset(h5, **args)
    jval, pval = jds.get_validation_dataset(), pds.get_validation_dataset()
    np.testing.assert_array_equal(pval.sampler.indices, jval.sampler.indices)
    np.testing.assert_array_equal(pval.train_mask, jval.train_mask)
    assert not pval.data_aug and not jval.data_aug and pds.data_aug
    assert pval.replay_buffer is pds.replay_buffer
    # disjoint from the training windows, and the whole validation episodes
    assert pds.val_mask.sum() == 2 and not (pds.val_mask & pds.train_mask).any()

    store = pdd.DeviceReplayDataset(pds, "cpu")
    val = store.split(pval)
    assert val.img is store.img and len(val) == len(pval.sampler) > 0 and not val.data_aug
    idxs = np.array([0, len(val) // 2, len(val) - 1])
    batch = val.gather(idxs)
    for row, idx in enumerate(idxs):
        want = jval.sampler.sample_sequence(int(idx))
        np.testing.assert_array_equal(batch["obs"]["image"][row].numpy(), np.moveaxis(want["img"], -1, 1))
        np.testing.assert_array_equal(batch["action"][row].numpy(), want["action"])
