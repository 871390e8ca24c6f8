"""The port's replay buffer on the reference's on-disk formats, the UMI
datasets on zarr stores and the store tools, against the JAX package on
the CPU.

- ``ReplayBuffer``: ``save_zarr`` (directory and zip stores, with and
  without a per-key codec) stores the same bytes as JAX's; ``load(...,
  lazy=True)`` of either writer's store reads the same arrays as JAX's,
  lazily; the HDF5 ``save`` writes JAX's datasets, chunks and compression;
  ``get_episode``, ``drop_episode`` and ``_optimal_chunks`` as JAX's.
- UMI: ``tools/gen_synthetic_umi.py`` writes the stores JAX's script
  writes, byte for byte; ``build_umi_multi_from_config`` on them gives the
  same loader batches as JAX's and never reads a whole key.
- The tools: ``convert_zarr_dataset`` (zarr to HDF5, HDF5 to zarr, a zip
  store to ``.npz``), ``merge_demos`` and ``stage_datasets extract``
  (``.zip``, ``.tar``, ``.tar.gz``, ``.tar.lz4``) against the JAX scripts.
"""

import importlib
import io
import json
import os
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401
from unified_video_action_tpu.data import loader as jloader
from unified_video_action_tpu.data import umi_dataset as jumi
from unified_video_action_tpu.data.replay_buffer import ReplayBuffer as JaxBuffer
from unified_video_action_tpu.utils import lz4f as jlz4f
from unified_video_action_tpu_torch.data import loader as ploader
from unified_video_action_tpu_torch.data import umi_dataset as pumi
from unified_video_action_tpu_torch.data import zarrlite as pz
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.tools import convert_zarr_dataset, merge_demos, stage_datasets
from unified_video_action_tpu_torch.tools.gen_synthetic_umi import write_corpus

h5py = pytest.importorskip("h5py")

JPEG = {"camera0_rgb": {"id": "imagecodecs_jpeg2k", "level": 50}}


def _script(name):
    return importlib.import_module(f"scripts.{name}")


def _buffers(n_episodes=3, episode_len=20, seed=4):
    """The same synthetic UMI buffer in both packages."""
    return (pumi.make_synthetic_umi(n_episodes, episode_len, seed=seed, image_size=16),
            jumi.make_synthetic_umi(n_episodes, episode_len, seed=seed, image_size=16))


def _store_bytes(path):
    store = pz.open_store(str(path))
    out = {k: store.get(k) for k in sorted(store.list_prefix(""))}
    store.close()
    return out


def _assert_same_buffer(got, want):
    np.testing.assert_array_equal(got.episode_ends, want.episode_ends)
    assert sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
        np.testing.assert_array_equal(np.asarray(got[k][:]), np.asarray(want[k][:]), err_msg=k)


@pytest.mark.parametrize("compressors", [None, "jpeg2k"])
@pytest.mark.parametrize("suffix", [".zarr", ".zarr.zip"])
def test_save_zarr_and_lazy_load_against_jax(tmp_path, suffix, compressors):
    port, jax_ = _buffers()
    codecs = JPEG if compressors else None
    paths = {"port": str(tmp_path / ("port" + suffix)), "jax": str(tmp_path / ("jax" + suffix))}
    port.save_zarr(paths["port"], compressors=codecs)
    jax_.save_zarr(paths["jax"], compressors=codecs)
    assert _store_bytes(paths["port"]) == _store_bytes(paths["jax"])
    assert ReplayBuffer._is_zarr(paths["port"]) and JaxBuffer._is_zarr(paths["port"])
    want = JaxBuffer.load(paths["jax"])
    for src in paths.values():
        got = ReplayBuffer.load(src, lazy=True)
        assert all(isinstance(got[k], pz.ZarrArray) for k in got.keys())
        _assert_same_buffer(got, want)
        _assert_same_buffer(ReplayBuffer.copy_from_path(src, keys=["robot0_eef_pos"]),
                            JaxBuffer.load(src, keys=["robot0_eef_pos"]))
        _assert_same_buffer(JaxBuffer.load(src, lazy=True), want)
    if not compressors:  # lossless: the buffer itself
        _assert_same_buffer(want, jax_)


def test_hdf5_and_npz_save_against_jax(tmp_path):
    port, jax_ = _buffers()
    port.save(str(tmp_path / "port.h5"))
    jax_.save(str(tmp_path / "jax.h5"))
    with h5py.File(tmp_path / "port.h5", "r") as a, h5py.File(tmp_path / "jax.h5", "r") as b:
        assert sorted(a["data"]) == sorted(b["data"])
        for k in b["data"]:
            for attr in ("shape", "dtype", "chunks", "compression"):
                assert getattr(a["data"][k], attr) == getattr(b["data"][k], attr), (k, attr)
            np.testing.assert_array_equal(a["data"][k][:], b["data"][k][:])
        np.testing.assert_array_equal(a["meta/episode_ends"][:], b["meta/episode_ends"][:])
    _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "jax.h5")), JaxBuffer.load(str(tmp_path / "port.h5")))
    port.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as z:
        assert set(z.files) == {"episode_ends", *port.keys()}
    _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "port.npz")), jax_)


def test_episodes_and_chunks_against_jax(tmp_path):
    port, jax_ = _buffers(n_episodes=4, episode_len=9)
    jax_.save_zarr(str(tmp_path / "s.zarr"))
    lazy = ReplayBuffer.load(str(tmp_path / "s.zarr"), lazy=True)
    for i in range(4):
        want = jax_.get_episode(i)
        for got in (port.get_episode(i), lazy.get_episode(i)):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    for arr in (np.zeros((0, 3)), np.zeros(()), np.zeros((5000, 7), np.float32),
                np.zeros((10, 96, 96, 3), np.uint8), np.zeros((3, 2048, 2048), np.uint8)):
        assert ReplayBuffer._optimal_chunks(arr) == JaxBuffer._optimal_chunks(arr)
    assert ReplayBuffer._optimal_chunks(lazy["camera0_rgb"]) == JaxBuffer._optimal_chunks(
        jax_["camera0_rgb"])
    for buf in (port, jax_, lazy):
        buf.drop_episode()
        buf.drop_episode()
    _assert_same_buffer(port, jax_)
    _assert_same_buffer(lazy, jax_)
    port.drop_episode()
    port.drop_episode()
    assert port.n_episodes == 0 and all(len(port[k]) == 0 for k in port.keys())
    with pytest.raises(ValueError, match="no episode"):
        port.drop_episode()


def test_gen_synthetic_umi_writes_jax_s_stores(tmp_path, monkeypatch, capsys):
    paths = write_corpus(str(tmp_path / "port"), episodes=2, episode_len=25, image_size=16)
    assert sorted(paths) == ["cup", "mouse", "towel"] and all(p.endswith(".zarr") for p in paths.values())
    monkeypatch.setattr(sys, "argv", ["gen_synthetic_umi.py", "--root", str(tmp_path / "jax"),
                                      "--episodes", "2", "--episode-len", "25", "--image-size", "16"])
    _script("gen_synthetic_umi").main()
    for name, path in paths.items():
        assert _store_bytes(path) == _store_bytes(tmp_path / "jax" / f"{name}.zarr"), name
    # a compressors argument and another store, as save_zarr takes them
    codecs = {k: {"id": "zlib", "level": 1} for k in jumi.make_synthetic_umi(1, 2).keys()}
    zipped = write_corpus(str(tmp_path / "zlib"), 2, 25, 16, compressors=codecs,
                          suffixes={"mouse": ".zarr.zip"})
    assert zipped["mouse"].endswith(".zarr.zip") and zipfile.is_zipfile(zipped["mouse"])
    want = jumi.make_synthetic_umi(2, 25, seed=102, image_size=16)
    want.save_zarr(str(tmp_path / "want.zarr.zip"), compressors=codecs)
    assert _store_bytes(zipped["mouse"]) == _store_bytes(tmp_path / "want.zarr.zip")


def test_umi_multi_on_zarr_stores_same_batches_as_jax(tmp_path, monkeypatch):
    """The same stores through both `build_umi_multi_from_config`: the same items and loader
    batches; the port reads them lazily and never a whole key."""
    paths = write_corpus(str(tmp_path), episodes=3, episode_len=30, image_size=24,
                         suffixes={"towel": ".zarr.zip"})
    cfg = {name: {"path": path, "mask_mirror": False, "prompt": f"do {name}"}
           for name, path in paths.items()}
    got = pumi.build_umi_multi_from_config(cfg, val_ratio=0.34, random_img_sampling=True,
                                           normalizer_type="none")
    want = jumi.build_umi_multi_from_config(cfg, val_ratio=0.34, random_img_sampling=True)
    for ds in got.datasets.values():
        assert all(isinstance(ds.replay_buffer[k], pz.ZarrArray) for k in ds.replay_buffer.keys())

    def whole_key(self, *args, **kwargs):
        raise AssertionError(f"{self.path} read whole")

    monkeypatch.setattr(pz.ZarrArray, "__array__", whole_key)
    kw = dict(batch_size=4, shuffle=True, seed=5, num_workers=2, worker_mode="thread")
    for g, w in ((got, want), (got.split_val(), want.split_val())):
        assert len(g) == len(w) > 0
        n = 0
        for a, b in zip(ploader.DataLoader(g, **kw), jloader.DataLoader(w, **kw)):
            assert list(a.pop("dataset_name")) == list(b.pop("dataset_name"))
            flat = lambda t, p="": [x for k, v in sorted(t.items()) for x in (
                flat(v, p + k + "/") if isinstance(v, dict) else [(p + k, v)])]
            for (ka, va), (kb, vb) in zip(flat(a), flat(b), strict=True):
                assert ka == kb
                np.testing.assert_array_equal(va, vb, err_msg=ka)
            n += 1
        assert n > 0
    cam = got.datasets["cup"].replay_buffer["camera0_rgb"]
    assert 0 < cam.cache_peak_bytes <= pz.CACHE_BYTES
    eager = pumi.build_umi_multi_from_config({k: dict(v, lazy=False) for k, v in cfg.items()})
    assert isinstance(eager.datasets["cup"].replay_buffer["camera0_rgb"], np.ndarray)


def test_convert_zarr_dataset_against_jax(tmp_path):
    port, _ = _buffers()
    port.save_zarr(str(tmp_path / "src.zarr"))
    script = _script("convert_zarr_dataset")
    convert_zarr_dataset.main([str(tmp_path / "src.zarr"), str(tmp_path / "port.h5")])
    script.main([str(tmp_path / "src.zarr"), str(tmp_path / "jax.h5")])
    _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "port.h5")),
                        JaxBuffer.load(str(tmp_path / "jax.h5")))
    convert_zarr_dataset.main([str(tmp_path / "jax.h5"), str(tmp_path / "port.zarr"),
                               "--keys", "robot0_eef_pos", "camera0_rgb"])
    script.main([str(tmp_path / "jax.h5"), str(tmp_path / "jax.zarr"),
                 "--keys", "robot0_eef_pos", "camera0_rgb"])
    assert _store_bytes(tmp_path / "port.zarr") == _store_bytes(tmp_path / "jax.zarr")
    convert_zarr_dataset.main([str(tmp_path / "src.zarr"), str(tmp_path / "s.zarr.zip")])
    convert_zarr_dataset.main([str(tmp_path / "s.zarr.zip"), str(tmp_path / "s.npz")])
    _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "s.npz")),
                        JaxBuffer.load(str(tmp_path / "src.zarr")))


def test_merge_demos_against_jax(tmp_path, monkeypatch):
    inputs = []
    for i in range(2):
        buf = pumi.make_synthetic_umi(2 + i, 12, seed=20 + i, image_size=8)
        inputs.append(str(tmp_path / f"in{i}.h5"))
        buf.save(inputs[-1])
    missing = str(tmp_path / "absent.h5")
    merge_demos.main([*inputs, missing, "--out", str(tmp_path / "port" / "merged.h5")])
    os.makedirs(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["merge_demos.py", *inputs, missing,
                                      "--out", str(tmp_path / "jax" / "merged.h5")])
    _script("merge_demos").main()
    _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "port" / "merged.h5")),
                        JaxBuffer.load(str(tmp_path / "jax" / "merged.h5")))
    metas = [json.loads((tmp_path / d / "merged_meta.json").read_text()) for d in ("port", "jax")]
    assert metas[0] == metas[1] and metas[0]["episodes"] == 5
    assert sorted(os.listdir(tmp_path / "port")) == ["merged.h5", "merged_meta.json"]
    # an npz and a zarr store out: the same episodes
    for out in ("m.npz", "m.zarr"):
        merge_demos.merge(inputs, str(tmp_path / out))
        _assert_same_buffer(ReplayBuffer.load(str(tmp_path / out)),
                            JaxBuffer.load(str(tmp_path / "jax" / "merged.h5")))


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_stage_datasets_extract_against_jax(tmp_path):
    from scripts.stage_datasets import extract_one as jax_extract

    src = tmp_path / "src"
    pumi.make_synthetic_umi(2, 10, seed=1, image_size=8).save_zarr(str(src / "umi.zarr"))
    raw = tmp_path / "raw"
    os.makedirs(raw)
    with zipfile.ZipFile(raw / "a.zarr.zip", "w") as z:
        for p, data in _tree(src).items():
            z.writestr(os.path.join("zipped", p), data)
    for name, mode in (("b.tar", "w"), ("c.tar.gz", "w:gz")):
        with tarfile.open(raw / name, mode) as t:
            t.add(src / "umi.zarr", arcname=name.split(".")[0] + ".zarr")
    tar = io.BytesIO()
    with tarfile.open(fileobj=tar, mode="w") as t:
        t.add(src / "umi.zarr", arcname="d.zarr")
    (raw / "d.zarr.tar.lz4").write_bytes(jlz4f.compress(tar.getvalue()))
    (raw / "notes.txt").write_text("not an archive")
    lines = stage_datasets.extract_all(str(raw), str(tmp_path / "port"), jobs=2)
    assert [line.endswith("(skipped: unknown format)") for line in lines] == [False] * 4 + [True]
    for p in sorted(os.listdir(raw)):
        jax_extract(str(raw / p), str(tmp_path / "jax"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for name in ("b", "c", "d"):
        _assert_same_buffer(ReplayBuffer.load(str(tmp_path / "port" / f"{name}.zarr"), lazy=True),
                            JaxBuffer.load(str(src / "umi.zarr")))
    stage_datasets.main(["extract", str(raw), "--out", str(tmp_path / "cli"), "--jobs", "1"])
    assert _tree(tmp_path / "cli") == _tree(tmp_path / "port")
