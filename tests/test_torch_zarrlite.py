"""The port's zarr v2 reader and writer (``data/zarrlite.py``) and its LZ4
frame binding (``utils/lz4f.py``) against the JAX package's, on the CPU.

- Every codec id (blosc, zstd, zlib, gzip, bz2, lzma, the reference's
  ``imagecodecs_jpeg2k`` and the ``imagecodecs_*`` aliases) in every store
  (memory, directory, zip): JAX writes and the port reads, the port writes
  and JAX reads, both bit-equal; the two writers store the same bytes under
  the same keys.
- int, slice (stepped either way), Ellipsis and integer-array indexing on
  axis 0 against JAX and numpy; ``resize``, ``append``, attrs and nested
  groups, the stores' bytes equal to JAX's after each.
- The chunk cache is bounded in bytes and in chunks; a codec whose library
  is absent raises naming it (libblosc, libzstd, liblz4, Pillow).
- The bounded-memory conversion: a ~160 MB store converted lazily in a
  subprocess that imports only the port's ``data/`` modules, under a 500 MB
  address-space cap, passes with the byte bound, and its control (a cache
  of 64 chunks whatever their size, as JAX's) exceeds the cap.
- LZ4 frames round-trip between the two bindings both ways.
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests import _torch_threads  # noqa: F401
from unified_video_action_tpu.data import zarrlite as jz
from unified_video_action_tpu.utils import lz4f as jlz4f
from unified_video_action_tpu_torch.data import zarrlite as pz
from unified_video_action_tpu_torch.utils import lz4f as plz4f

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODECS = {
    "blosc": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0},
    "zstd": {"id": "zstd", "level": 3},
    "zlib": {"id": "zlib", "level": 1},
    "gzip": {"id": "gzip", "level": 5},
    "bz2": {"id": "bz2", "level": 9},
    "lzma": {"id": "lzma"},
    "imagecodecs_jpeg2k": {"id": "imagecodecs_jpeg2k", "level": 50},
    "imagecodecs_blosc": {"id": "imagecodecs_blosc", "cname": "zstd", "clevel": 3, "shuffle": 2},
    "imagecodecs_zlib": {"id": "imagecodecs_zlib", "level": 6},
    "imagecodecs_zstd": {"id": "imagecodecs_zstd", "level": 1},
}
STORES = ("memory", "directory", "zip")


def _group(mod, kind, root, mode):
    """A root group of ``mod``'s zarrlite in a store of ``kind`` at ``root``
    (a memory store is handed over as a dict of its bytes)."""
    if kind == "memory":
        store = mod.MemoryStore()
        store._d.update(root if isinstance(root, dict) else {})
        return mod.open_group(store, mode=mode)
    path = str(root) + (".zarr.zip" if kind == "zip" else ".zarr")
    return mod.open_group(path, mode=mode)


def _contents(store):
    return {k: store.get(k) for k in sorted(store.list_prefix(""))}


def _data(codec):
    rng = np.random.default_rng(0)
    if codec == "imagecodecs_jpeg2k":
        smooth = np.linspace(0, 200, 24)[None, :, None, None] + np.linspace(0, 50, 20)[None, None, :, None]
        frames = smooth + rng.integers(0, 30, (5, 24, 20, 3))
        return {"img": frames.astype(np.uint8)}, {"img": (1, 24, 20, 3)}
    return ({"img": rng.integers(0, 255, (7, 6, 5, 3), dtype=np.uint8),
             "state": rng.standard_normal((11, 4)).astype(np.float32),
             "ends": np.arange(3, 12, 4, dtype=np.int64)},
            {"img": (2, 6, 5, 3), "state": (4, 4), "ends": (2,)})


def _write(mod, kind, root, codec):
    arrays, chunks = _data(codec)
    g = _group(mod, kind, root, "w" if kind == "zip" else "a")
    sub = g.require_group("data").require_group("nested")
    for k, v in arrays.items():
        sub.create_dataset(k, data=v, chunks=chunks[k], compressor=dict(CODECS[codec]))
    sub.attrs.update({"fps": 10, "name": codec})
    contents = _contents(g.store)
    g.store.close()
    return contents


def _read(mod, kind, root):
    g = _group(mod, kind, root, "r")
    sub = g["data"]["nested"]
    out = {k: sub[k][:] for k in sub.keys()}
    return out, dict(sub.attrs.asdict()), g.keys()


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_jax_writes_port_reads_and_back_bit_equal(tmp_path, codec, store):
    jax_written = _write(jz, store, tmp_path / "jax", codec)
    port_written = _write(pz, store, tmp_path / "port", codec)
    assert port_written.keys() == jax_written.keys()
    for k in jax_written:
        assert port_written[k] == jax_written[k], k  # the same bytes under every key
    src = {"jax": jax_written if store == "memory" else tmp_path / "jax",
           "port": port_written if store == "memory" else tmp_path / "port"}
    want, want_attrs, want_keys = _read(jz, store, src["jax"])
    for writer in ("jax", "port"):
        for reader in (pz, jz):
            got, attrs, keys = _read(reader, store, src[writer])
            assert keys == want_keys == ["data"] and attrs == want_attrs
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{writer} -> {reader.__name__}")
    if codec != "imagecodecs_jpeg2k":  # lossless: the data itself
        for k, v in _data(codec)[0].items():
            np.testing.assert_array_equal(want[k], v)
    else:  # level 50: near the frames, not equal
        frames = _data(codec)[0]["img"].astype(np.float64)
        rmse = np.sqrt(((want["img"] - frames) ** 2).mean())
        assert 0 < rmse < 5


def _both(shape, chunks, dtype=np.int32, seed=1):
    data = np.random.default_rng(seed).integers(-1000, 1000, shape).astype(dtype)
    arrays = []
    for mod in (jz, pz):
        g = mod.open_group(mod.MemoryStore(), mode="w")
        arrays.append(g.create_dataset("x", data=data, chunks=chunks, compressor={"id": "zlib"}))
    return data, arrays


KEYS = [0, -1, 7, np.int64(3), slice(None), slice(2, 9), slice(None, None, 3), slice(8, 1, -2),
        slice(None, None, -1), (slice(1, 5), 2), (Ellipsis, 1), (4, Ellipsis, slice(0, 2)),
        [0, 9, 3, 3], np.array([5, 1]), ([2, 0], slice(1, 3)), (slice(0, 10), -1, 0)]


@pytest.mark.parametrize("chunks", [(3, 2, 3), (4, 5, 3)], ids=["grid", "time_chunked"])
@pytest.mark.parametrize("key", KEYS, ids=[repr(k) for k in KEYS])
def test_indexing_against_jax_and_numpy(key, chunks):
    data, (jarr, parr) = _both((10, 5, 3), chunks)
    got = parr[key]
    want = jarr[key]
    assert got.shape == want.shape == data[key].shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[key])
    if isinstance(key, int):
        with pytest.raises(IndexError):
            parr[10 + abs(key)]


def test_writes_resize_append_attrs_and_groups_against_jax(tmp_path):
    """The same writes, resizes and appends through both packages leave the
    same bytes in their directory stores after each step."""
    roots = {m: m.open_group(str(tmp_path / m.__name__.split(".")[0]), mode="a") for m in (jz, pz)}
    arrays = {m: g.require_group("a").require_group("b").create_dataset(
        "x", shape=(10, 3), dtype=np.float32, chunks=(4, 3), fill_value=-1.0,
        compressor={"id": "zlib"}) for m, g in roots.items()}
    rng = np.random.default_rng(2)
    steps = [("set", (slice(0, 6),), rng.standard_normal((6, 3))),
             ("set", (7, 1), 5.0),
             ("set", (Ellipsis,), rng.standard_normal((10, 3))),
             ("resize", (3, 3), None),
             ("resize", (9, 3), None),
             ("append", None, rng.standard_normal((5, 3))),
             ("set", (slice(12, 14), slice(0, 2)), 2.5)]
    for op, key, value in steps:
        for m, arr in arrays.items():
            if op == "set":
                arr[key] = value
            elif op == "resize":
                arr.resize(*key)
            else:
                arr.append(value)
        jc, pc = (_contents(roots[m].store) for m in (jz, pz))
        assert jc == pc, op
        np.testing.assert_array_equal(arrays[pz][:], arrays[jz][:])
        assert arrays[pz].shape == arrays[jz].shape
    assert arrays[pz].shape == (14, 3) and (arrays[pz][3:9] == -1).all()
    for m, g in roots.items():
        g["a"].attrs["task"] = "umi"
        g["a"]["b"].attrs.update({"fps": 10})
    again = pz.open_group(str(tmp_path / "unified_video_action_tpu"), mode="r")
    assert again.keys() == ["a"] and again["a"].keys() == ["b"] and "b" in again["a"]
    assert isinstance(again["a"]["b"], pz.ZarrGroup) and isinstance(again["a/b/x"], pz.ZarrArray)
    assert again["a"].attrs["task"] == "umi" and again["a/b"].attrs.asdict() == {"fps": 10}
    assert [k for k, _ in again["a/b"].arrays()] == ["x"]
    zroot = pz.open_group(str(tmp_path / "z.zip"), mode="w")
    zarr_ = zroot.create_dataset("x", data=np.zeros((2, 2)))
    with pytest.raises(NotImplementedError):
        zarr_.resize(4, 2)


def test_chunk_cache_is_bounded_in_bytes_and_chunks(monkeypatch):
    g = pz.open_group(pz.MemoryStore(), mode="w")
    data = np.arange(40 * 1024, dtype=np.uint8).reshape(40, 1024)  # 40 chunks of 1 KiB
    g.create_dataset("x", data=data, chunks=(1, 1024), compressor=None)
    arr = pz.ZarrArray(g.store, "x")  # the module's bounds
    assert (arr.cache_bytes, arr.cache_chunks) == (pz.CACHE_BYTES, pz.CACHE_CHUNKS) == (32 << 20, 64)
    for cache_bytes, cache_chunks, cached in ((8 * 1024, 64, 8), (1 << 30, 5, 5)):
        monkeypatch.setattr(pz, "CACHE_BYTES", cache_bytes)
        monkeypatch.setattr(pz, "CACHE_CHUNKS", cache_chunks)
        arr = pz.ZarrArray(g.store, "x")
        for i in range(40):
            np.testing.assert_array_equal(arr[i], data[i])
        np.testing.assert_array_equal(arr[[39, 0, 39]], data[[39, 0, 39]])
        assert len(arr._cache) == cached and arr.cache_peak_bytes == cached * 1024
    monkeypatch.setattr(pz, "CACHE_BYTES", 512)  # a chunk past the bound is not kept
    arr = pz.ZarrArray(g.store, "x")
    np.testing.assert_array_equal(arr[[3, 3, 1]], data[[3, 3, 1]])
    assert arr.cache_peak_bytes == 0 and not arr._cache


def test_absent_libraries_raise_naming_them(monkeypatch):
    import builtins

    monkeypatch.setattr(pz._Blosc, "_lib", None)
    monkeypatch.setattr(pz._Zstd, "_lib", None)
    monkeypatch.setattr(plz4f._Lib, "_lib", None)
    real = pz._load_library
    monkeypatch.setattr(pz, "_load_library", lambda names, what: real(
        tuple(n.replace("lib", "libabsent_", 1) for n in names), what))
    monkeypatch.setattr(plz4f, "LIBRARY_NAMES", ("libabsent_lz4.so.1",))
    with pytest.raises(RuntimeError, match="libabsent_blosc"):
        pz.get_codec(CODECS["blosc"]).decode(b"\0" * 32)
    with pytest.raises(RuntimeError, match="libabsent_zstd"):
        pz.get_codec(CODECS["zstd"]).encode(b"x")
    with pytest.raises(RuntimeError, match="liblz4"):
        plz4f.decompress(b"\x04\x22\x4d\x18")
    with pytest.raises(RuntimeError, match="liblz4"):
        plz4f.compress(b"x")
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        pz.get_codec(CODECS["imagecodecs_jpeg2k"]).decode(b"")
    with pytest.raises(ValueError, match="unsupported zarr compressor"):
        pz.get_codec({"id": "lz4"})


_CONVERSION = textwrap.dedent("""
    import resource, sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from unified_video_action_tpu_torch.data import zarrlite
    from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer

    # the source, chunk by chunk (never whole in memory): 25 chunks of 6.55 MB
    root = zarrlite.open_group({src!r}, mode="a")
    n, frame = 2500, (128, 128, 4)
    arr = root.require_group("data").create_dataset(
        "img", shape=(n, *frame), dtype=np.uint8, chunks=(100, *frame), compressor=None)
    rng = np.random.default_rng(0)
    for t in range(0, n, 100):
        arr[t:t + 100] = rng.integers(0, 255, (100, *frame), dtype=np.uint8)
    root.require_group("meta").create_dataset(
        "episode_ends", data=np.arange(250, n + 1, 250), compressor=None)
    root.store.close()
    if {control!r}:  # JAX's cache: 64 chunks whatever their size
        zarrlite.CACHE_BYTES = 1 << 40
    assert "torch" not in sys.modules and "jax" not in sys.modules
    # 500 MB of address space: the interpreter and numpy take about 370 MB;
    # the whole source in the cache does not fit beside them
    resource.setrlimit(resource.RLIMIT_AS, (500 << 20, 500 << 20))
    rb = ReplayBuffer.load({src!r}, lazy=True)
    rb.save_zarr({dst!r}, compressors=None)
    print("OK", rb["img"].cache_peak_bytes)
""")


@pytest.mark.parametrize("cache", ["bytes", "chunks_control"])
def test_streaming_conversion_bounded_memory(tmp_path, cache):
    """The port's own copy of ``tests/test_zarrlite.py``'s bounded-memory
    conversion: with the byte-bounded cache it passes under the cap; with a
    cache of 64 chunks (JAX's, ROADMAP C3) it must not."""
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    script = _CONVERSION.format(repo=REPO, src=src, dst=dst, control=cache == "chunks_control")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300)
    if cache == "chunks_control":
        assert proc.returncode != 0 and "OK" not in proc.stdout
        assert "MemoryError" in proc.stderr or "Cannot allocate" in proc.stderr, proc.stderr[-2000:]
        return
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
    assert 0 < int(proc.stdout.split()[-1]) <= pz.CACHE_BYTES
    out, source = (jz.open_group(p, mode="r") for p in (dst, src))  # JAX reads the port's store
    assert out["data"]["img"].shape == (2500, 128, 128, 4)
    assert out["data"]["img"].compressor.get_config()["id"] == "blosc"  # compressors=None: blosc
    np.testing.assert_array_equal(out["data"]["img"][1234:1240], source["data"]["img"][1234:1240])
    np.testing.assert_array_equal(out["meta"]["episode_ends"][:], source["meta"]["episode_ends"][:])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_lz4_frames_round_trip_between_the_bindings(direction):
    rng = np.random.default_rng(3)
    data = rng.bytes(300_000) + b"\0" * 100_000 + b"umi episode " * 3000
    enc, dec = (plz4f, jlz4f) if direction == "port_to_jax" else (jlz4f, plz4f)
    frame = enc.compress(data)
    assert frame == dec.compress(data)  # the same frame from either binding
    assert dec.decompress(frame) == data and enc.decompress(frame) == data
    # concatenated frames (a multi-part archive) through small reads
    two = frame + enc.compress(b"second part")
    stream = plz4f.FrameDecompressor(io.BytesIO(two), chunk_size=512)
    out = b"".join(iter(lambda: stream.read(1000), b""))
    stream.close()
    assert out == data + b"second part" == jlz4f.decompress(two)
    with pytest.raises(ValueError, match="LZ4F_decompress"):
        plz4f.decompress(b"\x04\x22\x4d\x18" + b"\xff" * 16)
