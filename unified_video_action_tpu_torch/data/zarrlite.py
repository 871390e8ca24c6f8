"""A zarr v2 reader and writer (the port's own copy of ``data/zarrlite.py``),
numpy and the standard library only.

The reference keeps its datasets as zarr v2: UMI's episode stores are
directory trees read lazily per index, and the robomimic and LIBERO image
caches are ``*.zarr.zip`` files whose frames are compressed with the
``imagecodecs_jpeg2k`` codec. This module reads and writes that format:

- stores: memory, directory and zip (:class:`MemoryStore`,
  :class:`DirectoryStore`, :class:`ZipStore`, :func:`open_store`);
- metadata: the ``.zgroup``, ``.zarray`` and ``.zattrs`` JSON documents
  (:class:`Attrs`, :class:`ZarrGroup`, :func:`open_group`);
- codecs: blosc over the system's ``libblosc`` and zstd over ``libzstd``,
  both by ctypes; zlib, gzip, bz2 and lzma from the standard library; JPEG
  2000 through Pillow, imported where a chunk is coded; the reference's
  ``imagecodecs_*`` ids as aliases. A codec whose library is absent raises
  where a chunk is coded, naming the library.

:class:`ZarrArray` is lazy: indexing decodes the chunks it covers (int,
slice and integer-array indexing on axis 0), and writes, ``resize`` and
``append`` rewrite whole chunks. Each array keeps one cache of decoded
chunks, shared by the threads that index it under the array's lock, bounded
in bytes (``CACHE_BYTES``) as well as in chunks (``CACHE_CHUNKS``). The JAX
package's cache counts chunks alone (64 of them), which holds a whole store
of large chunks in memory (ROADMAP C3); ``cache_peak_bytes`` records the
most the cache held.
"""

from __future__ import annotations

import bz2
import ctypes
import io
import json
import lzma
import os
import threading
import zipfile
import zlib
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# the decoded-chunk cache of one array: at most this many bytes and chunks
# (read where an array is opened; a chunk larger than the byte bound is not
# kept)
CACHE_BYTES = 32 << 20
CACHE_CHUNKS = 64


# -- codecs ----------------------------------------------------------------

def _load_library(names: Tuple[str, ...], what: str):
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError(f"{names[0].split('.so')[0]} not found (tried {', '.join(names)}): "
                       f"{what} cannot be read or written")


class _Blosc:
    """c-blosc1 over the system's ``libblosc``."""

    _lib = None
    _lock = threading.Lock()

    @classmethod
    def lib(cls):
        if cls._lib is None:
            with cls._lock:
                if cls._lib is None:
                    lib = _load_library(("libblosc.so.1", "libblosc.so", "libblosc.dylib"),
                                        "blosc-compressed zarr chunks")
                    sz, vp, i = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
                    lib.blosc_compress_ctx.restype = i
                    lib.blosc_compress_ctx.argtypes = [i, i, sz, sz, vp, vp, sz, ctypes.c_char_p,
                                                       sz, i]
                    lib.blosc_decompress_ctx.restype = i
                    lib.blosc_decompress_ctx.argtypes = [vp, vp, sz, i]
                    lib.blosc_cbuffer_sizes.restype = None
                    lib.blosc_cbuffer_sizes.argtypes = [vp] + [ctypes.POINTER(sz)] * 3
                    cls._lib = lib
        return cls._lib

    @classmethod
    def decompress(cls, buf: bytes) -> bytes:
        lib = cls.lib()
        nbytes, cbytes, blocksize = ctypes.c_size_t(), ctypes.c_size_t(), ctypes.c_size_t()
        src = ctypes.create_string_buffer(bytes(buf), len(buf))
        lib.blosc_cbuffer_sizes(src, ctypes.byref(nbytes), ctypes.byref(cbytes),
                                ctypes.byref(blocksize))
        out = ctypes.create_string_buffer(nbytes.value)
        rc = lib.blosc_decompress_ctx(src, out, nbytes.value, 1)
        if rc <= 0:
            raise ValueError(f"blosc decompress failed (rc={rc})")
        return out.raw[:rc]

    @classmethod
    def compress(cls, data: bytes, typesize: int = 1, cname: str = "lz4", clevel: int = 5,
                 shuffle: int = 1, blocksize: int = 0) -> bytes:
        lib = cls.lib()
        src = ctypes.create_string_buffer(bytes(data), len(data))
        destsize = len(data) + 16  # BLOSC_MAX_OVERHEAD
        out = ctypes.create_string_buffer(destsize)
        rc = lib.blosc_compress_ctx(clevel, shuffle, max(typesize, 1), len(data), src, out,
                                    destsize, cname.encode(), blocksize, 1)
        if rc <= 0:
            raise ValueError(f"blosc compress failed (rc={rc})")
        return out.raw[:rc]


class _Zstd:
    """zstd frames over the system's ``libzstd``."""

    _lib = None
    _lock = threading.Lock()

    @classmethod
    def lib(cls):
        if cls._lib is None:
            with cls._lock:
                if cls._lib is None:
                    lib = _load_library(("libzstd.so.1", "libzstd.so", "libzstd.dylib"),
                                        "zstd-compressed zarr chunks")
                    sz, vp = ctypes.c_size_t, ctypes.c_void_p
                    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
                    lib.ZSTD_getFrameContentSize.argtypes = [vp, sz]
                    lib.ZSTD_decompress.restype = sz
                    lib.ZSTD_decompress.argtypes = [vp, sz, vp, sz]
                    lib.ZSTD_compressBound.restype = sz
                    lib.ZSTD_compressBound.argtypes = [sz]
                    lib.ZSTD_compress.restype = sz
                    lib.ZSTD_compress.argtypes = [vp, sz, vp, sz, ctypes.c_int]
                    lib.ZSTD_isError.restype = ctypes.c_uint
                    lib.ZSTD_isError.argtypes = [sz]
                    cls._lib = lib
        return cls._lib

    @classmethod
    def decompress(cls, buf: bytes) -> bytes:
        lib = cls.lib()
        src = ctypes.create_string_buffer(bytes(buf), len(buf))
        size = lib.ZSTD_getFrameContentSize(src, len(buf))
        if size in (2**64 - 1, 2**64 - 2):  # error, unknown
            raise ValueError("zstd frame with unknown content size")
        out = ctypes.create_string_buffer(int(size))
        rc = lib.ZSTD_decompress(out, int(size), src, len(buf))
        if lib.ZSTD_isError(rc):
            raise ValueError("zstd decompress failed")
        return out.raw[:rc]

    @classmethod
    def compress(cls, data: bytes, level: int = 1) -> bytes:
        lib = cls.lib()
        src = ctypes.create_string_buffer(bytes(data), len(data))
        bound = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(bound)
        rc = lib.ZSTD_compress(out, bound, src, len(data), level)
        if lib.ZSTD_isError(rc):
            raise ValueError("zstd compress failed")
        return out.raw[:rc]


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("JPEG 2000 zarr chunks (imagecodecs_jpeg2k) need Pillow, "
                          "which is not installed") from e
    return Image


def _jpeg2k_decode(buf: bytes) -> np.ndarray:
    return np.asarray(_pil_image().open(io.BytesIO(bytes(buf))))


def _jpeg2k_encode(arr: np.ndarray, level: Optional[int]) -> bytes:
    """A raw JPEG 2000 codestream of an image chunk, as the reference's
    ``Jpeg2k`` codec writes it: axes of size 1 before the last two squeezed;
    ``level`` a PSNR in dB (50 in the reference's caches), None lossless."""
    Image = _pil_image()
    arr = np.asarray(arr)
    squeeze = tuple(i for i, s in enumerate(arr.shape[:-2]) if s == 1 and arr.ndim > 2)
    if squeeze:
        arr = arr.squeeze(axis=squeeze)
    bio = io.BytesIO()
    if level is None:
        Image.fromarray(arr).save(bio, format="JPEG2000", irreversible=False)
    else:
        Image.fromarray(arr).save(bio, format="JPEG2000", irreversible=True, quality_mode="dB",
                                  quality_layers=[float(level)])
    return bio.getvalue()


class Codec:
    """A zarr v2 compressor: bytes to bytes (an image codec decodes to an
    array)."""

    is_image_codec = False

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)

    def decode(self, buf: bytes):
        raise NotImplementedError

    def encode(self, data, typesize: int = 1) -> bytes:
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        return dict(self.config)


class BloscCodec(Codec):
    def decode(self, buf):
        return _Blosc.decompress(buf)

    def encode(self, data, typesize: int = 1):
        c = self.config
        return _Blosc.compress(data, typesize=typesize, cname=c.get("cname", "lz4"),
                               clevel=int(c.get("clevel", 5)), shuffle=int(c.get("shuffle", 1)),
                               blocksize=int(c.get("blocksize", 0) or 0))


class ZstdCodec(Codec):
    def decode(self, buf):
        return _Zstd.decompress(buf)

    def encode(self, data, typesize: int = 1):
        return _Zstd.compress(data, level=int(self.config.get("level", 1)))


class ZlibCodec(Codec):
    def decode(self, buf):
        return zlib.decompress(bytes(buf))

    def encode(self, data, typesize: int = 1):
        return zlib.compress(bytes(data), int(self.config.get("level", 1)))


class GzipCodec(Codec):
    def decode(self, buf):
        return zlib.decompress(bytes(buf), wbits=31)

    def encode(self, data, typesize: int = 1):
        co = zlib.compressobj(int(self.config.get("level", 1)), wbits=31)
        return co.compress(bytes(data)) + co.flush()


class Bz2Codec(Codec):
    def decode(self, buf):
        return bz2.decompress(bytes(buf))

    def encode(self, data, typesize: int = 1):
        return bz2.compress(bytes(data), int(self.config.get("level", 1)))


class LzmaCodec(Codec):
    def decode(self, buf):
        return lzma.decompress(bytes(buf))

    def encode(self, data, typesize: int = 1):
        return lzma.compress(bytes(data))


class Jpeg2kCodec(Codec):
    """The reference's ``imagecodecs_jpeg2k`` codec."""

    is_image_codec = True

    def decode(self, buf):
        return _jpeg2k_decode(buf)

    def encode(self, data, typesize: int = 1):
        return _jpeg2k_encode(data, self.config.get("level"))


CODECS = {
    "blosc": BloscCodec, "zstd": ZstdCodec, "zlib": ZlibCodec, "gzip": GzipCodec,
    "bz2": Bz2Codec, "lzma": LzmaCodec, "imagecodecs_jpeg2k": Jpeg2kCodec,
    "imagecodecs_blosc": BloscCodec, "imagecodecs_zlib": ZlibCodec, "imagecodecs_zstd": ZstdCodec,
}


def get_codec(config: Optional[Dict[str, Any]]) -> Optional[Codec]:
    if config is None:
        return None
    cid = config.get("id")
    if cid not in CODECS:
        raise ValueError(f"unsupported zarr compressor {cid!r}; supported: {sorted(CODECS)}")
    return CODECS[cid](config)


# -- stores ----------------------------------------------------------------

class Store:
    """A key-value store of bytes; keys use '/' separators."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove ``key`` where present."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None


class MemoryStore(Store):
    def __init__(self):
        self._d: Dict[str, bytes] = {}

    def get(self, key):
        return self._d.get(key)

    def set(self, key, value):
        self._d[key] = bytes(value)

    def delete(self, key):
        self._d.pop(key, None)

    def list_prefix(self, prefix):
        return [k for k in self._d if k.startswith(prefix)]


class DirectoryStore(Store):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def get(self, key):
        p = self._path(key)
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def set(self, key, value):
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(value)

    def delete(self, key):
        p = self._path(key)
        if os.path.isfile(p):
            os.remove(p)

    def list_prefix(self, prefix):
        base = self._path(prefix) if prefix else self.root
        out = []
        for dirpath, _, filenames in os.walk(base):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            out.extend(rel + fn for fn in filenames)
        return out


class ZipStore(Store):
    """A zarr hierarchy in a zip file (the reference's ``*.zarr.zip``),
    entries stored uncompressed (the chunks are compressed already).
    Append-only: ``delete`` and ``resize`` refuse."""

    def __init__(self, path: str, mode: str = "r"):
        self.path, self.mode = path, mode
        self._zf = zipfile.ZipFile(path, mode=mode, compression=zipfile.ZIP_STORED)
        self._names = set(self._zf.namelist()) if mode != "w" else set()
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def _handle(self) -> zipfile.ZipFile:
        # a forked child shares the parent's file offset: reopen per process
        if os.getpid() != self._pid:
            self._zf = zipfile.ZipFile(self.path, mode="r")
            self._pid = os.getpid()
            self._lock = threading.Lock()
        return self._zf

    def get(self, key):
        if key not in self._names:
            return None
        zf = self._handle()
        with self._lock:
            try:
                return zf.read(key)
            except KeyError:
                return None

    def set(self, key, value):
        if self.mode == "r":
            raise PermissionError(f"zip store {self.path} is open read-only")
        with self._lock:
            self._zf.writestr(key, bytes(value))
            self._names.add(key)

    def list_prefix(self, prefix):
        return [k for k in self._names if k.startswith(prefix)]

    def close(self):
        self._zf.close()


# -- arrays and groups -----------------------------------------------------

def _norm_path(*parts: str) -> str:
    return "/".join(s for p in parts for s in p.split("/") if s)


class Attrs:
    """An array's or group's ``.zattrs``."""

    def __init__(self, store: Store, path: str):
        self._store = store
        self._key = _norm_path(path, ".zattrs") if path else ".zattrs"
        self._cache: Optional[Dict[str, Any]] = None

    def asdict(self) -> Dict[str, Any]:
        if self._cache is None:
            raw = self._store.get(self._key)
            self._cache = json.loads(raw) if raw else {}
        return self._cache

    def __getitem__(self, k):
        return self.asdict()[k]

    def get(self, k, default=None):
        return self.asdict().get(k, default)

    def __contains__(self, k):
        return k in self.asdict()

    def __setitem__(self, k, v):
        self.update({k: v})

    def update(self, other: Dict[str, Any]):
        d = self.asdict()
        d.update(other)
        self._store.set(self._key, json.dumps(d).encode())


class ZarrArray:
    """A lazy, chunked, C-order zarr v2 array with a cache of decoded chunks
    bounded by the module's ``CACHE_BYTES`` and ``CACHE_CHUNKS`` as they are
    when the array is opened."""

    def __init__(self, store: Store, path: str):
        self.store, self.path = store, path
        meta_raw = store.get(_norm_path(path, ".zarray"))
        if meta_raw is None:
            raise KeyError(f"no .zarray at {path!r}")
        meta = json.loads(meta_raw)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"only zarr v2 is supported, got {meta.get('zarr_format')}")
        if meta.get("order", "C") != "C":
            raise ValueError("only C-order zarr arrays are supported")
        if meta.get("filters"):
            raise ValueError(f"zarr filters are not supported: {meta['filters']}")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value")
        self._sep = meta.get("dimension_separator", ".")
        self.compressor = get_codec(meta.get("compressor"))
        self.attrs = Attrs(store, path)
        self._cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = OrderedDict()
        self.cache_bytes, self.cache_chunks = CACHE_BYTES, CACHE_CHUNKS
        self._cached_bytes = 0
        self.cache_peak_bytes = 0
        self._lock = threading.Lock()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    # -- chunks --

    def _chunk_key(self, cidx: Tuple[int, ...]) -> str:
        return _norm_path(self.path, self._sep.join(str(i) for i in cidx) if cidx else "0")

    def _fill_chunk(self) -> np.ndarray:
        fv = self.fill_value
        if fv is None:
            fv = 0
        elif isinstance(fv, str) and fv.lower() == "nan":
            fv = np.nan
        return np.full(self.chunks, fv, dtype=self.dtype)

    def _cache_put(self, cidx, chunk: np.ndarray) -> None:
        """Under the lock: keep ``chunk``, then drop the least recently used
        until both bounds hold."""
        if chunk.nbytes > self.cache_bytes or self.cache_chunks < 1:
            return
        old = self._cache.pop(cidx, None)
        if old is not None:
            self._cached_bytes -= old.nbytes
        self._cache[cidx] = chunk
        self._cached_bytes += chunk.nbytes
        while self._cached_bytes > self.cache_bytes or len(self._cache) > self.cache_chunks:
            self._cached_bytes -= self._cache.popitem(last=False)[1].nbytes
        self.cache_peak_bytes = max(self.cache_peak_bytes, self._cached_bytes)

    def _cache_drop(self, cidx=None) -> None:
        """Under the lock: forget chunk ``cidx``, or every chunk."""
        if cidx is None:
            self._cache.clear()
            self._cached_bytes = 0
        else:
            old = self._cache.pop(cidx, None)
            if old is not None:
                self._cached_bytes -= old.nbytes

    def _read_chunk(self, cidx: Tuple[int, ...]) -> np.ndarray:
        with self._lock:
            hit = self._cache.get(cidx)
            if hit is not None:
                self._cache.move_to_end(cidx)
                return hit
        raw = self.store.get(self._chunk_key(cidx))
        if raw is None:
            chunk = self._fill_chunk()
        else:
            decoded = raw if self.compressor is None else self.compressor.decode(raw)
            if isinstance(decoded, np.ndarray):  # an image codec: its squeezed shape
                chunk = decoded.astype(self.dtype, copy=False).reshape(self.chunks)
            else:
                chunk = np.frombuffer(decoded, dtype=self.dtype).reshape(self.chunks)
        with self._lock:
            self._cache_put(cidx, chunk)
        return chunk

    # -- reading --

    def __getitem__(self, key) -> np.ndarray:
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - len(key) + 1) + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))
        if key and isinstance(key[0], (list, np.ndarray)):  # integer array on axis 0
            idx0 = np.asarray(key[0])
            if idx0.ndim != 1:
                raise IndexError("only 1-d integer-array indexing on axis 0")
            return np.stack([self[(int(i),) + key[1:]] for i in idx0])

        sel: List[Tuple[int, int]] = []
        drop_axes: List[int] = []
        for d, k in enumerate(key):
            n = self.shape[d]
            if isinstance(k, (int, np.integer)):
                i = int(k) + (n if k < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {k} out of bounds for axis {d} ({n})")
                sel.append((i, i + 1))
                drop_axes.append(d)
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    # read the covered range, then step through it
                    if step > 0:
                        lo, hi, sub = start, stop, slice(None, None, step)
                    else:
                        lo, hi = stop + 1, start + 1
                        sub = slice(start - lo, None, step)
                    base = self[tuple(key[:d]) + (slice(lo, max(hi, lo)),) + tuple(key[d + 1:])]
                    return base[(slice(None),) * (d - len(drop_axes)) + (sub,)]
                sel.append((start, stop))
            else:
                raise TypeError(f"unsupported index {k!r}")

        out_shape = [max(stop - start, 0) for start, stop in sel]
        out = np.empty(out_shape, dtype=self.dtype)
        if out.size:
            first = [start // c for (start, _), c in zip(sel, self.chunks)]
            last = [max((stop - 1) // c, start // c) for (start, stop), c in zip(sel, self.chunks)]
            for rel in np.ndindex(*[l - f + 1 for f, l in zip(first, last)]):
                cidx = tuple(f + i for f, i in zip(first, rel))
                chunk = self._read_chunk(cidx)
                src, dst = [], []
                for d, ((start, stop), c) in enumerate(zip(sel, self.chunks)):
                    c0 = cidx[d] * c
                    s0, s1 = max(start, c0), min(stop, c0 + c)
                    src.append(slice(s0 - c0, s1 - c0))
                    dst.append(slice(s0 - start, s1 - start))
                out[tuple(dst)] = chunk[tuple(src)]
        if drop_axes:
            out = out.reshape([s for d, s in enumerate(out_shape) if d not in drop_axes])
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self[(slice(None),) * self.ndim] if self.ndim else self[()]
        return arr if dtype is None else arr.astype(dtype)

    # -- writing --

    def _normalize_write_key(self, key):
        """A basic-index selection (ints, unit-step slices, Ellipsis) as
        ([(start, stop)] per axis, the int axes)."""
        if key is Ellipsis:
            key = ()
        if not isinstance(key, tuple):
            key = (key,)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - (len(key) - 1)) + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))
        if len(key) != self.ndim:
            raise IndexError(f"too many indices for a {self.ndim}-d array")
        sel, squeeze = [], []
        for d, (k, s) in enumerate(zip(key, self.shape)):
            if isinstance(k, (int, np.integer)):
                k = int(k) + (s if k < 0 else 0)
                if not 0 <= k < s:
                    raise IndexError(f"index {k} out of bounds for axis {d}")
                sel.append((k, k + 1))
                squeeze.append(d)
            elif isinstance(k, slice):
                if k.step not in (None, 1):
                    raise NotImplementedError("strided writes are not supported")
                start, stop, _ = k.indices(s)
                sel.append((start, max(stop, start)))
            else:
                raise NotImplementedError(f"unsupported write index {type(k).__name__}")
        return sel, squeeze

    def __setitem__(self, key, value) -> None:
        """Write a region: a chunk the region covers whole (within the
        array's extent) is written without a read; another one is read,
        changed and written."""
        sel, squeeze = self._normalize_write_key(key)
        sel_shape = tuple(stop - start for start, stop in sel)
        value = np.asarray(value, dtype=self.dtype)
        vshape = tuple(s for d, s in enumerate(sel_shape) if d not in squeeze)
        value = np.broadcast_to(value, vshape).reshape(sel_shape)
        if 0 in sel_shape:
            return
        first = [start // c for (start, _), c in zip(sel, self.chunks)]
        last = [(stop - 1) // c for (_, stop), c in zip(sel, self.chunks)]
        for rel in np.ndindex(*[l - f + 1 for f, l in zip(first, last)]):
            cidx = tuple(f + i for f, i in zip(first, rel))
            src, dst, covered = [], [], True
            for d, ((start, stop), c, s) in enumerate(zip(sel, self.chunks, self.shape)):
                c0 = cidx[d] * c
                c1 = min(c0 + c, s)
                s0, s1 = max(start, c0), min(stop, c1)
                dst.append(slice(s0 - c0, s1 - c0))
                src.append(slice(s0 - start, s1 - start))
                covered = covered and s0 <= c0 and s1 >= c1
            chunk = self._fill_chunk() if covered else self._read_chunk(cidx).copy()
            chunk[tuple(dst)] = value[tuple(src)]
            self._write_chunk(cidx, chunk)

    def resize(self, *new_shape) -> None:
        """Grow or shrink: chunks wholly outside the new shape are deleted
        and the tails of the chunks it cuts are set to the fill value, so a
        later growth reads the fill value there. A zip store refuses."""
        if isinstance(self.store, ZipStore):
            raise NotImplementedError("resize on an append-only zip store")
        if len(new_shape) == 1 and isinstance(new_shape[0], (tuple, list)):
            new_shape = tuple(new_shape[0])
        new_shape = tuple(int(s) for s in new_shape)
        if len(new_shape) != self.ndim:
            raise ValueError(f"resize must keep ndim={self.ndim}")
        old_shape = self.shape
        if any(n < o for n, o in zip(new_shape, old_shape)):
            old_grid = [-(-o // c) for o, c in zip(old_shape, self.chunks)]
            new_grid = [-(-n // c) for n, c in zip(new_shape, self.chunks)]
            for cidx in np.ndindex(*old_grid):
                if any(i >= g for i, g in zip(cidx, new_grid)):
                    self.store.delete(self._chunk_key(cidx))
                    continue
                straddles = any(i * c < n < min(i * c + c, o)
                                for i, c, n, o in zip(cidx, self.chunks, new_shape, old_shape))
                if straddles and self.store.get(self._chunk_key(cidx)) is not None:
                    chunk = self._read_chunk(cidx).copy()
                    fill = self._fill_chunk()
                    for d, (i, c, n) in enumerate(zip(cidx, self.chunks, new_shape)):
                        lo = max(n - i * c, 0)
                        if lo < c:
                            sl = [slice(None)] * self.ndim
                            sl[d] = slice(lo, None)
                            chunk[tuple(sl)] = fill[tuple(sl)]
                    self._write_chunk(cidx, chunk)
        meta = json.loads(self.store.get(_norm_path(self.path, ".zarray")))
        meta["shape"] = list(new_shape)
        self.store.set(_norm_path(self.path, ".zarray"), json.dumps(meta).encode())
        self.shape = new_shape
        with self._lock:
            self._cache_drop()

    def append(self, value: np.ndarray, axis: int = 0) -> None:
        """Grow along ``axis`` and write ``value`` into the new region."""
        value = np.asarray(value, dtype=self.dtype)
        old = self.shape[axis]
        new_shape = list(self.shape)
        new_shape[axis] += value.shape[axis]
        self.resize(new_shape)
        key = [slice(None)] * self.ndim
        key[axis] = slice(old, new_shape[axis])
        self[tuple(key)] = value

    def _write_chunk(self, cidx: Tuple[int, ...], chunk: np.ndarray) -> None:
        chunk = np.ascontiguousarray(chunk)
        if self.compressor is None:
            raw = chunk.tobytes()
        elif self.compressor.is_image_codec:
            raw = self.compressor.encode(chunk)
        else:
            raw = self.compressor.encode(chunk.tobytes(), typesize=self.dtype.itemsize)
        self.store.set(self._chunk_key(cidx), raw)
        with self._lock:
            self._cache_drop(cidx)


DEFAULT_COMPRESSOR = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0}


class ZarrGroup:
    def __init__(self, store: Store, path: str = ""):
        self.store, self.path = store, path
        self.attrs = Attrs(store, path)

    def __getitem__(self, key: str) -> Union["ZarrGroup", ZarrArray]:
        p = _norm_path(self.path, key)
        if self.store.get(_norm_path(p, ".zarray")) is not None:
            return ZarrArray(self.store, p)
        if self.store.get(_norm_path(p, ".zgroup")) is not None:
            return ZarrGroup(self.store, p)
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        p = _norm_path(self.path, key)
        return (self.store.get(_norm_path(p, ".zarray")) is not None
                or self.store.get(_norm_path(p, ".zgroup")) is not None)

    def keys(self) -> List[str]:
        prefix = self.path + "/" if self.path else ""
        names = {k[len(prefix):].split("/", 1)[0] for k in self.store.list_prefix(prefix)
                 if "/" in k[len(prefix):]}
        return sorted(n for n in names if n in self)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def arrays(self) -> Iterator[Tuple[str, ZarrArray]]:
        for k in self.keys():
            v = self[k]
            if isinstance(v, ZarrArray):
                yield k, v

    def require_group(self, key: str) -> "ZarrGroup":
        p = _norm_path(self.path, key)
        if self.store.get(_norm_path(p, ".zgroup")) is None:
            self.store.set(_norm_path(p, ".zgroup"), json.dumps({"zarr_format": 2}).encode())
        return ZarrGroup(self.store, p)

    def create_dataset(self, key: str, data: Optional[np.ndarray] = None,
                       shape: Optional[Tuple[int, ...]] = None,
                       chunks: Optional[Tuple[int, ...]] = None, dtype=None,
                       compressor: Union[None, str, Dict[str, Any]] = "default",
                       fill_value: Any = 0, dimension_separator: str = ".") -> ZarrArray:
        """An array at ``key``: of ``data``, or of ``shape`` and ``dtype``
        holding the fill value. ``compressor`` "default" is blosc (lz4,
        level 5, byte shuffle), a string a codec id, a dict a codec config,
        None none."""
        if data is not None:
            data = np.asarray(data)
            shape = data.shape
            dtype = dtype or data.dtype
        if shape is None or dtype is None:
            raise ValueError("create_dataset needs data, or shape and dtype")
        dtype = np.dtype(dtype)
        if chunks is None:
            chunks = default_chunks(shape, dtype)
        chunks = tuple(min(c, s) if s else c for c, s in zip(chunks, shape))
        if compressor == "default":
            compressor = dict(DEFAULT_COMPRESSOR)
        elif isinstance(compressor, str):
            compressor = {"id": compressor}
        meta = {"zarr_format": 2, "shape": list(shape), "chunks": list(chunks),
                "dtype": dtype.str, "compressor": compressor, "fill_value": fill_value,
                "filters": None, "order": "C", "dimension_separator": dimension_separator}
        p = _norm_path(self.path, key)
        self.store.set(_norm_path(p, ".zarray"), json.dumps(meta).encode())
        arr = ZarrArray(self.store, p)
        if data is not None:
            arr[...] = data
        return arr


def default_chunks(shape: Tuple[int, ...], dtype: np.dtype,
                   target_bytes: int = 2 << 20) -> Tuple[int, ...]:
    """Chunks along time (axis 0) only, about ``target_bytes`` each: the
    reference's ``get_optimal_chunks`` convention."""
    if not shape:
        return ()
    item = dtype.itemsize * int(np.prod(shape[1:])) if len(shape) > 1 else dtype.itemsize
    return (max(1, min(shape[0], target_bytes // max(item, 1))),) + tuple(shape[1:])


def open_store(path: str, mode: str = "r") -> Store:
    if path.endswith(".zip") or (os.path.isfile(path) and zipfile.is_zipfile(path)):
        return ZipStore(path, mode=mode)
    return DirectoryStore(path)


def open_group(path_or_store: Union[str, Store], mode: str = "r") -> ZarrGroup:
    """The zarr v2 hierarchy at ``path_or_store`` (a directory, a zip file
    or a :class:`Store`); a mode other than "r" writes its root
    ``.zgroup`` where it has none."""
    store = path_or_store if isinstance(path_or_store, Store) else open_store(path_or_store, mode)
    if mode != "r" and store.get(".zgroup") is None:
        store.set(".zgroup", json.dumps({"zarr_format": 2}).encode())
    return ZarrGroup(store, "")
