"""The LZ4 frame format over the system's ``liblz4`` by ctypes (the port's
own copy of ``utils/lz4f.py``).

The reference stages UMI datasets as ``.zarr.tar.lz4`` archives written and
read by the lz4 command-line tool, whose format is the LZ4 *frame*. This
binds the frame API of ``liblz4.so.1``: :func:`compress` writes one frame,
:class:`FrameDecompressor` reads a stream of concatenated frames as a file
object (``tarfile`` reads it in stream mode), :func:`open_frame` opens a path
or a file object. Where the library does not load, every entry point raises
a ``RuntimeError`` that names ``liblz4``.
"""

from __future__ import annotations

import ctypes
import io
import threading
from typing import BinaryIO

_LZ4F_VERSION = 100
LIBRARY_NAMES = ("liblz4.so.1", "liblz4.so", "liblz4.dylib")


class _Lib:
    _lib = None
    _lock = threading.Lock()

    @classmethod
    def get(cls):
        if cls._lib is None:
            with cls._lock:
                if cls._lib is None:
                    cls._lib = cls._load()
        return cls._lib

    @staticmethod
    def _load():
        for name in LIBRARY_NAMES:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise RuntimeError(f"liblz4 not found (tried {', '.join(LIBRARY_NAMES)}): "
                               f"LZ4 frames cannot be read or written")
        sz, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.LZ4F_isError.restype, lib.LZ4F_isError.argtypes = ctypes.c_uint, [sz]
        lib.LZ4F_compressFrameBound.restype = sz
        lib.LZ4F_compressFrameBound.argtypes = [sz, vp]
        lib.LZ4F_compressFrame.restype = sz
        lib.LZ4F_compressFrame.argtypes = [vp, sz, vp, sz, vp]
        lib.LZ4F_createDecompressionContext.restype = sz
        lib.LZ4F_createDecompressionContext.argtypes = [ctypes.POINTER(vp), ctypes.c_uint]
        lib.LZ4F_freeDecompressionContext.restype = sz
        lib.LZ4F_freeDecompressionContext.argtypes = [vp]
        lib.LZ4F_decompress.restype = sz
        lib.LZ4F_decompress.argtypes = [vp, vp, ctypes.POINTER(sz), vp, ctypes.POINTER(sz), vp]
        return lib


def compress(data: bytes) -> bytes:
    """One LZ4 frame of ``data``, as the lz4 tool writes it."""
    lib = _Lib.get()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    rc = lib.LZ4F_compressFrame(dst, bound, src, len(data), None)
    if lib.LZ4F_isError(rc):
        raise ValueError("LZ4F_compressFrame failed")
    return dst.raw[:rc]


class FrameDecompressor(io.RawIOBase):
    """A stream of LZ4 frames read as a file object. A frame's end is not
    the stream's (the tool writes concatenated frames for a multi-part
    archive): the stream ends where the source file does."""

    def __init__(self, fileobj: BinaryIO, chunk_size: int = 1 << 20, owns_fileobj: bool = False):
        self._ctx = ctypes.c_void_p()
        self._f, self._owns_f, self._chunk = fileobj, owns_fileobj, chunk_size
        self._buf, self._src_rem, self._eof = b"", b"", False
        lib = _Lib.get()
        if lib.LZ4F_isError(lib.LZ4F_createDecompressionContext(ctypes.byref(self._ctx),
                                                                _LZ4F_VERSION)):
            raise ValueError("LZ4F context creation failed")

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        """Decode source chunks into the buffer until some bytes come out or
        the source ends; every call consumes source."""
        lib = _Lib.get()
        while not self._eof:
            if not self._src_rem:
                self._src_rem = self._f.read(self._chunk)
                if not self._src_rem:
                    self._eof = True
                    return
            src = ctypes.create_string_buffer(self._src_rem, len(self._src_rem))
            src_size = ctypes.c_size_t(len(self._src_rem))
            dst_cap = max(self._chunk, 4 * len(self._src_rem))
            dst = ctypes.create_string_buffer(dst_cap)
            dst_size = ctypes.c_size_t(dst_cap)
            rc = lib.LZ4F_decompress(self._ctx, dst, ctypes.byref(dst_size), src,
                                     ctypes.byref(src_size), None)
            if lib.LZ4F_isError(rc):
                raise ValueError("LZ4F_decompress failed (corrupt frame?)")
            self._buf += dst.raw[:dst_size.value]
            self._src_rem = self._src_rem[src_size.value:]
            if dst_size.value:
                return

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            while not self._eof:
                self._fill()
            out, self._buf = self._buf, b""
            return out
        while len(self._buf) < n and not self._eof:
            self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        if self._ctx:
            _Lib.get().LZ4F_freeDecompressionContext(self._ctx)
            self._ctx = ctypes.c_void_p()
        if self._owns_f:
            self._f.close()
        super().close()


def decompress(data: bytes) -> bytes:
    with FrameDecompressor(io.BytesIO(data)) as f:
        return f.read()


def open_frame(path_or_fileobj) -> FrameDecompressor:
    """A path or a binary file object of LZ4 frames, opened for reading."""
    if hasattr(path_or_fileobj, "read"):
        return FrameDecompressor(path_or_fileobj)
    return FrameDecompressor(open(path_or_fileobj, "rb"), owns_fileobj=True)
