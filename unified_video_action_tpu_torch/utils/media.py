"""Animated GIF writing with numpy alone (the card's machine has no OpenCV,
imageio or PIL): what the port's video recording (``envs/video_recording.py``,
``real/video_recorder.py``) and the offline evaluation's ``real_vs_pred.gif``
(``eval/offline.py``) write, where the JAX package calls OpenCV's mp4
writer, imageio or PIL.

Each (H, W, 3) uint8 frame is one GIF image with a local color table:

* a frame of at most 256 colors gets a table of exactly its colors (padded
  with black to a power of two, at least 4 entries), so that it decodes to
  the frame itself, losslessly (a PushT frame has 28 colors at 96 px);
* a frame of more colors is mapped onto the fixed 3-3-2 palette, 8 levels
  of red and of green and 4 of blue, each channel to its nearest level
  (``round(c * 7 / 255)`` of 7, ``round(c * 3 / 255)`` of 3), index
  ``32 r + 4 g + b``: lossy, at most 18 levels off in red and green and 42
  in blue.

The LZW stream is "uncompressed": every pixel is its own literal code of
``bits + 1`` bits (``bits`` = the table's width, at least 2), with a clear
code before every ``2 ** bits - 2`` literals, so that the decoder's table
never grows past the code width. It is built and packed with numpy in one
pass a frame, and it is about ``(bits + 1) / 8`` bytes a pixel.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterable, Optional

import numpy as np

HEADER = b"GIF89a"
TRAILER = b"\x3b"
MAX_COLORS = 256


def _fixed_palette() -> np.ndarray:
    r, g, b = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
    rgb = np.stack([np.rint(r * 255 / 7), np.rint(g * 255 / 7), np.rint(b * 255 / 3)], -1)
    return rgb.reshape(256, 3).astype(np.uint8)


# (256, 3) uint8: the 3-3-2 palette, index 32 r + 4 g + b
FIXED_PALETTE = _fixed_palette()


def palettize(frame: np.ndarray):
    """(H, W, 3) uint8 -> (indices (H, W) uint8, table (2 ** bits, 3) uint8,
    bits): the frame's own colors where it has at most 256, else the fixed
    palette's nearest levels."""
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"a frame is (H, W, 3) uint8, got {frame.shape} {frame.dtype}")
    flat = frame.reshape(-1, 3).astype(np.uint32)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    colors, inverse = np.unique(keys, return_inverse=True)
    if len(colors) <= MAX_COLORS:
        bits = max(2, int(np.ceil(np.log2(len(colors)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(colors)] = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], -1)
        return inverse.reshape(frame.shape[:2]).astype(np.uint8), table, bits
    q = frame.astype(np.int32)
    r = (q[..., 0] * 7 + 127) // 255
    g = (q[..., 1] * 7 + 127) // 255
    b = (q[..., 2] * 3 + 127) // 255
    return (32 * r + 4 * g + b).astype(np.uint8), FIXED_PALETTE, 8


def lzw_literal_stream(indices: np.ndarray, bits: int) -> bytes:
    """The GIF image data of ``indices`` (flattened, each < 2 ** bits): the
    minimum code size byte, then the "uncompressed" LZW codes in sub-blocks
    of at most 255 bytes, then the block terminator."""
    clear, end = 1 << bits, (1 << bits) + 1
    run = (1 << bits) - 2  # literals between clears: the table stays under 2 ** (bits + 1)
    width = bits + 1
    idx = np.asarray(indices, np.int64).ravel()
    n = idx.size
    n_runs = max(-(-n // run), 1)
    codes = np.full(n + n_runs + 1, clear, np.int64)
    pos = np.arange(n) + np.arange(n) // run + 1  # each run after its clear code
    codes[pos] = idx
    codes[-1] = end
    bitplane = ((codes[:, None] >> np.arange(width)) & 1).astype(np.uint8)
    data = np.packbits(bitplane.ravel(), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([bits]) + blocks + b"\x00"


class GifWriter:
    """A streaming animated GIF: ``append`` writes each frame as it comes
    (all frames one size; the file is created at the first), ``close``
    writes the trailer. ``fps`` sets each frame's delay in hundredths of a
    second; the animation loops forever. No frame, no file."""

    def __init__(self, path: str, fps: float = 10.0):
        self.path = path
        self.delay = max(int(round(100.0 / float(fps))), 1)
        self.n_frames = 0
        self.size: Optional[tuple] = None
        self._f: Optional[BinaryIO] = None

    def append(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame)
        H, W = frame.shape[:2]
        if self.size is None:
            self.size = (H, W)
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._f = open(self.path, "wb")
            # logical screen (no global color table), then the NETSCAPE2.0 loop
            self._f.write(HEADER + struct.pack("<HHBBB", W, H, 0, 0, 0)
                          + b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00")
        elif self.size != (H, W):
            raise ValueError(f"frame {self.n_frames} is {(H, W)}, the first was {self.size}")
        indices, table, bits = palettize(frame)
        self._f.write(b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, self.delay, 0, 0)  # keep it
                      + b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0x80 | (bits - 1))
                      + table.tobytes() + lzw_literal_stream(indices, bits))
        self.n_frames += 1

    def close(self) -> int:
        """Write the trailer and close; returns the number of frames."""
        if self._f is not None:
            self._f.write(TRAILER)
            self._f.close()
            self._f = None
        return self.n_frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def write_gif(path: str, frames: Iterable[np.ndarray], fps: float = 10.0) -> int:
    """Every (H, W, 3) uint8 frame of ``frames`` into an animated GIF at
    ``path``; returns the number of frames."""
    with GifWriter(path, fps) as w:
        for frame in frames:
            w.append(frame)
    return w.n_frames
