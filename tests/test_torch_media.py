"""The port's media writing on the CPU: ``utils/media.py``'s GIF writer
decoded by PIL, ``envs/video_recording.py`` against the JAX package's
wrapper, and ``eval/offline.save_video_grid``'s ``real_vs_pred.gif``.

- The GIF writer: frames of 1 to 256 colors decode to themselves (exact),
  frames of more colors to the fixed 3-3-2 palette's nearest levels (the
  bound its docstring states); ``GIF89a``, the frame count, the delay, the
  loop and the trailer; the LZW clear cadence at every table width.
- ``VideoRecordingWrapper(PushTImageEnv)`` and JAX's over the same seeded
  steps: the frames each writes (JAX's recorder fed through its
  ``write_frame``) equal, and the port's GIF decodes to them; ``.mp4``
  becomes ``.gif``; ``steps_per_render``.
- ``save_video_grid``: the GIF decodes to the PNG frames' grid.
"""

import os

import numpy as np
import pytest
from PIL import Image

from tests import _torch_threads  # noqa: F401  (torch's threads: one share of the cores a worker)
from unified_video_action_tpu.envs import video_recording as jvr
from unified_video_action_tpu.envs.pusht import PushTImageEnv as JaxImageEnv
from unified_video_action_tpu_torch.envs import video_recording as pvr
from unified_video_action_tpu_torch.envs.pusht import PushTImageEnv
from unified_video_action_tpu_torch.eval import offline as poffline
from unified_video_action_tpu_torch.utils import media

# the fixed palette's worst channel errors: half a level step
FIXED_PALETTE_ATOL = (18, 18, 42)


def read_gif(path):
    im = Image.open(path)
    frames = []
    for t in range(im.n_frames):
        im.seek(t)
        frames.append(np.array(im.convert("RGB")))
    return frames, im.info


@pytest.mark.parametrize("n_colors", [1, 3, 4, 5, 28, 200, 256, 257, 900])
def test_gif_frames_decode_with_pil(tmp_path, n_colors):
    rng = np.random.default_rng(n_colors)
    palette = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
    frames = [palette[rng.integers(0, n_colors, (23, 41))] for _ in range(3)]
    for f in frames:
        f.reshape(-1, 3)[:n_colors] = palette  # every color present
    path = str(tmp_path / "a.gif")
    assert media.write_gif(path, frames, fps=10) == 3
    raw = open(path, "rb").read()
    assert raw[:6] == b"GIF89a" and raw[-1:] == b"\x3b"
    got, info = read_gif(path)
    assert len(got) == 3 and info["duration"] == 100 and info["loop"] == 0
    for g, f in zip(got, frames):
        if n_colors <= 256:
            np.testing.assert_array_equal(g, f)
        else:
            assert (np.abs(g.astype(int) - f) <= FIXED_PALETTE_ATOL).all()
            np.testing.assert_array_equal(g, media.FIXED_PALETTE[media.palettize(f)[0]])


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_lzw_clears_before_the_table_grows(bits):
    n = 3 * ((1 << bits) - 2) + 1
    stream = media.lzw_literal_stream(np.zeros(n, np.int64), bits)
    assert stream[0] == bits and stream[-1] == 0
    data, i = b"", 1
    while stream[i]:
        data += stream[i + 1: i + 1 + stream[i]]
        i += 1 + stream[i]
    width = bits + 1
    bitstream = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    codes = bitstream[: (len(bitstream) // width) * width].reshape(-1, width) @ (1 << np.arange(width))
    clear = 1 << bits
    assert list(np.flatnonzero(codes[: n + 5] == clear)) == [0, (1 << bits) - 1, 2 * ((1 << bits) - 1),
                                                             3 * ((1 << bits) - 1)]
    assert codes[n + 4] == clear + 1  # end of information


def test_gif_writer_refuses_a_new_size_and_writes_no_empty_file(tmp_path):
    w = media.GifWriter(str(tmp_path / "x.gif"))
    assert w.close() == 0 and not os.path.exists(tmp_path / "x.gif")
    w = media.GifWriter(str(tmp_path / "y.gif"))
    w.append(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="first was"):
        w.append(np.zeros((4, 5, 3), np.uint8))
    assert w.close() == 1


class _FrameLog:
    """JAX's recorder, keeping the frames its wrapper writes."""

    def __init__(self, recorder):
        self.recorder, self.frames = recorder, []
        write = recorder.write_frame
        recorder.write_frame = lambda f: (self.frames.append(np.asarray(f).copy()), write(f))


@pytest.mark.parametrize("steps_per_render", [1, 2])
def test_video_recording_wrapper_matches_jax(tmp_path, steps_per_render):
    jrec = jvr.VideoRecorder(fps=10)
    jlog = _FrameLog(jrec)
    jenv = jvr.VideoRecordingWrapper(JaxImageEnv(), jrec, file_path=str(tmp_path / "jax.gif"),
                                     steps_per_render=steps_per_render)
    penv = pvr.VideoRecordingWrapper(PushTImageEnv(), pvr.VideoRecorder(fps=10),
                                     file_path=str(tmp_path / "port.mp4"),
                                     steps_per_render=steps_per_render)
    plog = _FrameLog(penv.video_recorder)
    for env in (jenv, penv):
        env.seed(9)
        env.reset()
    for a in np.random.default_rng(9).uniform(0, 512, (7, 2)):
        jenv.step(a)
        penv.step(a)
    path = penv.stop_recording()
    jenv.stop_recording()
    assert path == str(tmp_path / "port.gif") and not os.path.exists(tmp_path / "port.mp4")
    # the reset's frame, then every steps_per_render-th of the step counts 2..8
    assert len(plog.frames) == len(jlog.frames) == {1: 8, 2: 5}[steps_per_render]
    for got, want in zip(plog.frames, jlog.frames):
        np.testing.assert_array_equal(got, want)
    decoded, _ = read_gif(path)
    assert len(decoded) == len(plog.frames)
    for got, want in zip(decoded, plog.frames):
        np.testing.assert_array_equal(got, want)
    assert penv.render_size == 96  # other attributes reach the env
    assert penv.stop_recording() is None


def test_save_video_grid_gif_decodes_to_the_grid(tmp_path):
    rng = np.random.default_rng(2)
    palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    videos = palette[rng.integers(0, 40, (5, 3, 8, 6))]
    poffline.save_video_grid(videos, str(tmp_path / "grid"), fps=5)
    frames, info = read_gif(tmp_path / "grid.gif")
    assert len(frames) == 3 and info["duration"] == 200
    for t, frame in enumerate(frames):
        assert frame.shape == (2 * 8, 3 * 6, 3)
        for b in range(5):
            r, c = divmod(b, 3)
            np.testing.assert_array_equal(frame[r * 8:(r + 1) * 8, c * 6:(c + 1) * 6], videos[b, t])
        assert not frame[8:, 12:].any()
