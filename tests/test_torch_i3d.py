"""Port of eval/i3d.py (the I3D video embedder of the FVD) against the JAX
package on the CPU.

- The port's ``InceptionI3d`` with numpy-seeded random weights, saved as a
  torch state dict in the reference's ``pytorch_i3d`` layout: the port's
  ``load_i3d_embedder`` and JAX's (which reads the same file through its
  ``import_i3d`` into flax's ``InceptionI3d``) embed the same uint8 videos
  of 16 frames at 96 px, so the network runs at (1, 3, 16, 224, 224).
  Logits within I3D_RTOL of JAX's largest: 2 x 57 SAME convolutions and 13
  SAME max pools in float32, summed in another order.
- The frame resize against ``jax.image.resize(..., "linear")``, growing (96
  -> 224) and shrinking (256 -> 224, where JAX's antialiasing widens the
  kernel).
- Without the weights file, ``load_i3d_embedder`` raises
  ``FileNotFoundError`` and ``get_video_embedder`` falls back to pixel
  statistics, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL
from unified_video_action_tpu.eval import i3d as ji3d
from unified_video_action_tpu_torch.eval import i3d as pi3d
from unified_video_action_tpu_torch.eval import metrics as pmetrics

I3D_RTOL = 1e-4


def seeded_i3d(seed=0):
    """The port's I3D with numpy draws: He-scaled convolutions, BatchNorm
    scales near 1 and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    model = pi3d.InceptionI3d()
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            state[k] = v
        elif k.endswith("conv3d.weight"):
            state[k] = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            state[k] = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("bn.weight"):
            state[k] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            state[k] = 0.1 * rng.standard_normal(shape)
        state[k] = torch.as_tensor(np.asarray(state[k]), dtype=v.dtype)
    model.load_state_dict(state)
    return model


def test_state_dict_is_the_reference_layout():
    sd = pi3d.InceptionI3d().state_dict()
    for key in ("Conv3d_1a_7x7.conv3d.weight", "Conv3d_1a_7x7.bn.running_var",
                "Mixed_3b.b1b.conv3d.weight", "Mixed_5c.b3b.bn.bias", "logits.conv3d.bias"):
        assert key in sd, key
    assert tuple(sd["Conv3d_1a_7x7.conv3d.weight"].shape) == (64, 3, 7, 7, 7)
    assert tuple(sd["logits.conv3d.weight"].shape) == (400, 1024, 1, 1, 1)
    assert "Conv3d_1a_7x7.conv3d.bias" not in sd  # a convolution before BatchNorm has none


def test_embedder_matches_jax(tmp_path):
    path = str(tmp_path / "i3d.pt")
    torch.save(seeded_i3d().state_dict(), path)
    videos = np.random.default_rng(1).integers(0, 256, (1, 16, 96, 96, 3), dtype=np.uint8)
    got = pi3d.load_i3d_embedder(path, device="cpu")(videos)
    want = ji3d.load_i3d_embedder(path)(videos)
    assert got.shape == (1, 400) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=I3D_RTOL, atol=I3D_RTOL * np.abs(want).max())


@pytest.mark.parametrize("size", [96, 256])
def test_resize_matches_jax_linear(size):
    v = np.random.default_rng(size).uniform(0, 1, (1, 2, size, size, 3)).astype(np.float32)
    got = pi3d.resize_frames(torch.tensor(v)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(v), (1, 2, 224, 224, 3), method="linear"))
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_without_weights_the_fvd_takes_pixel_statistics(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        pi3d.load_i3d_embedder(str(tmp_path / "absent.pt"), device="cpu")
    monkeypatch.setenv("I3D_WEIGHTS", str(tmp_path / "absent.pt"))
    assert pmetrics.get_video_embedder(device="cpu") is pmetrics.pixel_embeddings
    videos = np.random.default_rng(2).integers(0, 256, (4, 4, 16, 16, 3), dtype=np.uint8)
    out = pmetrics.video_fvd(videos, videos[::-1])
    assert set(out) == {"video_fvd_pixel"} and np.isfinite(out["video_fvd_pixel"])
