"""The port's CLIP text tower (``models/clip.py``) and ``ClipTextEncoder``
(``utils/language.py``) against the JAX package's ``ClipTextModel``, on the
CPU: the tower at two layers of width 64 (4 heads, vocabulary 300, 16
positions, projection 32) on numpy-drawn weights in the flax layout through
the weight bridge, fp32, within FP32_TOL of JAX's, on token rows whose
end-of-text token sits at several positions, twice in a row (pooled at the
first) and nowhere (pooled at position 0). The causal mask holds: tokens
after the pooled one do not move the output; one before it does. ``get_text_encoder`` picks the
tower when it is given weights and the hash encoder otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import FP32_TOL, init_shapes, random_params, to_numpy
from unified_video_action_tpu.models import clip as jclip
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models import clip as pclip
from unified_video_action_tpu_torch.utils.language import (
    ClipTextEncoder,
    HashTextEncoder,
    get_text_encoder,
)

SIZE = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            max_position_embeddings=16, projection_dim=32, eos_token_id=299)
N = 16


def _ids():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 299, (5, N))
    ids[0, 5] = 299  # eos at 5
    ids[1, N - 1] = 299  # eos at the end
    ids[2, [3, 9]] = 299  # twice: pooled at the first
    ids[4, 0] = 299  # eos first
    return ids  # row 3: no eos, pooled at position 0


@pytest.fixture(scope="module")
def tower():
    module = jclip.ClipTextModel(jclip.ClipTextConfig(**SIZE))
    ids = jnp.asarray(_ids(), jnp.int32)
    params = to_numpy(random_params(init_shapes(module, ids), seed=3))
    return module, params


def test_clip_tower_equals_jax(tower):
    module, params = tower
    ids = _ids()
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    port = convert.load_into(pclip.ClipTextModel(pclip.ClipTextConfig(**SIZE)), params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    # causal: what follows the pooled token does not move it
    later = ids.copy()
    later[0, 6:] = (later[0, 6:] + 7) % 299
    later[2, 4:9] = 1
    with torch.no_grad():
        moved = port(torch.from_numpy(later)).numpy()
    np.testing.assert_allclose(moved[[0, 2]], got[[0, 2]], **FP32_TOL)
    # ... and what precedes it does
    earlier = ids.copy()
    earlier[0, 2] = (earlier[0, 2] + 7) % 299
    with torch.no_grad():
        assert np.abs(port(torch.from_numpy(earlier)).numpy()[0] - got[0]).max() > 1e-3


def test_encoder_and_get_text_encoder(tower):
    module, params = tower
    cfg = pclip.ClipTextConfig(**SIZE)
    enc, max_length = get_text_encoder("libero10", "clip", params, cfg=cfg, device="cpu")
    assert isinstance(enc, ClipTextEncoder) and max_length == 77 == enc.max_length
    ids = _ids()
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(enc.encode_ids(ids), want, **FP32_TOL)
    with pytest.raises(NotImplementedError, match="vocab.json"):
        enc.encode("open the drawer")
    enc, max_length = get_text_encoder("kitchen", "clip")
    assert isinstance(enc, HashTextEncoder) and max_length == 30
    assert get_text_encoder("pusht", None) == (None, None)
