"""Port of utils/language.py (the hash text encoder and get_text_encoder)
and of the policy's goal encoding (policy/policy.py:632-650) against the JAX
package.

The hash encoder must be bit-equal to JAX's: the same sha256 seed, the same
numpy generator and the same float32 normalization. ``get_text_encoder``
gives the JAX function's CLIP token budget (77 for libero, 30 otherwise);
on a host without the CLIP weights (this one, and the card's machine) both
packages encode with the hash encoder.
"""

import numpy as np
import pytest
import torch

from unified_video_action_tpu.utils import language as jax_language
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.utils import language

GOALS = ["open the microwave", "turn on the stove burner", "", "slide the cabinet door",
         "put the kettle on the back burner ☕", "a" * 300]


@pytest.mark.parametrize("goal", GOALS)
def test_hash_encoder_is_bit_equal_to_jax(goal):
    got = language.HashTextEncoder().encode(goal)
    want = jax_language.HashTextEncoder().encode(goal)
    assert got.dtype == np.float32 and got.shape == (1, language.CLIP_DIM)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_hash_encoder_encodes_a_list_row_by_row():
    enc = language.HashTextEncoder()
    got = enc.encode(GOALS)
    np.testing.assert_array_equal(got, jax_language.HashTextEncoder().encode(GOALS))
    for i, goal in enumerate(GOALS):
        np.testing.assert_array_equal(got[i], enc.encode(goal)[0])
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("task,max_length", [("kitchen", 30), ("libero10", 77), ("libero_goal", 77),
                                             ("toolhang", 30), (None, 30)])
def test_get_text_encoder_max_length(task, max_length):
    encoder, got = language.get_text_encoder(task, "clip")
    assert isinstance(encoder, language.HashTextEncoder)
    assert got == max_length == jax_language.get_text_encoder(task, "clip")[1]


def test_no_language_model_gives_no_encoder():
    assert language.get_text_encoder("pusht", None) == (None, None)
    assert jax_language.get_text_encoder("pusht", None) == (None, None)
    with pytest.raises(ValueError, match="bert"):
        language.get_text_encoder("kitchen", "bert")


def _kitchen_policy():
    from tests._torch_parity import TINY_POLICY_KW

    kw = dict(TINY_POLICY_KW, task_name="kitchen", shape_meta={"action": {"shape": [9]}})
    return UnifiedVideoActionPolicy(**kw, language_emb_model="clip", device="cpu")


def test_goal_encoding_tiles_one_goal_over_the_batch():
    policy = _kitchen_policy()
    assert isinstance(policy.text_encoder, language.HashTextEncoder) and policy.max_length == 30
    one = policy._encode_language_goal("open the microwave", batch=5)
    assert one.shape == (5, 512) and one.dtype == torch.float32
    want = language.HashTextEncoder().encode("open the microwave")[0]
    for row in one:
        np.testing.assert_array_equal(row.numpy(), want)
    # one goal per sample is kept as it is
    many = policy._encode_language_goal(["a", "b", "c"], batch=3)
    np.testing.assert_array_equal(many.numpy(), language.HashTextEncoder().encode(["a", "b", "c"]))
    # precomputed latents pass through, and a single row is tiled
    lat = np.random.default_rng(0).standard_normal((1, 512)).astype(np.float32)
    np.testing.assert_array_equal(policy._encode_language_goal(lat, batch=4).numpy(),
                                  np.repeat(lat, 4, axis=0))
    assert policy._encode_language_goal(None, batch=4) is None


def test_a_policy_without_language_ignores_the_goal():
    from tests._torch_parity import TINY_POLICY_KW

    policy = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="cpu")
    assert policy.text_encoder is None
    assert policy._encode_language_goal("open the microwave", batch=2) is None
