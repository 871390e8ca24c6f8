"""The port's weight bridge (convert.py): layout changes, strictness, the
flat .npz loader, and key and shape coverage of the committed flagship's
parameter trees (mar_base at 96 px with its KL-16 VAE).

The flagship check needs no weights: the JAX trees come from
``jax.eval_shape`` of the JAX policy's init, the port's from modules built on
the ``meta`` device, and the leaf names are checked against the orbax
checkpoint's own metadata file.
"""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.models.transformer import QuantLinear
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest")


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 5)
        self.conv = nn.Conv2d(2, 4, 3)
        self.ln = nn.LayerNorm(5)
        self.gn = nn.GroupNorm(2, 4)
        self.pos = nn.Parameter(torch.zeros(1, 7, 5))


def _tiny_tree(rng):
    return {
        "fc": {"kernel": rng.standard_normal((3, 5)), "bias": rng.standard_normal(5)},
        "conv": {"kernel": rng.standard_normal((3, 3, 2, 4)), "bias": rng.standard_normal(4)},
        "ln": {"scale": rng.standard_normal(5), "bias": rng.standard_normal(5)},
        "gn": {"scale": rng.standard_normal(4), "bias": rng.standard_normal(4)},
        "pos": rng.standard_normal((1, 7, 5)),
    }


def test_layout_changes():
    rng = np.random.default_rng(0)
    tree = _tiny_tree(rng)
    m = convert.load_into(_Tiny(), tree)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    f32 = lambda a: np.asarray(a, np.float32)
    np.testing.assert_array_equal(sd["fc.weight"], f32(tree["fc"]["kernel"]).T)
    np.testing.assert_array_equal(sd["conv.weight"], f32(tree["conv"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["ln.weight"], f32(tree["ln"]["scale"]))
    np.testing.assert_array_equal(sd["gn.weight"], f32(tree["gn"]["scale"]))
    np.testing.assert_array_equal(sd["pos"], f32(tree["pos"]))


def test_layout_changes_keep_the_function():
    # flax Dense and Conv (NHWC, VALID padding) against the port's layers
    import jax.numpy as jnp
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    tree = _tiny_tree(rng)
    m = convert.load_into(_Tiny(), tree)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    want = fnn.Dense(5).apply({"params": tree["fc"]}, jnp.asarray(x))
    np.testing.assert_allclose(m.fc(torch.tensor(x)).detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    img = rng.standard_normal((1, 6, 6, 2)).astype(np.float32)  # NHWC
    want = fnn.Conv(4, (3, 3), padding="VALID").apply({"params": tree["conv"]}, jnp.asarray(img))
    got = m.conv(torch.tensor(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unmapped_leaf_raises():
    tree = _tiny_tree(np.random.default_rng(2))
    tree["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="1 flax leaves unmapped"):
        convert.load_into(_Tiny(), tree)
    convert.load_into(_Tiny(), tree, skip=(("extra",),))


def test_unset_parameter_raises():
    tree = _tiny_tree(np.random.default_rng(3))
    del tree["gn"]["bias"]
    with pytest.raises(ValueError, match="1 port parameters unset"):
        convert.load_into(_Tiny(), tree)


def test_shape_mismatch_raises():
    tree = _tiny_tree(np.random.default_rng(4))
    tree["fc"]["kernel"] = np.zeros((5, 3))
    with pytest.raises(ValueError, match="fc/kernel"):
        convert.load_into(_Tiny(), tree)


def test_load_flat_npz(tmp_path):
    rng = np.random.default_rng(5)
    flat = {"encoder/conv_in/kernel": rng.standard_normal((3, 3, 3, 4)),
            "encoder/conv_in/bias": rng.standard_normal(4),
            "quant_conv/kernel": rng.standard_normal((4, 4))}
    np.savez(tmp_path / "vae.npz", **flat)
    tree = convert.load_flat_npz(str(tmp_path / "vae.npz"))
    assert set(tree) == {"encoder", "quant_conv"}
    np.testing.assert_array_equal(tree["encoder"]["conv_in"]["kernel"], flat["encoder/conv_in/kernel"])
    assert convert.flatten_tree(tree).keys() == {tuple(k.split("/")) for k in flat}


def test_seeded_tree_is_the_inverse_layout():
    m = _Tiny()
    tree = convert.seeded_tree(m, seed=0)
    assert convert.flatten_tree(tree).keys() == convert.flax_layout_shapes(m).keys()
    convert.load_into(m, tree)
    again = convert.seeded_tree(_Tiny(), seed=0)
    for path, v in convert.flatten_tree(tree).items():
        np.testing.assert_array_equal(v, convert.flatten_tree(again)[path])


def test_to_flax_tree_is_the_inverse_of_load_into():
    m = convert.load_into(_Tiny(), _tiny_tree(np.random.default_rng(4)))
    back = convert.to_flax_tree(m)
    again = convert.load_into(_Tiny(), back)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert {p: v.shape for p, v in convert.flatten_tree(back).items()} == \
        convert.flax_layout_shapes(m)
    with pytest.raises(ValueError, match="QuantLinear"):
        convert.to_flax_tree(_TinyQuant())


@pytest.fixture(scope="module")
def flagship_shapes():
    with open(os.path.join(FLAGSHIP, "meta.json")) as f:
        cfg = json.load(f)["cfg"]
    kw = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
    kw["autoregressive_model_params"] = dict(kw["autoregressive_model_params"], pretrained_model_path=None)
    kw["vae_model_params"] = dict(kw["vae_model_params"], autoencoder_path=None)
    jp = JaxPolicy(**kw, task_name=cfg["task"]["name"])
    shapes = jax.eval_shape(jp.init_params, jax.random.PRNGKey(0))
    return {k: {p: tuple(s.shape) for p, s in convert.flatten_tree(shapes[k]).items()}
            for k in ("mar", "vae")}


def _checkpoint_leaves(group):
    with open(os.path.join(FLAGSHIP, "state", "_METADATA")) as f:
        keys = json.load(f)["tree_metadata"]
    paths = [ast.literal_eval(k) for k in keys]
    return {p[1:] for p in paths if p[0] == group}


def test_flagship_tree_is_the_checkpoints(flagship_shapes):
    assert set(flagship_shapes["mar"]) == _checkpoint_leaves("ema_params")
    assert set(flagship_shapes["vae"]) == _checkpoint_leaves("vae_params")
    assert len(flagship_shapes["mar"]) == 444 and len(flagship_shapes["vae"]) == 292


def test_flagship_maps_onto_the_port(flagship_shapes):
    policy = UnifiedVideoActionPolicy.from_run_config(
        os.path.join(FLAGSHIP, "meta.json"), device="meta"
    )
    mar_plan = convert.plan(flagship_shapes["mar"], convert.module_shapes(policy.mar))
    vae_plan = convert.plan(flagship_shapes["vae"], convert.module_shapes(policy.vae))
    n_mar = sum(int(np.prod(flagship_shapes["mar"][p])) for p, _ in mar_plan.values())
    assert len(mar_plan) == len(policy.mar.state_dict())
    assert len(vae_plan) == len(policy.vae.state_dict())
    # every MAR leaf lands, the video head's too, and every VAE leaf, the decoder's too
    assert len(mar_plan) == 444
    assert convert.flax_layout_shapes(policy.mar) == flagship_shapes["mar"]
    assert n_mar > 200_000_000


class _TinyQuant(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = QuantLinear(64, 48)
        self.ln = nn.LayerNorm(48)


def test_quant_kernels_are_quantized_from_fp32_before_the_cast():
    # JAX's QuantDense quantizes its fp32 parameter inside the program, so
    # the bridge quantizes the fp32 value even into a model already cast to
    # bf16 (the policy casts in its constructor, before load_params)
    import jax.numpy as jnp

    from unified_video_action_tpu.ops.quant import quantize_weight

    rng = np.random.default_rng(6)
    tree = {"fc": {"kernel": rng.standard_normal((64, 48)).astype(np.float32),
                   "bias": rng.standard_normal(48).astype(np.float32)},
            "ln": {"scale": rng.standard_normal(48), "bias": rng.standard_normal(48)}}
    m = convert.load_into(_TinyQuant().to(torch.bfloat16), tree)
    want = jax.jit(quantize_weight)(jnp.asarray(tree["fc"]["kernel"]))
    np.testing.assert_array_equal(m.fc.weight_q.numpy(), np.asarray(want["kernel_q"]).T)
    assert m.fc.w_scale.dtype == m.fc.bias.dtype == torch.float32
    np.testing.assert_array_equal(m.fc.w_scale.numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(m.fc.bias.numpy(), tree["fc"]["bias"])
    cast_first = jax.jit(quantize_weight)(jnp.asarray(tree["fc"]["kernel"]).astype(jnp.bfloat16))
    assert not np.array_equal(np.asarray(cast_first["scale"]), np.asarray(want["scale"]))


def test_quant_layout_is_the_float_one():
    m = _TinyQuant()
    assert convert.flax_layout_shapes(m) == {("fc", "kernel"): (64, 48), ("fc", "bias"): (48,),
                                             ("ln", "scale"): (48,), ("ln", "bias"): (48,)}
    tree = convert.seeded_tree(m, seed=1)
    convert.load_into(m, tree)
    with pytest.raises(ValueError, match="fc/kernel"):
        bad = convert.seeded_tree(m, seed=1)
        bad["fc"]["kernel"] = np.zeros((48, 64), np.float32)
        convert.load_into(m, bad)


def test_flagship_maps_onto_the_int8_port(flagship_shapes):
    policy = UnifiedVideoActionPolicy.from_run_config(
        os.path.join(FLAGSHIP, "meta.json"), device="meta", serving_quant="int8"
    )
    mar_plan = convert.plan(flagship_shapes["mar"], convert.module_shapes(policy.mar))
    assert len(mar_plan) == len(policy.mar.state_dict())
    n_quant = sum(1 for _, change in mar_plan.values() if change == "quant")
    # the stacks, and both denoisers (the video head's and the action head's)
    assert n_quant == 24 * 4 + 2 * (6 * 3 + 3)
    # one fp32 kernel leaf sets both the int8 weight and its scales
    assert len({path for path, _ in mar_plan.values()}) == len(mar_plan) - n_quant
