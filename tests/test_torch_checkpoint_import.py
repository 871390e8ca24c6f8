"""The reference's torch checkpoints read by the port
(``models/torch_import.py`` and the policy's ``.ckpt`` routes) against the
JAX package's ``torch_import``, on the CPU.

Reference-layout state dicts are made by ``tests/_torch_reference_layout.py``
(the inverse of the importers' maps) from seeded flax-layout trees at small
widths:

- the VAE, the MAR (the pusht, UMI and tool-hang stream sets: history
  actions, state, text, the wrist video head, the proprioception head), the
  denoiser and the CLIP text tower: the port's importer gives JAX's tree
  leaf for leaf, and the port's modules loaded from either tree (through
  ``convert``) hold the same parameters, bit-equal;
- the action head's three other pool layouts (conv_ori, conv2, fc2) as JAX
  imports them;
- ``load_torch_checkpoint`` reads a payload whose config class cannot be
  imported (a plain ``torch.load`` cannot), the tensors unchanged;
- the policy's routes: ``autoencoder_path`` a ``kl16.ckpt``,
  ``pretrained_model_path`` the framework's checkpoint
  (``state_dicts.ema_model`` under ``model.``) or the MAR release
  (``model_ema``): the same parameters as JAX's policy loaded from the same
  files, the same ``predict_action`` under JAX's draws, and the import's
  counts; a size mismatch kept at init and counted as JAX counts it.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from tests import _torch_reference_layout as reference
from tests._torch_parity import TINY_POLICY_KW, policy_draws, random_params, to_numpy
from tests.test_torch_umi_policy import TOOLHANG_KW, UMI_KW
from unified_video_action_tpu.data.normalizer import LinearNormalizer as JaxNormalizer
from unified_video_action_tpu.models import torch_import as jti
from unified_video_action_tpu.policy.policy import UnifiedVideoActionPolicy as JaxPolicy
from unified_video_action_tpu_torch import convert
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
from unified_video_action_tpu_torch.models import torch_import as pti
from unified_video_action_tpu_torch.models.clip import ClipTextConfig, ClipTextModel
from unified_video_action_tpu_torch.models.denoiser import MlpDenoiser
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMALIZER = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest", "normalizer.npz")
NORMALIZED_ATOL = 1e-4
CLIP = ClipTextConfig(vocab_size=99, hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=2, max_position_embeddings=16, projection_dim=24)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    g, w = convert.flatten_tree(got), convert.flatten_tree(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:5]
    for p in w:
        assert np.asarray(g[p]).dtype == np.asarray(w[p]).dtype, p
        np.testing.assert_array_equal(g[p], w[p], err_msg="/".join(p))


def _assert_same_module(module, tree_a, tree_b):
    a = copy.deepcopy(module)
    convert.load_into(module, tree_a)
    convert.load_into(a, tree_b)
    sa, sb = module.state_dict(), a.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _policy_kw(case):
    return {"pusht": TINY_POLICY_KW, "umi": dict(UMI_KW, use_history_action=True),
            "toolhang": TOOLHANG_KW}[case]


@pytest.mark.parametrize("case", ["pusht", "umi", "toolhang"])
def test_mar_and_vae_importers_match_jax(case):
    port = UnifiedVideoActionPolicy(**_policy_kw(case), device="cpu")
    c = port.mar_cfg
    depths = dict(encoder_depth=c.encoder_depth, decoder_depth=c.decoder_depth,
                  diffloss_depth=c.diffloss_d, diffloss_act_depth=c.diffloss_act_d)
    tree = convert.seeded_tree(port.mar, 7)
    sd = _numpy_sd(reference.reference_state_dict("mar", tree))
    got, want = pti.import_mar(sd, **depths), jti.import_mar(sd, **depths)
    _assert_same_tree(got, want)
    _assert_same_tree(got, tree)  # every leaf of the MAR has its reference key
    _assert_same_module(port.mar, got, want)
    vae = convert.seeded_tree(port.vae, 8)
    sd = _numpy_sd(reference.reference_state_dict("vae", vae))
    for geometry in ({}, {"ch_mult": (1, 1, 2, 2), "resolution": 32}):
        got, want = pti.import_kl_vae(sd, **geometry), jti.import_kl_vae(sd, **geometry)
        _assert_same_tree(got, want)
    _assert_same_tree(got, vae)  # in the model's own geometry: every leaf
    _assert_same_module(port.vae, got, want)


def test_denoiser_and_clip_importers_match_jax():
    den = MlpDenoiser(in_channels=8, model_channels=32, out_channels=16, z_channels=64, depth=3)
    tree = convert.seeded_tree(den, 3)
    sd = _numpy_sd(reference.reference_state_dict("denoiser", tree))
    for prefix in ("", "diffloss.net."):
        psd = {prefix + k: v for k, v in sd.items()}
        got, want = pti.import_mlp_denoiser(psd, 3, prefix), jti.import_mlp_denoiser(psd, 3, prefix)
        _assert_same_tree(got, want)
        _assert_same_tree(got, tree)
    _assert_same_module(den, got, want)
    clip = ClipTextModel(CLIP)
    tree = convert.seeded_tree(clip, 4)
    sd = _numpy_sd(reference.reference_state_dict("clip", tree))
    assert sd["text_projection.weight"].shape == (CLIP.projection_dim, CLIP.hidden_size)
    got, want = pti.import_clip_text(sd, CLIP.num_layers), jti.import_clip_text(sd, CLIP.num_layers)
    _assert_same_tree(got, want)
    _assert_same_tree(got, tree)
    _assert_same_module(clip, got, want)


@pytest.mark.parametrize("pool", ["conv_ori", "conv2", "fc2", "conv_fc"])
def test_action_head_pool_layouts_match_jax(pool):
    rng = np.random.default_rng(5)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = "diffactloss."
    sd = {p + "net.input_proj.weight": r(32, 8), p + "net.input_proj.bias": r(32),
          p + "net.res_blocks.0.in_ln.weight": r(32), p + "net.final_layer.linear.weight": r(8, 32)}
    sd.update({"conv_ori": {p + "conv_transpose3d.weight": r(6, 4, 2, 3, 3),
                            p + "conv_transpose3d.bias": r(4)},
               "conv2": {p + "conv.0.weight": r(8, 6, 3), p + "conv.0.bias": r(8),
                         p + "conv.2.weight": r(4, 8, 3)},
               "fc2": {p + "fc.0.weight": r(16, 12), p + "fc.0.bias": r(16),
                       p + "fc.2.weight": r(4, 16), p + "fc.2.bias": r(4)},
               "conv_fc": {p + "conv.0.weight": r(8, 6, 3, 3), p + "conv.0.bias": r(8),
                           p + "fc.0.weight": r(16, 12), p + "fc.2.weight": r(4, 16),
                           p + "interpolate.weight": r(5, 4), p + "refine.0.weight": r(5, 5),
                           p + "refine.2.weight": r(5, 5), p + "refine.2.bias": r(5)}}[pool])
    got, want = pti.import_mar(sd, diffloss_act_depth=1), jti.import_mar(sd, diffloss_act_depth=1)
    _assert_same_tree(got, want)
    assert set(got["diffactloss"]["pool"]) and set(got["diffactloss"]["net"])


def test_load_torch_checkpoint_stands_in_unimportable_classes(tmp_path):
    port = UnifiedVideoActionPolicy(**TINY_POLICY_KW, device="meta")
    tree = convert.seeded_tree(port.mar, 1)
    path = str(tmp_path / "latest.ckpt")
    sd = reference.write_mar_checkpoint(path, tree)
    with pytest.raises(ModuleNotFoundError, match=reference.STANDIN_MODULE):
        torch.load(path, map_location="cpu", weights_only=False)
    got, want = pti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert got["cfg"].__dict__["_content"] == want["cfg"].__dict__["_content"] == {
        "name": "uva", "task": "umi_multi"}
    with pytest.raises(AttributeError):
        got["cfg"].missing  # noqa: B018  (an inert stand-in)
    ema = got["state_dicts"]["ema_model"]
    assert ema.keys() == want["state_dicts"]["ema_model"].keys()
    assert "normalizer.params_dict.action.scale" in ema
    mar = pti.mar_state_dict(got)
    assert mar.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(mar[k], v) and torch.equal(ema["model." + k], v)
    assert pti.mar_state_dict({"model_ema": sd}).keys() == sd.keys()
    with pytest.raises(ValueError, match="unrecognized checkpoint format"):
        pti.mar_state_dict({"state_dict": sd})


def _jax_policy(kw, params):
    """JAX's policy loaded from the checkpoints ``kw`` names, on ``params``."""
    jp = JaxPolicy(**kw)
    jp.set_normalizer(JaxNormalizer.load(NORMALIZER))
    return jp, to_numpy(jp.load_pretrained(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("layout", ["state_dicts", "model_ema"])
def test_policy_ckpt_routes_match_jax(tmp_path, layout):
    kw = copy.deepcopy(TINY_POLICY_KW)
    kw["autoregressive_model_params"]["act_diff_testing_steps"] = "ddim10"
    meta = UnifiedVideoActionPolicy(**kw, device="meta")
    trees = {"mar": convert.seeded_tree(meta.mar, 11), "vae": convert.seeded_tree(meta.vae, 12)}
    mar_path, vae_path = str(tmp_path / "latest.ckpt"), str(tmp_path / "kl16.ckpt")
    if layout == "state_dicts":
        reference.write_mar_checkpoint(mar_path, trees["mar"])
    else:
        torch.save({"model_ema": reference.reference_state_dict("mar", trees["mar"]), "epoch": 3},
                   mar_path)
    reference.write_vae_checkpoint(vae_path, trees["vae"])
    kw["autoregressive_model_params"]["pretrained_model_path"] = mar_path
    kw["vae_model_params"] = dict(kw["vae_model_params"], autoencoder_path=vae_path)

    jp = JaxPolicy(**kw)
    init = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=2)
    jp, params = _jax_policy(kw, init)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    # the leaves neither file sets (the VAE's attention at this width's 16 px
    # level: the kl16 geometry has it at level 4) keep JAX's init
    port.load_params(to_numpy(init["mar"]), to_numpy(init["vae"]))
    port.init_params(0)
    port.set_normalizer(LinearNormalizer.load(NORMALIZER))
    _assert_same_tree(convert.to_flax_tree(port.mar), params["mar"])
    _assert_same_tree(port.vae_tree, params["vae"])
    _assert_same_tree(convert.to_flax_tree(port.mar), trees["mar"])
    vae = convert.flatten_tree(port.vae_tree)
    kept = [p for p, v in convert.flatten_tree(trees["vae"]).items() if not np.array_equal(vae[p], v)]
    assert kept and {p[1] for p in kept} == {"down_1_attn_0", "down_1_attn_1"}
    assert port._last_mar_import_skipped == jp._last_mar_import_skipped == 0
    assert port._last_mar_import_kept_at_init == 0

    B = 2
    obs = {"image": np.random.default_rng(3).random((B, 16, 3, 32, 32)).astype(np.float32)}
    key = jax.random.PRNGKey(4)
    want = jp.predict_action(params, obs, key)
    got = port.predict_action(obs, noise=policy_draws(key, port.noise_shapes(B)))
    scale = float(port.normalizer["action"].scale.min())
    np.testing.assert_allclose(got["action_pred"], want["action_pred"], rtol=1e-5,
                               atol=NORMALIZED_ATOL / scale)


def test_policy_ckpt_size_mismatch_kept_at_init_as_jax_counts(tmp_path):
    """A checkpoint of a wider action head: the mismatched leaves are left
    out and counted as JAX counts them; the rest load."""
    kw = copy.deepcopy(TINY_POLICY_KW)
    meta = UnifiedVideoActionPolicy(**kw, device="meta")
    tree = convert.seeded_tree(meta.mar, 5)
    tree["diffactloss"]["net"]["input_proj"]["kernel"] = np.ones((3, 32), np.float32)
    path = str(tmp_path / "wide.ckpt")
    reference.write_mar_checkpoint(path, tree)
    kw["autoregressive_model_params"]["pretrained_model_path"] = path
    jp = JaxPolicy(**kw)
    init = random_params(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)), seed=6)
    jp, params = _jax_policy(kw, init)
    port = UnifiedVideoActionPolicy(**kw, device="cpu")
    port.load_params(to_numpy(init["mar"]), to_numpy(init["vae"]))
    port.load_pretrained(path)
    assert port._last_mar_import_skipped == jp._last_mar_import_skipped == 1
    assert port._last_mar_import_kept_at_init == 1
    _assert_same_tree(convert.to_flax_tree(port.mar), params["mar"])
