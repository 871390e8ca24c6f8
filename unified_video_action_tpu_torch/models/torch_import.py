"""The reference's torch checkpoints read into the port (the port's own copy
of ``models/torch_import.py``).

The reference ships its weights as torch state dicts: the KL-16 VAE's
``kl16.ckpt``, the MAR release (``model_ema``) and the framework's own
checkpoints (``state_dicts.ema_model``, keys under ``model.``). The
importers here turn such a state dict, as numpy arrays, into the flax tree
that the JAX package's importers make, key for key; ``convert.load_into``
puts that tree into the port's modules, as it does every tree of the JAX
package. The conventions:

* ``nn.Linear.weight`` (out, in)   -> Dense ``kernel`` (in, out)
* ``nn.Conv2d.weight`` (O, I, H, W) -> Conv ``kernel`` (H, W, I, O); a 1x1
  convolution -> Dense ``kernel`` (I, O)
* norm ``weight`` / ``bias``        -> ``scale`` / ``bias``

Only the keys present are emitted: a partial state dict (the MAR release
has no action head) gives a partial tree, merged onto the model's own by
``convert.merge_params`` where the shapes match. :func:`load_torch_checkpoint`
reads a checkpoint whose pickled config names classes that are not
installed (``omegaconf``, ``hydra``, ``dill`` payloads): they come back as
inert stand-ins, the tensors as they were.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _set(tree: dict, path: tuple, value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def assign_module(tree: dict, flax_path: tuple, torch_prefix: str, sd: Mapping[str, np.ndarray],
                  kind: str) -> None:
    """One torch leaf module (``kind``: linear, conv, norm or raw) into the
    tree, where its keys are present."""
    w, b = sd.get(torch_prefix + ".weight"), sd.get(torch_prefix + ".bias")
    if kind == "raw":
        if w is not None:
            _set(tree, flax_path, w)
        return
    if kind not in ("linear", "conv", "norm"):
        raise ValueError(kind)
    if w is not None:
        if kind == "norm":
            _set(tree, flax_path + ("scale",), w)
        elif kind == "linear":
            _set(tree, flax_path + ("kernel",), linear_kernel(w))
        elif w.ndim == 4 and w.shape[2:] == (1, 1):
            _set(tree, flax_path + ("kernel",), linear_kernel(w[:, :, 0, 0]))
        else:
            _set(tree, flax_path + ("kernel",), conv_kernel(w))
    if b is not None:
        _set(tree, flax_path + ("bias",), b)


# -- the denoiser (the reference's SimpleMLPAdaLN) ---------------------------

def import_mlp_denoiser(sd: Mapping[str, np.ndarray], depth: int, prefix: str = "") -> dict:
    tree: dict = {}
    p = prefix
    for flax_path, torch_name in [(("input_proj",), "input_proj"), (("cond_embed",), "cond_embed"),
                                  (("time_embed", "fc1"), "time_embed.mlp.0"),
                                  (("time_embed", "fc2"), "time_embed.mlp.2")]:
        assign_module(tree, flax_path, p + torch_name, sd, "linear")
    for i in range(depth):
        rb = f"{p}res_blocks.{i}."
        assign_module(tree, (f"block_{i}", "ln"), rb + "in_ln", sd, "norm")
        for name, torch_name in (("fc1", "mlp.0"), ("fc2", "mlp.2"),
                                 ("ada_mod", "adaLN_modulation.1")):
            assign_module(tree, (f"block_{i}", name), rb + torch_name, sd, "linear")
    assign_module(tree, ("final", "ada_mod"), p + "final_layer.adaLN_modulation.1", sd, "linear")
    assign_module(tree, ("final", "proj"), p + "final_layer.linear", sd, "linear")
    return tree


# -- the KL VAE (the reference's vaekl.py) -----------------------------------

def _import_resnet_block(tree, path, tp, sd):
    for name in ("norm1", "norm2"):
        assign_module(tree, path + (name,), f"{tp}.{name}", sd, "norm")
    for name in ("conv1", "conv2"):
        assign_module(tree, path + (name,), f"{tp}.{name}", sd, "conv")
    if tp + ".nin_shortcut.weight" in sd:
        assign_module(tree, path + ("shortcut",), tp + ".nin_shortcut", sd, "conv")


def _import_attn_block(tree, path, tp, sd):
    assign_module(tree, path + ("norm",), tp + ".norm", sd, "norm")
    for name in ("q", "k", "v", "proj_out"):
        assign_module(tree, path + (name,), f"{tp}.{name}", sd, "conv")


def import_kl_vae(sd: Mapping[str, np.ndarray], ch_mult=(1, 1, 2, 2, 4), num_res_blocks: int = 2,
                  resolution: int = 256, attn_resolutions=(16,)) -> dict:
    """An AutoencoderKL state dict (``encoder.*``, ``decoder.*``,
    ``quant_conv.*``, ``post_quant_conv.*``) as the VAE's flax tree."""
    tree: dict = {}
    n_levels = len(ch_mult)
    assign_module(tree, ("encoder", "conv_in"), "encoder.conv_in", sd, "conv")
    res = resolution
    for i in range(n_levels):
        for j in range(num_res_blocks):
            _import_resnet_block(tree, ("encoder", f"down_{i}_block_{j}"),
                                 f"encoder.down.{i}.block.{j}", sd)
            if res in attn_resolutions:
                _import_attn_block(tree, ("encoder", f"down_{i}_attn_{j}"),
                                   f"encoder.down.{i}.attn.{j}", sd)
        if i != n_levels - 1:
            assign_module(tree, ("encoder", f"down_{i}_downsample", "conv"),
                          f"encoder.down.{i}.downsample.conv", sd, "conv")
            res //= 2
    for part in ("encoder", "decoder"):
        if part == "decoder":
            assign_module(tree, ("decoder", "conv_in"), "decoder.conv_in", sd, "conv")
        _import_resnet_block(tree, (part, "mid_block_1"), f"{part}.mid.block_1", sd)
        _import_attn_block(tree, (part, "mid_attn_1"), f"{part}.mid.attn_1", sd)
        _import_resnet_block(tree, (part, "mid_block_2"), f"{part}.mid.block_2", sd)
        if part == "decoder":  # no per-level attention in the reference's decoder
            for i in range(n_levels):
                for j in range(num_res_blocks + 1):
                    _import_resnet_block(tree, ("decoder", f"up_{i}_block_{j}"),
                                         f"decoder.up.{i}.block.{j}", sd)
                if i != 0:
                    assign_module(tree, ("decoder", f"up_{i}_upsample", "conv"),
                                  f"decoder.up.{i}.upsample.conv", sd, "conv")
        assign_module(tree, (part, "norm_out"), f"{part}.norm_out", sd, "norm")
        assign_module(tree, (part, "conv_out"), f"{part}.conv_out", sd, "conv")
    assign_module(tree, ("quant_conv",), "quant_conv", sd, "conv")
    assign_module(tree, ("post_quant_conv",), "post_quant_conv", sd, "conv")
    return tree


# -- the MAR (the reference's mar_con_unified.py) -----------------------------

MAR_LINEARS = ("z_proj_cond", "z_proj", "z_proj_wrist", "action_proj_cond",
               "history_action_proj_cond", "proprioception_proj_cond",
               "proprioception_image_proj_cond", "text_proj_cond", "proj_cond_x_layer",
               "decoder_embed")
MAR_NORMS = ("z_proj_ln", "encoder_norm", "decoder_norm")
MAR_RAW = ("fake_latent_x", "fake_action_latent", "fake_latent", "fake_latent_history_action",
           "fake_latent_wrist_x", "temporal_pos_embed", "spatial_pos_embed",
           "decoder_temporal_pos_embed", "decoder_spatial_pos_embed", "diffusion_temporal_embed",
           "diffusion_spatial_embed", "text_pos_embed", "decoder_text_pos_embed")
VIT_BLOCK = ((("norm1",), "norm1", "norm"), (("attn", "qkv"), "attn.qkv", "linear"),
             (("attn", "proj"), "attn.proj", "linear"), (("norm2",), "norm2", "norm"),
             (("mlp_fc1",), "mlp.fc1", "linear"), (("mlp_fc2",), "mlp.fc2", "linear"))
CONV_FC_POOL = ((("conv",), "conv.0", "conv"), (("fc1",), "fc.0", "linear"),
                (("fc2",), "fc.2", "linear"), (("interpolate",), "interpolate", "linear"),
                (("refine1",), "refine.0", "linear"), (("refine2",), "refine.2", "linear"))


def _import_vit_blocks(tree, flax_prefix, torch_prefix, depth, sd):
    for i in range(depth):
        for sub, torch_name, kind in VIT_BLOCK:
            assign_module(tree, flax_prefix + (f"block_{i}",) + sub,
                          f"{torch_prefix}.{i}.{torch_name}", sd, kind)


def _import_action_head(tree, flax_prefix, p, depth, sd):
    """The reference's DiffActLoss as the action head: its pool in any of
    the four variants, then its denoiser."""
    pool = flax_prefix + ("pool",)
    if p + "conv.0.weight" in sd and p + "fc.0.weight" in sd:  # conv_fc
        for sub, torch_name, kind in CONV_FC_POOL:
            assign_module(tree, pool + sub, p + torch_name, sd, kind)
    elif p + "conv_transpose3d.weight" in sd:  # conv_ori: torch (in, out, kT, kH, kW)
        w = sd[p + "conv_transpose3d.weight"]
        _set(tree, pool + ("conv_transpose3d", "kernel"),
             np.ascontiguousarray(np.transpose(w, (2, 3, 4, 0, 1))))
        if p + "conv_transpose3d.bias" in sd:
            _set(tree, pool + ("conv_transpose3d", "bias"), sd[p + "conv_transpose3d.bias"])
    elif p + "conv.0.weight" in sd:  # conv2: Conv1d (out, in, k)
        for torch_name, name in (("conv.0", "conv1"), ("conv.2", "conv2")):
            _set(tree, pool + (name, "kernel"),
                 np.ascontiguousarray(np.transpose(sd[p + torch_name + ".weight"], (2, 1, 0))))
            if p + torch_name + ".bias" in sd:
                _set(tree, pool + (name, "bias"), sd[p + torch_name + ".bias"])
    elif p + "fc.0.weight" in sd:  # fc2
        assign_module(tree, pool + ("fc1",), p + "fc.0", sd, "linear")
        assign_module(tree, pool + ("fc2",), p + "fc.2", sd, "linear")
    _set(tree, flax_prefix + ("net",), import_mlp_denoiser(sd, depth, prefix=p + "net."))


def import_mar(sd: Mapping[str, np.ndarray], encoder_depth: int = 12, decoder_depth: int = 12,
               diffloss_depth: int = 6, diffloss_act_depth: int = 6) -> dict:
    """A reference MAR state dict (keys without the ``model.`` prefix) as the
    MAR's flax tree; only the modules present."""
    tree: dict = {}
    for name in MAR_LINEARS:
        if name + ".weight" in sd or name in sd:
            assign_module(tree, (name,), name, sd, "linear")
    for name in MAR_NORMS:
        if name + ".weight" in sd or name in sd:
            assign_module(tree, (name,), name, sd, "norm")
    for name in MAR_RAW:
        if name in sd:
            _set(tree, (name,), sd[name])
    for stack, depth in (("encoder_blocks", encoder_depth), ("decoder_blocks", decoder_depth)):
        if any(k.startswith(stack + ".") for k in sd):
            _import_vit_blocks(tree, (stack,), stack, depth, sd)
    for head in ("diffloss", "diffloss_wrist"):
        if f"{head}.net.input_proj.weight" in sd:
            _set(tree, (head, "net"), import_mlp_denoiser(sd, diffloss_depth, prefix=f"{head}.net."))
    for head in ("diffactloss", "diffproploss"):
        if f"{head}.net.input_proj.weight" in sd:
            _import_action_head(tree, (head,), head + ".", diffloss_act_depth, sd)
    return tree


# -- the CLIP text tower (HF CLIPTextModelWithProjection) ---------------------

def import_clip_text(sd: Mapping[str, np.ndarray], num_layers: int) -> dict:
    """An HF ``CLIPTextModelWithProjection`` state dict as the tree of
    ``models/clip.ClipTextModel``."""
    tree: dict = {}
    emb = "text_model.embeddings."
    _set(tree, ("token_embedding",), sd[emb + "token_embedding.weight"])
    _set(tree, ("position_embedding",), sd[emb + "position_embedding.weight"])
    for i in range(num_layers):
        tp, fp = f"text_model.encoder.layers.{i}.", (f"layer_{i}",)
        for name in ("layer_norm1", "layer_norm2"):
            assign_module(tree, fp + (name,), tp + name, sd, "norm")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            assign_module(tree, fp + ("self_attn", proj), tp + f"self_attn.{proj}", sd, "linear")
        assign_module(tree, fp + ("fc1",), tp + "mlp.fc1", sd, "linear")
        assign_module(tree, fp + ("fc2",), tp + "mlp.fc2", sd, "linear")
    assign_module(tree, ("final_layer_norm",), "text_model.final_layer_norm", sd, "norm")
    # a bias-free Linear (out, in) in HF; a raw (in, out) matrix in the tree
    _set(tree, ("text_projection",), linear_kernel(sd["text_projection.weight"]))
    return tree


# -- reading the files ---------------------------------------------------------

def load_torch_checkpoint(path: str):
    """``torch.load`` of a reference checkpoint on the CPU, where the
    pickled config graph names classes that are not installed: each such
    class unpickles as an inert stand-in (its state kept in ``__dict__``);
    the tensors are unaffected."""
    import importlib
    import io
    import pickle

    import torch

    class _Stub:
        def __init__(self, *args, **kwargs):
            self.__dict__["_args"] = (args, kwargs)

        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

        def __getattr__(self, name):
            raise AttributeError(name)

    class _TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return getattr(importlib.import_module(module), name)
            except Exception:
                return type(f"{module}.{name}", (_Stub,), {})

    class _PickleModule:
        Unpickler = _TolerantUnpickler

        @staticmethod
        def load(f, **kwargs):
            return _TolerantUnpickler(f).load()

        @staticmethod
        def loads(s, **kwargs):
            return _TolerantUnpickler(io.BytesIO(s)).load()

    return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PickleModule)


def state_dict_arrays(sd: Mapping) -> dict:
    """The tensors of a state dict as fp32 numpy arrays (others left out)."""
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def mar_state_dict(ckpt: Mapping) -> dict:
    """The MAR's state dict in a reference checkpoint: the framework's
    ``state_dicts.ema_model`` entries under ``model.`` (the prefix dropped),
    or the MAR release's ``model_ema``."""
    if "state_dicts" in ckpt:
        return {k[len("model."):]: v for k, v in ckpt["state_dicts"]["ema_model"].items()
                if k.startswith("model.")}
    if "model_ema" in ckpt:
        return dict(ckpt["model_ema"])
    raise ValueError(f"unrecognized checkpoint format: {list(ckpt)[:5]}")
