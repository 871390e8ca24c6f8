"""Reference-layout torch checkpoints made from flax-layout trees, to check
the port's importers (``models/torch_import.py``) with: the inverse of
those importers' key maps and layouts, kept out of the port.

- :func:`reference_state_dict` turns a flax-layout tree of the MAR, the VAE,
  the denoiser or the CLIP text tower into the reference's torch state dict
  (``nn.Linear`` (out, in), ``nn.Conv2d`` (O, I, H, W), the VAE's 1x1
  convolutions (O, I, 1, 1), norms' ``weight``);
- :func:`write_mar_checkpoint` writes the framework's checkpoint
  (``{"cfg": ..., "state_dicts": {"ema_model": {"model.<key>": tensor}}}``)
  and :func:`write_vae_checkpoint` a ``kl16.ckpt`` (``{"model": ...}``),
  each with a config object whose class lives in a module that does not
  exist where the file is read (as the reference's omegaconf and hydra
  objects do on a machine without them), so a plain ``torch.load`` of the
  file fails and ``load_torch_checkpoint`` must stand it in.

numpy and torch only: ``chip_smoke.py`` imports it on the card.
"""

from __future__ import annotations

import contextlib
import re
import sys
import types
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

STANDIN_MODULE = "uva_reference_config_standin"  # importable nowhere

_VIT = {"norm1": "norm1", "attn/qkv": "attn.qkv", "attn/proj": "attn.proj", "norm2": "norm2",
        "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}
_POOL = {"conv": "conv.0", "fc1": "fc.0", "fc2": "fc.2", "interpolate": "interpolate",
         "refine1": "refine.0", "refine2": "refine.2"}
_VAE_BLOCK = {"shortcut": "nin_shortcut"}


def _denoiser_name(rest: str) -> str:
    fixed = {"input_proj": "input_proj", "cond_embed": "cond_embed",
             "time_embed/fc1": "time_embed.mlp.0", "time_embed/fc2": "time_embed.mlp.2",
             "final/ada_mod": "final_layer.adaLN_modulation.1", "final/proj": "final_layer.linear"}
    if rest in fixed:
        return fixed[rest]
    m = re.fullmatch(r"block_(\d+)/(ln|fc1|fc2|ada_mod)", rest)
    sub = {"ln": "in_ln", "fc1": "mlp.0", "fc2": "mlp.2", "ada_mod": "adaLN_modulation.1"}
    return f"res_blocks.{m[1]}.{sub[m[2]]}"


def _mar_name(module: str) -> str:
    m = re.fullmatch(r"(encoder_blocks|decoder_blocks)/block_(\d+)/(.+)", module)
    if m:
        return f"{m[1]}.{m[2]}.{_VIT[m[3]]}"
    m = re.fullmatch(r"(diffloss|diffloss_wrist|diffactloss|diffproploss)/net/(.+)", module)
    if m:
        return f"{m[1]}.net.{_denoiser_name(m[2])}"
    m = re.fullmatch(r"(diffactloss|diffproploss)/pool/(\w+)", module)
    if m:
        return f"{m[1]}.{_POOL[m[2]]}"
    if "/" in module:
        raise KeyError(f"no reference key for the MAR's {module}")
    return module


def _vae_name(module: str) -> str:
    if module in ("quant_conv", "post_quant_conv"):
        return module
    part, rest = module.split("/", 1)
    for pattern, fmt in ((r"down_(\d+)_block_(\d+)/(\w+)", "down.{0}.block.{1}.{2}"),
                         (r"down_(\d+)_attn_(\d+)/(\w+)", "down.{0}.attn.{1}.{2}"),
                         (r"down_(\d+)_downsample/conv", "down.{0}.downsample.conv"),
                         (r"up_(\d+)_block_(\d+)/(\w+)", "up.{0}.block.{1}.{2}"),
                         (r"up_(\d+)_upsample/conv", "up.{0}.upsample.conv"),
                         (r"mid_(block_1|block_2|attn_1)/(\w+)", "mid.{0}.{1}"),
                         (r"(conv_in|conv_out|norm_out)", "{0}")):
        m = re.fullmatch(pattern, rest)
        if m:
            groups = [_VAE_BLOCK.get(g, g) for g in m.groups()]
            return f"{part}." + fmt.format(*groups)
    raise KeyError(f"no reference key for the VAE's {module}")


def _clip_name(module: str) -> str:
    if module == "final_layer_norm":
        return "text_model.final_layer_norm"
    m = re.fullmatch(r"layer_(\d+)/(.+)", module)
    sub = {"fc1": "mlp.fc1", "fc2": "mlp.fc2"}.get(m[2], m[2].replace("/", "."))
    return f"text_model.encoder.layers.{m[1]}.{sub}"


_CLIP_RAW = {"token_embedding": "text_model.embeddings.token_embedding.weight",
             "position_embedding": "text_model.embeddings.position_embedding.weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def reference_state_dict(kind: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's state dict of the flax-layout ``tree`` of ``kind``
    ("mar", "vae", "denoiser" or "clip"), fp32 CPU tensors."""
    names = {"mar": _mar_name, "vae": _vae_name, "denoiser": _denoiser_name, "clip": _clip_name}
    sd = {}
    for path, x in _flatten(tree).items():
        if kind == "clip" and path[0] in _CLIP_RAW:
            sd[_CLIP_RAW[path[0]]] = x
            continue
        if kind == "clip" and path == ("text_projection",):
            sd["text_projection.weight"] = x.T
            continue
        if kind == "mar" and len(path) == 1:  # positional embeddings, fake latents
            sd[path[0]] = x
            continue
        *module, leaf = path
        name = names[kind]("/".join(module))
        if leaf == "kernel":
            if x.ndim == 4:  # (H, W, I, O) -> (O, I, H, W)
                x = np.transpose(x, (3, 2, 0, 1))
            elif kind == "vae":  # a 1x1 convolution
                x = x.T[:, :, None, None]
            else:
                x = x.T
        elif leaf not in ("scale", "bias"):
            raise KeyError(f"leaf {'/'.join(path)}")
        sd[f"{name}.{'bias' if leaf == 'bias' else 'weight'}"] = x
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@contextlib.contextmanager
def _standin_module():
    """A module importable while the file is written and absent after."""
    mod = types.ModuleType(STANDIN_MODULE)
    cls = type("DictConfig", (), {"__module__": STANDIN_MODULE})
    mod.DictConfig = cls
    sys.modules[STANDIN_MODULE] = mod
    try:
        yield cls
    finally:
        del sys.modules[STANDIN_MODULE]


def _config_standin(cls, **content):
    cfg = cls()
    cfg.__dict__["_content"] = dict(content)
    return cfg


def write_mar_checkpoint(path: str, mar_tree: Mapping) -> Dict[str, torch.Tensor]:
    """The framework's checkpoint of ``mar_tree`` at ``path``: its EMA model
    under ``model.``, one entry of another module beside it, the config
    stand-in. Returns the MAR's state dict (no prefix)."""
    sd = reference_state_dict("mar", mar_tree)
    ema = {"model." + k: v for k, v in sd.items()}
    ema["normalizer.params_dict.action.scale"] = torch.ones(2)
    with _standin_module() as cls:
        torch.save({"cfg": _config_standin(cls, name="uva", task="umi_multi"),
                    "state_dicts": {"ema_model": ema}, "pickles": {}}, path)
    return sd


def write_vae_checkpoint(path: str, vae_tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``kl16.ckpt`` of ``vae_tree`` at ``path`` (``{"model": state
    dict}`` beside the config stand-in). Returns the state dict."""
    sd = reference_state_dict("vae", vae_tree)
    with _standin_module() as cls:
        torch.save({"model": sd, "config": _config_standin(cls, embed_dim=16)}, path)
    return sd
