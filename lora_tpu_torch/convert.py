"""Carry the JAX package's params and LoRA trees across to the port.

lora_tpu keeps params as a flat {HF name: array} dict in torch weight
layout, so a state dict is the same names with the arrays as tensors:

    import numpy as np
    from lora_tpu_torch.convert import lora_from_jax, state_dict_from_jax

    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jax_params.items()})
    unet.load_state_dict(sd, strict=True)
    lora = lora_from_jax(jax_lora_tree)
    trainable = trainable_from_jax(jax_trainable_tree)   # leaves require grad

Inputs are numpy arrays (np.asarray on the JAX leaves); bfloat16 arrays keep
their bits. A whole JAX pipeline (SD or SDXL: its params, configs and LoRA
trees, te2's too) becomes the port's with `pipeline_from_jax`. This module
imports no jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .core.lora import LoraTree
from .core.quantize import SCALE_SUFFIX


def to_torch(a, device="cpu", dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """A writable copy of array `a` as a tensor on `device`, cast to `dtype`
    when given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def state_dict_from_jax(params: Dict[str, np.ndarray], *, device="cpu",
                        dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX params -> a state dict that UNet / CLIPTextModel / VAE take with
    load_state_dict(..., strict=True). Int8-quantized params
    (core/quantize.py) keep their types whatever `dtype` says: int8 weights
    stay int8 and their "*_scale" companions float32, so JAX-quantized
    params load into a module that ran quantize_base()."""
    out = {}
    for name, a in params.items():
        if np.asarray(a).dtype == np.int8:
            out[name] = to_torch(a, device, torch.int8)
        elif name.endswith(SCALE_SUFFIX):
            out[name] = to_torch(a, device, torch.float32)
        else:
            out[name] = to_torch(a, device, dtype)
    return out


def lora_from_jax(tree: dict, *, device="cpu",
                  dtype: Optional[torch.dtype] = None) -> LoraTree:
    """A JAX LoRA tree -> the port's: per-site up/down (+ diag) or full-rank
    delta, scale, the stacked adapters' per-sample idx, and a LyCORIS
    tree's param_deltas ({param path: float32 tensor})."""
    extra = set(tree) - {"sites", "scale", "idx", "param_deltas"}
    if extra:
        raise ValueError(f"unknown LoRA tree keys {sorted(extra)}")
    out = {
        "sites": {name: {k: to_torch(v, device, dtype)
                         for k, v in entry.items()}
                  for name, entry in tree["sites"].items()},
        "scale": to_torch(tree["scale"], device, torch.float32),
    }
    if "idx" in tree:
        out["idx"] = to_torch(tree["idx"], device, torch.long)
    if "param_deltas" in tree:
        out["param_deltas"] = {k: to_torch(v, device, torch.float32)
                               for k, v in tree["param_deltas"].items()}
    return out


def trainable_from_jax(tree: dict, *, device="cpu") -> dict:
    """A JAX trainable tree ({"lora_unet": LoraTree, "lora_text": LoraTree,
    "lora_text2": LoraTree (SDXL's te2), "ti": {"embeds": (K, D)}}, numpy
    leaves) -> the port's, in the same layout: float32 leaf tensors that
    require grad (the LoRA scale included, as jax.grad differentiates every
    leaf)."""
    def leaf(a):
        return to_torch(a, device, torch.float32).requires_grad_(True)

    out = {}
    for group, sub in tree.items():
        if sub is None:
            out[group] = None
        elif group == "ti":
            out[group] = {"embeds": leaf(sub["embeds"])}
        else:
            lora = lora_from_jax(sub, device=device)
            out[group] = {
                "sites": {name: {k: leaf(v) for k, v in entry.items()}
                          for name, entry in lora["sites"].items()},
                "scale": leaf(lora["scale"]),
            }
    return out


def trainable_to_numpy(tree):
    """The way back: the same nested layout with float32 numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    if isinstance(tree, dict):
        return {k: trainable_to_numpy(v) for k, v in tree.items()}
    return tree


def pipeline_from_jax(jpipe, tokenizer, *, device="cpu",
                      dtype: Optional[torch.dtype] = None):
    """lora_tpu's StableDiffusionPipeline or StableDiffusionXLPipeline (read
    by attribute: *_params, *_cfg, lora_unet, lora_text, lora_text2) as the
    port's, on `device`, holding the same weights (cast to `dtype` when
    given) and LoRA trees, with the port tokenizer `tokenizer`."""
    from .models import config
    from .models.clip import CLIPTextModel
    from .models.unet import UNet
    from .models.vae import VAE
    from .pipelines.sd import StableDiffusionPipeline
    from .pipelines.sdxl import StableDiffusionXLPipeline

    def module(cls, jcfg, params, cfg_cls):
        m = cls(cfg_cls(**dataclasses.asdict(jcfg)), device="meta",
                dtype=dtype or torch.float32)
        m.load_state_dict(state_dict_from_jax(
            {k: np.asarray(v) for k, v in params.items()}, device=device,
            dtype=dtype), strict=True, assign=True)
        return m

    unet = module(UNet, jpipe.unet_cfg, jpipe.unet_params, config.UNetConfig)
    text = module(CLIPTextModel, jpipe.text_cfg, jpipe.text_params,
                  config.CLIPTextConfig)
    vae = module(VAE, jpipe.vae_cfg, jpipe.vae_params, config.VAEConfig)
    xl = getattr(jpipe, "text2_params", None) is not None
    if xl:
        pipe = StableDiffusionXLPipeline(
            unet, text, module(CLIPTextModel, jpipe.text2_cfg,
                               jpipe.text2_params, config.CLIPTextConfig),
            vae, tokenizer)
    else:
        pipe = StableDiffusionPipeline(unet, text, vae, tokenizer)
    for attr in ("lora_unet", "lora_text") + (("lora_text2",) if xl else ()):
        tree = getattr(jpipe, attr, None)
        if tree is not None:
            setattr(pipe, attr, lora_from_jax(tree, device=device,
                                              dtype=dtype))
    return pipe
