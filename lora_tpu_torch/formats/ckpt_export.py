"""Export to the original CompVis / A1111 `.ckpt` layout and back: the
counterpart of lora_tpu/formats/ckpt_export.py (the reference's
to_ckpt_v2.py: a diffusers directory -> an SD checkpoint).

The key maps are generated from the model config by models/structure.py,
so they cover the reduced test configs too. Weights stay in torch layout,
so the export is a renaming plus one reshape: the VAE attention
projections are linears in diffusers and 1x1 convs in the CompVis layout
(to_ckpt_v2.py:180-192). The `.ckpt` is written with torch.save from the
pipeline's modules, as {"state_dict": {name: tensor}}.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models import structure
from ..models.config import UNetConfig, VAEConfig

_RESNET_UNET = {
    "norm1": "in_layers.0",
    "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0",
    "conv2": "out_layers.3",
    "conv_shortcut": "skip_connection",
}

_RESNET_VAE = {
    "norm1": "norm1",
    "conv1": "conv1",
    "norm2": "norm2",
    "conv2": "conv2",
    "conv_shortcut": "nin_shortcut",
}

_ATTN_VAE = {
    "group_norm": "norm",
    "to_q": "q",
    "to_k": "k",
    "to_v": "v",
    "to_out.0": "proj_out",
}

_PREFIX_UNET = "model.diffusion_model."
_PREFIX_VAE = "first_stage_model."
_PREFIX_TEXT = "cond_stage_model.transformer."


def unet_key_map(cfg: UNetConfig) -> Dict[str, str]:
    """diffusers module path -> LDM module path for every UNet module with
    weights but the transformers' insides (a Transformer2DModel maps as a
    whole: its sub-paths are the same in both layouts). The SDXL kohya
    schema names its UNet modules through it too (formats/kohya.py)."""
    m = {
        "conv_in": "input_blocks.0.0",
        "time_embedding.linear_1": "time_embed.0",
        "time_embedding.linear_2": "time_embed.2",
        "conv_norm_out": "out.0",
        "conv_out": "out.2",
    }

    def resnet(src, dst):
        for a, b in _RESNET_UNET.items():
            m[f"{src}.{a}"] = f"{dst}.{b}"

    idx = 1
    for i, block in enumerate(structure.down_blocks(cfg)):
        for j in range(len(block.resnets)):
            resnet(f"down_blocks.{i}.resnets.{j}", f"input_blocks.{idx}.0")
            if block.attentions[j] is not None:
                m[f"down_blocks.{i}.attentions.{j}"] = f"input_blocks.{idx}.1"
            idx += 1
        if block.has_downsample:
            m[f"down_blocks.{i}.downsamplers.0.conv"] = \
                f"input_blocks.{idx}.0.op"
            idx += 1

    resnet("mid_block.resnets.0", "middle_block.0")
    m["mid_block.attentions.0"] = "middle_block.1"
    resnet("mid_block.resnets.1", "middle_block.2")

    idx = 0
    for i, block in enumerate(structure.up_blocks(cfg)):
        for j in range(len(block.resnets)):
            resnet(f"up_blocks.{i}.resnets.{j}", f"output_blocks.{idx}.0")
            has_attn = block.attentions[j] is not None
            if has_attn:
                m[f"up_blocks.{i}.attentions.{j}"] = f"output_blocks.{idx}.1"
            if j == len(block.resnets) - 1 and block.has_upsample:
                sub = 2 if has_attn else 1
                m[f"up_blocks.{i}.upsamplers.0.conv"] = \
                    f"output_blocks.{idx}.{sub}.conv"
            idx += 1
    return m


def vae_key_map(cfg: VAEConfig) -> Dict[str, str]:
    """diffusers module path -> CompVis module path for the VAE."""
    n = len(cfg.block_out_channels)
    m = {
        "encoder.conv_in": "encoder.conv_in",
        "encoder.conv_norm_out": "encoder.norm_out",
        "encoder.conv_out": "encoder.conv_out",
        "decoder.conv_in": "decoder.conv_in",
        "decoder.conv_norm_out": "decoder.norm_out",
        "decoder.conv_out": "decoder.conv_out",
        "quant_conv": "quant_conv",
        "post_quant_conv": "post_quant_conv",
    }

    def resnet(src, dst):
        for a, b in _RESNET_VAE.items():
            m[f"{src}.{a}"] = f"{dst}.{b}"

    def attn(src, dst):
        for a, b in _ATTN_VAE.items():
            m[f"{src}.{a}"] = f"{dst}.{b}"

    for i in range(n):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   f"encoder.down.{i}.block.{j}")
        if i < n - 1:
            m[f"encoder.down_blocks.{i}.downsamplers.0.conv"] = \
                f"encoder.down.{i}.downsample.conv"
    resnet("encoder.mid_block.resnets.0", "encoder.mid.block_1")
    resnet("encoder.mid_block.resnets.1", "encoder.mid.block_2")
    attn("encoder.mid_block.attentions.0", "encoder.mid.attn_1")

    resnet("decoder.mid_block.resnets.0", "decoder.mid.block_1")
    resnet("decoder.mid_block.resnets.1", "decoder.mid.block_2")
    attn("decoder.mid_block.attentions.0", "decoder.mid.attn_1")
    for i in range(n):
        # CompVis numbers the decoder's up blocks in reverse
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   f"decoder.up.{n - 1 - i}.block.{j}")
        if i < n - 1:
            m[f"decoder.up_blocks.{i}.upsamplers.0.conv"] = \
                f"decoder.up.{n - 1 - i}.upsample.conv"
    return m


def _apply_map(params: Dict[str, torch.Tensor], key_map: Dict[str, str],
               prefix: str) -> Dict[str, torch.Tensor]:
    """Rename by the longest matching module prefix (the keys under an
    attention subtree keep their tail); a key no entry matches keeps its
    name (the transformer blocks inside an attention)."""
    items = sorted(key_map.items(), key=lambda kv: -len(kv[0]))
    out = {}
    for k, v in params.items():
        stem = k.rpartition(".")[0]
        new = k
        for src, dst in items:
            if k.startswith(src + ".") or stem == src:
                new = dst + k[len(src):]
                break
        out[prefix + new] = v
    return out


def _invert(key_map: Dict[str, str]) -> Dict[str, str]:
    return {v: k for k, v in key_map.items()}


def _is_vae_attn_weight(key: str) -> bool:
    return ".attentions.0." in key and key.endswith(".weight")


def params_from_ckpt(checkpoint_path: str, unet_cfg: UNetConfig,
                     vae_cfg: VAEConfig):
    """A CompVis / A1111 `.ckpt` back to (unet, text, vae) flat params of
    float32 CPU tensors, the inverse of convert_to_ckpt. The file is read
    with torch.load(weights_only=True): a checkpoint that pickles more than
    tensors and containers is refused, not executed."""
    sd = torch.load(checkpoint_path, map_location="cpu",
                    weights_only=True)["state_dict"]
    groups = {_PREFIX_UNET: {}, _PREFIX_VAE: {}, _PREFIX_TEXT: {}}
    for k, v in sd.items():
        for prefix, d in groups.items():
            if k.startswith(prefix):
                d[k[len(prefix):]] = v.float()
                break
    unet_p = _apply_map(groups[_PREFIX_UNET], _invert(unet_key_map(unet_cfg)),
                        "")
    vae_p = _apply_map(groups[_PREFIX_VAE], _invert(vae_key_map(vae_cfg)), "")
    # the VAE attention projections come back as 1x1 convs: squeeze
    for k, v in vae_p.items():
        if _is_vae_attn_weight(k) and v.ndim == 4:
            vae_p[k] = v[:, :, 0, 0]
    return unet_p, groups[_PREFIX_TEXT], vae_p


def convert_to_ckpt(pipe, checkpoint_path: str, as_half: bool = True) -> None:
    """The pipeline's UNet, VAE and text encoder as a CompVis `.ckpt`
    ({"state_dict": ...}, the reference's convert_to_ckpt,
    to_ckpt_v2.py:198-232): float tensors in fp16 with `as_half`, copied
    to the host."""
    vae = {}
    for k, v in pipe.vae.flat_params().items():
        if _is_vae_attn_weight(k) and v.ndim == 2:
            v = v[:, :, None, None]  # 1x1 convs in the CompVis layout
        vae[k] = v
    parts = (
        _apply_map(pipe.unet.flat_params(), unet_key_map(pipe.unet.cfg),
                   _PREFIX_UNET),
        _apply_map(vae, vae_key_map(pipe.vae.cfg), _PREFIX_VAE),
        {_PREFIX_TEXT + k: v
         for k, v in pipe.text_encoder.flat_params().items()})
    state_dict = {}
    for part in parts:
        for k, v in part.items():
            t = v.detach()
            if as_half and t.is_floating_point():
                t = t.half()
            state_dict[k] = t.to("cpu", copy=True)
    torch.save({"state_dict": state_dict}, checkpoint_path)
