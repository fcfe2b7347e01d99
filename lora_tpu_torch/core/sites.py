"""LoRA site registry: the ordered list of matmul/conv sites that carry a
LoRA adapter, for each model and target set.

The index position of each site REPRODUCES the reference's module traversal
order (lora.py:189-252 `_find_modules_v2` over diffusers/transformers torch
module trees), because the on-disk format keys tensors as "{model}:{idx}:up".
Order verified empirically against the reference's example LoRA files
(144 UNet sites: down_blocks -> up_blocks -> mid_block LAST — a consequence of
torch registration order; per transformer block: attn1.{q,k,v,out},
ff GEGLU proj, attn2.{q,k,v,out}; text encoder per CLIPAttention:
k_proj, v_proj, q_proj, out_proj).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

from ..models import structure
from ..models.config import CLIPTextConfig, UNetConfig
from ..formats.safetensors_io import (
    DEFAULT_TARGET_REPLACE,
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
)


@dataclasses.dataclass(frozen=True)
class Site:
    """One LoRA-able op. `name` is the diffusers/transformers module path
    (also the flat-params key minus '.weight')."""

    name: str
    kind: str  # "linear" | "conv"
    in_dim: int
    out_dim: int
    # conv geometry (lora_down copies it; lora_up is always 1x1: lora.py:105-123)
    kernel: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)


def _attn_sites(prefix: str, spec: structure.AttnSpec) -> List[Site]:
    """Sites for one Transformer2DModel under {CrossAttention, GEGLU} targets.

    Per BasicTransformerBlock the reference traversal yields attn1 (self),
    the GEGLU inside ff, then attn2 (cross) — torch registration order.
    """
    c = spec.channels
    out: List[Site] = []
    for k in range(spec.n_blocks):
        tb = f"{prefix}.transformer_blocks.{k}"
        out += [
            Site(f"{tb}.attn1.to_q", "linear", c, c),
            Site(f"{tb}.attn1.to_k", "linear", c, c),
            Site(f"{tb}.attn1.to_v", "linear", c, c),
            Site(f"{tb}.attn1.to_out.0", "linear", c, c),
            Site(f"{tb}.ff.net.0.proj", "linear", c, 8 * c),
            Site(f"{tb}.attn2.to_q", "linear", c, c),
            Site(f"{tb}.attn2.to_k", "linear", spec.cross_dim, c),
            Site(f"{tb}.attn2.to_v", "linear", spec.cross_dim, c),
            Site(f"{tb}.attn2.to_out.0", "linear", c, c),
        ]
    return out


def _resnet_sites(prefix: str, spec: structure.ResnetSpec) -> List[Site]:
    """Sites for one ResnetBlock2D (extended targets): conv1, time_emb_proj,
    conv2, conv_shortcut — named_modules registration order."""
    out = [
        Site(f"{prefix}.conv1", "conv", spec.in_channels, spec.out_channels,
             kernel=(3, 3), padding=(1, 1)),
        Site(f"{prefix}.time_emb_proj", "linear", spec.temb_channels,
             spec.out_channels),
        Site(f"{prefix}.conv2", "conv", spec.out_channels, spec.out_channels,
             kernel=(3, 3), padding=(1, 1)),
    ]
    if spec.has_shortcut:
        out.append(
            Site(f"{prefix}.conv_shortcut", "conv", spec.in_channels,
                 spec.out_channels)
        )
    return out


def unet_lora_sites(
    cfg: UNetConfig, target_replace: Optional[Set[str]] = None
) -> List[Site]:
    """Ordered LoRA sites of the UNet for a given target set."""
    targets = target_replace or DEFAULT_TARGET_REPLACE
    want_attn = bool({"CrossAttention", "Attention"} & targets)
    want_geglu = "GEGLU" in targets
    want_resnet = "ResnetBlock2D" in targets

    def block_sites(prefix: str, block: structure.BlockSpec) -> List[Site]:
        out: List[Site] = []
        # torch registration: attentions are registered before resnets in
        # CrossAttn{Down,Up}Block2D / UNetMidBlock2DCrossAttn.
        for j, attn in enumerate(block.attentions):
            if attn is None:
                continue
            sites = _attn_sites(f"{prefix}.attentions.{j}", attn)
            if not want_attn:
                sites = [s for s in sites if ".ff." in s.name]
            if not want_geglu:
                sites = [s for s in sites if ".ff." not in s.name]
            out += sites
        if want_resnet:
            for j, res in enumerate(block.resnets):
                out += _resnet_sites(f"{prefix}.resnets.{j}", res)
        return out

    sites: List[Site] = []
    for i, b in enumerate(structure.down_blocks(cfg)):
        sites += block_sites(f"down_blocks.{i}", b)
    for i, b in enumerate(structure.up_blocks(cfg)):
        sites += block_sites(f"up_blocks.{i}", b)
    # mid_block is registered AFTER up_blocks in the torch module dict
    # (first Module-typed assignment happens after up_blocks), so it comes
    # last in traversal — confirmed by golden-file shapes.
    sites += block_sites("mid_block", structure.mid_block(cfg))
    return sites


def _locon_attn_extras(prefix: str, spec: structure.AttnSpec) -> List[Site]:
    """kohya/LyCORIS targets inside a Transformer2DModel beyond the
    reference's sets: proj_in/proj_out 1x1 convs and the ff output linear
    (kohya's UNET_TARGET_REPLACE_MODULE covers every Linear/Conv2d child of
    Transformer2DModel, not just attention+GEGLU)."""
    c = spec.channels
    # SD2.x publishes proj_in/proj_out as Linear (use_linear_projection);
    # kohya keys them identically either way, only the delta geometry differs
    proj_kind = "linear" if spec.linear_proj else "conv"
    out = [Site(f"{prefix}.proj_in", proj_kind, c, c)]
    for k in range(spec.n_blocks):
        out.append(Site(f"{prefix}.transformer_blocks.{k}.ff.net.2",
                        "linear", 4 * c, c))
    out.append(Site(f"{prefix}.proj_out", proj_kind, c, c))
    return out


def unet_locon_sites(cfg: UNetConfig) -> List[Site]:
    """The kohya-ss / LyCORIS "LoCon" module superset of the UNet: every
    Linear/Conv2d inside Transformer2DModel, ResnetBlock2D, Downsample2D,
    and Upsample2D (kohya's conv_dim targets). A strict superset of
    `unet_lora_sites(cfg, UNET_EXTENDED_TARGET_REPLACE)`.

    Only for the name-keyed kohya format (formats/kohya.py) and in-pipe
    patching — the cloneofsimo indexed format cannot express these sites
    (no class-name target set covers Downsample2D/proj_in; lora.py:159-167),
    so ordering here follows torch registration for readability but carries
    no on-disk meaning."""

    def block_sites(prefix: str, block: structure.BlockSpec) -> List[Site]:
        out: List[Site] = []
        for j, attn in enumerate(block.attentions):
            if attn is None:
                continue
            pre = f"{prefix}.attentions.{j}"
            extras = _locon_attn_extras(pre, attn)
            # registration order: proj_in, per-tb [attn1, ff(.0/.2), attn2],
            # proj_out
            out.append(extras[0])
            attn_sites = _attn_sites(pre, attn)
            for k in range(attn.n_blocks):
                out += attn_sites[9 * k: 9 * k + 5]     # attn1 + ff.net.0
                out.append(extras[1 + k])               # ff.net.2
                out += attn_sites[9 * k + 5: 9 * k + 9]  # attn2
            out.append(extras[-1])
        for j, res in enumerate(block.resnets):
            out += _resnet_sites(f"{prefix}.resnets.{j}", res)
        if block.has_downsample:
            ch = block.resnets[-1].out_channels
            out.append(Site(f"{prefix}.downsamplers.0.conv", "conv", ch, ch,
                            kernel=(3, 3), stride=(2, 2), padding=(1, 1)))
        if block.has_upsample:
            ch = block.resnets[-1].out_channels
            out.append(Site(f"{prefix}.upsamplers.0.conv", "conv", ch, ch,
                            kernel=(3, 3), padding=(1, 1)))
        return out

    sites: List[Site] = []
    for i, b in enumerate(structure.down_blocks(cfg)):
        sites += block_sites(f"down_blocks.{i}", b)
    sites += block_sites("mid_block", structure.mid_block(cfg))
    for i, b in enumerate(structure.up_blocks(cfg)):
        sites += block_sites(f"up_blocks.{i}", b)
    return sites


def text_encoder_locon_sites(cfg: CLIPTextConfig) -> List[Site]:
    """kohya text-encoder targets: CLIPAttention + CLIPMLP (fc1/fc2) —
    a superset of the reference's {CLIPAttention}."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    sites: List[Site] = []
    for i in range(cfg.num_hidden_layers):
        p = f"text_model.encoder.layers.{i}"
        sites += [
            Site(f"{p}.self_attn.k_proj", "linear", d, d),
            Site(f"{p}.self_attn.v_proj", "linear", d, d),
            Site(f"{p}.self_attn.q_proj", "linear", d, d),
            Site(f"{p}.self_attn.out_proj", "linear", d, d),
            Site(f"{p}.mlp.fc1", "linear", d, ff),
            Site(f"{p}.mlp.fc2", "linear", ff, d),
        ]
    return sites


def text_encoder_lora_sites(
    cfg: CLIPTextConfig, target_replace: Optional[Set[str]] = None
) -> List[Site]:
    """Ordered LoRA sites of the CLIP text encoder ({CLIPAttention}).

    transformers CLIPAttention registers k_proj, v_proj, q_proj, out_proj —
    that order defines the on-disk idx."""
    targets = target_replace or TEXT_ENCODER_DEFAULT_TARGET_REPLACE
    if "CLIPAttention" not in targets:
        return []
    d = cfg.hidden_size
    sites: List[Site] = []
    for i in range(cfg.num_hidden_layers):
        p = f"text_model.encoder.layers.{i}.self_attn"
        sites += [
            Site(f"{p}.k_proj", "linear", d, d),
            Site(f"{p}.v_proj", "linear", d, d),
            Site(f"{p}.q_proj", "linear", d, d),
            Site(f"{p}.out_proj", "linear", d, d),
        ]
    return sites


__all__ = [
    "Site",
    "unet_lora_sites",
    "unet_locon_sites",
    "text_encoder_lora_sites",
    "text_encoder_locon_sites",
    "UNET_EXTENDED_TARGET_REPLACE",
]
