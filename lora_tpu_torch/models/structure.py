"""Channel arithmetic for the SD UNet topology, shared by parameter
construction (models/unet.py) and the LoRA site registry (core/sites.py).

Mirrors the structural rules of diffusers' UNet2DConditionModel that the
reference trains against (see SURVEY.md §2 L1); re-derived from the
published SD-1.5 architecture, not translated code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .config import UNetConfig


@dataclasses.dataclass(frozen=True)
class ResnetSpec:
    in_channels: int
    out_channels: int
    temb_channels: int

    @property
    def has_shortcut(self) -> bool:
        return self.in_channels != self.out_channels


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """One Transformer2DModel: `transformer_layers` BasicTransformerBlocks."""

    channels: int
    num_heads: int
    cross_dim: int
    n_blocks: int
    # SD2.x: proj_in/proj_out are Linear over the flattened sequence
    # (use_linear_projection) instead of 1x1 convs
    linear_proj: bool = False


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str  # "down" | "up" | "mid"
    resnets: Tuple[ResnetSpec, ...]
    attentions: Tuple[Optional[AttnSpec], ...]  # one per resnet (None if plain)
    has_downsample: bool = False
    has_upsample: bool = False


def time_embed_dim(cfg: UNetConfig) -> int:
    return cfg.block_out_channels[0] * 4


def down_blocks(cfg: UNetConfig) -> List[BlockSpec]:
    blocks = []
    temb = time_embed_dim(cfg)
    out_prev = cfg.block_out_channels[0]
    n = len(cfg.block_out_channels)
    for i, out_ch in enumerate(cfg.block_out_channels):
        in_ch = out_prev
        resnets = []
        attns = []
        for j in range(cfg.layers_per_block):
            resnets.append(ResnetSpec(in_ch if j == 0 else out_ch, out_ch, temb))
            attns.append(
                AttnSpec(out_ch, cfg.heads_for_block(i),
                         cfg.cross_attention_dim, cfg.tx_layers_for_block(i),
                         linear_proj=cfg.use_linear_projection)
                if cfg.down_block_has_attn[i]
                else None
            )
        blocks.append(
            BlockSpec("down", tuple(resnets), tuple(attns),
                      has_downsample=(i < n - 1))
        )
        out_prev = out_ch
    return blocks


def mid_block(cfg: UNetConfig) -> BlockSpec:
    temb = time_embed_dim(cfg)
    ch = cfg.block_out_channels[-1]
    return BlockSpec(
        "mid",
        (ResnetSpec(ch, ch, temb), ResnetSpec(ch, ch, temb)),
        (AttnSpec(ch, cfg.heads_for_block(-1), cfg.cross_attention_dim,
                  cfg.tx_layers_for_block(-1),
                  linear_proj=cfg.use_linear_projection),),
    )


def up_blocks(cfg: UNetConfig) -> List[BlockSpec]:
    blocks = []
    temb = time_embed_dim(cfg)
    rev = list(reversed(cfg.block_out_channels))
    n = len(rev)
    n_res = cfg.layers_per_block + 1
    for i in range(n):
        prev_output = rev[i - 1] if i > 0 else rev[0]
        out_ch = rev[i]
        input_ch = rev[min(i + 1, n - 1)]
        resnets = []
        attns = []
        for j in range(n_res):
            skip_ch = input_ch if j == n_res - 1 else out_ch
            res_in = (prev_output if j == 0 else out_ch) + skip_ch
            resnets.append(ResnetSpec(res_in, out_ch, temb))
            attns.append(
                # up block i mirrors down block n-1-i (channel level rev[i])
                AttnSpec(out_ch, cfg.heads_for_block(n - 1 - i),
                         cfg.cross_attention_dim,
                         cfg.tx_layers_for_block(n - 1 - i),
                         linear_proj=cfg.use_linear_projection)
                if cfg.up_block_has_attn[i]
                else None
            )
        blocks.append(
            BlockSpec("up", tuple(resnets), tuple(attns),
                      has_upsample=(i < n - 1))
        )
    return blocks
