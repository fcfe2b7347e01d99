"""Model configurations.

SD15_UNET/SD15_VAE/SD15_TEXT mirror the published Stable-Diffusion-1.5
configs (runwayml/stable-diffusion-v1-5 {unet,vae,text_encoder}/config.json)
that the reference loads via diffusers/transformers from_pretrained
(cli_lora_pti.py:58-127).  SD21_* mirror stabilityai/stable-diffusion-2-1
(the reference's scripts accept any such diffusers dir via
--pretrained_model_name_or_path, and its loss already branches on
v_prediction: cli_lora_pti.py:336).  TINY_* are scaled-down variants for
CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # block types, bottom of the U last. True = has cross-attention.
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)
    layers_per_block: int = 2
    # Number of attention heads per transformer. diffusers' misnamed
    # `attention_head_dim=8` for SD1.x actually sets num_heads=8; SD2.x
    # publishes a per-down-block list (5, 10, 20, 20) = constant head dim 64.
    # A tuple here is per down-block (up blocks mirror it in reverse; the
    # mid block uses the last entry).
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    # BasicTransformerBlocks per Transformer2DModel. SDXL publishes a
    # per-down-block list (transformer_layers_per_block = [1, 2, 10]); up
    # blocks mirror it in reverse and the mid block uses the last entry.
    transformer_layers: Union[int, Tuple[int, ...]] = 1
    cross_attention_dim: int = 768
    # SD2.x Transformer2DModel: proj_in/proj_out are nn.Linear over the
    # flattened sequence instead of 1x1 convs (use_linear_projection in the
    # published config). Math-identical; the checkpoint weight rank differs.
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    # SDXL micro-conditioning: "text_time" adds an `add_embedding` MLP fed
    # by [pooled text embed | sinusoidal(time_ids)] whose output is summed
    # into the timestep embedding (unet/config.json addition_embed_type).
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    # add_embedding.linear_1 input width: pooled_dim + 6*addition_time_embed_dim
    # (SDXL: 1280 + 6*256 = 2816)
    projection_class_embeddings_input_dim: Optional[int] = None

    def heads_for_block(self, block_index: int) -> int:
        """Heads for down-block `block_index` (negative indexes from the
        bottom of the U, so -1 = the mid/deepest level)."""
        nh = self.num_attention_heads
        if isinstance(nh, tuple):
            return nh[block_index]
        return nh

    def tx_layers_for_block(self, block_index: int) -> int:
        """Transformer depth for down-block `block_index` (negative indexes
        from the bottom of the U, so -1 = the mid/deepest level)."""
        tl = self.transformer_layers
        if isinstance(tl, tuple):
            return tl[block_index]
        return tl


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # room reserved for textual-inversion placeholder rows (jit-static)
    max_extra_tokens: int = 16
    # CLIPTextModelWithProjection: adds text_projection (projection_dim,
    # hidden) without bias; SDXL's text_encoder_2 (OpenCLIP ViT-bigG export)
    # projects the pooled EOS embedding through it.
    projection_dim: Optional[int] = None


SD15_UNET = UNetConfig()
SD15_VAE = VAEConfig()
SD15_TEXT = CLIPTextConfig()

# Stable Diffusion 2.1 (768-v): stabilityai/stable-diffusion-2-1
# {unet,vae,text_encoder}/config.json. The text encoder is the HF export of
# OpenCLIP ViT-H/14 truncated to 23 layers (the "penultimate layer" SD2
# conditioning) with plain gelu. The v-prediction objective lives in the
# scheduler config (prediction_type), not here. SD 2.1-base (512px) is the
# same but sample_size=64.
SD21_UNET = UNetConfig(
    sample_size=96,
    num_attention_heads=(5, 10, 20, 20),  # constant head dim 64
    cross_attention_dim=1024,
    use_linear_projection=True,
)
SD21_VAE = VAEConfig()
SD21_TEXT = CLIPTextConfig(
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=23,
    num_attention_heads=16,
    hidden_act="gelu",
)

# Stable Diffusion XL base: stabilityai/stable-diffusion-xl-base-1.0
# unet/config.json. Three levels (no fourth 1280 block), per-block
# transformer depth [_, 2, 10] (the first down block is attention-free so
# the published list's leading 1 is unused), heads (5, 10, 20) = constant
# head dim 64 (the config publishes them under the misnamed
# attention_head_dim with num_attention_heads null), context = concat of
# both text encoders' penultimate states (768 + 1280 = 2048), and
# "text_time" additive conditioning: pooled te2 embed (1280) + six
# 256-wide sinusoidal time_ids (original/crop/target size) -> 2816-wide
# add_embedding MLP summed into the timestep embedding.
SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_has_attn=(False, True, True),
    up_block_has_attn=(True, True, False),
    num_attention_heads=(5, 10, 20),
    transformer_layers=(1, 2, 10),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
# text_encoder: the same CLIP ViT-L as SD1.5 but SDXL consumes its
# PENULTIMATE hidden state (clip_skip, no final norm) — handled at call
# sites, not here. text_encoder_2: OpenCLIP ViT-bigG/14 HF export
# (CLIPTextModelWithProjection), penultimate state for conditioning plus
# the projected pooled EOS embedding for add_embedding.
SDXL_TEXT = CLIPTextConfig()
SDXL_TEXT2 = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)

# Tiny configs for CPU unit tests: same topology, small dims.
TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=2,
    cross_attention_dim=32,
    norm_num_groups=8,
)
TINY_VAE = VAEConfig(block_out_channels=(16, 16, 32, 32), norm_num_groups=8)
# SD2-flavored tiny variants: per-block head counts + linear projections +
# gelu text encoder, for CPU differential tests of the SD2 topology.
TINY_SD2_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=(2, 4, 4, 4),  # constant head dim 16
    cross_attention_dim=48,
    use_linear_projection=True,
    norm_num_groups=8,
)
TINY_SD2_TEXT = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=48,
    intermediate_size=96,
    num_hidden_layers=3,
    num_attention_heads=4,
    hidden_act="gelu",
    max_extra_tokens=8,
)
# SDXL-flavored tiny variants: 3 levels, attention-free first block,
# per-block transformer depth, text_time additive conditioning, dual text
# encoders (te2 with projection). Head dim 16 throughout.
TINY_XL_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64),
    down_block_has_attn=(False, True, True),
    up_block_has_attn=(True, True, False),
    num_attention_heads=(2, 4, 4),
    transformer_layers=(1, 1, 2),
    cross_attention_dim=44,  # 16 (te1) + 28 (te2)
    use_linear_projection=True,
    norm_num_groups=8,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=28 + 6 * 8,
)
TINY_XL_TEXT = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=16,
    intermediate_size=32,
    num_hidden_layers=3,
    num_attention_heads=2,
    max_extra_tokens=8,
)
TINY_XL_TEXT2 = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=28,
    intermediate_size=56,
    num_hidden_layers=3,
    num_attention_heads=2,
    hidden_act="gelu",
    max_extra_tokens=8,
    projection_dim=28,
)

TINY_TEXT = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    intermediate_size=64,
    num_hidden_layers=2,
    num_attention_heads=2,
    max_extra_tokens=8,
)
