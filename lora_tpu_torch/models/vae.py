"""AutoencoderKL (the SD VAE) in PyTorch.

The counterpart of lora_tpu/models/vae.py, with the modern diffusers param
names. The public layout is NHWC, as in the JAX package; inside,
activations are NCHW with the channels_last memory format. The mid-block
attention is a plain matmul + float32 softmax, as in the JAX package: it
never reaches the flash kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import VAEConfig
from .layers import (
    Initializer,
    ParamModule,
    Params,
    conv2d,
    dense,
    group_norm,
    silu,
    upsample_nearest_2x,
)

EPS = 1e-6


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_resnet(ini: Initializer, prefix: str, cin: int, cout: int):
    ini.norm(prefix + ".norm1", cin)
    ini.conv(prefix + ".conv1", cin, cout)
    ini.norm(prefix + ".norm2", cout)
    ini.conv(prefix + ".conv2", cout, cout)
    if cin != cout:
        ini.conv(prefix + ".conv_shortcut", cin, cout, k=1)


def _init_attn(ini: Initializer, prefix: str, c: int):
    ini.norm(prefix + ".group_norm", c)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        ini.lin(f"{prefix}.{n}", c, c)


def init_vae(cfg: VAEConfig, generator: Optional[torch.Generator], *,
             device, dtype=torch.float32) -> Params:
    """Random-init params (uninitialised when generator is None)."""
    ini = Initializer(generator, device, dtype)
    chs = cfg.block_out_channels
    n = len(chs)

    # encoder
    ini.conv("encoder.conv_in", cfg.in_channels, chs[0])
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(cfg.layers_per_block):
            _init_resnet(ini, f"encoder.down_blocks.{i}.resnets.{j}",
                         cin if j == 0 else ch, ch)
        cin = ch
        if i < n - 1:
            ini.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    c = chs[-1]
    _init_resnet(ini, "encoder.mid_block.resnets.0", c, c)
    _init_attn(ini, "encoder.mid_block.attentions.0", c)
    _init_resnet(ini, "encoder.mid_block.resnets.1", c, c)
    ini.norm("encoder.conv_norm_out", c)
    ini.conv("encoder.conv_out", c, 2 * cfg.latent_channels)
    ini.conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels,
             k=1)

    # decoder
    ini.conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    ini.conv("decoder.conv_in", cfg.latent_channels, c)
    _init_resnet(ini, "decoder.mid_block.resnets.0", c, c)
    _init_attn(ini, "decoder.mid_block.attentions.0", c)
    _init_resnet(ini, "decoder.mid_block.resnets.1", c, c)
    cin = c
    for i, ch in enumerate(reversed(chs)):
        for j in range(cfg.layers_per_block + 1):
            _init_resnet(ini, f"decoder.up_blocks.{i}.resnets.{j}",
                         cin if j == 0 else ch, ch)
        cin = ch
        if i < n - 1:
            ini.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    ini.norm("decoder.conv_norm_out", chs[0])
    ini.conv("decoder.conv_out", chs[0], cfg.out_channels)
    return ini.p


# ---------------------------------------------------------------------------
# forward (NCHW inside)
# ---------------------------------------------------------------------------

def _resnet(p: Params, prefix: str, x, cfg: VAEConfig):
    h = group_norm(p, prefix + ".norm1", x, cfg.norm_num_groups, EPS)
    h = conv2d(p, prefix + ".conv1", silu(h), padding=(1, 1))
    h = group_norm(p, prefix + ".norm2", h, cfg.norm_num_groups, EPS)
    h = conv2d(p, prefix + ".conv2", silu(h), padding=(1, 1))
    if prefix + ".conv_shortcut.weight" in p:
        x = conv2d(p, prefix + ".conv_shortcut", x)
    return x + h


def _attn(p: Params, prefix: str, x, cfg: VAEConfig):
    """Single-head self-attention over spatial positions (the mid block).
    Its weights' names are the UNet's, so lora_tpu's rules shard them on
    tp; one head does not split, and under tensor parallelism it reads
    them whole (all-gathered)."""
    B, C, H, W = x.shape
    h = group_norm(p, prefix + ".group_norm", x, cfg.norm_num_groups, EPS)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    q = dense(p, prefix + ".to_q", h)
    k = dense(p, prefix + ".to_k", h)
    v = dense(p, prefix + ".to_v", h)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * C ** -0.5
    att = torch.softmax(logits, dim=-1).to(h.dtype)
    h = dense(p, prefix + ".to_out.0", torch.matmul(att, v))
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def vae_encode_moments(p: Params, x: torch.Tensor,
                       cfg: VAEConfig) -> torch.Tensor:
    """Image (B, H, W, 3) in [-1, 1] -> moments (B, h, w, 2 * latent):
    mean | logvar, NHWC."""
    n = len(cfg.block_out_channels)
    h = conv2d(p, "encoder.conv_in", x.permute(0, 3, 1, 2), padding=(1, 1))
    for i in range(n):
        for j in range(cfg.layers_per_block):
            h = _resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, cfg)
        if i < n - 1:
            # diffusers Downsample2D in the VAE pads (0, 1) asymmetrically
            h = F.pad(h, (0, 1, 0, 1))
            h = conv2d(p, f"encoder.down_blocks.{i}.downsamplers.0.conv", h,
                       stride=(2, 2))
    h = _resnet(p, "encoder.mid_block.resnets.0", h, cfg)
    h = _attn(p, "encoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "encoder.mid_block.resnets.1", h, cfg)
    h = group_norm(p, "encoder.conv_norm_out", h, cfg.norm_num_groups, EPS)
    h = conv2d(p, "encoder.conv_out", silu(h), padding=(1, 1))
    return conv2d(p, "quant_conv", h).permute(0, 2, 3, 1)


def vae_sample(moments: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + std * noise for the posterior moments; the noise is given, or
    drawn from `generator` in the moments' dtype."""
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    if noise is None:
        if generator is None:
            raise ValueError("vae_sample needs a generator or the noise")
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + std * noise.to(mean.dtype)


def vae_encode(p: Params, x: torch.Tensor, cfg: VAEConfig,
               generator: Optional[torch.Generator] = None,
               sample: bool = True,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image -> scaled latent (x scaling_factor), NHWC. sample=False takes
    the mean; sampling takes the posterior noise, or a generator to draw
    it from."""
    moments = vae_encode_moments(p, x, cfg)
    if sample:
        z = vae_sample(moments, generator, noise)
    else:
        z = moments.chunk(2, dim=-1)[0]
    return z * cfg.scaling_factor


def vae_decode(p: Params, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """Scaled latent (B, h, w, latent) -> image (B, H, W, 3) in [-1, 1],
    NHWC."""
    n = len(cfg.block_out_channels)
    h = conv2d(p, "post_quant_conv", (z / cfg.scaling_factor).permute(0, 3, 1, 2))
    h = conv2d(p, "decoder.conv_in", h, padding=(1, 1))
    h = _resnet(p, "decoder.mid_block.resnets.0", h, cfg)
    h = _attn(p, "decoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "decoder.mid_block.resnets.1", h, cfg)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, cfg)
        if i < n - 1:
            h = upsample_nearest_2x(h)
            h = conv2d(p, f"decoder.up_blocks.{i}.upsamplers.0.conv", h,
                       padding=(1, 1))
    h = group_norm(p, "decoder.conv_norm_out", h, cfg.norm_num_groups, EPS)
    h = conv2d(p, "decoder.conv_out", silu(h), padding=(1, 1))
    return h.permute(0, 2, 3, 1)


class VAE(ParamModule):
    """The VAE as an nn.Module whose state_dict keys are the flat names."""

    def __init__(self, cfg: VAEConfig, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(init_vae(cfg, generator, device=device, dtype=dtype))
        self.cfg = cfg

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return vae_decode(self.flat_params(), z, self.cfg)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample: bool = True) -> torch.Tensor:
        return vae_encode(self.flat_params(), x, self.cfg, generator, sample)
