"""UNet2DCondition (SD-1.x / SD-2.x / SDXL topologies) in PyTorch.

The counterpart of lora_tpu/models/unet.py. Param names match the HF
diffusers state_dict; structure comes from models/structure.py. LoRA rides
through every dense/conv via the lora tree (models/layers.py). The public
layout is NHWC, as in the JAX package; inside, activations are NCHW with the
channels_last memory format that the NHWC input already has. SDXL's
"text_time" micro-conditioning (cfg.addition_embed_type) adds the
add_embedding MLP over [te2's pooled embed | sinusoidal time_ids], summed
into the timestep embedding.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..parallel import tensor as tp_lib
from . import structure
from .config import UNetConfig
from .layers import (
    Initializer,
    ParamModule,
    Params,
    conv2d,
    dense,
    gelu,
    group_norm,
    layer_norm,
    silu,
    timestep_embedding,
    upsample_nearest_2x,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_resnet(ini: Initializer, prefix: str, spec: structure.ResnetSpec):
    ini.norm(prefix + ".norm1", spec.in_channels)
    ini.conv(prefix + ".conv1", spec.in_channels, spec.out_channels)
    ini.lin(prefix + ".time_emb_proj", spec.temb_channels, spec.out_channels)
    ini.norm(prefix + ".norm2", spec.out_channels)
    ini.conv(prefix + ".conv2", spec.out_channels, spec.out_channels)
    if spec.has_shortcut:
        ini.conv(prefix + ".conv_shortcut", spec.in_channels,
                 spec.out_channels, k=1)


def _init_transformer(ini: Initializer, prefix: str, spec: structure.AttnSpec):
    c, xd = spec.channels, spec.cross_dim
    ini.norm(prefix + ".norm", c)
    if spec.linear_proj:  # SD2.x: Linear over the flattened sequence
        ini.lin(prefix + ".proj_in", c, c)
    else:
        ini.conv(prefix + ".proj_in", c, c, k=1)
    for k in range(spec.n_blocks):
        tb = f"{prefix}.transformer_blocks.{k}"
        for n in ("norm1", "norm2", "norm3"):
            ini.norm(f"{tb}.{n}", c)
        for a, kv in (("attn1", c), ("attn2", xd)):
            ini.lin_nobias(f"{tb}.{a}.to_q", c, c)
            ini.lin_nobias(f"{tb}.{a}.to_k", kv, c)
            ini.lin_nobias(f"{tb}.{a}.to_v", kv, c)
            ini.lin(f"{tb}.{a}.to_out.0", c, c)
        ini.lin(f"{tb}.ff.net.0.proj", c, 8 * c)
        ini.lin(f"{tb}.ff.net.2", 4 * c, c)
    if spec.linear_proj:
        ini.lin(prefix + ".proj_out", c, c)
    else:
        ini.conv(prefix + ".proj_out", c, c, k=1)


def init_unet(cfg: UNetConfig, generator: Optional[torch.Generator], *,
              device, dtype=torch.float32) -> Params:
    """Random-init params (uninitialised when generator is None)."""
    ini = Initializer(generator, device, dtype)
    c0 = cfg.block_out_channels[0]
    temb = structure.time_embed_dim(cfg)
    ini.conv("conv_in", cfg.in_channels, c0)
    ini.lin("time_embedding.linear_1", c0, temb)
    ini.lin("time_embedding.linear_2", temb, temb)
    if cfg.addition_embed_type == "text_time":
        # SDXL micro-conditioning MLP over [pooled text | sinus(time_ids)]
        ini.lin("add_embedding.linear_1",
                cfg.projection_class_embeddings_input_dim, temb)
        ini.lin("add_embedding.linear_2", temb, temb)

    for i, block in enumerate(structure.down_blocks(cfg)):
        pre = f"down_blocks.{i}"
        for j, res in enumerate(block.resnets):
            _init_resnet(ini, f"{pre}.resnets.{j}", res)
        for j, attn in enumerate(block.attentions):
            if attn is not None:
                _init_transformer(ini, f"{pre}.attentions.{j}", attn)
        if block.has_downsample:
            out_ch = block.resnets[-1].out_channels
            ini.conv(f"{pre}.downsamplers.0.conv", out_ch, out_ch)

    mid = structure.mid_block(cfg)
    _init_resnet(ini, "mid_block.resnets.0", mid.resnets[0])
    _init_transformer(ini, "mid_block.attentions.0", mid.attentions[0])
    _init_resnet(ini, "mid_block.resnets.1", mid.resnets[1])

    for i, block in enumerate(structure.up_blocks(cfg)):
        pre = f"up_blocks.{i}"
        for j, res in enumerate(block.resnets):
            _init_resnet(ini, f"{pre}.resnets.{j}", res)
        for j, attn in enumerate(block.attentions):
            if attn is not None:
                _init_transformer(ini, f"{pre}.attentions.{j}", attn)
        if block.has_upsample:
            out_ch = block.resnets[-1].out_channels
            ini.conv(f"{pre}.upsamplers.0.conv", out_ch, out_ch)

    ini.norm("conv_norm_out", cfg.block_out_channels[0])
    ini.conv("conv_out", cfg.block_out_channels[0], cfg.out_channels)
    return ini.p


# ---------------------------------------------------------------------------
# forward (NCHW inside)
# ---------------------------------------------------------------------------

def _resnet(p: Params, prefix: str, x, temb, cfg: UNetConfig,
            spec: structure.ResnetSpec, lora):
    h = group_norm(p, prefix + ".norm1", x, cfg.norm_num_groups, cfg.norm_eps)
    h = conv2d(p, prefix + ".conv1", silu(h), padding=(1, 1), lora=lora)
    t = dense(p, prefix + ".time_emb_proj", silu(temb), lora)
    h = h + t[:, :, None, None]
    h = group_norm(p, prefix + ".norm2", h, cfg.norm_num_groups, cfg.norm_eps)
    h = conv2d(p, prefix + ".conv2", silu(h), padding=(1, 1), lora=lora)
    if spec.has_shortcut:
        x = conv2d(p, prefix + ".conv_shortcut", x, lora=lora)
    return x + h


_ATTN = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight")


def _attention(p: Params, prefix: str, x, ctx, heads: int, lora):
    """One CrossAttention: x (B, T, C) queries, ctx (B, S, Ckv) keys/values.
    Under tensor parallelism (parallel/tensor.py) a rank runs heads / tp
    of the heads when the block splits."""
    B, T, C = x.shape
    split = None
    mesh = tp_lib.split_block(p, [prefix + n for n in _ATTN], heads)
    if mesh is not None:
        split = "column"
        heads //= mesh.shape["tp"]
        xs = tp_lib.copy_to_tp(x, mesh)
        ctx = xs if ctx is x else tp_lib.copy_to_tp(ctx, mesh)
        x = xs
    q = dense(p, prefix + ".to_q", x, lora, split)
    k = dense(p, prefix + ".to_k", ctx, lora, split)
    v = dense(p, prefix + ".to_v", ctx, lora, split)
    S = ctx.shape[1]
    dh = q.shape[-1] // heads

    def split_heads(y, L):  # (B, L, heads * dh) -> (B, heads, L, dh), a view
        return y.reshape(B, L, heads, dh).transpose(1, 2)

    att = attention(split_heads(q, T), split_heads(k, S), split_heads(v, S))
    att = att.transpose(1, 2).reshape(B, T, heads * dh)
    return dense(p, prefix + ".to_out.0", att, lora,
                 "row" if split else None)


def _ff_geglu(p: Params, prefix: str, x, lora):
    """GEGLU feed-forward; split over tp when both weights are (the rank's
    rows of net.0.proj are its value block then its gate block)."""
    split = None
    mesh = tp_lib.split_block(p, [prefix + ".net.0.proj.weight",
                                  prefix + ".net.2.weight"])
    if mesh is not None:
        split = "column"
        x = tp_lib.copy_to_tp(x, mesh)
    y = dense(p, prefix + ".net.0.proj", x, lora, split)
    val, gate = y.chunk(2, dim=-1)
    return dense(p, prefix + ".net.2", val * gelu(gate), lora,
                 "row" if split else None)


def _transformer(p: Params, prefix: str, x, ctx, cfg: UNetConfig,
                 spec: structure.AttnSpec, lora):
    B, C, H, W = x.shape
    res = x
    h = group_norm(p, prefix + ".norm", x, cfg.norm_num_groups, 1e-6)
    if spec.linear_proj:  # SD2.x: flatten first, then Linear (diffusers order)
        h = dense(p, prefix + ".proj_in",
                  h.permute(0, 2, 3, 1).reshape(B, H * W, C), lora)
    else:
        h = conv2d(p, prefix + ".proj_in", h, lora=lora)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    for k in range(spec.n_blocks):
        tb = f"{prefix}.transformer_blocks.{k}"
        y = layer_norm(p, f"{tb}.norm1", h, 1e-5)
        h = h + _attention(p, f"{tb}.attn1", y, y, spec.num_heads, lora)
        y = layer_norm(p, f"{tb}.norm2", h, 1e-5)
        h = h + _attention(p, f"{tb}.attn2", y, ctx.to(h.dtype),
                           spec.num_heads, lora)
        y = layer_norm(p, f"{tb}.norm3", h, 1e-5)
        h = h + _ff_geglu(p, f"{tb}.ff", y, lora)
    if spec.linear_proj:  # Linear before unflattening (diffusers order)
        h = dense(p, prefix + ".proj_out", h, lora)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    else:
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        h = conv2d(p, prefix + ".proj_out", h, lora=lora)
    return h + res


def unet_forward(
    params: Params,
    sample: torch.Tensor,                 # (B, H, W, Cin) latents, NHWC
    timesteps: torch.Tensor,              # (B,) int/float
    encoder_hidden_states: torch.Tensor,  # (B, S, cross_dim)
    cfg: UNetConfig,
    lora=None,
    remat: bool = False,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Noise prediction (B, H, W, Cout), NHWC.

    remat=True is gradient checkpointing: each resnet and transformer block
    keeps only its inputs for the backward and recomputes the rest there
    (torch.utils.checkpoint, non-reentrant), as jax.checkpoint does in the
    JAX package (lora_tpu/models/unet.py:247-253).

    added_cond (SDXL, cfg.addition_embed_type == "text_time"):
    {"text_embeds": (B, pooled_dim), "time_ids": (B, 6)}, te2's pooled
    embedding and the original-size / crop / target-size ids, embedded and
    summed into the timestep embedding; required iff the config declares
    addition_embed_type."""
    if (added_cond is None) != (cfg.addition_embed_type is None):
        raise ValueError(
            f"added_cond must be passed iff the config declares "
            f"addition_embed_type (got added_cond="
            f"{'set' if added_cond is not None else 'None'} with "
            f"addition_embed_type={cfg.addition_embed_type!r})")
    resnet_fn, transformer_fn = _resnet, _transformer
    if remat:
        # only the activations go through checkpoint's arguments: it walks
        # every tensor argument of every region (device and RNG-state
        # bookkeeping), and the params and LoRA tree are ~1,000 tensors
        def resnet_fn(p, prefix, x, temb, cfg, spec, lora):
            return checkpoint(functools.partial(
                _resnet, p, prefix, cfg=cfg, spec=spec, lora=lora),
                x, temb, use_reentrant=False)

        def transformer_fn(p, prefix, x, ctx, cfg, spec, lora):
            return checkpoint(functools.partial(
                _transformer, p, prefix, cfg=cfg, spec=spec, lora=lora),
                x, ctx, use_reentrant=False)

    dt = sample.dtype
    c0 = cfg.block_out_channels[0]
    temb = timestep_embedding(
        timesteps, c0, flip_sin_to_cos=cfg.flip_sin_to_cos,
        freq_shift=cfg.freq_shift).to(dt)
    temb = dense(params, "time_embedding.linear_1", temb)
    temb = dense(params, "time_embedding.linear_2", silu(temb))
    if added_cond is not None:
        # six time_ids, each a sinusoidal embedding in the timesteps'
        # [cos | sin] layout, flattened after the pooled text embed, then a
        # 2-layer MLP summed into temb before any block reads it
        time_ids = added_cond["time_ids"]
        t_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            freq_shift=cfg.freq_shift).reshape(time_ids.shape[0], -1)
        add = torch.cat([added_cond["text_embeds"].to(dt), t_emb.to(dt)],
                        dim=-1)
        add = dense(params, "add_embedding.linear_1", add)
        temb = temb + dense(params, "add_embedding.linear_2", silu(add))

    h = conv2d(params, "conv_in", sample.permute(0, 3, 1, 2), padding=(1, 1))
    skips: List[torch.Tensor] = [h]

    for i, block in enumerate(structure.down_blocks(cfg)):
        pre = f"down_blocks.{i}"
        for j, res in enumerate(block.resnets):
            h = resnet_fn(params, f"{pre}.resnets.{j}", h, temb, cfg, res, lora)
            if block.attentions[j] is not None:
                h = transformer_fn(params, f"{pre}.attentions.{j}", h,
                                   encoder_hidden_states, cfg,
                                   block.attentions[j], lora)
            skips.append(h)
        if block.has_downsample:
            h = conv2d(params, f"{pre}.downsamplers.0.conv", h,
                       stride=(2, 2), padding=(1, 1), lora=lora)
            skips.append(h)

    mid = structure.mid_block(cfg)
    h = resnet_fn(params, "mid_block.resnets.0", h, temb, cfg, mid.resnets[0],
                  lora)
    h = transformer_fn(params, "mid_block.attentions.0", h,
                       encoder_hidden_states, cfg, mid.attentions[0], lora)
    h = resnet_fn(params, "mid_block.resnets.1", h, temb, cfg, mid.resnets[1],
                  lora)

    for i, block in enumerate(structure.up_blocks(cfg)):
        pre = f"up_blocks.{i}"
        for j, res in enumerate(block.resnets):
            h = torch.cat([h, skips.pop()], dim=1)
            h = resnet_fn(params, f"{pre}.resnets.{j}", h, temb, cfg, res, lora)
            if block.attentions[j] is not None:
                h = transformer_fn(params, f"{pre}.attentions.{j}", h,
                                   encoder_hidden_states, cfg,
                                   block.attentions[j], lora)
        if block.has_upsample:
            h = upsample_nearest_2x(h)
            h = conv2d(params, f"{pre}.upsamplers.0.conv", h, padding=(1, 1),
                       lora=lora)

    h = group_norm(params, "conv_norm_out", h, cfg.norm_num_groups,
                   cfg.norm_eps)
    h = conv2d(params, "conv_out", silu(h), padding=(1, 1))
    return h.permute(0, 2, 3, 1)


class UNet(ParamModule):
    """The UNet as an nn.Module whose state_dict keys are the flat names."""

    # the directory's upcast_attention, written back by save_pipeline_params;
    # no arithmetic reads it (models/hf_import.py load_upcast_attention)
    upcast_attention = False

    def __init__(self, cfg: UNetConfig, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(init_unet(cfg, generator, device=device, dtype=dtype))
        self.cfg = cfg

    def forward(self, sample, timesteps, encoder_hidden_states, lora=None,
                remat: bool = False, added_cond=None):
        return unet_forward(self.flat_params(), sample, timesteps,
                            encoder_hidden_states, self.cfg, lora, remat,
                            added_cond)
