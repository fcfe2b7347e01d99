"""Plain float32 Stable Diffusion 1.x / 2.x: the UNet, the CLIP text encoder
and the VAE, written from the published diffusers / transformers layouts.

Parameters are flat {diffusers name: tensor} dicts in torch weight layout
(Linear (out, in), Conv (out, in, kh, kw)); activations are NCHW. Every op
is a plain torch op in the parameters' dtype (float32 here, TF32 off: see
`plain_float32`), attention is softmax(q k^T / sqrt(d)) v in blocks of query
rows. A LoRA is {"sites": {module name: (up, down)}, "scale": float} and
adds scale * (x @ down^T) @ up^T at each named linear site. Under
`operand_precision(torch.float8_e4m3fn)` both operands of every matrix
product and convolution are first rounded to that type with a per-tensor
scale, as an fp8 tensor-core path rounds them (products still accumulate
in float32): the control, a precision below bfloat16.

Nothing here imports the program under test. `param_shapes` lists every
parameter of a configuration (the benchmark draws its weights from it).
Configurations are the published config.json dicts of the unet,
text_encoder and vae directories (see benchmark/configs/).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Shapes = List[Tuple[str, Tuple[int, ...], str]]

# rows of queries per attention block: bounds the (rows, keys) score tile
ATTN_ROWS = 1024

# the operands' type under operand_precision (None: float32 as they are)
_OPERAND = [None]


@contextlib.contextmanager
def plain_float32():
    """float32 matmuls and convolutions in full precision (no TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@contextlib.contextmanager
def operand_precision(dtype):
    """Round the operands of every product and convolution to `dtype`."""
    prev, _OPERAND[0] = _OPERAND[0], dtype
    try:
        yield
    finally:
        _OPERAND[0] = prev


def _op(x: torch.Tensor) -> torch.Tensor:
    """x as a product's operand: rounded to the operand type with a
    per-tensor scale (amax to the type's largest value); the gradient
    passes straight through the rounding."""
    dt = _OPERAND[0]
    if dt is None:
        return x
    s = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dt).max
    q = (x.detach() / s).to(dt).to(x.dtype) * s
    return x + (q - x).detach()


# ---------------------------------------------------------------------------
# parameter lists: (name, shape, kind); kind is "w" (a weight whose fan-in
# is shape[1:]'s product), "b" (a bias), "g" / "beta" (a norm's scale and
# shift), "emb" (an embedding table), "pos" (positions)
# ---------------------------------------------------------------------------

def _lin(out: Shapes, name: str, i: int, o: int, bias: bool = True):
    out.append((name + ".weight", (o, i), "w"))
    if bias:
        out.append((name + ".bias", (o,), "b"))


def _conv(out: Shapes, name: str, i: int, o: int, k: int = 3):
    out.append((name + ".weight", (o, i, k, k), "w"))
    out.append((name + ".bias", (o,), "b"))


def _norm(out: Shapes, name: str, c: int):
    out.append((name + ".weight", (c,), "g"))
    out.append((name + ".bias", (c,), "beta"))


def _heads(cfg: dict) -> List[int]:
    """Heads per down block. diffusers' `attention_head_dim` of the SD-1.x
    and SD-2.x configs is the number of heads (its num_attention_heads is
    unset), an int or one entry per down block."""
    h = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    n = len(cfg["block_out_channels"])
    return list(h) if isinstance(h, (list, tuple)) else [h] * n


def unet_blocks(cfg: dict):
    """The UNet's levels: [(kind, index, [(resnet in, out)...], attn?,
    heads, resample?)] for the down blocks, the mid block and the up
    blocks, in diffusers' order."""
    boc = cfg["block_out_channels"]
    n, L = len(boc), cfg["layers_per_block"]
    heads = _heads(cfg)
    blocks = []
    out_ch = boc[0]
    for i, btype in enumerate(cfg["down_block_types"]):
        in_ch, out_ch = out_ch, boc[i]
        res = [(in_ch if j == 0 else out_ch, out_ch) for j in range(L)]
        blocks.append(("down", i, res, btype.startswith("CrossAttn"),
                       heads[i], i < n - 1))
    blocks.append(("mid", 0, [(boc[-1], boc[-1])] * 2, True, heads[-1],
                   False))
    rev, rheads = list(reversed(boc)), list(reversed(heads))
    out_ch = rev[0]
    for i, btype in enumerate(cfg["up_block_types"]):
        prev, out_ch = out_ch, rev[i]
        skip_in = rev[min(i + 1, n - 1)]
        res = [((prev if j == 0 else out_ch)
                + (skip_in if j == L else out_ch), out_ch)
               for j in range(L + 1)]
        blocks.append(("up", i, res, btype.startswith("CrossAttn"),
                       rheads[i], i < n - 1))
    return blocks


def _block_prefix(kind: str, i: int) -> str:
    return "mid_block" if kind == "mid" else f"{kind}_blocks.{i}"


def unet_param_shapes(cfg: dict) -> Shapes:
    out: Shapes = []
    c0 = cfg["block_out_channels"][0]
    temb = 4 * c0
    xd = cfg["cross_attention_dim"]
    linear_proj = cfg.get("use_linear_projection", False)
    _conv(out, "conv_in", cfg["in_channels"], c0)
    _lin(out, "time_embedding.linear_1", c0, temb)
    _lin(out, "time_embedding.linear_2", temb, temb)

    def resnet(pre, i, o):
        _norm(out, pre + ".norm1", i)
        _conv(out, pre + ".conv1", i, o)
        _lin(out, pre + ".time_emb_proj", temb, o)
        _norm(out, pre + ".norm2", o)
        _conv(out, pre + ".conv2", o, o)
        if i != o:
            _conv(out, pre + ".conv_shortcut", i, o, k=1)

    def transformer(pre, c):
        _norm(out, pre + ".norm", c)
        (_lin if linear_proj else lambda o, n, i, oo: _conv(o, n, i, oo, 1))(
            out, pre + ".proj_in", c, c)
        tb = pre + ".transformer_blocks.0"
        for a, kv in (("attn1", c), ("attn2", xd)):
            _norm(out, f"{tb}.norm{1 if a == 'attn1' else 2}", c)
            _lin(out, f"{tb}.{a}.to_q", c, c, bias=False)
            _lin(out, f"{tb}.{a}.to_k", kv, c, bias=False)
            _lin(out, f"{tb}.{a}.to_v", kv, c, bias=False)
            _lin(out, f"{tb}.{a}.to_out.0", c, c)
        _norm(out, tb + ".norm3", c)
        _lin(out, tb + ".ff.net.0.proj", c, 8 * c)
        _lin(out, tb + ".ff.net.2", 4 * c, c)
        (_lin if linear_proj else lambda o, n, i, oo: _conv(o, n, i, oo, 1))(
            out, pre + ".proj_out", c, c)

    for kind, i, res, attn, _, resample in unet_blocks(cfg):
        pre = _block_prefix(kind, i)
        for j, (ci, co) in enumerate(res):
            resnet(f"{pre}.resnets.{j}", ci, co)
            if attn and (kind != "mid" or j == 0):
                transformer(f"{pre}.attentions.{j}", co)
        if resample:
            co = res[-1][1]
            _conv(out, f"{pre}.{'downsamplers' if kind == 'down' else 'upsamplers'}"
                  ".0.conv", co, co)
    _norm(out, "conv_norm_out", c0)
    _conv(out, "conv_out", c0, cfg["out_channels"])
    return out


def clip_param_shapes(cfg: dict) -> Shapes:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    out: Shapes = [
        ("text_model.embeddings.token_embedding.weight",
         (cfg["vocab_size"], d), "emb"),
        ("text_model.embeddings.position_embedding.weight",
         (cfg["max_position_embeddings"], d), "pos")]
    for i in range(cfg["num_hidden_layers"]):
        base = f"text_model.encoder.layers.{i}"
        _norm(out, base + ".layer_norm1", d)
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            _lin(out, f"{base}.self_attn.{proj}", d, d)
        _norm(out, base + ".layer_norm2", d)
        _lin(out, base + ".mlp.fc1", d, ff)
        _lin(out, base + ".mlp.fc2", ff, d)
    _norm(out, "text_model.final_layer_norm", d)
    return out


def vae_param_shapes(cfg: dict) -> Shapes:
    out: Shapes = []
    chs, L = cfg["block_out_channels"], cfg["layers_per_block"]
    lat = cfg["latent_channels"]

    def resnet(pre, i, o):
        _norm(out, pre + ".norm1", i)
        _conv(out, pre + ".conv1", i, o)
        _norm(out, pre + ".norm2", o)
        _conv(out, pre + ".conv2", o, o)
        if i != o:
            _conv(out, pre + ".conv_shortcut", i, o, k=1)

    def attn(pre, c):
        _norm(out, pre + ".group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _lin(out, f"{pre}.{n}", c, c)

    _conv(out, "encoder.conv_in", cfg["in_channels"], chs[0])
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(L):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   cin if j == 0 else ch, ch)
        cin = ch
        if i < len(chs) - 1:
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch)
    c = chs[-1]
    resnet("encoder.mid_block.resnets.0", c, c)
    attn("encoder.mid_block.attentions.0", c)
    resnet("encoder.mid_block.resnets.1", c, c)
    _norm(out, "encoder.conv_norm_out", c)
    _conv(out, "encoder.conv_out", c, 2 * lat)
    _conv(out, "quant_conv", 2 * lat, 2 * lat, k=1)
    _conv(out, "post_quant_conv", lat, lat, k=1)
    _conv(out, "decoder.conv_in", lat, c)
    resnet("decoder.mid_block.resnets.0", c, c)
    attn("decoder.mid_block.attentions.0", c)
    resnet("decoder.mid_block.resnets.1", c, c)
    cin = c
    for i, ch in enumerate(reversed(chs)):
        for j in range(L + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   cin if j == 0 else ch, ch)
        cin = ch
        if i < len(chs) - 1:
            _conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch)
    _norm(out, "decoder.conv_norm_out", chs[0])
    _conv(out, "decoder.conv_out", chs[0], cfg["out_channels"])
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(p: Params, name: str, x: torch.Tensor, lora=None) -> torch.Tensor:
    y = _op(x) @ _op(p[name + ".weight"]).t()
    b = p.get(name + ".bias")
    if b is not None:
        y = y + b
    if lora is not None and name in lora["sites"]:
        up, down = lora["sites"][name]
        h = _op(x) @ _op(down).t()
        y = y + lora["scale"] * (_op(h) @ _op(up).t())
    return y


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    return F.conv2d(_op(x), _op(p[name + ".weight"]), p[name + ".bias"],
                    stride, padding)


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"],
                        eps)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], eps)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = False) -> torch.Tensor:
    """(B, H, T, D) queries against (B, H, S, D) keys and values:
    softmax(q k^T / sqrt(D)) v, ATTN_ROWS query rows at a time."""
    scale = q.shape[-1] ** -0.5
    T, S = q.shape[2], k.shape[2]
    outs = []
    for r in range(0, T, ATTN_ROWS):
        s = (_op(q[:, :, r:r + ATTN_ROWS]) @ _op(k).transpose(-1, -2)) * scale
        if causal:
            rows = torch.arange(r, min(r + ATTN_ROWS, T), device=q.device)
            cols = torch.arange(S, device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        outs.append(_op(torch.softmax(s, dim=-1)) @ _op(v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, C = x.shape
    return x.reshape(B, L, heads, C // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       freq_shift: float) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    args = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

_ACTS = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
         "gelu": lambda x: F.gelu(x)}


def clip_text(p: Params, cfg: dict, ids: torch.Tensor,
              lora=None) -> torch.Tensor:
    """last_hidden_state (B, T, D) after the final LayerNorm. The token
    table may be longer than the vocabulary (textual-inversion rows)."""
    B, T = ids.shape
    eps = cfg.get("layer_norm_eps", 1e-5)
    heads = cfg["num_attention_heads"]
    act = _ACTS[cfg["hidden_act"]]
    x = (p["text_model.embeddings.token_embedding.weight"][ids]
         + p["text_model.embeddings.position_embedding.weight"][:T][None])
    for i in range(cfg["num_hidden_layers"]):
        base = f"text_model.encoder.layers.{i}"
        sa = base + ".self_attn"
        y = layer_norm(p, base + ".layer_norm1", x, eps)
        q, k, v = (_split_heads(linear(p, f"{sa}.{n}", y, lora), heads)
                   for n in ("q_proj", "k_proj", "v_proj"))
        x = x + linear(p, sa + ".out_proj",
                       _merge_heads(attend(q, k, v, causal=True)), lora)
        y = layer_norm(p, base + ".layer_norm2", x, eps)
        x = x + linear(p, base + ".mlp.fc2",
                       act(linear(p, base + ".mlp.fc1", y, lora)), lora)
    return layer_norm(p, "text_model.final_layer_norm", x, eps)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _unet_resnet(p, pre, x, temb, groups, eps):
    h = conv(p, pre + ".conv1", F.silu(group_norm(p, pre + ".norm1", x,
                                                  groups, eps)), padding=1)
    h = h + linear(p, pre + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(p, pre + ".conv2", F.silu(group_norm(p, pre + ".norm2", h,
                                                  groups, eps)), padding=1)
    if pre + ".conv_shortcut.weight" in p:
        x = conv(p, pre + ".conv_shortcut", x)
    return x + h


def _cross_attention(p, pre, x, ctx, heads, lora):
    q = _split_heads(linear(p, pre + ".to_q", x, lora), heads)
    k = _split_heads(linear(p, pre + ".to_k", ctx, lora), heads)
    v = _split_heads(linear(p, pre + ".to_v", ctx, lora), heads)
    return linear(p, pre + ".to_out.0", _merge_heads(attend(q, k, v)), lora)


def _transformer(p, pre, x, ctx, heads, groups, linear_proj, lora):
    B, C, H, W = x.shape
    h = group_norm(p, pre + ".norm", x, groups, 1e-6)
    if linear_proj:
        h = linear(p, pre + ".proj_in",
                   h.permute(0, 2, 3, 1).reshape(B, H * W, C), lora)
    else:
        h = conv(p, pre + ".proj_in", h).permute(0, 2, 3, 1).reshape(
            B, H * W, C)
    tb = pre + ".transformer_blocks.0"
    y = layer_norm(p, tb + ".norm1", h, 1e-5)
    h = h + _cross_attention(p, tb + ".attn1", y, y, heads, lora)
    y = layer_norm(p, tb + ".norm2", h, 1e-5)
    h = h + _cross_attention(p, tb + ".attn2", y, ctx, heads, lora)
    y = layer_norm(p, tb + ".norm3", h, 1e-5)
    val, gate = linear(p, tb + ".ff.net.0.proj", y, lora).chunk(2, dim=-1)
    h = h + linear(p, tb + ".ff.net.2", val * F.gelu(gate), lora)
    if linear_proj:
        h = linear(p, pre + ".proj_out", h, lora)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    else:
        h = conv(p, pre + ".proj_out",
                 h.reshape(B, H, W, C).permute(0, 3, 1, 2))
    return h + x


def unet(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor,
         ctx: torch.Tensor, lora=None) -> torch.Tensor:
    """The model output (B, C, h, w) for latents x (B, C, h, w), timesteps
    t (B,) and context (B, S, cross_attention_dim)."""
    groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    linear_proj = cfg.get("use_linear_projection", False)
    c0 = cfg["block_out_channels"][0]
    temb = timestep_embedding(t, c0, cfg["flip_sin_to_cos"],
                              cfg["freq_shift"])
    temb = linear(p, "time_embedding.linear_2",
                  F.silu(linear(p, "time_embedding.linear_1", temb)))
    h = conv(p, "conv_in", x, padding=1)
    skips = [h]
    for kind, i, res, attn, heads, resample in unet_blocks(cfg):
        pre = _block_prefix(kind, i)
        for j in range(len(res)):
            if kind == "up":
                h = torch.cat([h, skips.pop()], dim=1)
            h = _unet_resnet(p, f"{pre}.resnets.{j}", h, temb, groups, eps)
            if attn and (kind != "mid" or j == 0):
                h = _transformer(p, f"{pre}.attentions.{j}", h, ctx, heads,
                                 groups, linear_proj, lora)
            if kind == "down":
                skips.append(h)
        if resample and kind == "down":
            h = conv(p, f"{pre}.downsamplers.0.conv", h, stride=2, padding=1)
            skips.append(h)
        elif resample:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(p, f"{pre}.upsamplers.0.conv", h, padding=1)
    h = F.silu(group_norm(p, "conv_norm_out", h, groups, eps))
    return conv(p, "conv_out", h, padding=1)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

VAE_EPS = 1e-6


def _vae_resnet(p, pre, x, groups):
    h = conv(p, pre + ".conv1", F.silu(group_norm(p, pre + ".norm1", x,
                                                  groups, VAE_EPS)), padding=1)
    h = conv(p, pre + ".conv2", F.silu(group_norm(p, pre + ".norm2", h,
                                                  groups, VAE_EPS)), padding=1)
    if pre + ".conv_shortcut.weight" in p:
        x = conv(p, pre + ".conv_shortcut", x)
    return x + h


def _vae_attn(p, pre, x, groups):
    B, C, H, W = x.shape
    h = group_norm(p, pre + ".group_norm", x, groups, VAE_EPS)
    h = h.permute(0, 2, 3, 1).reshape(B, 1, H * W, C)
    q, k, v = (linear(p, f"{pre}.{n}", h) for n in ("to_q", "to_k", "to_v"))
    h = linear(p, pre + ".to_out.0", attend(q, k, v))
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _vae_mid(p, pre, h, groups):
    h = _vae_resnet(p, pre + ".resnets.0", h, groups)
    h = _vae_attn(p, pre + ".attentions.0", h, groups)
    return _vae_resnet(p, pre + ".resnets.1", h, groups)


def vae_decode(p: Params, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents (B, 4, h, w) -> images (B, 3, H, W) in about [-1, 1]."""
    chs, L, groups = (cfg["block_out_channels"], cfg["layers_per_block"],
                      cfg["norm_num_groups"])
    h = conv(p, "post_quant_conv", z / cfg["scaling_factor"])
    h = conv(p, "decoder.conv_in", h, padding=1)
    h = _vae_mid(p, "decoder.mid_block", h, groups)
    for i in range(len(chs)):
        for j in range(L + 1):
            h = _vae_resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, groups)
        if i < len(chs) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv", h,
                     padding=1)
    h = F.silu(group_norm(p, "decoder.conv_norm_out", h, groups, VAE_EPS))
    return conv(p, "decoder.conv_out", h, padding=1)


def vae_encode(p: Params, cfg: dict, x: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """Images (B, 3, H, W) in [-1, 1] -> scaled latents (B, 4, h, w): the
    posterior's mean + std * noise, times the scaling factor."""
    chs, L, groups = (cfg["block_out_channels"], cfg["layers_per_block"],
                      cfg["norm_num_groups"])
    h = conv(p, "encoder.conv_in", x, padding=1)
    for i in range(len(chs)):
        for j in range(L):
            h = _vae_resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h,
                            groups)
        if i < len(chs) - 1:  # diffusers' VAE pads (0, 1) before the stride
            h = conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), stride=2)
    h = _vae_mid(p, "encoder.mid_block", h, groups)
    h = F.silu(group_norm(p, "encoder.conv_norm_out", h, groups, VAE_EPS))
    moments = conv(p, "quant_conv", conv(p, "encoder.conv_out", h, padding=1))
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return (mean + std * noise) * cfg["scaling_factor"]
