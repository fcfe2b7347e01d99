"""Swin2SR super-resolution in PyTorch, without `transformers`: the
counterpart of Swin2SRForImageSuperResolution and Swin2SRImageProcessor,
which lora_tpu's swin_ir_sr (lora_tpu/data/preprocess.py:186-215) runs on
the host.

The processor rescales to [0, 1] and pads bottom and right, mirrored
(numpy's "symmetric"), to the next multiple of its divisor past the size
(a size already a multiple gains a whole divisor, as transformers pads).
The model: the mean subtracted, a shallow 3x3 conv, the patch embedding
(a 1x1 conv and a LayerNorm), residual Swin-v2 groups (each layer: cosine
attention in windows with the learned logit scale clamped at log 100,
the continuous position bias 16 * sigmoid(MLP(log-spaced offsets)), the
shift of every second layer with its -100 mask added twice as transformers
adds it, post-norm residuals, a GELU MLP; each group closed by a 3x3 conv,
the "1conv" connection), a LayerNorm, a 3x3 conv added to the shallow
features, and the "pixelshuffle" upsampler (conv, LeakyReLU, conv and
pixel shuffle per factor of 2, conv). The output keeps the processor's
padding, scaled (lora_tpu writes it as it is).

The windows are 64 tokens with a relative-position bias, which the flash
kernels do not take: the attention is written out here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import hf_dir
from .layers import Initializer, Params, dense, layer_norm


@dataclasses.dataclass(frozen=True)
class Swin2SRConfig:
    """transformers' Swin2SRConfig defaults (caidas/swin2SR-classical-sr-
    x2-64 is this configuration)."""
    image_size: int = 64
    patch_size: int = 1
    num_channels: int = 3
    num_channels_out: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    hidden_act: str = "gelu"
    use_absolute_embeddings: bool = False
    layer_norm_eps: float = 1e-5
    upscale: int = 2
    img_range: float = 1.0
    resi_connection: str = "1conv"
    upsampler: str = "pixelshuffle"


SWIN2SR_X2_64 = Swin2SRConfig()

_MEAN = (0.4488, 0.4371, 0.4040)
_UPSAMPLE_FEATURES = 64


def config_from_json(d: dict) -> Swin2SRConfig:
    cfg = hf_dir.config_from_dict(Swin2SRConfig, d)
    unsupported = {"patch_size": 1, "num_channels": 3,
                   "num_channels_out": 3, "use_absolute_embeddings": False,
                   "resi_connection": "1conv", "upsampler": "pixelshuffle"}
    for key, value in unsupported.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"Swin2SR {key}={getattr(cfg, key)!r}: the port "
                             f"runs {key}={value!r} only")
    if cfg.upscale & (cfg.upscale - 1):
        raise ValueError(f"Swin2SR upscale {cfg.upscale}: powers of 2 only")
    return cfg


def config_to_json(cfg: Swin2SRConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["depths"], d["num_heads"] = list(cfg.depths), list(cfg.num_heads)
    return {"architectures": ["Swin2SRForImageSuperResolution"],
            "model_type": "swin2sr", **d}


def _layers(cfg: Swin2SRConfig):
    for s, depth in enumerate(cfg.depths):
        for j in range(depth):
            yield s, j, f"swin2sr.encoder.stages.{s}.layers.{j}"


def init_swin2sr(cfg: Swin2SRConfig, generator: Optional[torch.Generator],
                 *, device, dtype=torch.float32) -> Params:
    """Random-init params (N(0, 0.02) weights, zero biases, unit norms,
    logit scales log 10; uninitialised without a generator)."""
    ini = Initializer(generator, device, dtype)
    p = ini.p
    c = cfg.embed_dim
    hidden = int(cfg.mlp_ratio * c)

    def lin(name, i, o, bias=True):
        p[name + ".weight"] = ini.normal((o, i), 0.02)
        if bias:
            p[name + ".bias"] = ini.zeros((o,))

    def conv(name, i, o, k):
        p[name + ".weight"] = ini.normal((o, i, k, k), 0.02)
        p[name + ".bias"] = ini.zeros((o,))

    conv("swin2sr.first_convolution", cfg.num_channels, c, 3)
    conv("swin2sr.embeddings.patch_embeddings.projection", c, c,
         cfg.patch_size)
    ini.norm("swin2sr.embeddings.patch_embeddings.layernorm", c)
    for s, j, b in _layers(cfg):
        a = b + ".attention.self"
        heads = cfg.num_heads[s]
        p[a + ".logit_scale"] = ini.zeros((heads, 1, 1)) + math.log(10.0)
        lin(a + ".continuous_position_bias_mlp.0", 2, 512)
        lin(a + ".continuous_position_bias_mlp.2", 512, heads, bias=False)
        lin(a + ".query", c, c, cfg.qkv_bias)
        lin(a + ".key", c, c, False)
        lin(a + ".value", c, c, cfg.qkv_bias)
        lin(b + ".attention.output.dense", c, c)
        ini.norm(b + ".layernorm_before", c)
        lin(b + ".intermediate.dense", c, hidden)
        lin(b + ".output.dense", hidden, c)
        ini.norm(b + ".layernorm_after", c)
    for s in range(len(cfg.depths)):
        conv(f"swin2sr.encoder.stages.{s}.conv", c, c, 3)
        conv(f"swin2sr.encoder.stages.{s}.patch_embed.projection", c, c,
             cfg.patch_size)
    ini.norm("swin2sr.layernorm", c)
    conv("swin2sr.conv_after_body", c, c, 3)
    f = _UPSAMPLE_FEATURES
    conv("upsample.conv_before_upsample", c, f, 3)
    for i in range(int(math.log2(cfg.upscale))):
        conv(f"upsample.upsample.convolution_{i}", f, 4 * f, 3)
    conv("upsample.final_convolution", f, cfg.num_channels_out, 3)
    return p


def _window_shift(cfg: Swin2SRConfig) -> Tuple[int, int]:
    """The layers' window and shift: transformers sizes them from the
    config's image_size (the grid it was trained on), not the input's."""
    res = cfg.image_size // cfg.patch_size
    ws = min(cfg.window_size, res)
    return ws, (0 if res <= ws else cfg.window_size // 2)


def _relative_tables(ws: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the log-spaced offsets the bias MLP reads, (2ws-1)^2 x 2; the
    index of each window position pair into them, ws^2 x ws^2), built in
    float32 on the CPU as transformers builds them."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.int64).float()
    table = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(
        1, 2, 0).contiguous()
    if ws > 1:
        table = table / (ws - 1)
    table = table * 8
    table = (torch.sign(table) * torch.log2(torch.abs(table) + 1.0)
             / math.log2(8))
    coords = torch.stack(torch.meshgrid([torch.arange(ws)] * 2,
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    index = rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]
    return table.reshape(-1, 2).to(device), index.reshape(-1).to(device)


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C), row-major windows."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = w.shape[-1]
    x = w.view(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def _shift_mask(H: int, W: int, ws: int, shift: int, device
                ) -> torch.Tensor:
    """(windows, ws^2, ws^2): -100 between positions of a shifted window
    that come from different regions of the image, else 0."""
    img = torch.zeros((1, H, W, 1))
    count = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[:, hs, wsl, :] = count
            count += 1
    mw = _partition(img, ws)[..., 0]
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


def _swin_layer(params: Params, b: str, x: torch.Tensor, H: int, W: int,
                heads: int, ws: int, shift: int, tables, mask,
                cfg: Swin2SRConfig) -> torch.Tensor:
    B, _, C = x.shape
    eps = cfg.layer_norm_eps
    shortcut = x
    h = x.view(B, H, W, C)
    pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
    h = F.pad(h, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    if shift:
        h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
    win = _partition(h, ws)
    nb, n = win.shape[:2]
    a = b + ".attention.self"

    def split(y):
        return y.view(nb, n, heads, C // heads).transpose(1, 2)

    q = split(dense(params, a + ".query", win))
    k = split(dense(params, a + ".key", win))
    v = split(dense(params, a + ".value", win))
    scores = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
    scale = torch.clamp(params[a + ".logit_scale"],
                        max=math.log(1.0 / 0.01)).exp()
    scores = scores * scale
    coords, index = tables
    bias = dense(params, a + ".continuous_position_bias_mlp.2", torch.relu(
        dense(params, a + ".continuous_position_bias_mlp.0", coords)))
    bias = bias[index].view(n, n, heads).permute(2, 0, 1)
    scores = scores + 16 * torch.sigmoid(bias)[None]
    if shift:
        nw = mask.shape[0]
        scores = scores.view(nb // nw, nw, heads, n, n) + mask[None, :, None]
        scores = (scores + mask[None, :, None]).view(nb, heads, n, n)
    ctx = torch.softmax(scores, dim=-1) @ v
    out = dense(params, b + ".attention.output.dense",
                ctx.transpose(1, 2).reshape(nb, n, C))
    h = _reverse(out.view(nb, ws, ws, C), ws, Hp, Wp)
    if shift:
        h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
    h = h[:, :H, :W].reshape(B, H * W, C)
    x = shortcut + layer_norm(params, b + ".layernorm_before", h, eps)
    act = hf_dir.act_fn(cfg.hidden_act)
    y = dense(params, b + ".output.dense",
              act(dense(params, b + ".intermediate.dense", x)))
    return x + layer_norm(params, b + ".layernorm_after", y, eps)


def _conv(params: Params, name: str, x: torch.Tensor,
          padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, params[name + ".weight"], params[name + ".bias"],
                    padding=padding)


@torch.no_grad()
def super_resolve(params: Params, pixel_values: torch.Tensor,
                  cfg: Swin2SRConfig) -> torch.Tensor:
    """Swin2SRForImageSuperResolution(pixel_values).reconstruction:
    (B, 3, H, W) in [0, 1] -> (B, 3, H * upscale, W * upscale)."""
    B, _, H, W = pixel_values.shape
    ws = cfg.window_size
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h or pad_w:
        # transformers pads here and then reads the features at the
        # unpadded size, which fails; the processor's padding avoids it
        raise ValueError(f"Swin2SR input {H}x{W} is not a multiple of the "
                         f"window {ws}: pad it as the processor does")
    mean = torch.tensor(_MEAN, device=pixel_values.device).view(1, 3, 1, 1)
    x = (pixel_values - mean) * cfg.img_range
    shallow = _conv(params, "swin2sr.first_convolution", x)
    c, eps = cfg.embed_dim, cfg.layer_norm_eps

    def embed(name, y):
        y = _conv(params, name, y, padding=0)
        return y.flatten(2).transpose(1, 2)

    def unembed(y):
        return y.transpose(1, 2).reshape(B, c, H, W)

    e = layer_norm(params, "swin2sr.embeddings.patch_embeddings.layernorm",
                   embed("swin2sr.embeddings.patch_embeddings.projection",
                         shallow), 1e-5)
    lws, shift = _window_shift(cfg)
    tables = _relative_tables(lws, x.device)
    # the shifted layers' mask, over the features padded to the window
    mask = (_shift_mask(-(-H // lws) * lws, -(-W // lws) * lws, lws, shift,
                        x.device) if shift else None)
    for s, depth in enumerate(cfg.depths):
        res = e
        for j in range(depth):
            e = _swin_layer(params, f"swin2sr.encoder.stages.{s}.layers.{j}",
                            e, H, W, cfg.num_heads[s], lws,
                            shift if j % 2 else 0, tables, mask, cfg)
        st = f"swin2sr.encoder.stages.{s}"
        e = embed(st + ".patch_embed.projection",
                  _conv(params, st + ".conv", unembed(e))) + res
    e = unembed(layer_norm(params, "swin2sr.layernorm", e, eps))
    y = _conv(params, "swin2sr.conv_after_body", e) + shallow
    y = F.leaky_relu(_conv(params, "upsample.conv_before_upsample", y))
    for i in range(int(math.log2(cfg.upscale))):
        y = F.pixel_shuffle(_conv(params,
                                  f"upsample.upsample.convolution_{i}", y), 2)
    y = _conv(params, "upsample.final_convolution", y)
    y = y / cfg.img_range + mean
    return y[:, :, :H * cfg.upscale, :W * cfg.upscale]


def processor_pixels(img: np.ndarray, pre: dict) -> np.ndarray:
    """Swin2SRImageProcessor of a (H, W, 3) uint8 image: rescaled in
    float64 and cast to float32, padded bottom and right (symmetric) to
    the next multiple of the divisor past the size; (3, H', W')."""
    x = np.asarray(img)
    if pre.get("do_rescale", True):
        x = x.astype(np.float64) * pre.get("rescale_factor", 1 / 255)
    x = x.astype(np.float32)
    if pre.get("do_pad", True):
        div = int(pre.get("size_divisor") or pre.get("pad_size") or 8)
        h, w = x.shape[:2]
        x = np.pad(x, ((0, (h // div + 1) * div - h),
                       (0, (w // div + 1) * div - w), (0, 0)),
                   mode="symmetric")
    return np.ascontiguousarray(x.transpose(2, 0, 1))


class Swin2SRUpscaler:
    """A Swin2SR directory on a device: the params and the processor's
    settings."""

    def __init__(self, model_dir: str, device="cuda"):
        device = hf_dir.check_device(device, "Swin2SR super-resolution")
        self.cfg = config_from_json(hf_dir.read_json(model_dir,
                                                     "config.json"))
        expected = hf_dir.shapes(init_swin2sr(self.cfg, None, device="meta"))
        self.params = hf_dir.load_params(model_dir, expected, device=device)
        self.device = device
        self.pre = hf_dir.read_json(model_dir, "preprocessor_config.json",
                                    required=False)

    def reconstruction(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        px = np.stack([processor_pixels(img, self.pre) for img in images])
        return super_resolve(self.params, torch.from_numpy(px).to(
            self.device), self.cfg)

    def upscale(self, image: np.ndarray) -> np.ndarray:
        """lora_tpu's output of one (H, W, 3) uint8 image: the
        reconstruction clamped to [0, 1], times 255, truncated to uint8;
        (H' * upscale, W' * upscale, 3), H' and W' the padded size."""
        o = self.reconstruction([image])[0].clamp_(0, 1)
        return (o.permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)
