"""Primitive layers over flat parameter dicts, and the module that owns them.

Params are a flat {dotted_name: tensor} dict in torch weight layout
(Linear (out, in), Conv (out, in, kh, kw)) with the HF diffusers /
transformers names, exactly the JAX package's (lora_tpu/models/layers.py).
`ParamModule` registers such a dict as the parameters of an nn.Module tree
that follows the dots, so `state_dict()` keys are the flat names and a
converted JAX checkpoint loads with `load_state_dict(..., strict=True)`.

Inside the models activations are NCHW; a contiguous NHWC tensor permuted
with `permute(0, 3, 1, 2)` is already channels_last, so the NHWC public
functions pay no copy for it. Every dense/conv consults an optional LoRA
tree (core/lora.py) by its own param name:

    lora = {"sites": {name: {"up", "down"[, "diag"]}}, "scale": tensor,
            "dropout_p": float, "rng": int step seed | None,
            "rows": (first, total) | None}

("rows": a data-parallel rank's block of the global batch, whose dropout
masks are the global batch's, cut to the block.) The params may be any
mapping: under FSDP (parallel/mesh.py ShardedParams) reading a weight
gathers it.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.lora import lora_delta_conv, lora_delta_dense
from ..core.quantize import SCALE_SUFFIX, dequantize_weight
from ..ops.int8_matmul import int8_matmul

Params = Dict[str, torch.Tensor]


class ParamModule(nn.Module):
    """nn.Module over a flat {dotted_name: tensor} dict. Parameters are
    frozen (requires_grad=False): only LoRA/TI leaves train, and they live
    outside the module (training/train_step.py). Int8-quantized weights and
    their float32 "*_scale" companions (core/quantize.py) are parameters
    like any other."""

    def __init__(self, params: Params):
        super().__init__()
        for name, t in params.items():
            self._owner(name, create=True).register_parameter(
                name.rsplit(".", 1)[-1], nn.Parameter(t, requires_grad=False))

    def _owner(self, name: str, create: bool = False) -> nn.Module:
        mod: nn.Module = self
        for part in name.split(".")[:-1]:
            child = mod._modules.get(part)
            if child is None:
                if not create:
                    raise KeyError(name)
                child = nn.Module()
                mod.add_module(part, child)
            mod = child
        return mod

    def flat_params(self) -> Params:
        return dict(self.named_parameters())

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Replace one parameter, shape included (the TI table grows)."""
        self._owner(name).register_parameter(
            name.rsplit(".", 1)[-1], nn.Parameter(value, requires_grad=False))


class Initializer:
    """Draws the random init of the JAX package's `_Init` helpers with a
    torch.Generator: uniform(-1/sqrt(fan_in), +) weights, zero biases, unit
    norms, drawn in float32 and cast. Without a generator it allocates
    uninitialised tensors of the same shapes (for load_state_dict)."""

    def __init__(self, generator: Optional[torch.Generator], device, dtype):
        self.generator = generator
        self.device = device
        self.dtype = dtype
        self.p: Params = {}

    def _uniform(self, shape, bound):
        if self.generator is None:
            return torch.empty(shape, device=self.device, dtype=self.dtype)
        w = torch.empty(shape, device=self.device, dtype=torch.float32)
        return w.uniform_(-bound, bound, generator=self.generator).to(self.dtype)

    def normal(self, shape, std):
        if self.generator is None:
            return torch.empty(shape, device=self.device, dtype=self.dtype)
        w = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (w * std).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def conv(self, name, i, o, k=3):
        self.p[name + ".weight"] = self._uniform((o, i, k, k),
                                                 (1.0 / (i * k * k)) ** 0.5)
        self.p[name + ".bias"] = self.zeros((o,))

    def lin(self, name, i, o):
        self.lin_nobias(name, i, o)
        self.p[name + ".bias"] = self.zeros((o,))

    def lin_nobias(self, name, i, o):
        self.p[name + ".weight"] = self._uniform((o, i), (1.0 / i) ** 0.5)

    def norm(self, name, c):
        self.p[name + ".weight"] = self.ones((c,))
        self.p[name + ".bias"] = self.zeros((c,))


def _lora_entry(lora, name):
    if lora is None:
        return None
    return lora["sites"].get(name)


def _lora_dropout(lora, name: str, device):
    """The per-site random source of LoRA dropout, the counterpart of the
    JAX _lora_rng (lora_tpu/models/layers.py:39-46, fold_in(rng,
    crc32(name))). torch cannot give the JAX bits, so each site gets its own
    generator seeded from (step seed, crc32(name)): the mask depends only on
    the step and the site, never on call order, so the recompute of a
    torch.utils.checkpoint region (which restores the global RNG state but
    not explicit generators) draws the same mask as the forward."""
    seed = lora.get("rng")
    p = lora.get("dropout_p", 0.0)
    if seed is None or p <= 0.0:
        return None, 0.0
    site = zlib.crc32(name.encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 31) | site)
    return gen, p


def dense(p: Params, name: str, x: torch.Tensor, lora=None) -> torch.Tensor:
    w = p[name + ".weight"]
    b = p.get(name + ".bias")
    if w.dtype == torch.int8 and w.ndim == 2:
        # int8 base (core/quantize.py): the int8 bytes go to the kernel,
        # which widens them on chip (ops/int8_matmul.py)
        y = int8_matmul(x, w, p[name + ".weight" + SCALE_SUFFIX])
        if b is not None:
            y = y + b.to(x.dtype)
    else:  # a float weight (dequantize_weight's w.to(dtype)), read once
        y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    entry = _lora_entry(lora, name)
    if entry is not None:
        gen, drop = _lora_dropout(lora, name, x.device)
        y = y + lora_delta_dense(x, entry, lora["scale"], gen, drop,
                                 idx=lora.get("idx"),
                                 dropout_rows=lora.get("rows"))
    return y


def conv2d(
    p: Params,
    name: str,
    x: torch.Tensor,
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
    lora=None,
) -> torch.Tensor:
    """x: NCHW. An int8 weight is dequantized with its per-channel scale
    (the JAX _weight, lora_tpu/models/layers.py:49)."""
    b = p.get(name + ".bias")
    y = F.conv2d(x, dequantize_weight(p, name + ".weight", x.dtype),
                 None if b is None else b.to(x.dtype), stride, padding)
    entry = _lora_entry(lora, name)
    if entry is not None:
        gen, drop = _lora_dropout(lora, name, x.device)
        y = y + lora_delta_conv(x, entry, lora["scale"], stride, padding,
                                gen, drop, idx=lora.get("idx"),
                                dropout_rows=lora.get("rows"))
    return y


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """GroupNorm over NCHW channels, statistics and affine in float32."""
    y = F.group_norm(x.float(), groups, p[name + ".weight"].float(),
                     p[name + ".bias"].float(), eps)
    return y.to(x.dtype)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], p[name + ".weight"].float(),
                     p[name + ".bias"].float(), eps)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0, max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding in float32, diffusers
    get_timestep_embedding semantics (SD1.5: [cos | sin])."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """x: NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
