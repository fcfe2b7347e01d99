"""LoRA as data, forward half: construction, scale tuning and the bypass
applied inside every dense/conv of the models.

A LoRA is a plain tree, as in the JAX package (lora_tpu/core/lora.py):

    lora = {
        "sites": {site_name: {"up": (out, r), "down": (r, in)}          # linear
                              or {"up": (out, r, 1, 1),
                                  "down": (r, in, kh, kw)}},            # conv
        "scale": 0-d float32 tensor,       # tune_lora_scale knob
    }

plus an optional per-site "diag" (r,) selector, full-rank {"delta": W}
entries (LyCORIS LoHa/LoKr/IA3), and stacked adapters (a leading K axis on
up/down, (K,) scale) routed per batch element by an "idx" (B,) tensor.
Injection is passing the tree to a model's forward; removal is passing None.
Weight layout is torch's Linear/Conv2d (out, in[, kh, kw]).

Training adds LoRA dropout: a keep mask on the bypass output, scaled by
1 / (1 - p), drawn from a per-site generator (models/layers.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .sites import Site

LoraTree = Dict[str, object]


def init_lora(
    sites: Sequence[Site],
    r: int = 4,
    *,
    generator: torch.Generator,
    device,
    scale: float = 1.0,
    dtype=torch.float32,
) -> LoraTree:
    """Fresh LoRA: down ~ N(0, 1/r) (std 1/r, as the reference draws it),
    up = 0, so the forward pass is initially unchanged."""
    site_params = {}
    for site in sites:
        if r > min(site.in_dim, site.out_dim):
            raise ValueError(
                f"LoRA rank {r} must be less or equal than "
                f"{min(site.in_dim, site.out_dim)} at {site.name}")
        if site.kind == "linear":
            down_shape, up_shape = (r, site.in_dim), (site.out_dim, r)
        else:
            down_shape = (r, site.in_dim) + tuple(site.kernel)
            up_shape = (site.out_dim, r, 1, 1)
        down = torch.randn(down_shape, generator=generator, device=device,
                           dtype=torch.float32) * (1.0 / r)
        site_params[site.name] = {
            "up": torch.zeros(up_shape, device=device, dtype=dtype),
            "down": down.to(dtype),
        }
    return {"sites": site_params,
            "scale": torch.tensor(scale, dtype=torch.float32, device=device)}


def lora_from_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    sites: Sequence[Site],
    scale: float = 1.0,
    dtype=torch.float32,
    device="cpu",
) -> LoraTree:
    """LoRA tree from an ordered [(up, down), ...] list (the on-disk order);
    conv tensors are told apart by ndim."""
    if len(pairs) != len(sites):
        raise ValueError(f"got {len(pairs)} pairs for {len(sites)} sites")
    site_params = {}
    for site, (up, down) in zip(sites, pairs):
        up = torch.as_tensor(np.array(up), device=device).to(dtype)
        down = torch.as_tensor(np.array(down), device=device).to(dtype)
        want_nd = 2 if site.kind == "linear" else 4
        if up.ndim != want_nd or down.ndim != want_nd:
            raise ValueError(
                f"site {site.name} expects {want_nd}-D tensors, got "
                f"up{tuple(up.shape)} down{tuple(down.shape)}")
        site_params[site.name] = {"up": up, "down": down}
    return {"sites": site_params,
            "scale": torch.tensor(scale, dtype=torch.float32, device=device)}


def lora_from_flat(
    weights: Sequence[np.ndarray], sites: Sequence[Site], scale: float = 1.0,
    dtype=torch.float32, device="cpu",
) -> LoraTree:
    from ..formats.safetensors_io import pairs_from_flat

    return lora_from_pairs(pairs_from_flat(list(weights)), sites, scale,
                           dtype, device)


def lora_to_pairs(lora: LoraTree,
                  sites: Sequence[Site]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Save-order float32 numpy pairs; up is pre-multiplied by the runtime
    scale (the reference's realize_as_lora; the diag selector is not
    folded in)."""
    scale = float(lora["scale"])
    out = []
    for site in sites:
        entry = lora["sites"][site.name]
        if "delta" in entry:
            raise ValueError(
                f"site {site.name} holds a full-rank delta (LoHa/LoKr/IA3); "
                "it has no (up, down) factorization")
        out.append((entry["up"].float().cpu().numpy() * scale,
                    entry["down"].float().cpu().numpy()))
    return out


def tune_lora_scale(lora: LoraTree, alpha: float) -> LoraTree:
    """Reference tune_lora_scale (lora.py:877-880), functionally."""
    device = lora["scale"].device
    return {**lora,
            "scale": torch.tensor(alpha, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# forward-pass application
# ---------------------------------------------------------------------------

def _maybe_diag(h: torch.Tensor, entry: dict, channel_dim: int) -> torch.Tensor:
    diag = entry.get("diag")
    if diag is None:
        return h
    shape = [1] * h.ndim
    shape[channel_dim] = -1
    return h * diag.to(h.dtype).reshape(shape)


def _dropout(d: torch.Tensor, generator: Optional[torch.Generator],
             p: float) -> torch.Tensor:
    """The JAX package's bypass dropout (lora_tpu/core/lora.py:381-383):
    keep each element with probability 1 - p and scale it by 1 / (1 - p).
    The mask comes from `generator` (one per site and step), so a
    checkpointed recompute draws the same mask."""
    if generator is None or p <= 0.0:
        return d
    keep = torch.rand(d.shape, generator=generator, device=d.device) < 1.0 - p
    return torch.where(keep, d / (1.0 - p), torch.zeros((), dtype=d.dtype,
                                                        device=d.device))


def lora_delta_dense(x: torch.Tensor, entry: dict, scale: torch.Tensor,
                     dropout_generator: Optional[torch.Generator] = None,
                     dropout_p: float = 0.0,
                     idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scale * up(selector(down(x))) for a linear site. x: (..., in).

    Stacked adapters (up (K, out, r)) route each batch element through
    adapter idx[b] (x must be batch-leading). A full-rank delta entry applies
    as one matmul: scale * x @ delta.T. Dropout (p > 0 with a generator)
    masks the bypass output before the scale."""
    dt = x.dtype
    if "delta" in entry:
        d = _dropout(x @ entry["delta"].to(dt).T, dropout_generator, dropout_p)
        return d * scale.to(dt)
    down, up = entry["down"], entry["up"]
    if up.ndim == 3:
        if idx is None:
            raise ValueError("stacked LoRA needs an 'idx' entry")
        dsel = down[idx].to(dt)   # (B, r, in)
        usel = up[idx].to(dt)     # (B, out, r)
        h = torch.einsum("b...i,bri->b...r", x, dsel)
        d = torch.einsum("b...r,bor->b...o", h, usel)
        s = scale[idx].to(dt)
        return d * s.reshape((-1,) + (1,) * (d.ndim - 1))
    h = x @ down.to(dt).T
    h = _maybe_diag(h, entry, -1)
    d = _dropout(h @ up.to(dt).T, dropout_generator, dropout_p)
    return d * scale.to(dt)


def lora_delta_conv(x: torch.Tensor, entry: dict, scale: torch.Tensor,
                    stride: Tuple[int, int], padding: Tuple[int, int],
                    dropout_generator: Optional[torch.Generator] = None,
                    dropout_p: float = 0.0,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv LoRA bypass: down conv in the site's geometry, then a 1x1 up
    conv. x: NCHW; kernels OIHW.

    Stacked adapters: the per-sample down convs run as one grouped
    convolution with the batch folded into feature groups, then a
    per-sample 1x1 up einsum. A full-rank delta applies as one conv.
    Dropout as in lora_delta_dense."""
    dt = x.dtype
    if "delta" in entry:
        d = F.conv2d(x, entry["delta"].to(dt), stride=stride, padding=padding)
        return _dropout(d, dropout_generator, dropout_p) * scale.to(dt)
    down, up = entry["down"], entry["up"]
    if up.ndim == 5:
        if idx is None:
            raise ValueError("stacked conv LoRA needs an 'idx' entry")
        B, C, H, W = x.shape
        dsel = down[idx].to(dt)          # (B, r, C, kh, kw)
        usel = up[idx].to(dt)            # (B, out, r, 1, 1)
        r = dsel.shape[1]
        xg = x.reshape(1, B * C, H, W)
        kg = dsel.reshape(B * r, C, *dsel.shape[3:])
        dn = F.conv2d(xg, kg, stride=stride, padding=padding, groups=B)
        dn = dn.reshape(B, r, dn.shape[2], dn.shape[3])
        dn = _maybe_diag(dn, entry, 1)
        d = torch.einsum("brhw,bor->bohw", dn, usel[..., 0, 0])
        s = scale[idx].to(dt)
        return d * s[:, None, None, None]
    dn = F.conv2d(x, down.to(dt), stride=stride, padding=padding)
    dn = _maybe_diag(dn, entry, 1)
    d = _dropout(F.conv2d(dn, up.to(dt)), dropout_generator, dropout_p)
    return d * scale.to(dt)
