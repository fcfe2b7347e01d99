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

The combinators are pure functions on trees, as in lora_tpu: merge_loras,
add_lora, join_loras (rank concatenation), stack_loras + with_lora_idx
(K adapters routed per batch element), set_lora_diag, lora_ranks,
inspect_lora and collapse_lora (fold into the base weights). A tree loaded
from a LyCORIS file (formats/lycoris.py) may also carry "param_deltas"
({param path: f32 tensor}, norm and bias deltas), which the pipeline
applies to its base params.
"""

from __future__ import annotations

import contextlib
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


def _to_tensor(a, device, dtype) -> torch.Tensor:
    """A numpy array (copied) or a tensor, on `device` in `dtype`."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype)


def lora_from_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    sites: Sequence[Site],
    scale: float = 1.0,
    dtype=torch.float32,
    device="cpu",
) -> LoraTree:
    """LoRA tree from an ordered [(up, down), ...] list (the on-disk order;
    numpy arrays or tensors); conv tensors are told apart by ndim."""
    if len(pairs) != len(sites):
        raise ValueError(f"got {len(pairs)} pairs for {len(sites)} sites")
    site_params = {}
    for site, (up, down) in zip(sites, pairs):
        up = _to_tensor(up, device, dtype)
        down = _to_tensor(down, device, dtype)
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


def lora_from_deltas(
    deltas: Sequence, sites: Sequence[Site], scale: float = 1.0,
    dtype=torch.float32, device="cpu",
) -> LoraTree:
    """LoRA tree of full-rank weight deltas (numpy arrays or tensors, torch
    weight layout: (out, in) linear / OIHW conv): the exact form of the
    composed LyCORIS LoHa/LoKr/IA3/... modules."""
    if len(deltas) != len(sites):
        raise ValueError(f"got {len(deltas)} deltas for {len(sites)} sites")
    site_params = {}
    for site, d in zip(sites, deltas):
        d = _to_tensor(d, device, dtype)
        want = ((site.out_dim, site.in_dim) if site.kind == "linear"
                else (site.out_dim, site.in_dim) + tuple(site.kernel))
        if tuple(d.shape) != want:
            raise ValueError(
                f"site {site.name} expects delta shape {want}, got "
                f"{tuple(d.shape)}")
        site_params[site.name] = {"delta": d}
    return {"sites": site_params,
            "scale": torch.tensor(scale, dtype=torch.float32, device=device)}


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
                f"it has no (up, down) factorization — distill one with "
                f"core.svd first")
        out.append((entry["up"].detach().float().cpu().numpy() * scale,
                    entry["down"].detach().float().cpu().numpy()))
    return out


def tune_lora_scale(lora: LoraTree, alpha: float) -> LoraTree:
    """Reference tune_lora_scale (lora.py:877-880), functionally."""
    device = lora["scale"].device
    return {**lora,
            "scale": torch.tensor(alpha, dtype=torch.float32, device=device)}


@contextlib.contextmanager
def f32_products():
    """Matmuls inside run in true f32 (TF32 off on the card), whatever the
    caller set: adapter weights are composed and folded in f32, as
    lora_tpu composes them on the host."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def set_lora_diag(lora: LoraTree, diag) -> LoraTree:
    """A per-rank diagonal selector on every site (the reference's
    set_lora_diag, lora.py:883-886)."""
    diag = torch.as_tensor(diag, dtype=torch.float32,
                           device=lora["scale"].device)
    return {**lora, "sites": {name: {**entry, "diag": diag}
                              for name, entry in lora["sites"].items()}}


def _unit_scale(lora: LoraTree) -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32,
                        device=lora["scale"].device)


def merge_loras(l1: LoraTree, l2: LoraTree, alpha_1: float,
                alpha_2: float) -> LoraTree:
    """Per-tensor weighted sum (`lora_add --mode=lpl`)."""
    if set(l1["sites"]) != set(l2["sites"]):
        raise ValueError("merge requires identical site sets")
    sites = {}
    for name in l1["sites"]:
        a, b = l1["sites"][name], l2["sites"][name]
        if ("delta" in a) != ("delta" in b):
            raise ValueError(
                f"cannot merge a factored LoRA with a full-rank delta at "
                f"{name}")
        if "delta" in a:
            if a["delta"].shape != b["delta"].shape:
                raise ValueError(f"shape mismatch at {name}")
            sites[name] = {
                "delta": alpha_1 * a["delta"] + alpha_2 * b["delta"]}
            continue
        if a["up"].shape != b["up"].shape or \
                a["down"].shape != b["down"].shape:
            raise ValueError(f"shape mismatch at {name}")
        sites[name] = {"up": alpha_1 * a["up"] + alpha_2 * b["up"],
                       "down": alpha_1 * a["down"] + alpha_2 * b["down"]}
    return {"sites": sites, "scale": _unit_scale(l1)}


def add_lora(lora: LoraTree, incoming: LoraTree, alpha: float = 1.0,
             beta: float = 1.0) -> LoraTree:
    """up/down <- alpha * incoming + beta * existing (the reference's
    monkeypatch_add_lora, lora.py:850-874)."""
    sites = {}
    for name, entry in lora["sites"].items():
        inc = incoming["sites"][name]
        if "delta" in entry or "delta" in inc:
            if not ("delta" in entry and "delta" in inc):
                raise ValueError(
                    f"cannot mix a factored LoRA with a full-rank delta at "
                    f"{name}")
            sites[name] = {
                "delta": alpha * inc["delta"] + beta * entry["delta"]}
            continue
        sites[name] = {"up": alpha * inc["up"] + beta * entry["up"],
                       "down": alpha * inc["down"] + beta * entry["down"]}
    return {**lora, "sites": sites}


def join_loras(loras: Sequence[LoraTree]) -> Tuple[LoraTree, List[int]]:
    """N LoRAs as one of rank sum(r_i): down concatenated on the rank axis
    0, up on axis 1 (the reference's lora_join, lora_manager.py:44-55).
    Returns (joined, ranklist) for block-diagonal selector tuning."""
    names = set(loras[0]["sites"])
    for other in loras[1:]:
        if set(other["sites"]) != names:
            raise ValueError("join requires identical site sets")
    ranklist = []
    for lora in loras:
        if any("delta" in e for e in lora["sites"].values()):
            raise ValueError(
                "join requires factored (up, down) LoRAs; full-rank "
                "LoHa/LoKr/IA3 deltas have no rank axis to concatenate")
        ranks = {e["down"].shape[0] for e in lora["sites"].values()}
        if len(ranks) > 1:
            raise ValueError("Rank should be the same per model")
        ranklist.append(ranks.pop() if ranks else 0)
    sites = {name: {
        "up": torch.cat([l["sites"][name]["up"] for l in loras], dim=1),
        "down": torch.cat([l["sites"][name]["down"] for l in loras], dim=0),
    } for name in loras[0]["sites"]}
    return {"sites": sites, "scale": _unit_scale(loras[0])}, ranklist


def _entry_delta(entry: dict) -> torch.Tensor:
    """A site's weight delta in f32: the full-rank entry, or up @ down with
    conv kernels flattened to 2-D (lora.py:635-669)."""
    if "delta" in entry:
        return entry["delta"].float()
    up, down = entry["up"].float(), entry["down"].float()
    with f32_products():
        return up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)


def collapse_lora(params: Dict[str, torch.Tensor], lora: LoraTree,
                  alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """Fold the LoRA into the base weights: W += alpha * delta, in f32 and
    cast back to W's dtype (the runtime scale and selector are not
    applied, as in the reference). Returns a new params dict. An int8
    (quantized) weight has no f32 value to fold into: that raises."""
    out = dict(params)
    for name, entry in lora["sites"].items():
        key = name + ".weight"
        w = out[key]
        if w.dtype == torch.int8:
            raise ValueError(
                f"collapse_lora: {key!r} is an int8-quantized weight; "
                f"collapse the LoRA before quantize_base")
        delta = _entry_delta(entry).to(w.device)
        out[key] = (w.float() + alpha * delta.reshape(w.shape)).to(w.dtype)
    return out


def lora_ranks(lora: LoraTree, sites: Sequence[Site]) -> List[int]:
    out = []
    for s in sites:
        entry = lora["sites"][s.name]
        if "delta" in entry:
            raise ValueError(
                f"site {s.name} holds a full-rank delta; it has no rank")
        out.append(int(entry["down"].shape[0]))
    return out


def inspect_lora(lora: LoraTree) -> Dict[str, List[float]]:
    """Per-site mean |delta| drift diagnostic (lora.py:1025-1042)."""
    return {name: [float(_entry_delta(entry).abs().mean())]
            for name, entry in lora["sites"].items()}


def stack_loras(loras: Sequence[LoraTree]) -> LoraTree:
    """K same-shape LoRAs as one tree for per-sample routed serving: up
    (K, out, r[, 1, 1]), down (K, r, in[, kh, kw]), scale (K,). At apply
    time the tree carries "idx" (B,) (with_lora_idx; the pipeline's
    lora_idx=) picking an adapter per batch element."""
    names = set(loras[0]["sites"])
    for other in loras[1:]:
        if set(other["sites"]) != names:
            raise ValueError("stack requires identical site sets")
    sites = {}
    for name in loras[0]["sites"]:
        entries = [l["sites"][name] for l in loras]
        if any("delta" in e for e in entries):
            raise ValueError(
                f"stack requires factored (up, down) LoRAs at {name}; "
                f"full-rank LoHa/LoKr/IA3 deltas are not routable")
        shapes = {(tuple(e["up"].shape), tuple(e["down"].shape))
                  for e in entries}
        if len(shapes) > 1:
            raise ValueError(f"rank mismatch at {name}: {shapes}")
        sites[name] = {"up": torch.stack([e["up"] for e in entries]),
                       "down": torch.stack([e["down"] for e in entries])}
    scale = torch.stack([l["scale"].to(torch.float32).reshape(())
                         for l in loras])
    return {"sites": sites, "scale": scale}


def with_lora_idx(lora: LoraTree, idx) -> LoraTree:
    """Attach the per-sample adapter index to a stacked LoRA tree."""
    return {**lora, "idx": torch.as_tensor(idx, dtype=torch.long,
                                           device=lora["scale"].device)}


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
             p: float, rows: Optional[Tuple[int, int]] = None
             ) -> torch.Tensor:
    """The JAX package's bypass dropout (lora_tpu/core/lora.py:381-383):
    keep each element with probability 1 - p and scale it by 1 / (1 - p).
    The mask comes from `generator` (one per site and step), so a
    checkpointed recompute draws the same mask. rows = (first, total): d
    holds those rows of a batch of `total` (a data-parallel rank's block),
    and the mask is the whole batch's, cut to them."""
    if generator is None or p <= 0.0:
        return d
    if rows is None:
        keep = torch.rand(d.shape, generator=generator, device=d.device)
    else:
        first, total = rows
        keep = torch.rand((total,) + tuple(d.shape[1:]), generator=generator,
                          device=d.device)[first:first + d.shape[0]]
    keep = keep < 1.0 - p
    return torch.where(keep, d / (1.0 - p), torch.zeros((), dtype=d.dtype,
                                                        device=d.device))


def lora_delta_dense(x: torch.Tensor, entry: dict, scale: torch.Tensor,
                     dropout_generator: Optional[torch.Generator] = None,
                     dropout_p: float = 0.0,
                     idx: Optional[torch.Tensor] = None,
                     dropout_rows: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """scale * up(selector(down(x))) for a linear site. x: (..., in).

    Stacked adapters (up (K, out, r)) route each batch element through
    adapter idx[b] (x must be batch-leading). A full-rank delta entry applies
    as one matmul: scale * x @ delta.T. Dropout (p > 0 with a generator)
    masks the bypass output before the scale."""
    dt = x.dtype
    if "delta" in entry:
        d = _dropout(x @ entry["delta"].to(dt).T, dropout_generator, dropout_p,
                     dropout_rows)
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
    d = _dropout(h @ up.to(dt).T, dropout_generator, dropout_p, dropout_rows)
    return d * scale.to(dt)


def lora_delta_conv(x: torch.Tensor, entry: dict, scale: torch.Tensor,
                    stride: Tuple[int, int], padding: Tuple[int, int],
                    dropout_generator: Optional[torch.Generator] = None,
                    dropout_p: float = 0.0,
                    idx: Optional[torch.Tensor] = None,
                    dropout_rows: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Conv LoRA bypass: down conv in the site's geometry, then a 1x1 up
    conv. x: NCHW; kernels OIHW.

    Stacked adapters: the per-sample down convs run as one grouped
    convolution with the batch folded into feature groups, then a
    per-sample 1x1 up einsum. A full-rank delta applies as one conv.
    Dropout as in lora_delta_dense."""
    dt = x.dtype
    if "delta" in entry:
        d = F.conv2d(x, entry["delta"].to(dt), stride=stride, padding=padding)
        return (_dropout(d, dropout_generator, dropout_p, dropout_rows)
                * scale.to(dt))
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
    d = _dropout(F.conv2d(dn, up.to(dt)), dropout_generator, dropout_p,
                 dropout_rows)
    return d * scale.to(dt)
