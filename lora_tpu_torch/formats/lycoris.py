"""LyCORIS files for SD-1.x/2.x (LoHa, LoKr, IA3, DoRA, diag-OFT, BOFT,
GLoRA, full and norm modules): the counterpart of the SD part of
lora_tpu/formats/lycoris.py, with the same algebra and the same refusals.

They share the kohya key schema (formats/kohya.py) but factor the weight
delta otherwise:

- LoHa: dW = (w1a @ w1b) * (w2a @ w2b) * alpha / r; Tucker convs rebuild
  each side as einsum('ijkl,ip,jr->prkl', t, wa, wb).
- LoKr: dW = kron(w1, w2) * alpha / r, each side full, factored or (w2)
  Tucker; alpha applies only where a factored side gives a rank.
- IA3: dW = W * v, v over the input or the output axis.
- DoRA: W' = m * (W + dW_lora) / ||W + dW_lora||_row (+ f32 eps); the
  entry holds W' - W.
- diag-OFT: a per-block Cayley rotation R = (I + Q)(I - Q)^-1 of the output
  channels (Q the skew part of each block), with the global Frobenius clamp
  ||Q||_F <= alpha * out_dim and the "rescaled" variant's per-channel gain;
  BOFT: m butterfly stages of such block rotations.
- GLoRA: dW = (W @ (a2 @ a1) + b2 @ b1) * alpha / r.
- full: `diff` is the weight delta; `diff_b`, a bias delta, rides the
  tree's `param_deltas` channel ({param path: f32 tensor}).
- norm: `w_norm` / `b_norm` deltas on GroupNorm/LayerNorm layers, resolved
  against the model's own param paths, also as `param_deltas`, which the
  pipeline applies to its base params as W + scale * delta.

These compositions are full-rank, so they load as exact {"delta"} entries
(core/lora.lora_from_deltas); plain LoRA/LoCon modules stay (up, down)
pairs. A file may mix algorithms per module. Unknown factor keys raise, so
a partial load never passes silently.

Everything is composed in torch, in f32, on the device the base params
live on (the card's are bf16, which numpy cannot hold), with TF32 off for
the products (core/lora.f32_products). IA3, DoRA, OFT, BOFT and GLoRA read
the base weight: an int8 (quantized) weight holds codes, not values, so
those modules refuse it; load them before quantize_base. load_lycoris_xl
reads the SDXL key layout (formats/kohya.py `_xl_index`) with the same
per-module dispatch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.lora import LoraTree, f32_products
from ..core.sites import Site
from .kohya import (
    _PREFIX,
    _PREFIX_XL,
    _alpha,
    _check_prefixes,
    _f32,
    _factored_pair,
    _site_index,
    _xl_index,
)
from .reader import SafetensorsFile

# factor-key sets per algorithm (leaf names after the module base)
_LORA_LEAVES = {"lora_up", "lora_down", "lora_mid", "alpha"}
_LOHA_LEAVES = {"hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b",
                "hada_t1", "hada_t2", "alpha"}
_LOKR_LEAVES = {"lokr_w1", "lokr_w1_a", "lokr_w1_b",
                "lokr_w2", "lokr_w2_a", "lokr_w2_b", "lokr_t2", "alpha"}
# trainers write .alpha for IA3 modules too; loaders ignore it (the gain is
# absolute)
_IA3_LEAVES = {"weight", "on_input", "alpha"}
_DORA_LEAVES = _LORA_LEAVES | {"dora_scale"}
_OFT_LEAVES = {"oft_blocks", "alpha", "rescale"}
_GLORA_LEAVES = {"a1", "a2", "b1", "b2", "alpha"}
_FULL_LEAVES = {"diff", "diff_b", "alpha"}
_NORM_LEAVES = {"w_norm", "b_norm", "alpha"}
# the algorithms whose delta depends on the base weight
_BASE_DEPENDENT = ("ia3", "dora", "oft", "glora")


def is_lycoris(keys: Sequence[str]) -> bool:
    """True if any key carries a LoHa/LoKr/IA3/DoRA/OFT/GLoRA/full/norm
    factor (plain kohya LoRA/LoCon files load through formats/kohya.py)."""
    for k in keys:
        leaf = k.rpartition(".")[2]
        if leaf.startswith(("hada_", "lokr_")) or \
                leaf in ("on_input", "dora_scale", "oft_blocks",
                         "diff", "diff_b", "w_norm", "b_norm"):
            return True
        if k.endswith((".a1.weight", ".a2.weight",
                       ".b1.weight", ".b2.weight")):
            return True
    return False


def _detect_algo(base: str, leaves: set) -> str:
    # magnitude/rotation/diff tensors are unambiguous markers; check them
    # first (a DoRA group is a superset of the plain-LoRA leaf set)
    if "dora_scale" in leaves:
        if leaves <= _DORA_LEAVES:
            return "dora"
    elif "oft_blocks" in leaves:
        if leaves <= _OFT_LEAVES:
            return "oft"
    elif "diff" in leaves or "diff_b" in leaves:
        if leaves <= _FULL_LEAVES:
            return "full"
    elif "w_norm" in leaves or "b_norm" in leaves:
        if leaves <= _NORM_LEAVES:
            return "norm"
    elif {"a1", "a2", "b1", "b2"} & leaves:
        if leaves <= _GLORA_LEAVES:
            return "glora"
    else:
        for algo, known in (("lora", _LORA_LEAVES), ("loha", _LOHA_LEAVES),
                            ("lokr", _LOKR_LEAVES), ("ia3", _IA3_LEAVES)):
            if leaves <= known:
                return algo
    raise ValueError(
        f"kohya module {base!r} has unsupported factor tensors "
        f"{sorted(leaves)} (LoHa++/mixed algorithms?); refusing a partial "
        f"load")


def _site_shape(site: Site) -> Tuple[int, ...]:
    if site.kind == "linear":
        return (site.out_dim, site.in_dim)
    return (site.out_dim, site.in_dim) + tuple(site.kernel)


def _rebuild_tucker(t, wa, wb) -> torch.Tensor:
    """(r, r, kh, kw) core x (r, out) x (r, in) -> (out, in, kh, kw)."""
    return torch.einsum("ijkl,ip,jr->prkl", t, wa, wb)


def _compose_loha(base: str, site: Site, g) -> torch.Tensor:
    need = {"hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b"}
    if not need <= set(g):
        raise ValueError(f"LoHa module {base!r} is missing factors "
                         f"{sorted(need - set(g))}")
    if ("hada_t1" in g) != ("hada_t2" in g):
        raise ValueError(f"LoHa module {base!r} has a Tucker core on only "
                         f"one side")
    if "hada_t1" in g:
        if site.kind != "conv":
            raise ValueError(f"LoHa module {base!r} has Tucker cores but "
                             f"maps to a linear site")
        m1 = _rebuild_tucker(g["hada_t1"], g["hada_w1_a"], g["hada_w1_b"])
        m2 = _rebuild_tucker(g["hada_t2"], g["hada_w2_a"], g["hada_w2_b"])
    else:
        m1 = g["hada_w1_a"] @ g["hada_w1_b"]
        m2 = g["hada_w2_a"] @ g["hada_w2_b"]
    r = g["hada_w1_b"].shape[0]
    if m1.shape != m2.shape:
        raise ValueError(f"LoHa module {base!r}: factor shapes disagree "
                         f"({tuple(m1.shape)} vs {tuple(m2.shape)})")
    return (m1 * m2).reshape(_site_shape(site)) * (_alpha(g, r) / r)


def _compose_lokr(base: str, site: Site, g) -> torch.Tensor:
    if "lokr_w1" in g:
        if "lokr_w1_a" in g or "lokr_w1_b" in g:
            raise ValueError(f"LoKr module {base!r} has both a full w1 and "
                             f"w1 factors")
        w1, r1 = g["lokr_w1"], None
    elif "lokr_w1_a" in g and "lokr_w1_b" in g:
        w1, r1 = g["lokr_w1_a"] @ g["lokr_w1_b"], g["lokr_w1_b"].shape[0]
    else:
        raise ValueError(f"LoKr module {base!r} is missing w1")
    if "lokr_t2" in g:
        if site.kind != "conv":
            raise ValueError(f"LoKr module {base!r} has a Tucker core but "
                             f"maps to a linear site")
        if not {"lokr_w2_a", "lokr_w2_b"} <= set(g):
            raise ValueError(f"LoKr module {base!r} has lokr_t2 without "
                             f"w2 factors")
        w2 = _rebuild_tucker(g["lokr_t2"], g["lokr_w2_a"], g["lokr_w2_b"])
        r2 = g["lokr_w2_b"].shape[0]
    elif "lokr_w2" in g:
        w2, r2 = g["lokr_w2"], None
    elif "lokr_w2_a" in g and "lokr_w2_b" in g:
        w2, r2 = g["lokr_w2_a"] @ g["lokr_w2_b"], g["lokr_w2_b"].shape[0]
    else:
        raise ValueError(f"LoKr module {base!r} is missing w2")
    if w1.ndim != 2:
        raise ValueError(f"LoKr module {base!r}: w1 must be 2-D, got "
                         f"{tuple(w1.shape)}")
    # the webui multiplier: alpha / r only where a factored side defines a
    # rank (w1's first, then w2's); fully materialized sides ignore alpha
    r = r1 if r1 is not None else r2
    scale = (_alpha(g, r) / r) if r else 1.0
    if w2.ndim == 4:
        w1 = w1[:, :, None, None]
    # (torch.kron views its inputs: an einsum's strided result needs a copy)
    delta = torch.kron(w1.contiguous(), w2.contiguous())
    want = _site_shape(site)
    if delta.numel() != math.prod(want):
        raise ValueError(
            f"LoKr module {base!r}: kron factor shapes compose to "
            f"{tuple(delta.shape)}, site needs {want}")
    return delta.reshape(want) * scale


def _compose_ia3(base: str, site: Site, g, w: torch.Tensor) -> torch.Tensor:
    if not {"weight", "on_input"} <= set(g):
        raise ValueError(f"IA3 module {base!r} needs 'weight' and "
                         f"'on_input' tensors")
    v = g["weight"].reshape(-1)
    on_input = bool(g["on_input"])
    axis_dim = site.in_dim if on_input else site.out_dim
    if v.shape[0] != axis_dim:
        raise ValueError(
            f"IA3 module {base!r}: gain has {v.shape[0]} channels, the "
            f"{'input' if on_input else 'output'} axis has {axis_dim}")
    shape = [1] * w.ndim
    shape[1 if on_input else 0] = axis_dim
    return w * v.reshape(shape)


def _compose_dora(base: str, site: Site, g, w: torch.Tensor
                  ) -> torch.Tensor:
    """DoRA: m * (W + dW) / ||W + dW||_row, the row norm per output channel
    over all remaining axes, + f32 eps (the LyCORIS weight-decompose / PEFT
    DoRA algebra). Returns W' - W."""
    w = w.reshape(_site_shape(site))
    m = g["dora_scale"].reshape(-1)
    if m.shape[0] != site.out_dim:
        raise ValueError(
            f"DoRA module {base!r}: dora_scale has {m.shape[0]} channels, "
            f"the output axis has {site.out_dim}")
    if not {"lora_up", "lora_down"} <= set(g):
        raise ValueError(f"kohya module {base!r} is missing "
                         f"lora_up/lora_down factors")
    up, down = _factored_pair(base, site, g, w.device)
    r = down.shape[0]
    prod = up.reshape(up.shape[0], -1) @ down.reshape(r, -1)
    if prod.numel() != w.numel():
        raise ValueError(
            f"kohya module {base!r}: factors compose to {tuple(prod.shape)}, "
            f"site needs {tuple(w.shape)}")
    wp = w + prod.reshape(w.shape)
    norm = torch.linalg.vector_norm(wp.reshape(wp.shape[0], -1), dim=1)
    norm = norm + torch.finfo(torch.float32).eps
    bshape = (site.out_dim,) + (1,) * (wp.ndim - 1)
    return m.reshape(bshape) * wp / norm.reshape(bshape) - w


def _apply_rescale(base: str, site: Site, g, merged: torch.Tensor
                   ) -> torch.Tensor:
    """The LyCORIS "rescaled" OFT variant's per-output-channel gain."""
    if "rescale" not in g:
        return merged
    s = g["rescale"].reshape(-1)
    if s.shape[0] != site.out_dim:
        raise ValueError(
            f"OFT module {base!r}: rescale has {s.shape[0]} channels, "
            f"the output axis has {site.out_dim}")
    return merged * s.reshape((site.out_dim,) + (1,) * (merged.ndim - 1))


def _clamped_cayley(q: torch.Tensor, alpha, out_dim: int) -> torch.Tensor:
    """Skew-symmetrize the trailing (b, b) blocks, clamp ||Q||_F to
    alpha * out_dim (when alpha > 0) with ONE factor over every block and,
    for BOFT, every stage (LyCORIS get_r takes torch.norm of the whole
    tensor; eps 1e-8 as in their clamp), and Cayley-map each block to a
    rotation R = (I + Q)(I - Q)^-1."""
    skew = q - q.transpose(-1, -2)
    if alpha is not None and float(alpha) > 0:
        constraint = float(alpha) * out_dim
        n = float(torch.linalg.vector_norm(skew))
        skew = skew * ((min(n, constraint) + 1e-8) / (n + 1e-8))
    eye = torch.eye(q.shape[-1], dtype=torch.float32, device=q.device)
    return (eye + skew) @ torch.linalg.inv(eye - skew)


def _compose_boft(base: str, site: Site, g, w: torch.Tensor
                  ) -> torch.Tensor:
    """BOFT (LyCORIS modules/boft.py make_weight): m stages of butterfly-
    permuted block rotations of the output channels. Stage i permutes the
    channels (c, g=2, k=2^i*b/2) -> (c, k, g), rotates blocks of b (R @ w
    per block), and un-permutes. Returns W' - W; the tree scale lerps this
    delta (exact at scale 0 and 1, as in lora_tpu)."""
    q = g["oft_blocks"]  # (m, n_blocks, b, b)
    m, n, b, b2 = q.shape
    out_dim = site.out_dim
    if b != b2 or b % 2 or n * b != out_dim:
        raise ValueError(
            f"BOFT module {base!r}: oft_blocks (m, n, b, b) = "
            f"{tuple(q.shape)} must have square even-sized blocks with "
            f"n*b == out_dim ({out_dim})")
    rot = _clamped_cayley(q, g.get("alpha"), out_dim)  # (m, n, b, b)
    w = w.reshape(_site_shape(site))
    inp = w.reshape(out_dim, -1)
    r_b = b // 2
    for i in range(m):
        k = (2 ** i) * r_b
        if out_dim % (2 * k):
            raise ValueError(
                f"BOFT module {base!r}: stage {i} butterfly needs "
                f"out_dim divisible by {2 * k}, got {out_dim}")
        c = out_dim // (2 * k)
        # (c g k) -> (c k g): interleave the two butterfly wings
        inp = inp.reshape(c, 2, k, -1).transpose(1, 2)
        inp = torch.einsum("bij,bjr->bir", rot[i], inp.reshape(n, b, -1))
        # (c k g) -> (c g k): undo the interleave
        inp = inp.reshape(c, k, 2, -1).transpose(1, 2).reshape(out_dim, -1)
    return _apply_rescale(base, site, g, inp.reshape(w.shape)) - w


def _compose_oft(base: str, site: Site, g, w: torch.Tensor) -> torch.Tensor:
    """diag-OFT: a per-block Cayley rotation of the output channels (kohya
    sd-scripts networks/oft.py), with the optional rescale gain. 4-D
    oft_blocks (butterfly stages) are BOFT. Returns W' - W."""
    q = g["oft_blocks"]
    if q.ndim == 4:
        return _compose_boft(base, site, g, w)
    if q.ndim != 3 or q.shape[1] != q.shape[2]:
        raise ValueError(
            f"OFT module {base!r}: oft_blocks must be (num_blocks, b, b) "
            f"or BOFT's (m, num_blocks, b, b), got {tuple(q.shape)}")
    k, b, _ = q.shape
    if k * b != site.out_dim:
        raise ValueError(
            f"OFT module {base!r}: {k} blocks of size {b} cover "
            f"{k * b} channels, the output axis has {site.out_dim}")
    rot = _clamped_cayley(q, g.get("alpha"), site.out_dim)
    w = w.reshape(_site_shape(site))
    merged = torch.einsum("knm,knr->kmr", rot,
                          w.reshape(k, b, -1)).reshape(w.shape)
    return _apply_rescale(base, site, g, merged) - w


def _compose_glora(base: str, site: Site, g, w: torch.Tensor
                   ) -> torch.Tensor:
    """GLoRA (W' = W + W.A + B, LyCORIS modules/glora.py): A = a2 @ a1 on
    the frozen weight's input, B = b2 @ b1 a low-rank bypass; dW = (W @ A +
    B) * alpha / r. For convs a1/a2/b1 are 1x1 and b2 carries the kernel."""
    need = {"a1", "a2", "b1", "b2"}
    if not need <= set(g):
        raise ValueError(f"GLoRA module {base!r} is missing factors "
                         f"{sorted(need - set(g))}")
    a1, a2, b1, b2 = g["a1"], g["a2"], g["b1"], g["b2"]
    r = a1.shape[0]
    if a1.ndim == 4:  # conv factors: a1/a2/b1 must be 1x1 bottlenecks
        for name, t in (("a1", a1), ("a2", a2), ("b1", b1)):
            if tuple(t.shape[2:]) != (1, 1):
                raise ValueError(
                    f"GLoRA module {base!r}: {name} must be a 1x1 conv, "
                    f"got kernel {tuple(t.shape[2:])}")
        a1, a2, b1 = a1[..., 0, 0], a2[..., 0, 0], b1[..., 0, 0]
    w = w.reshape(_site_shape(site))
    A = a2 @ a1  # (in, in)
    if tuple(A.shape) != (site.in_dim, site.in_dim):
        raise ValueError(
            f"GLoRA module {base!r}: a2 @ a1 composes to {tuple(A.shape)}, "
            f"the input axis has {site.in_dim}")
    if site.kind == "conv":
        # W @ A over the input-channel axis, keeping the spatial taps
        wa = torch.einsum("oihw,ij->ojhw", w, A)
        if tuple(b2.shape) != tuple(w.shape[:1]) + (r,) + tuple(w.shape[2:]):
            raise ValueError(
                f"GLoRA module {base!r}: b2 {tuple(b2.shape)} must carry the "
                f"site kernel {tuple(w.shape[2:])} over rank {r}")
        bb = torch.einsum("orhw,ri->oihw", b2, b1)
    else:
        wa = w @ A
        bb = b2 @ b1
    if bb.shape != w.shape:
        raise ValueError(
            f"GLoRA module {base!r}: b2 @ b1 composes to {tuple(bb.shape)}, "
            f"the site needs {tuple(w.shape)}")
    return (wa + bb) * (_alpha(g, r) / r)


def _compose_full(base: str, g) -> torch.Tensor:
    """`diff` IS W_tuned - W_base (LyCORIS modules/full.py); alpha is
    ignored (the diff is absolute). `diff_b` rides the param deltas."""
    if "diff" not in g:
        raise ValueError(
            f"full module {base!r} has only a bias diff; refusing (the "
            f"weight diff is mandatory in LyCORIS full modules)")
    return g["diff"]


def _mangled_param_index(prefix: str, params) -> Dict[str, str]:
    """kohya module base -> model param path prefix, for modules outside
    the matmul site registry (norm layers). Built from the params so the
    underscore mangling inverts exactly (paths hold digits, so un-mangling
    the string alone is ambiguous)."""
    out: Dict[str, str] = {}
    for k in params:
        if k.endswith(".weight"):
            path = k[: -len(".weight")]
            out[prefix + "_" + path.replace(".", "_")] = path
    return out


def _parse_groups(f: SafetensorsFile) -> Dict[str, Dict[str, object]]:
    """Group a LyCORIS file's keys per module base (numpy arrays),
    accepting every factor leaf a supported algorithm uses; anything else
    raises."""
    groups: Dict[str, Dict[str, object]] = {}
    for k in f.keys():
        base, _, leaf = k.rpartition(".")
        if leaf == "weight" and base.endswith((".lora_up", ".lora_down",
                                               ".lora_mid", ".a1", ".a2",
                                               ".b1", ".b2")):
            base, _, which = base.rpartition(".")
            groups.setdefault(base, {})[which] = f.get_tensor(k)
        elif leaf in ("alpha", "weight", "on_input", "dora_scale",
                      "oft_blocks", "rescale", "diff", "diff_b",
                      "w_norm", "b_norm") or \
                leaf.startswith(("hada_", "lokr_")):
            groups.setdefault(base, {})[leaf] = f.get_tensor(k)
        else:
            raise ValueError(f"unrecognized LyCORIS key {k!r}")
    return groups


def load_lycoris(
    path: str,
    *,
    unet_sites: Optional[Sequence[Site]] = None,
    text_sites: Optional[Sequence[Site]] = None,
    unet_params: Optional[Dict[str, torch.Tensor]] = None,
    text_params: Optional[Dict[str, torch.Tensor]] = None,
    dtype=torch.float32,
    device="cpu",
) -> Tuple[Optional[LoraTree], Optional[LoraTree]]:
    """(lora_unet, lora_text) from a LyCORIS file with per-module algorithm
    dispatch, their entries on `device` in `dtype` and their param deltas
    f32 on `device`; a model whose sites are not given (or with no keys in
    the file) comes back None. Plain LoRA/LoCon modules stay (up, down)
    entries; the others become exact full-rank {"delta"} entries. IA3,
    DoRA, OFT, BOFT and GLoRA modules need the model's `*_params` (flat
    {name: tensor}, e.g. module.flat_params(), on `device`) and a float
    base weight; norm modules and bias diffs need them too."""
    with SafetensorsFile(path) as f:
        groups = _parse_groups(f)
    _check_prefixes(groups, _PREFIX.values(), "LyCORIS")
    out = {}
    for model, sites, params in (("unet", unet_sites, unet_params),
                                 ("text_encoder", text_sites, text_params)):
        if sites is None:
            out[model] = None
            continue
        out[model] = _load_model_groups(
            model, _PREFIX[model], groups, _site_index(model, sites), sites,
            params, dtype, device)
    return out["unet"], out["text_encoder"]


def load_lycoris_xl(
    path: str,
    *,
    unet_cfg,
    unet_sites: Optional[Sequence[Site]] = None,
    text_sites: Optional[Sequence[Site]] = None,
    text2_sites: Optional[Sequence[Site]] = None,
    unet_params: Optional[Dict[str, torch.Tensor]] = None,
    text_params: Optional[Dict[str, torch.Tensor]] = None,
    text2_params: Optional[Dict[str, torch.Tensor]] = None,
    dtype=torch.float32,
    device="cpu",
) -> Tuple[Optional[LoraTree], Optional[LoraTree], Optional[LoraTree]]:
    """(lora_unet, lora_te1, lora_te2) of an SDXL LyCORIS file: load_lycoris
    over the SDXL kohya layout (LDM UNet names, lora_te1_ / lora_te2_
    prefixes), with its refusals; IA3, DoRA, OFT, BOFT and GLoRA modules
    need the matching float `*_params`."""
    with SafetensorsFile(path) as f:
        groups = _parse_groups(f)
    _check_prefixes(groups, _PREFIX_XL.values(), "SDXL LyCORIS", hint="")
    out = {}
    for model, sites, params in (("unet", unet_sites, unet_params),
                                 ("text_encoder", text_sites, text_params),
                                 ("text_encoder_2", text2_sites,
                                  text2_params)):
        if sites is None:
            out[model] = None
            continue
        out[model] = _load_model_groups(
            model, _PREFIX_XL[model], groups,
            _xl_index(model, sites, unet_cfg), sites, params, dtype, device)
    return out["unet"], out["text_encoder"], out["text_encoder_2"]


def _load_model_groups(model, prefix, groups, index, sites, params, dtype,
                       device):
    """One model's tree: matmul-site modules dispatch per algorithm; norm
    modules (outside the site registry) resolve against the model's params
    and ride the tree's `param_deltas` channel."""
    present = {b: g for b, g in groups.items() if b in index}
    leftover = [b for b in groups
                if b.startswith(prefix + "_") and b not in index]
    norm_bases = [b for b in leftover
                  if {"w_norm", "b_norm"} & set(groups[b])]
    unknown = [b for b in leftover if b not in norm_bases]
    if unknown:
        raise ValueError(
            f"LyCORIS file has {model} modules outside the known "
            f"site set: {sorted(unknown)[:5]}"
            f"{'...' if len(unknown) > 5 else ''}")
    pdeltas: Dict[str, torch.Tensor] = {}
    if norm_bases:
        pdeltas = _norm_param_deltas(
            model, norm_bases, groups, _mangled_param_index(prefix,
                                                            params or {}),
            params, device)
    entries, bias_deltas = _entries_for_sites(model, present, index, sites,
                                              params, dtype, device)
    pdeltas.update(bias_deltas)
    if not entries and not pdeltas:
        return None
    tree = {"sites": entries,
            "scale": torch.tensor(1.0, dtype=torch.float32, device=device)}
    if pdeltas:
        tree["param_deltas"] = pdeltas
    return tree


def _base_weight(model: str, algo: str, base: str, site: Site, params,
                 device) -> torch.Tensor:
    """The float base weight a base-weight-dependent module composes on,
    f32 on `device`."""
    if params is None:
        raise ValueError(
            f"{algo.upper()} module {base!r} needs the {model} base weights "
            f"to compose its delta; pass {model}_params")
    key = site.name + ".weight"
    bw = params.get(key)
    if bw is None:
        raise ValueError(
            f"{algo.upper()} module {base!r}: no base weight {key!r} in "
            f"{model} params")
    bw = torch.as_tensor(bw)
    if bw.dtype == torch.int8:
        raise ValueError(
            f"{algo.upper()} module {base!r}: the {model} base weight "
            f"{key!r} is int8-quantized; its delta is composed from the "
            f"float weight, so load this file before quantize_base")
    return bw.to(device=device, dtype=torch.float32)


def _entries_for_sites(model, present, index, sites, params, dtype, device):
    """Per-site algorithm dispatch: `present` maps kohya module bases to
    their factor groups, `index` those bases to Sites. Returns (entries,
    param_deltas), the latter holding full-module bias diffs keyed by flat
    param path."""
    by_name = {index[b].name: b for b in present}
    entries = {}
    param_deltas: Dict[str, torch.Tensor] = {}
    for s in sites:
        base = by_name.get(s.name)
        if base is None:
            continue
        raw = present[base]
        algo = _detect_algo(base, set(raw))
        if algo == "lora":
            if not {"lora_up", "lora_down"} <= set(raw):
                raise ValueError(
                    f"kohya module {base!r} is missing "
                    f"lora_up/lora_down factors")
            with f32_products():
                up, down = _factored_pair(base, s, raw, device)
            entries[s.name] = {"up": up.to(dtype), "down": down.to(dtype)}
            continue
        if algo in _BASE_DEPENDENT:
            bw = _base_weight(model, algo, base, s, params, device)
        g = {k: v if k == "on_input" else _f32(v, device)
             for k, v in raw.items()}
        with f32_products():
            if algo == "full":
                delta = _compose_full(base, g)
                if "diff_b" in g:
                    param_deltas.update(_bias_delta(model, base, s, g,
                                                    params))
            elif algo == "loha":
                delta = _compose_loha(base, s, g)
            elif algo == "lokr":
                delta = _compose_lokr(base, s, g)
            elif algo == "dora":
                delta = _compose_dora(base, s, g, bw)
            elif algo == "oft":
                delta = _compose_oft(base, s, g, bw)
            elif algo == "glora":
                delta = _compose_glora(base, s, g, bw)
            elif algo == "norm":
                raise ValueError(
                    f"norm module {base!r} targets a matmul site {s.name!r} "
                    f"— w_norm/b_norm belong on normalization layers")
            else:  # ia3
                delta = _compose_ia3(base, s, g, bw)
        want = _site_shape(s)
        if tuple(delta.shape) != want:
            raise ValueError(
                f"LyCORIS module {base!r} composes to "
                f"{tuple(delta.shape)}, site {s.name} needs {want}")
        entries[s.name] = {"delta": delta.to(dtype)}
    return entries, param_deltas


def _bias_delta(model, base, site, g, params) -> Dict[str, torch.Tensor]:
    """A full module's `diff_b`, checked against the site's base bias."""
    bk = site.name + ".bias"
    if params is None:
        raise ValueError(
            f"full module {base!r} carries a bias diff; pass "
            f"{model}_params so it can be checked against the base bias")
    if bk not in params:
        raise ValueError(
            f"full module {base!r} has a bias diff but the {model} site "
            f"{site.name!r} has no bias parameter")
    db, bshape = g["diff_b"], tuple(params[bk].shape)
    if tuple(db.shape) != bshape:
        raise ValueError(
            f"full module {base!r}: diff_b {tuple(db.shape)} vs base bias "
            f"{bshape}")
    return {bk: db}


def _norm_param_deltas(model, bases, groups, pindex, params, device):
    """Norm-module groups (w_norm/b_norm on GroupNorm/LayerNorm layers,
    LyCORIS modules/norms.py with train_norm=True) as flat param-path
    deltas, f32 on `device`. A norm's output is linear in its weight and
    bias, so the pipeline's W + scale * delta is LyCORIS's multiplier."""
    out: Dict[str, torch.Tensor] = {}
    for base in bases:
        g = groups[base]
        if params is None:
            raise ValueError(
                f"norm module {base!r} needs {model}_params to resolve "
                f"its layer path and check shapes")
        pbase = pindex.get(base)
        if pbase is None:
            raise ValueError(
                f"norm module {base!r} does not match any {model} "
                f"parameter path")
        for leaf, suffix in (("w_norm", ".weight"), ("b_norm", ".bias")):
            if leaf not in g:
                continue
            key = pbase + suffix
            if key not in params:
                raise ValueError(
                    f"norm module {base!r}: the {model} layer has no "
                    f"{suffix[1:]} parameter {key!r}")
            d = _f32(g[leaf], device)
            want = tuple(params[key].shape)
            if tuple(d.shape) != want:
                raise ValueError(
                    f"norm module {base!r}: {leaf} {tuple(d.shape)} vs base "
                    f"{want}")
            out[key] = d
    return out
