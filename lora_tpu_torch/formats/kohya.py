"""kohya-ss / AUTOMATIC1111-webui LoRA files for SD-1.x/2.x: the counterpart
of the SD half of lora_tpu/formats/kohya.py.

Keys are `lora_unet_<module>_<path>.lora_down.weight` / `.lora_up.weight` /
`.alpha` (and `lora_te_` for the text encoder). The site names are
diffusers module paths (core/sites.py), so a key is the prefix plus the
path with dots replaced by underscores. On save `.alpha` is the site's rank
(multiplier 1) and the runtime scale is folded into `lora_up`, as the
reference's realize_as_lora does; on load a file's alpha / rank is folded
into the up weights (webui's effective multiplier). LoCon files (kohya's
conv_dim targets over every Linear/Conv2d of the transformer, resnet and
resampler blocks) load against the LoCon site supersets
(core/sites.unet_locon_sites / text_encoder_locon_sites), and a
CP-decomposed conv's `lora_mid` is folded exactly into the down conv. This
is the pairs loader: it keeps the (up, down) factorization and refuses any
other decomposition; LoHa/LoKr/IA3/... files load through
formats/lycoris.py, which patch_pipe dispatches to.

The folds run in torch, in f32 (TF32 off), on the device the tree is loaded
to. SDXL files (save_kohya_xl / load_kohya_xl, the counterpart of the SDXL
half) name their text modules lora_te1_ / lora_te2_ and their UNet modules
by the original LDM layout (input_blocks / middle_block / output_blocks,
formats/ckpt_export.py `unet_key_map`), as kohya's SDXL trainer writes them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.lora import LoraTree, f32_products, lora_from_pairs, lora_to_pairs
from ..core.sites import Site
from .ckpt_export import unet_key_map
from .reader import SafetensorsFile, save_file

_PREFIX = {"unet": "lora_unet", "text_encoder": "lora_te"}


def kohya_key(model: str, site_name: str) -> str:
    return _PREFIX[model] + "_" + site_name.replace(".", "_")


def save_kohya(
    path: str,
    *,
    lora_unet: Optional[LoraTree] = None,
    unet_sites: Optional[Sequence[Site]] = None,
    lora_text: Optional[LoraTree] = None,
    text_sites: Optional[Sequence[Site]] = None,
    dtype=np.float16,
) -> None:
    tensors: Dict[str, np.ndarray] = {}
    for model, lora, sites in (("unet", lora_unet, unet_sites),
                               ("text_encoder", lora_text, text_sites)):
        if lora is None:
            continue
        for site, (up, down) in zip(sites, lora_to_pairs(lora, sites)):
            base = kohya_key(model, site.name)
            tensors[base + ".lora_down.weight"] = down.astype(dtype)
            tensors[base + ".lora_up.weight"] = up.astype(dtype)
            tensors[base + ".alpha"] = np.asarray(float(down.shape[0]),
                                                  dtype)
    save_file(tensors, path, {"library": "lora_tpu"})


def _site_index(model: str, sites: Sequence[Site]) -> Dict[str, Site]:
    return {kohya_key(model, s.name): s for s in sites}


def _f32(a, device) -> torch.Tensor:
    """A file tensor (numpy) or a tensor as float32 on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _alpha(g: Dict[str, object], default) -> float:
    """A module's `.alpha` as a Python float (`default` when absent)."""
    a = g.get("alpha", default)
    return float(a.item() if isinstance(a, torch.Tensor) else np.asarray(a))


def _compose_cp_mid(base: str, site: Site, mid: torch.Tensor,
                    down: torch.Tensor) -> torch.Tensor:
    """Fold a LoCon CP-decomposed conv into the two-factor form.

    The file factors the delta as up(1x1) . mid(kxk, r->r) . down(1x1,
    in->r); the runtime is down(kxk, the site's geometry) . up(1x1)
    (core/lora.lora_delta_conv). A 1x1 conv is pure channel mixing, so
    mid . down is exactly one kxk conv: down'[r, in, kh, kw] =
    sum_s mid[r, s, kh, kw] * down[s, in]. Both factors are f32."""
    if site.kind != "conv":
        raise ValueError(
            f"kohya module {base!r} has a lora_mid factor but maps to a "
            f"linear site; CP decomposition only applies to convs")
    if down.ndim != 4 or tuple(down.shape[2:]) != (1, 1) or mid.ndim != 4:
        raise ValueError(
            f"kohya module {base!r}: unexpected CP factor shapes "
            f"down={tuple(down.shape)} mid={tuple(mid.shape)} (want down "
            f"1x1, mid kxk)")
    if mid.shape[1] != down.shape[0] or \
            tuple(mid.shape[2:]) != tuple(site.kernel):
        raise ValueError(
            f"kohya module {base!r}: CP factors disagree with the site "
            f"geometry (mid {tuple(mid.shape)}, down {tuple(down.shape)}, "
            f"kernel {tuple(site.kernel)})")
    with f32_products():
        return torch.einsum("rskh,sc->rckh", mid, down[:, :, 0, 0])


def _check_prefixes(groups, prefixes, what: str,
                    hint: str = " (SDXL/unsupported model?)") -> None:
    """Every module must sit under one of `prefixes` (an SDXL lora_te1_ /
    lora_te2_ module would otherwise be skipped by every model pass)."""
    foreign = [b for b in groups
               if not any(b.startswith(p + "_") for p in prefixes)]
    if foreign:
        raise ValueError(
            f"{what} file has modules under unknown prefixes{hint}: "
            f"{sorted(foreign)[:5]}{'...' if len(foreign) > 5 else ''}")


def _read_groups(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A kohya file's tensors grouped per module base; a key that is not a
    factor weight or an `.alpha`, or a module with other sub-tensors than
    lora_up / lora_down / lora_mid / alpha, raises."""
    with SafetensorsFile(path) as f:
        groups: Dict[str, Dict[str, np.ndarray]] = {}
        for k in f.keys():
            base, _, leaf = k.rpartition(".")
            if leaf == "weight":
                base, _, which = base.rpartition(".")
                groups.setdefault(base, {})[which] = f.get_tensor(k)
            elif leaf == "alpha":
                groups.setdefault(base, {})["alpha"] = f.get_tensor(k)
            else:
                raise ValueError(f"unrecognized kohya key {k!r}")
    # a known site can still carry sub-tensors this loader does not
    # implement: LoCon's CP lora_mid is folded below, anything else
    # (LoHa/LoKr factors, ...) is refused
    for base, g in groups.items():
        extra = sorted(set(g) - {"lora_up", "lora_down", "lora_mid",
                                 "alpha"})
        if extra:
            raise ValueError(
                f"kohya module {base!r} has unsupported sub-tensors "
                f"{extra} (LyCORIS decomposition?); refusing a partial load")
    return groups


def _load_trees(groups, models, what: str, hint: str, dtype,
                device) -> Dict[str, Optional[LoraTree]]:
    """{model: tree or None} for `models`, (model, prefix, index, sites)
    each: None where the sites are not given or no module of the file
    matches them; a module under the model's prefix outside `index`
    raises."""
    out = {}
    for model, prefix, index, sites in models:
        if sites is None:
            out[model] = None
            continue
        present = {b: g for b, g in groups.items() if b in index}
        if not present:
            out[model] = None
            continue
        unknown = [b for b in groups
                   if b.startswith(prefix + "_") and b not in index]
        if unknown:
            raise ValueError(
                f"{what} file has {model} modules outside the known site "
                f"set{hint}: {sorted(unknown)[:5]}"
                f"{'...' if len(unknown) > 5 else ''}")
        out[model] = _tree_from_groups(present, index, sites, dtype, device)
    return out


def load_kohya(
    path: str,
    *,
    unet_sites: Optional[Sequence[Site]] = None,
    text_sites: Optional[Sequence[Site]] = None,
    dtype=torch.float32,
    device="cpu",
) -> Tuple[Optional[LoraTree], Optional[LoraTree]]:
    """(lora_unet, lora_text), each on `device` in `dtype`; a model whose
    sites are not given (or that has no keys in the file) comes back None.

    LoCon files load fully against the LoCon site supersets, CP convs
    included. Unknown keys (modules outside the given site sets, or
    LoHa/LoKr factor tensors) raise with the key names, so a partial load
    cannot pass silently; so does an SDXL file (load_kohya_xl)."""
    groups = _read_groups(path)
    _check_prefixes(groups, _PREFIX.values(), "kohya")
    out = _load_trees(
        groups, [(model, _PREFIX[model],
                  None if sites is None else _site_index(model, sites), sites)
                 for model, sites in (("unet", unet_sites),
                                      ("text_encoder", text_sites))],
        "kohya", " (LoCon/unsupported targets?)", dtype, device)
    return out["unet"], out["text_encoder"]


def _factored_pair(base: str, site: Site, g, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A module's (up, down) in f32 on `device`: the CP mid folded into
    down, and alpha / rank (webui's multiplier) folded into up."""
    up, down = _f32(g["lora_up"], device), _f32(g["lora_down"], device)
    if "lora_mid" in g:
        down = _compose_cp_mid(base, site, _f32(g["lora_mid"], device), down)
    return up * (_alpha(g, down.shape[0]) / down.shape[0]), down


def _tree_from_groups(present: Dict[str, Dict[str, np.ndarray]],
                      index: Dict[str, Site], sites: Sequence[Site],
                      dtype, device) -> LoraTree:
    """A LoRA tree from the (lora_up, lora_down, lora_mid, alpha) groups of
    the modules present, in site order. Trainers cover varying module
    subsets (attention only, attention + ff, ...); a tree applies wherever
    a site is present, so partial coverage loads."""
    by_name = {index[b].name: b for b in present}
    pairs, matched = [], []
    for s in sites:
        base = by_name.get(s.name)
        if base is None:
            continue
        pairs.append(_factored_pair(base, s, present[base], device))
        matched.append(s)
    return lora_from_pairs(pairs, matched, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# SDXL: lora_te1_ / lora_te2_ text prefixes and LDM unet module names
# ---------------------------------------------------------------------------

_PREFIX_XL = {"unet": "lora_unet", "text_encoder": "lora_te1",
              "text_encoder_2": "lora_te2"}


def _xl_unet_index(sites: Sequence[Site], cfg) -> Dict[str, Site]:
    """kohya module base -> UNet site under the LDM module names (sd-scripts
    trains its own LDM-layout SDXL UNet), from the config's diffusers ->
    LDM map, so the block indices follow each block's transformer depth."""
    km = sorted(unet_key_map(cfg).items(), key=lambda kv: -len(kv[0]))
    idx: Dict[str, Site] = {}
    for s in sites:
        for src, dst in km:
            if s.name == src or s.name.startswith(src + "."):
                ldm = dst + s.name[len(src):]
                break
        else:
            raise KeyError(f"no LDM name mapping for unet site {s.name!r}")
        idx["lora_unet_" + ldm.replace(".", "_")] = s
    return idx


def _xl_index(model: str, sites: Sequence[Site], unet_cfg) -> Dict[str, Site]:
    if model == "unet":
        return _xl_unet_index(sites, unet_cfg)
    return {_PREFIX_XL[model] + "_" + s.name.replace(".", "_"): s
            for s in sites}


def save_kohya_xl(
    path: str,
    *,
    unet_cfg,
    lora_unet: Optional[LoraTree] = None,
    unet_sites: Optional[Sequence[Site]] = None,
    lora_text: Optional[LoraTree] = None,
    text_sites: Optional[Sequence[Site]] = None,
    lora_text2: Optional[LoraTree] = None,
    text2_sites: Optional[Sequence[Site]] = None,
    dtype=np.float16,
) -> None:
    """The SDXL kohya schema (webui loads it): LDM UNet names, lora_te1_ /
    lora_te2_ text-encoder prefixes; alpha and the up fold as save_kohya."""
    tensors: Dict[str, np.ndarray] = {}
    for model, lora, sites in (("unet", lora_unet, unet_sites),
                               ("text_encoder", lora_text, text_sites),
                               ("text_encoder_2", lora_text2, text2_sites)):
        if lora is None:
            continue
        by_name = {s.name: k
                   for k, s in _xl_index(model, sites, unet_cfg).items()}
        for site, (up, down) in zip(sites, lora_to_pairs(lora, sites)):
            base = by_name[site.name]
            tensors[base + ".lora_down.weight"] = down.astype(dtype)
            tensors[base + ".lora_up.weight"] = up.astype(dtype)
            tensors[base + ".alpha"] = np.asarray(float(down.shape[0]),
                                                  dtype)
    save_file(tensors, path, {"library": "lora_tpu"})


def is_kohya_xl(keys) -> bool:
    """Whether any key carries an SDXL marker: a te1 / te2 prefix or an LDM
    UNet block name (SD-1.x kohya UNet keys use diffusers paths)."""
    for k in keys:
        if k.startswith(("lora_te1_", "lora_te2_")):
            return True
        if k.startswith(("lora_unet_input_blocks_",
                         "lora_unet_middle_block_",
                         "lora_unet_output_blocks_")):
            return True
    return False


def load_kohya_xl(
    path: str,
    *,
    unet_cfg,
    unet_sites: Optional[Sequence[Site]] = None,
    text_sites: Optional[Sequence[Site]] = None,
    text2_sites: Optional[Sequence[Site]] = None,
    dtype=torch.float32,
    device="cpu",
) -> Tuple[Optional[LoraTree], Optional[LoraTree], Optional[LoraTree]]:
    """(lora_unet, lora_te1, lora_te2) of an SDXL kohya file, on `device`
    in `dtype`, with load_kohya's refusals: unknown sub-tensors, unknown
    prefixes and modules outside the given site sets raise."""
    groups = _read_groups(path)
    _check_prefixes(groups, _PREFIX_XL.values(), "SDXL kohya", hint="")
    out = _load_trees(
        groups, [(model, _PREFIX_XL[model],
                  None if sites is None else _xl_index(model, sites,
                                                       unet_cfg), sites)
                 for model, sites in (("unet", unet_sites),
                                      ("text_encoder", text_sites),
                                      ("text_encoder_2", text2_sites))],
        "SDXL kohya", "", dtype, device)
    return out["unet"], out["text_encoder"], out["text_encoder_2"]
