"""LoRA safetensors schema — bit-compatible with the reference format.

Schema (reference: lora_diffusion/lora.py:451-535):

  tensors   "{model}:{idx}:up"   fp16  (out, r)  [linear]  / (out, r, 1, 1) [conv]
            "{model}:{idx}:down" fp16  (r, in)             / (r, in, kh, kw)
            "{token}"            fp32  (768,)    textual-inversion embeds
  metadata  "{model}"            json list of target-replace class names
            "{model}:{idx}:rank" str(rank)
            "{token}"            "<embed>"

``idx`` follows the reference's module traversal order, reproduced by
lora_tpu_torch.core.sites.  ``up`` is stored pre-multiplied by the module scale
(reference realize_as_lora, lora.py:60-61).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .reader import SafetensorsFile, load_file, safe_open, save_file

EMBED_FLAG = "<embed>"

# Target-set names mirror the reference (lora.py:159-167). They are *torch
# class names* kept verbatim because they are serialized into file metadata.
UNET_DEFAULT_TARGET_REPLACE = {"CrossAttention", "Attention", "GEGLU"}
UNET_EXTENDED_TARGET_REPLACE = {"ResnetBlock2D", "CrossAttention", "Attention", "GEGLU"}
TEXT_ENCODER_DEFAULT_TARGET_REPLACE = {"CLIPAttention"}
TEXT_ENCODER_EXTENDED_TARGET_REPLACE = {"CLIPAttention"}
DEFAULT_TARGET_REPLACE = UNET_DEFAULT_TARGET_REPLACE

Pair = Tuple[np.ndarray, np.ndarray]  # (up, down)


def save_safeloras_with_embeds(
    modelmap: Dict[str, Tuple[Sequence[Pair], Iterable[str]]],
    embeds: Dict[str, np.ndarray] = {},
    outpath: str = "./lora.safetensors",
    cast_fp16: bool = False,
) -> None:
    """Save LoRAs for multiple models plus TI embeds into one file.

    modelmap: {"model name": ([(up, down), ...] in site order, target_set)}
    Reference: lora.py:451-483. Fresh training saves use cast_fp16=True
    (the reference extracts as fp16, lora.py:400-421); conversion tools keep
    incoming dtypes so round-trips are byte-exact (golden fixtures exist in
    both F32 and F16).
    """
    weights, metadata = build_safeloras(modelmap, embeds, cast_fp16)
    save_file(weights, outpath, metadata)


def build_safeloras(
    modelmap: Dict[str, Tuple[Sequence[Pair], Iterable[str]]],
    embeds: Dict[str, np.ndarray] = {},
    cast_fp16: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Assemble the schema's (tensors, metadata) dicts without touching disk
    (shared by save_safeloras_with_embeds and the in-memory join path)."""
    weights: Dict[str, np.ndarray] = {}
    metadata: Dict[str, str] = {}

    def _cast(a):
        a = np.asarray(a)
        return a.astype(np.float16) if cast_fp16 else a

    for name, (pairs, target_replace_module) in modelmap.items():
        metadata[name] = json.dumps(list(target_replace_module))
        for i, (up, down) in enumerate(pairs):
            rank = int(np.shape(down)[0])
            metadata[f"{name}:{i}:rank"] = str(rank)
            weights[f"{name}:{i}:up"] = _cast(up)
            weights[f"{name}:{i}:down"] = _cast(down)

    for token, tensor in embeds.items():
        metadata[token] = EMBED_FLAG
        weights[token] = np.asarray(tensor)

    return weights, metadata


def save_safeloras(
    modelmap: Dict[str, Tuple[Sequence[Pair], Iterable[str]]],
    outpath: str = "./lora.safetensors",
) -> None:
    save_safeloras_with_embeds(modelmap, {}, outpath)


ParsedLora = Dict[str, Tuple[List[np.ndarray], List[int], List[str]]]


# "{model}:{idx}:up|down" — the schema's only tensor-key shape besides bare
# TI token names.
_LORA_KEY = re.compile(r"^(?P<model>.+):(?P<idx>\d+):(?P<dir>up|down)$")


def parse_safeloras(safeloras) -> ParsedLora:
    """Group a loaded safetensors handle back into per-model weight lists.

    Returns {"model": (flat [up0, down0, up1, down1, ...], ranks, target)}.
    Behavior matches the reference parser (lora.py:538-596); accepts any
    object with keys()/metadata()/get_tensor() (our SafetensorsFile, the
    safetensors package handle, or the in-memory join result).
    """
    metadata = safeloras.metadata() or {}
    # model -> {site index -> {"up"/"down": tensor}}
    by_model: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}

    for key in safeloras.keys():
        hit = _LORA_KEY.match(key)
        model = hit["model"] if hit else key
        info = metadata.get(model)
        if not info:
            raise ValueError(
                f"Tensor {model} has no metadata - is this a Lora safetensor?"
            )
        if info == EMBED_FLAG:  # TI embed row; parse_safeloras_embeds' job
            continue
        if hit is None:
            raise ValueError(f"Unrecognized LoRA tensor key: {key!r}")
        by_model.setdefault(model, {}).setdefault(int(hit["idx"]), {})[
            hit["dir"]
        ] = np.asarray(safeloras.get_tensor(key))

    loras: ParsedLora = {}
    for model, sites in by_model.items():
        target = json.loads(metadata[model])
        n = max(sites) + 1
        ranks = [
            int(metadata.get(f"{model}:{i}:rank", 4)) for i in range(n)
        ]
        flat: List[Optional[np.ndarray]] = []
        for i in range(n):
            pair = sites.get(i, {})
            flat += [pair.get("up"), pair.get("down")]
        loras[model] = (flat, ranks, target)
    return loras


def parse_safeloras_embeds(safeloras) -> Dict[str, np.ndarray]:
    """Extract TI embeds: {token: array}. Reference: lora.py:599-617."""
    embeds: Dict[str, np.ndarray] = {}
    metadata = safeloras.metadata()
    for key in safeloras.keys():
        if metadata.get(key) == EMBED_FLAG:
            embeds[key] = np.asarray(safeloras.get_tensor(key))
    return embeds


def load_safeloras(path: str) -> ParsedLora:
    with SafetensorsFile(path) as f:
        return parse_safeloras(f)


def load_safeloras_embeds(path: str) -> Dict[str, np.ndarray]:
    with SafetensorsFile(path) as f:
        return parse_safeloras_embeds(f)


def load_safeloras_both(path: str):
    with SafetensorsFile(path) as f:
        return parse_safeloras(f), parse_safeloras_embeds(f)


def pairs_from_flat(weights: Sequence[np.ndarray]) -> List[Pair]:
    """[up0, down0, up1, down1, ...] -> [(up0, down0), ...]."""
    if len(weights) % 2:
        raise ValueError("flat LoRA list must have even length")
    return [(weights[2 * i], weights[2 * i + 1]) for i in range(len(weights) // 2)]


def flat_from_pairs(pairs: Sequence[Pair]) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    for up, down in pairs:
        out.append(np.asarray(up))
        out.append(np.asarray(down))
    return out


class InMemorySafetensors:
    """Dict-backed stand-in for a safetensors handle (reference
    DummySafeTensorObject, lora_manager.py:74-87)."""

    def __init__(self, tensors: Dict[str, np.ndarray], metadata: Dict[str, str]):
        self.tensors = tensors
        self._metadata = metadata

    def keys(self):
        return self.tensors.keys()

    def metadata(self):
        return self._metadata

    def get_tensor(self, key):
        return self.tensors[key]


__all__ = [
    "EMBED_FLAG",
    "UNET_DEFAULT_TARGET_REPLACE",
    "UNET_EXTENDED_TARGET_REPLACE",
    "TEXT_ENCODER_DEFAULT_TARGET_REPLACE",
    "TEXT_ENCODER_EXTENDED_TARGET_REPLACE",
    "DEFAULT_TARGET_REPLACE",
    "save_safeloras",
    "save_safeloras_with_embeds",
    "build_safeloras",
    "parse_safeloras",
    "parse_safeloras_embeds",
    "load_safeloras",
    "load_safeloras_embeds",
    "load_safeloras_both",
    "pairs_from_flat",
    "flat_from_pairs",
    "InMemorySafetensors",
    "SafetensorsFile",
    "safe_open",
    "save_file",
    "load_file",
]
