"""Legacy torch .pt files, the counterpart of lora_tpu/formats/pt_io.py,
with the same files: the reference's flat interleaved [up0, down0, ...]
lists of fp16 nn.Parameters, textual-inversion {token: tensor} dicts,
A1111 embeddings (one or several vectors), and the JSON debug form. Arrays
go in and come out as float32 numpy, as in lora_tpu.

Files are read with torch.load(weights_only=True): every file these
functions or lora_tpu's write (nn.Parameter lists included) loads that way,
and nothing in them runs code.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Pair = Tuple[np.ndarray, np.ndarray]


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def text_lora_path(path: str) -> str:
    if not path.endswith(".pt"):
        raise ValueError(f"only .pt files are supported, got {path!r}")
    return ".".join(path.split(".")[:-1] + ["text_encoder", "pt"])


def ti_lora_path(path: str) -> str:
    if not path.endswith(".pt"):
        raise ValueError(f"only .pt files are supported, got {path!r}")
    return ".".join(path.split(".")[:-1] + ["ti", "pt"])


def save_lora_pt(pairs: Sequence[Pair], path: str) -> None:
    """Write the reference's flat interleaved fp16 list, each element an
    nn.Parameter (the reference's resume path assigns list items to a
    Parameter attribute, which torch takes only for Parameters)."""
    weights = []
    for up, down in pairs:
        for a in (up, down):
            weights.append(torch.nn.Parameter(
                torch.from_numpy(np.asarray(a, dtype=np.float16)),
                requires_grad=False))
    torch.save(weights, path)


def load_lora_pt(path: str) -> List[np.ndarray]:
    """A flat [up0, down0, ...] list as float32 numpy."""
    return [w.detach().float().numpy() for w in _load(path)]


def save_lora_json(pairs: Sequence[Pair], path: str) -> None:
    """The debug form: the flat interleaved list as nested JSON lists."""
    weights = []
    for up, down in pairs:
        weights.append(np.asarray(up, dtype=np.float32).tolist())
        weights.append(np.asarray(down, dtype=np.float32).tolist())
    with open(path, "w") as f:
        json.dump(weights, f)


def load_lora_json(path: str) -> List[np.ndarray]:
    with open(path) as f:
        return [np.asarray(w, dtype=np.float32) for w in json.load(f)]


def save_ti_pt(embeds: Dict[str, np.ndarray], path: str) -> None:
    torch.save({tok: torch.from_numpy(np.asarray(v, dtype=np.float32))
                for tok, v in embeds.items()}, path)


def load_ti_pt(path: str) -> Dict[str, np.ndarray]:
    return {tok: v.detach().float().numpy() for tok, v in _load(path).items()}


def _a1111(param: torch.Tensor, name: str, **extra) -> dict:
    return {"string_to_token": {"*": 265}, "string_to_param": {"*": param},
            "name": name, "step": 0, "sd_checkpoint": "custom",
            "sd_checkpoint_name": "custom", **extra}


def save_a1111_embedding(token: str, embed: np.ndarray, path: str,
                         name: str = "embed") -> None:
    """An A1111 textual embedding .pt: {"string_to_token": {"*": 265},
    "string_to_param": {"*": tensor (1, dim)}, ...}."""
    t = torch.from_numpy(np.asarray(embed, dtype=np.float32)).unsqueeze(0)
    torch.save(_a1111(t, name), path)


def save_a1111_multi_embedding(embeds: Dict[str, np.ndarray], path: str,
                               name: str = "embed") -> None:
    """Several vectors stacked under "*" in sorted-token order, and a
    "lora_tpu_tokens" {token: row} key (A1111 ignores it) so
    load_a1111_embedding gives back the per-token dict."""
    toks = sorted(embeds)
    cat = torch.stack([torch.from_numpy(np.asarray(embeds[t], np.float32))
                       for t in toks])
    torch.save(_a1111(cat, name,
                      lora_tpu_tokens={t: i for i, t in enumerate(toks)}),
               path)


def load_a1111_embedding(path: str) -> Tuple[str, Dict[str, np.ndarray]]:
    """(name, {token: vector}) of an A1111 embedding. Files with
    "lora_tpu_tokens" come back as written; other files name their rows
    after the embedding (name, name:1, name:2, ...)."""
    d = _load(path)
    cat = d["string_to_param"]["*"].detach().float().numpy()
    if cat.ndim == 1:
        cat = cat[None]
    name = d.get("name", "embed")
    tokens = d.get("lora_tpu_tokens")
    if tokens:
        return name, {t: cat[i] for t, i in tokens.items()}
    return name, {name if i == 0 else f"{name}:{i}": cat[i]
                  for i in range(cat.shape[0])}
