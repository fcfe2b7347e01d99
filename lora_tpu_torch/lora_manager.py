"""Several LoRA files served through one pipeline patch: the counterpart of
lora_tpu/lora_manager.py (the reference's lora_join and LoRAManager).

Each file is parsed into per-model LoRA trees, concatenated with
core.lora.join_loras (downs stacked on the rank axis, ups on the column
axis) and assembled again through build_safeloras, the save path's
assembly. TI tokens of file i are renamed <s{i}-{j}>, so joined adapters
keep distinct vocabularies; LoRAManager.tune gates each file's rank block
of the UNet LoRA through the per-rank selector (core.lora.set_lora_diag).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.lora import join_loras, lora_from_flat, set_lora_diag
from .formats.safetensors_io import (
    InMemorySafetensors,
    build_safeloras,
    pairs_from_flat,
    parse_safeloras,
    parse_safeloras_embeds,
    safe_open,
)


def _as_tree(flat: Sequence[np.ndarray]) -> dict:
    """An on-disk flat weight list as a site-indexed LoRA tree of CPU
    tensors in the file's dtype, so the core combinators can join it
    without model configs."""
    return {
        "sites": {f"{i:05d}": {"up": torch.from_numpy(np.array(up)),
                               "down": torch.from_numpy(np.array(down))}
                  for i, (up, down) in enumerate(pairs_from_flat(list(flat)))},
        "scale": torch.tensor(1.0),
    }


def _tree_to_pairs(tree: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [(entry["up"].numpy(), entry["down"].numpy())
            for _, entry in sorted(tree["sites"].items())]


def _renamed_embeds(handles: Sequence) -> Tuple[Dict[str, np.ndarray],
                                                List[int]]:
    """The TI tokens of file i as <s{i}-{j}> (j over the file's sorted
    tokens), and each file's token count (LoRAManager.prompt reads them)."""
    embeds: Dict[str, np.ndarray] = {}
    counts: List[int] = []
    for i, handle in enumerate(handles):
        file_embeds = parse_safeloras_embeds(handle)
        for j, token in enumerate(sorted(file_embeds)):
            embeds[f"<s{i}-{j}>"] = file_embeds[token]
        counts.append(len(file_embeds))
    return embeds, counts


def lora_join(lora_safetensors: Sequence) -> tuple:
    """N LoRA files (open handles) as one adapter of the summed rank:
    (tensors, metadata, ranklist, token_size_list) in the schema the
    reference writes (lora_manager.py:13-72). Every site's rank metadata is
    the summed rank, a model's targets come from the last file, and the
    embeds are renamed per file. Each file has one rank over all its
    models; every file must hold every model that any file holds."""
    parsed = [parse_safeloras(h) for h in lora_safetensors]
    ranklist: List[int] = []
    for per_model in parsed:
        ranks = {r for _, rs, _ in per_model.values() for r in rs}
        if len(ranks) > 1:
            raise ValueError("Rank should be the same per model")
        ranklist.append(ranks.pop() if ranks else 0)

    models = sorted({m for per_model in parsed for m in per_model})
    modelmap: Dict[str, Tuple[list, list]] = {}
    for model in models:
        missing = [i for i, p in enumerate(parsed) if model not in p]
        if missing:
            raise ValueError(
                f"model {model!r} is absent from input file(s) {missing}; "
                "all joined files must cover the same models")
        joined, _ = join_loras([_as_tree(p[model][0]) for p in parsed])
        modelmap[model] = (_tree_to_pairs(joined), parsed[-1][model][2])

    embeds, token_size_list = _renamed_embeds(lora_safetensors)
    tensors, metadata = build_safeloras(modelmap, embeds)
    return tensors, metadata, ranklist, token_size_list


class LoRAManager:
    """N LoRA files through one pipeline patch (the reference's LoRAManager:
    join once; `tune` scales each file's rank block of the UNet LoRA,
    `prompt` rewrites <1>, <2>, ... to each file's renamed tokens). The
    joined trees land on the pipeline's device in its dtype."""

    def __init__(self, lora_paths_list: List[str], pipe):
        self.lora_paths_list = lora_paths_list
        self.pipe = pipe
        self._patch()

    def _patch(self) -> None:
        handles = [safe_open(p) for p in self.lora_paths_list]
        try:
            tensors, metadata, self.ranklist, self.token_size_list = \
                lora_join(handles)
        finally:
            for h in handles:
                h.close()
        joined = InMemorySafetensors(tensors, metadata)
        loras = parse_safeloras(joined)
        pipe = self.pipe
        for model, sites_of, attr in (
                ("unet", pipe.unet_sites, "lora_unet"),
                ("text_encoder", pipe.text_sites, "lora_text")):
            if model in loras:
                flat, _, target = loras[model]
                setattr(pipe, attr, lora_from_flat(
                    flat, sites_of(set(target)), dtype=pipe.dtype,
                    device=pipe.device))
        pipe.apply_ti(parse_safeloras_embeds(joined), idempotent=True)

    def tune(self, scales: Sequence[float]) -> None:
        """Scale i gates the rank block of file i in the UNet LoRA (the
        text encoder's LoRA is not gated, as in the reference)."""
        if len(scales) != len(self.ranklist):
            raise ValueError(
                f"need one scale per joined LoRA "
                f"({len(self.ranklist)}), got {len(scales)}")
        diag = np.repeat(np.asarray(scales, np.float32),
                         np.asarray(self.ranklist, np.int64))
        if self.pipe.lora_unet is not None:
            self.pipe.lora_unet = set_lora_diag(self.pipe.lora_unet, diag)

    def prompt(self, prompt: str) -> str:
        """<1>, <2>, ... rewritten to the renamed token group of the file
        each names."""
        if prompt is None:
            return prompt
        for i, n_tokens in enumerate(self.token_size_list):
            group = "".join(f"<s{i}-{j}>" for j in range(n_tokens))
            prompt = prompt.replace(f"<{i + 1}>", group)
        return prompt
