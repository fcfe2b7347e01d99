"""Token ids and LoRA site order: frozen copies of the rules the program
applies, so that the reference derives them again from the prompts and
the configuration alone.

Token ids: the hashed CLIP tokenizer used where no CLIP vocabulary is
present (lowercase, collapse whitespace, split out added tokens, then the
CLIP word pattern; each word is lo + crc32(word) mod (bos - lo) with
lo = min(1000, bos // 4); BOS / EOS are the vocabulary's top two ids;
padded with EOS to 77). Added (textual-inversion) tokens take ids from
the vocabulary size up.

Site order: the indexed LoRA file's "{model}:{idx}" order, the torch
module traversal of cloneofsimo/lora's `_find_modules` over diffusers'
UNet2DConditionModel and transformers' CLIPTextModel with the default
targets: per transformer block attn1 q, k, v, out, the GEGLU projection,
attn2 q, k, v, out; down blocks, then up blocks, then the mid block; per
text layer k, v, q, out.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

from .sd import unet_blocks

_WORD = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+"
    r"|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)


def token_ids(text: str, vocab_size: int, added: Dict[str, int],
              length: int = 77) -> List[int]:
    bos, eos = vocab_size - 2, vocab_size - 1
    lo = min(1000, bos // 4)
    text = re.sub(r"\s+", " ", text.strip()).lower()
    parts = [text]
    for tok in sorted(added, key=len, reverse=True):
        nxt = []
        for part in parts:
            if isinstance(part, tuple):
                nxt.append(part)
                continue
            pieces = part.split(tok)
            for i, piece in enumerate(pieces):
                if piece:
                    nxt.append(piece)
                if i < len(pieces) - 1:
                    nxt.append((tok,))
        parts = nxt
    ids = [bos]
    for part in parts:
        if isinstance(part, tuple):
            ids.append(added[part[0]])
            continue
        ids += [lo + zlib.crc32(w.encode()) % (bos - lo)
                for w in _WORD.findall(part)]
    ids = ids[:length - 1] + [eos]
    return ids + [eos] * (length - len(ids))


def unet_sites(cfg: dict) -> List[str]:
    """The UNet's default LoRA sites (module names), in file order."""
    per_level = {"down": [], "up": [], "mid": []}
    for kind, i, res, attn, _, _ in unet_blocks(cfg):
        if not attn:
            continue
        pre = "mid_block" if kind == "mid" else f"{kind}_blocks.{i}"
        n_attn = 1 if kind == "mid" else len(res)
        for j in range(n_attn):
            tb = f"{pre}.attentions.{j}.transformer_blocks.0"
            per_level[kind] += [
                f"{tb}.attn1.to_q", f"{tb}.attn1.to_k", f"{tb}.attn1.to_v",
                f"{tb}.attn1.to_out.0", f"{tb}.ff.net.0.proj",
                f"{tb}.attn2.to_q", f"{tb}.attn2.to_k", f"{tb}.attn2.to_v",
                f"{tb}.attn2.to_out.0"]
    return per_level["down"] + per_level["up"] + per_level["mid"]


def text_sites(cfg: dict) -> List[str]:
    return [f"text_model.encoder.layers.{i}.self_attn.{p}"
            for i in range(cfg["num_hidden_layers"])
            for p in ("k_proj", "v_proj", "q_proj", "out_proj")]
