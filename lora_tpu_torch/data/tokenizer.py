"""CLIP byte-pair tokenizer, self-contained.

Replaces the reference's `transformers.CLIPTokenizer` dependency
(cli_lora_pti.py:58-63). Loads the standard OpenAI vocab.json/merges.txt
when given (producing identical ids to HF's CLIPTokenizer); without vocab
files a deterministic hashed fallback keeps the full pipeline runnable in
hermetic environments (ids differ, everything else — padding, specials,
added tokens — behaves the same).

Textual-inversion support: `add_tokens` appends new whole-word tokens after
the base vocabulary (the reference resizes the embedding table,
lora.py:922-941; here new ids simply index the TI buffer region).
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Sequence, Union

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False  # \p classes need regex module; use the ascii-equivalent below
    else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """model_max_length / pad-to-max semantics match the reference usage
    (cli_lora_pti.py:159-164: padding="max_length", truncation=True)."""

    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        merges: Optional[List[str]] = None,
        model_max_length: int = 77,
        vocab_size: int = 49408,
    ):
        self.model_max_length = model_max_length
        self.byte_encoder = bytes_to_unicode()
        if vocab is not None:
            self.encoder = dict(vocab)
            self.hashed = False
            self.base_vocab_size = max(self.encoder.values()) + 1
        else:
            # hashed fallback: words map deterministically into the model's
            # id space; BOS/EOS take the top two ids (CLIP convention)
            self.encoder = {BOS: vocab_size - 2, EOS: vocab_size - 1}
            self.hashed = True
            self.base_vocab_size = vocab_size
        self.bos_token_id = self.encoder[BOS] if BOS in self.encoder else 49406
        self.eos_token_id = self.encoder[EOS] if EOS in self.encoder else 49407
        self.bpe_ranks: Dict[tuple, int] = {}
        if merges:
            pairs = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
            self.bpe_ranks = {p: i for i, p in enumerate(pairs)}
        self.added_tokens: Dict[str, int] = {}
        self._added_sorted: List[str] = []
        self.cache: Dict[str, List[str]] = {}

    # -- vocab management ---------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   model_max_length: int = 77) -> "CLIPTokenizer":
        with open(vocab_json) as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line of the OpenAI merges file is a version header
        merges = [l for l in lines[1:] if l]
        return cls(vocab, merges, model_max_length)

    def __len__(self) -> int:
        return self.base_vocab_size + len(self.added_tokens)

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Returns how many were newly added (0 if present) — the contract
        apply_learned_embed_in_clip relies on (lora.py:922-931)."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for t in tokens:
            if t in self.added_tokens or t in self.encoder:
                continue
            self.added_tokens[t] = self.base_vocab_size + len(self.added_tokens)
            added += 1
        self._added_sorted = sorted(self.added_tokens, key=len, reverse=True)
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token in self.encoder:
            return self.encoder[token]
        if self.hashed:
            return self._hash_id(token)
        return self.encoder.get(token + "</w>", self.eos_token_id)

    # -- tokenization -------------------------------------------------------
    def _hash_id(self, word: str) -> int:
        lo = min(1000, self.bos_token_id // 4)
        return lo + (zlib.crc32(word.encode()) % (self.bos_token_id - lo))

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            self.cache[token] = ["".join(word)]
            return self.cache[token]
        while len(word) > 1:
            pairs = _get_pairs(word)
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self.cache[token] = out
        return out

    def _split_added(self, text: str) -> List[Union[str, tuple]]:
        """Split out added (TI) tokens as atomic units before BPE."""
        parts: List[Union[str, tuple]] = [text]
        for tok in self._added_sorted:
            next_parts: List[Union[str, tuple]] = []
            for part in parts:
                if isinstance(part, tuple):
                    next_parts.append(part)
                    continue
                pieces = part.split(tok)
                for i, piece in enumerate(pieces):
                    if piece:
                        next_parts.append(piece)
                    if i < len(pieces) - 1:
                        next_parts.append((tok,))
            parts = next_parts
        return parts

    def encode(self, text: str) -> List[int]:
        """Token ids without specials."""
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for part in self._split_added(text):
            if isinstance(part, tuple):
                ids.append(self.added_tokens[part[0]])
                continue
            for word in _PAT.findall(part):
                if self.hashed:
                    ids.append(self._hash_id(word))
                    continue
                word_b = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                for piece in self._bpe(word_b):
                    ids.append(self.encoder.get(piece, self.eos_token_id))
        return ids

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: Optional[int] = None,
        pad_token_id: Optional[int] = None,
    ):
        """Returns {"input_ids": List[List[int]]} padded with EOS to
        max_length, BOS/EOS wrapped — CLIP convention. SDXL's second
        tokenizer pads with "!" (id 0) instead; pass pad_token_id=0 for
        that convention (the pad identity reaches the conditioning: every
        position feeds cross-attention, not just the pre-eos ones)."""
        if isinstance(text, str):
            text = [text]
        L = max_length or self.model_max_length
        pad = self.eos_token_id if pad_token_id is None else pad_token_id
        batch = []
        for t in text:
            ids = [self.bos_token_id] + self.encode(t)
            if truncation:
                ids = ids[: L - 1]
            ids = ids + [self.eos_token_id]
            ids = ids + [pad] * (L - len(ids))
            batch.append(ids[:L])
        return {"input_ids": batch}


def default_tokenizer(vocab_dir: Optional[str] = None,
                      vocab_size: int = 49408,
                      require_real: bool = False) -> CLIPTokenizer:
    """Load the real CLIP vocab if present (vocab.json + merges.txt in
    vocab_dir, vocab_dir/tokenizer, or $LORA_TPU_CLIP_VOCAB), else the
    hashed fallback sized to the model's vocabulary.

    The hashed fallback produces ids unrelated to the real CLIP vocabulary —
    fine for hermetic tests, garbage conditioning with pretrained weights.
    ``require_real=True`` (set by ``from_pretrained`` when it loaded real
    weights) turns the silent fallback into an error unless the caller opts
    in with LORA_TPU_ALLOW_HASHED_TOKENIZER=1."""
    for d in (vocab_dir, os.environ.get("LORA_TPU_CLIP_VOCAB")):
        if not d:
            continue
        for sub in ("", "tokenizer"):
            vj = os.path.join(d, sub, "vocab.json")
            if os.path.exists(vj):
                return CLIPTokenizer.from_files(
                    vj, os.path.join(d, sub, "merges.txt"))
    if require_real:
        if os.environ.get("LORA_TPU_ALLOW_HASHED_TOKENIZER") != "1":
            raise FileNotFoundError(
                f"No CLIP vocab.json found under {vocab_dir!r} (or "
                "$LORA_TPU_CLIP_VOCAB); refusing to pair pretrained weights "
                "with the hashed test tokenizer. Provide tokenizer/vocab.json"
                " + merges.txt, pass tokenizer=..., or set "
                "LORA_TPU_ALLOW_HASHED_TOKENIZER=1 to override."
            )
        import warnings

        warnings.warn(
            "Using the crc32-hashed tokenizer with pretrained weights "
            "(LORA_TPU_ALLOW_HASHED_TOKENIZER=1): prompt conditioning will "
            "not match the real CLIP vocabulary.",
            stacklevel=2,
        )
    return CLIPTokenizer(vocab_size=vocab_size)
