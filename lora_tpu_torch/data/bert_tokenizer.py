"""BERT's WordPiece tokenizer, self-contained: the tokenizer of a BLIP
captioning checkpoint (vocab.txt plus its special-token files), which
lora_tpu reads through `transformers` (BlipProcessor's BertTokenizer).

Encoding is BERT's basic tokenizer (control characters dropped, white
space split, lower case with accents stripped, punctuation and CJK
characters split off), then greedy longest-match WordPiece over the vocab
with "##" continuations and [UNK] for a word it cannot cover; encode wraps
the ids in [CLS] ... [SEP]. Decoding drops the special tokens on request,
joins the pieces ("##" pieces to the piece before them) and cleans the
spaces before punctuation and contractions, as transformers'
clean_up_tokenization does.

BLIP's added tokens ([DEC], the decoder's bos, and [ENC]) come from the
directory's tokenizer_config.json, special_tokens_map.json and
added_tokens.json; they are matched whole in the text before the basic
tokenizer runs.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional

_SPECIAL_KEYS = ("unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token", "bos_token", "eos_token")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _token_content(value) -> Optional[str]:
    """A token entry of the special-token files: a string or an
    AddedToken dict ({"content": ...})."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def clean_up_tokenization(text: str) -> str:
    """transformers' clean_up_tokenization: no space before . ? ! , and
    the English contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class BertTokenizer:
    """BERT's uncased WordPiece tokenizer over a vocab {token: id}."""

    def __init__(self, vocab: Dict[str, int], *, do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True,
                 special_tokens: Optional[Dict[str, str]] = None,
                 added_tokens: Optional[Dict[str, int]] = None,
                 extra_special: Iterable[str] = (),
                 clean_up_tokenization_spaces: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        self.max_input_chars_per_word = max_input_chars_per_word
        self.special = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                        "pad_token": "[PAD]", "cls_token": "[CLS]",
                        "mask_token": "[MASK]"}
        self.special.update(special_tokens or {})
        self.added = dict(added_tokens or {})
        # an added or special token missing from the vocab takes the next id
        for tok in list(self.special.values()) + list(extra_special):
            if tok not in self.vocab and tok not in self.added:
                self.added[tok] = len(self.vocab) + len(self.added)
        self.encoder = {**self.vocab, **self.added}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.special_ids = {self.encoder[t] for t in
                            list(self.special.values()) + list(extra_special)}
        # matched whole in the text, before the basic tokenizer
        self._whole = sorted(set(self.added) | set(self.special.values())
                             | set(extra_special), key=len, reverse=True)

    @classmethod
    def from_dir(cls, path: str) -> "BertTokenizer":
        """The tokenizer of a checkpoint directory: vocab.txt, and where
        present tokenizer_config.json (lower case, accents, Chinese
        characters, clean-up, added tokens), special_tokens_map.json and
        added_tokens.json."""
        vocab: Dict[str, int] = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i

        def read(name):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return {}
            with open(p, encoding="utf-8") as f:
                return json.load(f)

        cfg = read("tokenizer_config.json")
        smap = read("special_tokens_map.json")
        special, extra = {}, []
        added: Dict[str, int] = {}
        for tid, entry in (cfg.get("added_tokens_decoder") or {}).items():
            tok = _token_content(entry)
            if tok not in vocab:
                added[tok] = int(tid)
            if isinstance(entry, dict) and entry.get("special"):
                extra.append(tok)
        for tok, tid in read("added_tokens.json").items():
            if tok not in vocab:
                added[tok] = int(tid)
        for src in (cfg, smap):
            for key in _SPECIAL_KEYS:
                tok = _token_content(src.get(key))
                if tok is not None:
                    special[key] = tok
            for tok in src.get("additional_special_tokens") or ():
                extra.append(_token_content(tok))
        return cls(vocab, do_lower_case=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   tokenize_chinese_chars=cfg.get("tokenize_chinese_chars",
                                                  True),
                   special_tokens=special, added_tokens=added,
                   extra_special=extra,
                   clean_up_tokenization_spaces=cfg.get(
                       "clean_up_tokenization_spaces", True))

    def __len__(self) -> int:
        return len(self.encoder)

    def token_id(self, key: str) -> int:
        """The id of a special token by its key ("cls_token", ...)."""
        return self.encoder[self.special[key]]

    # -- encoding -----------------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic(self, text: str) -> List[str]:
        text = self._clean(text)
        if self.tokenize_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        text = unicodedata.normalize("NFC", text)
        words = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
            if (self.strip_accents is None and self.do_lower_case) or \
                    self.strip_accents:
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            piece = []
            for ch in tok:
                if _is_punctuation(ch):
                    if piece:
                        words.append("".join(piece))
                        piece = []
                    words.append(ch)
                else:
                    piece.append(ch)
            if piece:
                words.append("".join(piece))
        return words

    def _wordpiece(self, word: str) -> List[str]:
        unk = self.special["unk_token"]
        if len(word) > self.max_input_chars_per_word:
            return [unk]
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        parts = [text]
        for tok in self._whole:
            nxt = []
            for part in parts:
                if isinstance(part, tuple):
                    nxt.append(part)
                    continue
                split = part.split(tok)
                for i, s in enumerate(split):
                    nxt.append(s)
                    if i < len(split) - 1:
                        nxt.append((tok,))
            parts = nxt
        tokens = []
        for part in parts:
            if isinstance(part, tuple):
                tokens.append(part[0])
                continue
            for word in self._basic(part):
                tokens.extend(self._wordpiece(word))
        return tokens

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.encoder[t] for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.token_id("cls_token")] + ids + [
                self.token_id("sep_token")]
        return ids

    # -- decoding -----------------------------------------------------------
    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            tokens.append(self.decoder.get(i, self.special["unk_token"]))
        text = ""
        for n, tok in enumerate(tokens):
            if n == 0:
                text = tok
            elif tok.startswith("##"):
                text += tok[2:]
            else:
                text += " " + tok
        if self.clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return text
