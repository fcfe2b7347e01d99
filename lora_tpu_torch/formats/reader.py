"""Self-contained safetensors reader/writer (no external deps beyond numpy).

The safetensors container format:

    [8 bytes LE u64: N = header length]
    [N bytes: JSON header]
    [raw little-endian tensor data]

Header maps tensor names to ``{"dtype": str, "shape": [...], "data_offsets":
[begin, end]}`` (offsets relative to the start of the data section) plus an
optional ``"__metadata__"`` dict of string key/value pairs.

This mirrors the role of the reference's pure-python fallback reader
(lora_diffusion/safe_open.py) but is a fresh implementation
on numpy mmap views (zero-copy reads) and also implements *writing*, which
the reference fallback does not.  Unlike the reference fallback (which
never validated input), every header entry is checked at open time — dtype,
offset bounds, byte-length/shape agreement, cross-tensor overlap — so a
corrupt or adversarial file fails loudly here instead of returning garbage
tensors (pinned by tests/test_formats_adversarial.py).
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES: Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),  # numpy has no bfloat16; exposed as raw u16 view
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
    "U16": np.dtype("<u2"),
    "U32": np.dtype("<u4"),
    "U64": np.dtype("<u8"),
}

_NP_TO_ST = {
    np.dtype("float64"): "F64",
    np.dtype("float32"): "F32",
    np.dtype("float16"): "F16",
    np.dtype("int64"): "I64",
    np.dtype("int32"): "I32",
    np.dtype("int16"): "I16",
    np.dtype("int8"): "I8",
    np.dtype("uint8"): "U8",
    np.dtype("bool"): "BOOL",
    np.dtype("uint16"): "U16",
    np.dtype("uint32"): "U32",
    np.dtype("uint64"): "U64",
}


def _bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """Widen a raw-u16 view of bfloat16 data to float32."""
    out = raw_u16.astype(np.uint32) << 16
    return out.view(np.float32)


class SafetensorsFile:
    """Zero-copy safetensors reader over an mmap'ed file.

    API shape matches what the reference passes around for ``safe_open``
    handles: ``keys() / metadata() / get_tensor(key)``.
    """

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._mm = mmap.mmap(self._fd, 0, access=mmap.ACCESS_READ)
        except Exception:
            os.close(self._fd)
            raise
        try:
            self._parse_header(path)
        except Exception:
            self.close()
            raise

    def _parse_header(self, path: str) -> None:
        if len(self._mm) < 8:
            raise ValueError(
                f"corrupt safetensors header in {path}: file shorter than "
                "the 8-byte length prefix")
        header_len = int.from_bytes(self._mm[:8], "little")
        if header_len > len(self._mm) - 8:
            raise ValueError(f"corrupt safetensors header in {path}")
        try:
            header = json.loads(self._mm[8 : 8 + header_len].decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(
                f"corrupt safetensors header in {path}: not valid JSON "
                f"({e})") from e
        if not isinstance(header, dict):
            raise ValueError(
                f"corrupt safetensors header in {path}: header is not an "
                "object")
        self._metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries: Dict[str, dict] = header
        self._data_start = 8 + header_len
        self._validate_entries()

    def _validate_entries(self) -> None:
        """Reject malformed entries at open time so corruption fails loudly
        here rather than as an opaque numpy error (or worse, a silently
        garbage tensor) at first get_tensor().  Checks per entry: known
        dtype, well-formed in-bounds offsets, and byte length == dtype
        itemsize x prod(shape).  Across entries: no overlapping data ranges
        (two names aliasing the same bytes is corruption, not sharing)."""
        data_len = len(self._mm) - self._data_start
        spans = []
        for name, ent in self._entries.items():
            if not isinstance(ent, dict) or not {
                    "dtype", "shape", "data_offsets"} <= set(ent):
                raise ValueError(
                    f"corrupt safetensors header in {self.path}: entry "
                    f"{name!r} is not a tensor record")
            if ent["dtype"] not in _DTYPES:
                raise ValueError(
                    f"unsupported safetensors dtype {ent['dtype']!r} for "
                    f"tensor {name!r} in {self.path} "
                    f"(supported: {sorted(_DTYPES)})")
            off = ent["data_offsets"]
            if (not isinstance(off, (list, tuple)) or len(off) != 2
                    or not all(isinstance(o, int) for o in off)):
                raise ValueError(
                    f"corrupt safetensors header in {self.path}: bad "
                    f"data_offsets for tensor {name!r}")
            begin, end = off
            if begin < 0 or end < begin or end > data_len:
                raise ValueError(
                    f"truncated or corrupt safetensors file {self.path}: "
                    f"tensor {name!r} spans [{begin}, {end}) but only "
                    f"{data_len} data bytes are present")
            shape = ent["shape"]
            if (not isinstance(shape, list)
                    or not all(isinstance(d, int) and d >= 0 for d in shape)):
                raise ValueError(
                    f"corrupt safetensors header in {self.path}: bad shape "
                    f"for tensor {name!r}")
            n = 1
            for d in shape:
                n *= d
            want = n * _DTYPES[ent["dtype"]].itemsize
            if end - begin != want:
                raise ValueError(
                    f"corrupt safetensors file {self.path}: tensor {name!r} "
                    f"shape {shape} x {ent['dtype']} needs {want} bytes but "
                    f"data_offsets give {end - begin}")
            spans.append((begin, end, name))
        spans.sort()
        for (b0, e0, n0), (b1, e1, n1) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(
                    f"corrupt safetensors file {self.path}: tensors {n0!r} "
                    f"and {n1!r} have overlapping data ranges")

    # -- reader API ---------------------------------------------------------
    def keys(self) -> List[str]:
        return list(self._entries.keys())

    def metadata(self) -> Dict[str, str]:
        return dict(self._metadata)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def dtype(self, name: str) -> str:
        return self._entries[name]["dtype"]

    def get_tensor(self, name: str) -> np.ndarray:
        """Return tensor as numpy. bfloat16 is widened to float32."""
        ent = self._entries[name]
        st_dtype = ent["dtype"]
        np_dtype = _DTYPES[st_dtype]
        begin, end = ent["data_offsets"]
        buf = self._mm[self._data_start + begin : self._data_start + end]
        arr = np.frombuffer(buf, dtype=np_dtype).reshape(ent["shape"])
        if st_dtype == "BF16":
            arr = _bf16_to_f32(arr)
        return arr

    def close(self) -> None:
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def safe_open(path: str, framework: str = "np", device: str = "cpu") -> SafetensorsFile:
    """Drop-in shaped like ``safetensors.safe_open`` (numpy-only)."""
    del framework, device
    return SafetensorsFile(path)


def load_file(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    with SafetensorsFile(path) as f:
        return {k: np.array(f.get_tensor(k)) for k in f.keys()}, f.metadata()


def save_file(
    tensors: Dict[str, np.ndarray],
    path: str,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write a safetensors file. Accepts numpy arrays (C-contiguous enforced).

    jax bfloat16 arrays are accepted and tagged BF16.
    """
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}

    blobs: List[bytes] = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if not arr.flags["C_CONTIGUOUS"]:
            # note: ascontiguousarray promotes 0-d to 1-d, so only call it
            # when actually needed (0-d is always contiguous)
            arr = np.ascontiguousarray(arr)
        if arr.dtype.name == "bfloat16":  # ml_dtypes / jax bfloat16
            st_dtype = "BF16"
            raw = arr.view(np.uint16)
        else:
            if arr.dtype not in _NP_TO_ST:
                raise TypeError(f"unsupported dtype {arr.dtype} for tensor {name}")
            st_dtype = _NP_TO_ST[arr.dtype]
            raw = arr
        data = raw.tobytes()
        header[name] = {
            "dtype": st_dtype,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)

    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte multiple with spaces (as the rust impl does)
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for b in blobs:
            f.write(b)
