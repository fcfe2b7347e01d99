"""PNG encode and decode on the stdlib's zlib and struct, for hosts without
Pillow (the GPU machines this port targets have none): the serving path's
images (serve.py) and the trainer's instance and class images
(data/dataset.py, training/dreambooth.py).

_png_bytes writes an 8-bit RGB PNG, or an 8-bit gray one (colour type 0)
of a 2-D array (the trainer's face masks); _png_decode reads the PNGs Pillow's
convert("RGB") reads, apart from 16-bit and interlaced files, which raise
a ValueError naming the case; png_size reads a file's size from its IHDR
chunk alone.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 array: RGB (colour type 2) of (H, W, 3),
    gray (colour type 0, Pillow's mode "L") of (H, W). One IDAT, filter 0
    on every row."""
    gray = rgb.ndim == 2
    h, w = rgb.shape[:2]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths this decoder takes)
_PNG_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8,)), 6: (4, (8,))}


def _png_chunks(data: bytes):
    """(tag, body) of each chunk up to IEND, every CRC checked."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4:
            raise ValueError(f"truncated PNG in chunk {tag!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n


def _unfilter_sequential(ftype: int, line: bytes, prior: bytes,
                         bpp: int) -> bytearray:
    """Average (3) and Paeth (4) scanlines: each byte needs the one bpp to
    its left already reconstructed, so a loop (the first bpp bytes see a
    zero left neighbour)."""
    cur = bytearray(line)
    if ftype == 3:
        for i in range(bpp):
            cur[i] = (cur[i] + (prior[i] >> 1)) & 0xFF
        for i in range(bpp, len(cur)):
            cur[i] = (cur[i] + ((cur[i - bpp] + prior[i]) >> 1)) & 0xFF
        return cur
    for i in range(bpp):  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prior[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prior[i], prior[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            cur[i] = (cur[i] + a) & 0xFF
        elif pb <= pc:
            cur[i] = (cur[i] + b) & 0xFF
        else:
            cur[i] = (cur[i] + c) & 0xFF
    return cur


def _png_decode(data: bytes) -> np.ndarray:
    """A PNG's pixels as (H, W, 3) uint8 RGB, as Pillow's convert("RGB")
    gives them: gray replicated (1-, 2- and 4-bit gray scaled to 0..255),
    palette indices mapped (tRNS ignored), alpha dropped. Takes colour
    types 0, 2, 3, 4 and 6 at 8 bits (0 and 3 also at 1, 2 and 4) with
    every filter, non-interlaced; anything else raises ValueError naming
    the case."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG image (only PNG is decoded)")
    header, palette, idat = None, None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            if len(body) != 13:
                raise ValueError("malformed PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if depth == 16:
        raise ValueError("16-bit PNG is not supported: save the image with "
                         "8 bits per channel")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported: save the "
                         "image non-interlaced")
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         "not supported")
    if compression or filtering or not w or not h:
        raise ValueError("malformed PNG header")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = _PNG_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)      # filter unit in bytes
    stride = (w * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum in each of the bpp lanes
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(
                ftype, line.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG scanline filter {ftype} is not valid")
        out[y] = cur
        prior = out[y]
    if depth < 8:  # unpack the samples of each byte, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w]
    px = out.reshape(h, w, channels)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette) // 3] = palette.reshape(-1, 3)
        return table[px[..., 0]]
    if ctype in (0, 4):
        gray = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file, from its IHDR chunk alone (the first
    chunk of every PNG), as Pillow's Image.open(path).size gives them
    without decoding the pixels."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG image (no IHDR chunk)")
    return struct.unpack(">II", head[16:24])
