"""Pillow's image arithmetic on uint8 numpy arrays: Image.resize with the
BICUBIC, BILINEAR and LANCZOS filters, and Image.crop of a float box.

lora_tpu's preprocessing (lora_tpu/data/preprocess.py) and the image
processors of its BLIP, CLIPSeg and Swin2SR checkpoints resize through
Pillow; the port's machines have no Pillow, so this module does the same
arithmetic in the same order (Pillow's libImaging/Resample.c):

- the filter's support is stretched by the reduction factor when
  shrinking, each output pixel's taps are the input pixels whose centers
  fall within it, weighted by the filter at their distance and normalised
  to sum to one (double precision);
- the weights are rounded to 22-bit fixed point, each pass sums
  level * weight in integers from half a unit, shifts back and clamps to
  a level;
- the horizontal pass runs first (when the width changes), its result
  stored as uint8, then the vertical pass (when the height changes);
- an image with alpha (RGBA, LA) is resampled premultiplied, as Pillow
  converts it to RGBa / La first and back after: each color level times
  alpha / 255 rounded as its MULDIV255, and back as 255 * level / alpha
  truncated and clamped (left as it is where alpha is 0 or 255).

The tests hold resize and crop to Pillow's bytes with RESAMPLE_TOL = 0
levels over filters, gray, gray with alpha, RGB and RGBA images, up and
down, and odd sizes.

Images are (H, W) or (H, W, C) uint8 arrays, C = 2 being gray with alpha
and C = 4 RGB with alpha, as Pillow's fromarray reads them; sizes are
(width, height), as Pillow gives them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# the largest difference in levels from Pillow's resize and crop that the
# port is held to: none
RESAMPLE_TOL = 0

NEAREST, LANCZOS, BILINEAR, BICUBIC = 0, 1, 2, 3  # PIL.Image.Resampling

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# filter -> (function, support)
_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0),
            LANCZOS: (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, resample: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs for the box (0, in_size) and
    normalize_coeffs_8bpc: (first input index (out,), 22-bit fixed-point
    weights (out, ksize) int64, zero past each pixel's taps)."""
    fn, support = _FILTERS[resample]
    filterscale = scale = float(np.float32(in_size)) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        first[xx] = xmin
    scaled = kk * float(1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5))
    return first, fixed.astype(np.int64)


def _pass(a: np.ndarray, out_size: int, resample: int) -> np.ndarray:
    """One 8-bit pass along axis 1 of an (H, W, C) uint8 array."""
    first, k = _coeffs(a.shape[1], out_size, resample)
    ksize = k.shape[1]
    idx = np.minimum(first[:, None] + np.arange(ksize)[None, :],
                     a.shape[1] - 1)  # taps past the taps weigh 0
    taps = a.astype(np.int64)[:, idx]  # (H, out, ksize, C)
    ss = (taps * k[None, :, :, None]).sum(axis=2) + (1 << (_PRECISION_BITS - 1))
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(a: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (LA -> La) as Pillow's converter does it: each color
    level times alpha with MULDIV255's rounding, alpha kept."""
    alpha = a[..., -1:].astype(np.int64)
    tmp = a[..., :-1].astype(np.int64) * alpha + 128
    return np.concatenate([((tmp >> 8) + tmp) >> 8, alpha],
                          axis=-1).astype(np.uint8)


def _unpremultiply(a: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (La -> LA): 255 * level / alpha, truncated and clamped
    to 255, where alpha is neither 0 nor 255; elsewhere the levels as they
    are."""
    alpha = a[..., -1:].astype(np.int64)
    color = a[..., :-1].astype(np.int64)
    scaled = np.minimum(255 * color // np.maximum(alpha, 1), 255)
    color = np.where((alpha == 0) | (alpha == 255), color, scaled)
    return np.concatenate([color, alpha], axis=-1).astype(np.uint8)


def resize(img: np.ndarray, size: Sequence[int],
           resample: int = BICUBIC) -> np.ndarray:
    """Image.resize(size, resample) of a uint8 (H, W) or (H, W, C) array;
    size is (width, height). An image already of that size is copied; one
    with alpha (C = 2 or 4) is resampled premultiplied."""
    if resample not in _FILTERS:
        raise ValueError(f"resample {resample!r} is not one of BICUBIC, "
                         "BILINEAR or LANCZOS")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 images, got {img.dtype}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize to {w}x{h}: both sides must be positive")
    gray = img.ndim == 2
    a = img[..., None] if gray else img
    alpha = a.shape[-1] in (2, 4) and a.shape[:2] != (h, w)
    if alpha:
        a = _premultiply(a)
    if a.shape[1] != w:
        a = _pass(a, w, resample)
    if a.shape[0] != h:
        a = _pass(a.transpose(1, 0, 2), h, resample).transpose(1, 0, 2)
    if alpha:
        a = _unpremultiply(a)
    a = np.ascontiguousarray(a)
    return a[..., 0] if gray else a


def crop(img: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """Image.crop(box) of a uint8 array: each corner of the (left, upper,
    right, lower) box rounded as Python's round() does, the part outside
    the image zero."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"crop box {tuple(box)} has a negative side")
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out
