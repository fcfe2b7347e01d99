"""The face masks pivotal tuning conditions its loss on, the counterpart of
the part of lora_tpu/data/preprocess.py that the PTI dataset reaches:
_ellipse_mask (preprocess.py:60-71) and face_mask_google_mediapipe
(preprocess.py:146-183). The rest of the preprocessing pipeline (BLIP
captions, CLIPSeg masks, super-resolution, the salience crop) is not ported
yet (ROADMAP Slice 5).

Built on numpy, without Pillow: images are (H, W, 3) uint8 arrays and masks
(H, W) uint8 arrays. Pillow's GaussianBlur is an extended box blur, three
passes of a box with a fractional radius in 8-bit fixed point, horizontal
then vertical; _gaussian_blur does the same arithmetic in the same order
and gives Pillow's bytes (the tests hold it to Pillow's output with
GAUSSIAN_BLUR_TOL = 0 levels, over sizes from 1x1 to 640x480 and radii
from 0.5 to 100).

mediapipe is imported lazily; where it is absent (on both the machines the
port runs on) every image gets the soft centered ellipse, as in lora_tpu.
The rectangle branch that runs with mediapipe is ported as well, but no
machine of this project can run it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# the largest difference in levels from Pillow's GaussianBlur on a uint8
# mask that the port's blur is held to: none
GAUSSIAN_BLUR_TOL = 0


def _box_radius(sigma: float, passes: int) -> np.float32:
    """The fractional box radius whose `passes` passes have variance
    sigma ** 2 (Gwosdek et al., the formula of Pillow's
    _gaussian_blur_radius), in its f32 arithmetic."""
    f32 = np.float32
    sigma2 = f32(sigma) * f32(sigma) / f32(passes)
    L = f32(np.sqrt(12.0 * float(sigma2) + 1.0))
    l = f32(np.floor((float(L) - 1.0) / 2.0))
    a = (f32(2) * l + f32(1)) * (l * (l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (l + f32(1)) * (l + f32(1))))
    return f32(l + a)


def _box_pass(a: np.ndarray, radius: np.float32) -> np.ndarray:
    """One pass along the last axis of a uint8-valued int64 array: the
    edge-replicated box of integer radius r with the two taps at r + 1
    weighted by the fractional part, in Pillow's 24-bit fixed point,
    rounded to a level."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = a.shape[-1]
    padded = a[..., np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)]
    c = np.concatenate([np.zeros(a.shape[:-1] + (1,), np.int64),
                        np.cumsum(padded, axis=-1)], axis=-1)
    x = np.arange(n)
    window = c[..., x + 2 * r + 2] - c[..., x + 1]
    far = padded[..., x] + padded[..., x + 2 * r + 2]
    return (window * ww + far * fw + (1 << 23)) >> 24


def _gaussian_blur(mask: np.ndarray, radius: float,
                   passes: int = 3) -> np.ndarray:
    """Pillow's ImageFilter.GaussianBlur(radius) of an (H, W) uint8 mask:
    `passes` box passes along the rows, then as many along the columns."""
    if radius == 0:
        return mask.copy()
    box = _box_radius(radius, passes)
    a = mask.astype(np.int64)
    for _ in range(passes):
        a = _box_pass(a, box)
    a = a.T
    for _ in range(passes):
        a = _box_pass(a, box)
    return np.ascontiguousarray(a.T).astype(np.uint8)


def _ellipse_mask(size: Tuple[int, int],
                  blur_amount: float = 80.0) -> np.ndarray:
    """Fallback saliency mask of an image of size (w, h): a soft centered
    ellipse, (h, w) uint8."""
    w, h = size
    ys, xs = np.indices((h, w)).astype(np.float32)
    d = (((xs - w / 2) / (w / 2.5)) ** 2 + ((ys - h / 2) / (h / 2.5)) ** 2)
    mask = (d < 1.0).astype(np.float32) * 255
    return _gaussian_blur(mask.astype(np.uint8), blur_amount / 8)


def _image_size(img: np.ndarray) -> Tuple[int, int]:
    return img.shape[1], img.shape[0]


def face_mask_google_mediapipe(images: Sequence[np.ndarray],
                               blur_amount: float = 80.0,
                               bias: float = 0.05) -> List[np.ndarray]:
    """(h, w) uint8 face masks of (h, w, 3) uint8 images: mediapipe's face
    boxes filled, blurred by blur_amount and lifted by `bias` where
    mediapipe is installed and finds a face; the soft ellipse otherwise."""
    try:
        import mediapipe as mp
    except ImportError:
        return [_ellipse_mask(_image_size(img), blur_amount)
                for img in images]

    mp_face = mp.solutions.face_detection
    masks = []
    with mp_face.FaceDetection(model_selection=1,
                               min_detection_confidence=0.5) as fd:
        for img in images:
            w, h = _image_size(img)
            results = fd.process(np.ascontiguousarray(img[..., :3]))
            if not results.detections:
                masks.append(_ellipse_mask((w, h), blur_amount))
                continue
            mask = np.zeros((h, w), np.uint8)
            for det in results.detections:
                bbox = det.location_data.relative_bounding_box
                x1 = bbox.xmin * w
                y1 = bbox.ymin * h
                x2 = x1 + bbox.width * w
                y2 = y1 + bbox.height * h
                # Pillow's draw.rectangle: corners truncated to ints, both
                # edges inside the box
                c0, c1 = sorted((max(int(x1), 0), max(int(x2), 0)))
                r0, r1 = sorted((max(int(y1), 0), max(int(y2), 0)))
                mask[r0:r1 + 1, c0:c1 + 1] = 255
            mask = _gaussian_blur(mask, blur_amount)
            arr = mask.astype(np.float32) / 255
            arr = np.clip(arr + bias, 0, 1) * 255
            masks.append(arr.astype(np.uint8))
    return masks
