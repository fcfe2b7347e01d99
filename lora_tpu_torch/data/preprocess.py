"""The dataset preprocessing pipeline, `lora_ppim`: the counterpart of
lora_tpu/data/preprocess.py. BLIP captions, CLIPSeg concept masks,
mediapipe face masks, Swin2SR super-resolution, the salience-centered
square crop, and the {i}.src.jpg / {i}.mask.png / caption.txt layout.

Built on numpy and the port's own towers, without Pillow or
`transformers`: images are (H, W, 3) uint8 arrays and masks (H, W) uint8
arrays. The model-backed stages run BLIP (models/blip.py), CLIPSeg
(models/clipseg.py) and Swin2SR (models/swin2sr.py) from the checkpoint
directories lora_tpu's from_pretrained loads, given explicitly or found
under $LORA_TPU_AUX_MODELS/{blip,clipseg,swin2sr}, on `device` (None: the
card; asked for the card without one, a stage raises). Where no directory
is given each stage falls back as lora_tpu's does: the constant caption,
the soft ellipse mask, the bicubic upscale. Pillow's resizes and crops are
data/resample.py's, byte for byte.

Pillow's GaussianBlur is an extended box blur, three passes of a box with
a fractional radius in 8-bit fixed point, horizontal then vertical;
_gaussian_blur does the same arithmetic in the same order and gives
Pillow's bytes (the tests hold it to Pillow's output with
GAUSSIAN_BLUR_TOL = 0 levels, over sizes from 1x1 to 640x480 and radii
from 0.5 to 100).

mediapipe is imported lazily; where it is absent (on both the machines the
port runs on) every image gets the soft centered ellipse, as in lora_tpu.
The rectangle branch that runs with mediapipe is ported as well, but no
machine of this project can run it.

The entry point is split in two: `preprocess_images` runs the stages on arrays
and returns captions, images and masks; `write_dataset` writes the files.
The masks are written as gray PNGs by data/png.py; {i}.src.jpg is JPEG and
is written by Pillow (quality 99), so the entry point raises before any model
runs where Pillow is absent. Input PNGs are read by data/png.py, JPEGs
only where Pillow is (data/dataset.py read_image).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.blip import BlipCaptioner
from ..models.clipseg import CLIPSegMasker
from ..models.hf_dir import aux_model_dir as _aux_model_dir
from ..models.swin2sr import Swin2SRUpscaler
from . import resample
from .dataset import read_image
from .png import _png_bytes

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


def _fill_rectangle(mask: np.ndarray, x1: float, y1: float, x2: float,
                    y2: float) -> None:
    """Set the box to 255 in an (h, w) uint8 mask, as Pillow's
    draw.rectangle(fill=255) does: each corner truncated toward zero, both
    edges inside the box, nothing drawn where the box lies wholly outside
    the image, the rest clipped to it."""
    h, w = mask.shape
    c0, c1 = sorted((int(x1), int(x2)))
    r0, r1 = sorted((int(y1), int(y2)))
    if c1 < 0 or r1 < 0 or c0 >= w or r0 >= h:
        return
    mask[max(r0, 0):r1 + 1, max(c0, 0):c1 + 1] = 255


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
                _fill_rectangle(mask, x1, y1, x2, y2)
            mask = _gaussian_blur(mask, blur_amount)
            arr = mask.astype(np.float32) / 255
            arr = np.clip(arr + bias, 0, 1) * 255
            masks.append(arr.astype(np.uint8))
    return masks


# ---------------------------------------------------------------------------
# the salience crop
# ---------------------------------------------------------------------------

def _center_of_mass(mask: np.ndarray) -> Tuple[float, float]:
    """Intensity-weighted centroid (x, y) of an (h, w) mask, the image's
    center where the mask is empty."""
    arr = np.asarray(mask, np.float32)
    total = arr.sum()
    if total <= 0:
        return arr.shape[1] / 2, arr.shape[0] / 2
    ys, xs = np.indices(arr.shape)
    return float((xs * arr).sum() / total), float((ys * arr).sum() / total)


def _crop_to_square(img: np.ndarray, com: Tuple[float, float],
                    resize_to: Optional[int] = None) -> np.ndarray:
    """The square crop centered, as far as the edges allow, on the salience
    point, its float box rounded as Pillow rounds it; then LANCZOS to
    resize_to x resize_to where given."""
    cx, cy = com
    w, h = _image_size(img)
    if w > h:
        left = min(max(cx - h / 2, 0), w - h)
        img = resample.crop(img, (left, 0, left + h, h))
    elif h > w:
        top = min(max(cy - w / 2, 0), h - w)
        img = resample.crop(img, (0, top, w, top + w))
    if resize_to:
        img = resample.resize(img, (resize_to, resize_to), resample.LANCZOS)
    return img


# ---------------------------------------------------------------------------
# model-backed stages (the fallbacks where no checkpoint directory is given)
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def blip_captioning_dataset(
    images: Sequence[np.ndarray],
    text: Optional[str] = None,
    model_dir: Optional[str] = None,
    fallback_caption: str = "a photo of a person",
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
) -> List[str]:
    """BLIP captions of (h, w, 3) uint8 images, lora_tpu's call
    (max_length=150, do_sample=True, top_k=50, temperature=0.7, the
    optional prompt); the constant caption where no BLIP directory is
    given. The draws come from `generator`, else from a generator on the
    device seeded with `seed` (from entropy when None)."""
    model_dir = model_dir or _aux_model_dir("blip")
    if model_dir is None:
        return [fallback_caption] * len(images)
    captioner = BlipCaptioner(model_dir, device=_device(device))
    if generator is None:
        generator = torch.Generator(captioner.device)
        if seed is None:
            generator.seed()
        else:
            generator.manual_seed(int(seed))
    return [captioner.caption(img, text, generator=generator, max_length=150,
                              do_sample=True, top_k=50, temperature=0.7)
            for img in images]


def clipseg_mask_generator(
    images: Sequence[np.ndarray],
    target_prompts: Union[str, Sequence[str]],
    model_dir: Optional[str] = None,
    bias: float = 0.01,
    temp: float = 1.0,
    *,
    device=None,
) -> List[np.ndarray]:
    """CLIPSeg masks, (h, w) uint8, of (h, w, 3) images: sigmoid(logits /
    temp) + bias, clamped, times 255, truncated, BICUBIC back to the
    image's size; the soft ellipse where no CLIPSeg directory is given.
    Prompts are padded to CLIP's 77 positions and truncated."""
    if isinstance(target_prompts, str):
        target_prompts = [target_prompts] * len(images)
    model_dir = model_dir or _aux_model_dir("clipseg")
    if model_dir is None:
        return [_ellipse_mask(_image_size(img)) for img in images]
    masker = CLIPSegMasker(model_dir, device=_device(device))
    return [masker.mask(img, prompt, bias=bias, temp=temp)
            for img, prompt in zip(images, target_prompts)]


def swin_ir_sr(
    images: Sequence[np.ndarray],
    target_size: Optional[Tuple[int, int]] = None,
    model_dir: Optional[str] = None,
    *,
    device=None,
) -> List[np.ndarray]:
    """Swin2SR 2x super-resolution of the images narrower than target_size
    (w, h); the output keeps the processor's padding, as lora_tpu's. The
    bicubic resize to target_size where no Swin2SR directory is given."""
    model_dir = model_dir or _aux_model_dir("swin2sr")
    out = []
    if model_dir is None:
        for img in images:
            if target_size is not None and _image_size(img)[0] < \
                    target_size[0]:
                img = resample.resize(img, target_size, resample.BICUBIC)
            out.append(img)
        return out
    upscaler = Swin2SRUpscaler(model_dir, device=_device(device))
    for img in images:
        if target_size is not None and _image_size(img)[0] >= target_size[0]:
            out.append(img)
            continue
        out.append(upscaler.upscale(img))
    return out


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _pillow_image():
    """Pillow's Image module, which writes {i}.src.jpg."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "lora_ppim writes {i}.src.jpg as JPEG, which needs Pillow, and "
            "Pillow is not installed; install it (the stages themselves run "
            "without it: preprocess_images returns the arrays)") from None
    return Image


def _list_files(files: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(files, str):
        if os.path.isdir(files):
            return sorted(
                os.path.join(files, f) for f in os.listdir(files)
                if f.lower().endswith((".png", ".jpg", ".jpeg")))
        import glob

        return sorted(glob.glob(files))
    return list(files)


def _read_rgb(path: str) -> np.ndarray:
    """An image file as Pillow's convert("RGB") gives it: (H, W, 3)
    uint8, gray replicated."""
    img = read_image(path)
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def preprocess_images(
    images: Sequence[np.ndarray],
    caption_text: Optional[str] = None,
    target_prompts: Optional[Union[str, Sequence[str]]] = None,
    target_size: int = 512,
    use_face_detection_instead: bool = False,
    temp: float = 1.0,
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
) -> Tuple[List[str], List[np.ndarray], List[np.ndarray]]:
    """lora_tpu's stages in its order on (h, w, 3) uint8 images: caption,
    mask (CLIPSeg on the target prompts, the captions by default, or face
    masks), the salience crop of both (the mask LANCZOS to target_size),
    super-resolution, LANCZOS to target_size. Returns (captions, images
    (target_size, target_size, 3), masks (target_size, target_size))."""
    captions = blip_captioning_dataset(images, text=caption_text,
                                       device=device, generator=generator,
                                       seed=seed)
    if target_prompts is None:
        target_prompts = captions
    if use_face_detection_instead:
        masks = face_mask_google_mediapipe(images)
    else:
        masks = clipseg_mask_generator(images, target_prompts, temp=temp,
                                       device=device)
    coms = [_center_of_mass(m) for m in masks]
    images = [_crop_to_square(img, com) for img, com in zip(images, coms)]
    masks = [_crop_to_square(m, com, resize_to=target_size)
             for m, com in zip(masks, coms)]
    images = swin_ir_sr(images, target_size=(target_size, target_size),
                        device=device)
    images = [resample.resize(img, (target_size, target_size),
                              resample.LANCZOS) for img in images]
    return captions, images, masks


def write_dataset(output_dir: str, captions: Sequence[str],
                  images: Sequence[np.ndarray],
                  masks: Sequence[np.ndarray]) -> None:
    """caption.txt (one caption a line), {i}.src.jpg (Pillow, quality 99)
    and {i}.mask.png (gray, data/png.py)."""
    Image = _pillow_image()
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "caption.txt"), "w") as f:
        f.write("\n".join(captions))
    for i, (img, mask) in enumerate(zip(images, masks)):
        Image.fromarray(img).save(os.path.join(output_dir, f"{i}.src.jpg"),
                                  quality=99)
        with open(os.path.join(output_dir, f"{i}.mask.png"), "wb") as f:
            f.write(_png_bytes(mask))


def load_and_save_masks_and_captions(
    files: Union[str, Sequence[str]],
    output_dir: str,
    caption_text: Optional[str] = None,
    target_prompts: Optional[Union[str, Sequence[str]]] = None,
    target_size: int = 512,
    use_face_detection_instead: bool = False,
    temp: float = 1.0,
    n_length: int = -1,
    device: Optional[str] = None,
    seed: Optional[int] = None,
) -> List[str]:
    """The `lora_ppim` entry point, lora_tpu's: the images of a directory
    or glob (or a list of paths) through preprocess_images, written by
    write_dataset; returns the captions. `device` (None: the card) runs
    the towers; `seed` seeds BLIP's draws."""
    _pillow_image()
    files = _list_files(files)
    if not files:
        raise ValueError("no input images found")
    if n_length > 0:
        files = files[:n_length]
    images = [_read_rgb(f) for f in files]
    captions, images, masks = preprocess_images(
        images, caption_text, target_prompts, target_size,
        use_face_detection_instead, temp, device=device, seed=seed)
    write_dataset(output_dir, captions, images, masks)
    return captions
