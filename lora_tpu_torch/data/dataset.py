"""The training datasets and their loader: the counterpart of
lora_tpu/data/dataset.py (the caption templates, _resize_short,
_center_crop, crop_geometry, _color_jitter, load_image_norm,
_get_cutout_holes, generate_random_mask, PivotalTuningDataset,
DreamBoothDataset, DreamBoothTiDataset, prefetch, device_prefetch,
data_loader), without Pillow on the way.

Images come out as lora_tpu's do: NHWC float32 in [-1, 1], resized so the
short side is `size` (bilinear), optionally colour-jittered, center-cropped,
optionally flipped. The differences are in decoding and resizing:

- PNG is decoded on zlib (data/png.py), and a PNG's size is read from its
  IHDR chunk alone. JPEG is read through Pillow, imported only when a JPEG
  is met; where Pillow is absent (the card's machine), a JPEG is a
  ValueError that names the file and says to convert it to PNG.
- Pillow's BILINEAR resize is F.interpolate(mode="bilinear",
  antialias=True) on the uint8 image, on the CPU: at most one level apart
  from Pillow's on a fraction of a percent of the pixels, exact where no
  resize happens. data/resample.py gives Pillow's bytes, but its numpy
  passes are far slower on photo-sized images, and this runs on every
  image the loader reads.

random.Random(seed) drives shuffling, h_flip, color_jitter, the
inpainting holes, the caption templates and the stochastic attributes,
drawn in lora_tpu's order, so the same seed gives the same batches.
Mask-captioned PTI data ({i}.src.jpg beside {i}.mask.png) is JPEG and so
needs Pillow; face-segmentation masks that are missing are written as gray
PNGs (data/preprocess.py, data/png.py).

With LORA_TPU_TORCH_NATIVE_IMGOPS=1 an image that is resized and not
colour-jittered goes through native/imgops.c instead (lora_tpu's
LORA_TPU_NATIVE_IMGOPS=1 path): resize, crop and normalization fused in
one pass, bilinear without antialiasing. It is built at first use, and a
failed build raises.
"""

from __future__ import annotations

import collections
import glob
import os
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .png import _PNG_SIGNATURE, _png_bytes, _png_decode, png_size

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")
# "1" sends load_image_norm's resize through native/imgops.c
NATIVE_IMGOPS_ENV = "LORA_TPU_TORCH_NATIVE_IMGOPS"

# the caption templates of textual inversion, filled with the token map's
# value (lora_tpu/data/dataset.py:28-87)
OBJECT_TEMPLATE = [
    "a photo of a {}",
    "a rendering of a {}",
    "a cropped photo of the {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a photo of a dirty {}",
    "a dark photo of the {}",
    "a photo of my {}",
    "a photo of the cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a photo of the {}",
    "a good photo of the {}",
    "a photo of one {}",
    "a close-up photo of the {}",
    "a rendition of the {}",
    "a photo of the clean {}",
    "a rendition of a {}",
    "a photo of a nice {}",
    "a good photo of a {}",
    "a photo of the nice {}",
    "a photo of the small {}",
    "a photo of the weird {}",
    "a photo of the large {}",
    "a photo of a cool {}",
    "a photo of a small {}",
]

STYLE_TEMPLATE = [
    "a painting in the style of {}",
    "a rendering in the style of {}",
    "a cropped painting in the style of {}",
    "the painting in the style of {}",
    "a clean painting in the style of {}",
    "a dirty painting in the style of {}",
    "a dark painting in the style of {}",
    "a picture in the style of {}",
    "a cool painting in the style of {}",
    "a close-up painting in the style of {}",
    "a bright painting in the style of {}",
    "a cropped painting in the style of {}",
    "a good painting in the style of {}",
    "a close-up painting in the style of {}",
    "a rendition in the style of {}",
    "a nice painting in the style of {}",
    "a small painting in the style of {}",
    "a weird painting in the style of {}",
    "a large painting in the style of {}",
]

NULL_TEMPLATE = ["{}"]

TEMPLATE_MAP = {
    "object": OBJECT_TEMPLATE,
    "style": STYLE_TEMPLATE,
    "null": NULL_TEMPLATE,
}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _pillow(path: str):
    """Pillow's Image module, imported only for a non-PNG image."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: only PNG images are read without Pillow, which is not "
            "installed; convert the image to PNG") from None
    return Image


def read_image(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an image file, in the mode lora_tpu's
    load_image_norm keeps: RGB, or one channel for an 8-bit (or 2-, 4-bit)
    grayscale image (Pillow's "L"); palette, alpha and 1-bit images become
    RGB."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        rgb = _png_decode(data)
        # IHDR: bit depth at byte 24, colour type at byte 25
        if data[25] == 0 and data[24] != 1:  # gray: Pillow's mode "L"
            return np.ascontiguousarray(rgb[..., :1])
        return rgb
    Image = _pillow(path)
    with Image.open(path) as img:
        if img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        arr = np.asarray(img, np.uint8)
    return arr[..., None] if arr.ndim == 2 else arr


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the file's header, without decoding it."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        return png_size(path)
    Image = _pillow(path)
    with Image.open(path) as img:  # header-only read
        return img.size


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

def _resize_hw(w: int, h: int, size: int) -> Tuple[int, int]:
    """(new w, new h) with the short side `size`, as lora_tpu rounds it."""
    if w <= h:
        return size, max(int(round(h * size / w)), size)
    return max(int(round(w * size / h)), size), size


def _resize_short(arr: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> short side `size`, bilinear with antialiasing on
    the uint8 image (Pillow's BILINEAR resize within one level)."""
    h, w = arr.shape[:2]
    nw, nh = _resize_hw(w, h, size)
    if (nw, nh) == (w, h):
        return arr
    x = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True,
                      align_corners=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return arr[top: top + size, left: left + size]


def crop_geometry(orig_w: int, orig_h: int, size: int,
                  resize: bool = True) -> np.ndarray:
    """SDXL micro-conditioning geometry of the resize-short + center-crop
    transform: [orig_h, orig_w, crop_top, crop_left], crop offsets in
    post-resize pixels."""
    nw, nh = _resize_hw(orig_w, orig_h, size) if resize else (orig_w, orig_h)
    top = max((nh - size) // 2, 0)
    left = max((nw - size) // 2, 0)
    return np.asarray([orig_h, orig_w, top, left], np.float32)


def _color_jitter(arr: np.ndarray, rng: random.Random,
                  brightness=0.1, contrast=0.1) -> np.ndarray:
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    out = arr * b
    mean = out.mean()
    return np.clip((out - mean) * c + mean, 0.0, 1.0)


def load_image_norm(path_or_pixels: Union[str, Path, np.ndarray], size: int,
                    resize: bool = True, color_jitter: bool = False,
                    rng: Optional[random.Random] = None) -> np.ndarray:
    """An image file, or its (H, W, C) uint8 pixels -> (size, size, C)
    float32 in [-1, 1]."""
    arr = (read_image(path_or_pixels)
           if isinstance(path_or_pixels, (str, Path)) else path_or_pixels)
    if (resize and not color_jitter
            and os.environ.get(NATIVE_IMGOPS_ENV) == "1"):
        from ..native.build import resize_crop_normalize

        return resize_crop_normalize(arr, size)
    if resize:
        arr = _resize_short(arr, size)
    arr = np.asarray(arr, np.float32) / 255.0
    if color_jitter and rng is not None:
        arr = _color_jitter(arr, rng)
    arr = _center_crop(arr, size)
    return arr * 2.0 - 1.0


def _get_cutout_holes(height, width, rng: random.Random, min_holes=8,
                      max_holes=32, min_height=16, max_height=128,
                      min_width=16, max_width=128):
    """Random (x1, y1, x2, y2) holes, their extents clamped to the image
    (lora_tpu/data/dataset.py:175-193)."""
    max_height = min(max_height, height)
    max_width = min(max_width, width)
    min_height = min(min_height, max_height)
    min_width = min(min_width, max_width)
    holes = []
    for _ in range(rng.randint(min_holes, max_holes)):
        hh = rng.randint(min_height, max_height)
        hw = rng.randint(min_width, max_width)
        y1 = rng.randint(0, height - hh)
        x1 = rng.randint(0, width - hw)
        holes.append((x1, y1, x1 + hw, y1 + hh))
    return holes


def generate_random_mask(image: np.ndarray, rng: random.Random):
    """image: (H, W, C) in [-1, 1] -> (mask (H, W, 1) in {0, 1}, the masked
    image); a quarter of the masks cover everything
    (lora_tpu/data/dataset.py:196-206)."""
    h, w = image.shape[:2]
    mask = np.zeros((h, w, 1), np.float32)
    for (x1, y1, x2, y2) in _get_cutout_holes(h, w, rng):
        mask[y1:y2, x1:x2] = 1.0
    if rng.uniform(0, 1) < 0.25:
        mask.fill(1.0)
    masked = image * (mask < 0.5)
    return mask, masked


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _image_files(root: Path, skip_masks: bool = False):
    return sorted(str(p) for p in root.iterdir()
                  if p.suffix.lower() in IMAGE_SUFFIXES
                  and not (skip_masks and p.name.endswith(".mask.png")))


def _rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 with C 1 or 3 -> (H, W, 3), Pillow's
    convert("RGB")."""
    return np.repeat(pixels, 3, axis=-1) if pixels.shape[-1] == 1 else pixels


class PivotalTuningDataset:
    """Captioned instances for pivotal tuning, lora_tpu's
    PivotalTuningDataset (lora_tpu/data/dataset.py:209-334): captions from
    a template bank, the file names, or caption.txt beside {i}.src.jpg /
    {i}.mask.png pairs (use_mask_captioned_data, which needs Pillow for
    the JPEGs); token_map replacement; face-segmentation masks
    ({i}.mask.png, written as gray PNGs where missing); inpainting holes.
    Each example draws, in this order, the colour jitter, the holes and
    the fill-all, the template and the flip; a flip turns the image, the
    mask and both inpainting arrays."""

    def __init__(
        self,
        instance_data_root: str,
        tokenizer,
        token_map: Optional[dict] = None,
        use_template: Optional[str] = None,
        size: int = 512,
        h_flip: bool = True,
        color_jitter: bool = False,
        resize: bool = True,
        use_mask_captioned_data: bool = False,
        use_face_segmentation_condition: bool = False,
        train_inpainting: bool = False,
        blur_amount: int = 70,
        seed: int = 0,
    ):
        self.size = size
        self.tokenizer = tokenizer
        self.resize = resize
        self.train_inpainting = train_inpainting
        self.rng = random.Random(seed)

        root = Path(instance_data_root)
        if not root.exists():
            raise ValueError("Instance images root doesn't exists.")
        assert not (use_mask_captioned_data and use_template), \
            "Can't use both mask caption data and template."

        self.instance_images_path: List[str] = []
        self.mask_path: List[str] = []

        if use_mask_captioned_data:
            for f in sorted(glob.glob(str(root) + "/*src.jpg")):
                idx = int(Path(f).stem.split(".")[0])
                mpath = f"{root}/{idx}.mask.png"
                if Path(mpath).exists():
                    self.instance_images_path.append(f)
                    self.mask_path.append(mpath)
            with open(f"{root}/caption.txt") as fh:
                self.captions = fh.readlines()
        else:
            candidates = set(
                glob.glob(str(root) + "/*.jpg")
                + glob.glob(str(root) + "/*.png")
                + glob.glob(str(root) + "/*.jpeg")
            ) - set(glob.glob(str(root) + "/*mask.png"))
            self.instance_images_path = sorted(candidates)
            self.captions = [Path(x).name.split(".")[0]
                             for x in self.instance_images_path]

        assert self.instance_images_path, \
            "No images found in the instance data root."

        self.use_mask = (use_face_segmentation_condition
                         or use_mask_captioned_data)
        if use_face_segmentation_condition:
            n = len(self.instance_images_path)
            if any(not Path(f"{root}/{i}.mask.png").exists()
                   for i in range(n)):
                from .preprocess import face_mask_google_mediapipe

                masks = face_mask_google_mediapipe(
                    [_rgb(read_image(f)) for f in self.instance_images_path],
                    blur_amount=blur_amount)
                for i, m in enumerate(masks):
                    with open(f"{root}/{i}.mask.png", "wb") as fh:
                        fh.write(_png_bytes(m))
            self.mask_path = [f"{root}/{i}.mask.png" for i in range(n)]

        self.num_instance_images = len(self.instance_images_path)
        self.token_map = token_map
        self.use_template = use_template
        self.templates = TEMPLATE_MAP[use_template] if use_template else None
        self.h_flip = h_flip
        self.color_jitter = color_jitter
        self.blur_amount = blur_amount
        self._length = self.num_instance_images

    def __len__(self):
        return self._length

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        example: Dict[str, np.ndarray] = {}
        i = index % self.num_instance_images
        img = load_image_norm(self.instance_images_path[i], self.size,
                              self.resize, self.color_jitter, self.rng)
        example["instance_images"] = img

        if self.train_inpainting:
            m, masked = generate_random_mask(img, self.rng)
            example["instance_masks"] = m
            example["instance_masked_images"] = masked

        if self.use_template:
            assert self.token_map is not None
            input_tok = list(self.token_map.values())[0]
            text = self.rng.choice(self.templates).format(input_tok)
        else:
            text = self.captions[i].strip()
            if self.token_map is not None:
                for token, value in self.token_map.items():
                    text = text.replace(token, value)

        if self.use_mask:
            # the image's transform, then * 0.5 + 1.0, one channel
            mask = load_image_norm(self.mask_path[i], self.size,
                                   self.resize) * 0.5 + 1.0
            example["mask"] = mask[..., :1]

        if self.h_flip and self.rng.random() > 0.5:
            for key in ("instance_images", "mask", "instance_masks",
                        "instance_masked_images"):
                if key in example:
                    example[key] = example[key][:, ::-1]

        example["text"] = text
        example["instance_prompt_ids"] = self.tokenizer(
            [text])["input_ids"][0]
        return example


class DreamBoothDataset:
    """Instance + class (prior-preservation) dataset, lora_tpu's
    DreamBoothDataset."""

    def __init__(
        self,
        instance_data_root: str,
        instance_prompt: str,
        tokenizer,
        class_data_root: Optional[str] = None,
        class_prompt: Optional[str] = None,
        size: int = 512,
        center_crop: bool = False,
        color_jitter: bool = False,
        h_flip: bool = False,
        resize: bool = True,
        seed: int = 0,
        return_geometry: bool = False,
    ):
        self.size = size
        self.tokenizer = tokenizer
        self.rng = random.Random(seed)
        self.resize = resize
        self.color_jitter = color_jitter
        self.h_flip = h_flip
        self.return_geometry = return_geometry

        root = Path(instance_data_root)
        if not root.exists():
            raise ValueError("Instance images root doesn't exists.")
        # cached face-segmentation masks ({i}.mask.png) are not instances
        self.instance_images_path = _image_files(root, skip_masks=True)
        self.num_instance_images = len(self.instance_images_path)
        self.instance_prompt = instance_prompt
        self._length = self.num_instance_images

        if class_data_root is not None:
            croot = Path(class_data_root)
            croot.mkdir(parents=True, exist_ok=True)
            self.class_images_path = _image_files(croot)
            self.num_class_images = len(self.class_images_path)
            self._length = max(self.num_class_images, self.num_instance_images)
            self.class_prompt = class_prompt
        else:
            self.class_images_path = []
            self.num_class_images = 0

    def __len__(self):
        return self._length

    def _geometry(self, path: str) -> np.ndarray:
        w, h = image_size(path)
        return crop_geometry(w, h, self.size, self.resize)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        ex: Dict[str, np.ndarray] = {}
        ipath = self.instance_images_path[index % self.num_instance_images]
        img = load_image_norm(ipath, self.size, self.resize,
                              self.color_jitter, self.rng)
        if self.h_flip and self.rng.random() > 0.5:
            img = img[:, ::-1]
        ex["instance_images"] = img
        if self.return_geometry:
            ex["instance_geometry"] = self._geometry(ipath)
        ex["instance_prompt_ids"] = self.tokenizer(
            [self.instance_prompt])["input_ids"][0]
        if self.num_class_images:
            cpath = self.class_images_path[index % self.num_class_images]
            ex["class_images"] = load_image_norm(cpath, self.size, self.resize)
            if self.return_geometry:
                ex["class_geometry"] = self._geometry(cpath)
            ex["class_prompt_ids"] = self.tokenizer(
                [self.class_prompt])["input_ids"][0]
        return ex


class DreamBoothTiDataset(DreamBoothDataset):
    """The legacy TI+LoRA trainer's dataset, lora_tpu's DreamBoothTiDataset
    (lora_tpu/data/dataset.py:508-535): captions from the template bank
    around the placeholder token, with stochastic attributes (a random
    subset, shuffled, comma-joined after the token)."""

    def __init__(self, *args, placeholder_token: str = "<s>",
                 learnable_property: str = "object",
                 stochastic_attribute: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.placeholder_token = placeholder_token
        self.templates = TEMPLATE_MAP[learnable_property]
        self.stochastic_attribute = (
            stochastic_attribute.split(",") if stochastic_attribute else [])

    def __getitem__(self, index):
        ex = super().__getitem__(index)
        attrs = [a for a in self.stochastic_attribute
                 if self.rng.random() < 0.5]
        self.rng.shuffle(attrs)
        text = self.rng.choice(self.templates).format(
            ", ".join([self.placeholder_token] + attrs))
        ex["instance_prompt_ids"] = self.tokenizer([text])["input_ids"][0]
        return ex


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch: host-side decode and augmentation
    overlap the device steps. The worker also exits when the consumer
    abandons the generator (close or garbage collection), not only at the
    end of the iterator: training loops run endless loaders, and without
    the stop signal each finished run would leak a worker blocked in
    q.put."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    stop_evt = threading.Event()

    def guarded_put(item) -> bool:
        while not stop_evt.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not guarded_put(item):
                    return
        except Exception as e:  # surface errors to the consumer
            guarded_put(("__error__", e))
        guarded_put(stop)

    t = threading.Thread(target=worker, daemon=True,
                         name="lora_tpu_torch_prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] == "__error__"):
                raise item[1]
            yield item
    finally:
        stop_evt.set()


def device_prefetch(iterator: Iterator, depth: int = 2, device="cuda",
                    keep_on_host: Tuple[str, ...] = ()
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays -> dicts of tensors on `device`, `depth`
    batches ahead: on CUDA each array goes through pinned host memory with
    a non_blocking copy, so the upload overlaps the running step. Keys in
    keep_on_host stay numpy arrays (the trainer keys its text-embedding
    cache on the host ids). Combine with prefetch for host-side decode
    overlap: device_prefetch(prefetch(data_loader(...)))."""
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if k in keep_on_host:
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t.to(device)
        return out

    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def data_loader(dataset, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                prior_preservation: bool = False,
                process_index: int = 0,
                process_count: int = 1,
                num_workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batch iterator, lora_tpu's data_loader. With
    prior_preservation, instance and class halves are concatenated
    [instance | class] and "is_instance" marks the rows. Pixel masks
    ("mask", ones for the class rows) and inpainting arrays
    ("mask_values", "masked_image_values") are stacked when the examples
    carry them.
    process_index/count shard the sample stream per process. num_workers > 0
    decodes samples on a thread pool with one batch of lookahead; the
    augmentation draws then interleave across threads, so set
    num_workers=0 for a deterministic augmentation order."""

    def index_chunks():
        rng = random.Random(seed)
        n = len(dataset)
        while True:
            idxs = list(range(n))
            if shuffle:
                rng.shuffle(idxs)
            if process_count > 1:
                idxs = idxs[process_index::process_count] or idxs[:1]
            while len(idxs) < batch_size:  # tiny datasets: repeat-sample
                idxs = idxs + idxs
            m = len(idxs)
            for s in range(0, m - (batch_size - 1 if drop_last else 0),
                           batch_size):
                ci = idxs[s: s + batch_size]
                if len(ci) == batch_size or not drop_last:
                    yield ci

    def collate(chunk) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        pixel = np.stack([c["instance_images"] for c in chunk])
        ids = [c["instance_prompt_ids"] for c in chunk]
        if prior_preservation:
            pixel = np.concatenate(
                [pixel, np.stack([c["class_images"] for c in chunk])])
            ids = ids + [c["class_prompt_ids"] for c in chunk]
            n = len(chunk)
            batch["is_instance"] = np.concatenate(
                [np.ones(n, np.float32), np.zeros(n, np.float32)])
        batch["pixel_values"] = pixel.astype(np.float32)
        batch["input_ids"] = np.asarray(ids, np.int64)
        if "instance_geometry" in chunk[0]:
            geom = np.stack([c["instance_geometry"] for c in chunk])
            if prior_preservation:
                geom = np.concatenate(
                    [geom, np.stack([c["class_geometry"] for c in chunk])])
            batch["time_ids_geom"] = geom.astype(np.float32)
        if "mask" in chunk[0]:
            batch["mask"] = np.stack(
                [c["mask"] for c in chunk]).astype(np.float32)
            if prior_preservation:
                batch["mask"] = np.concatenate(
                    [batch["mask"], np.ones_like(batch["mask"])])
        if "instance_masks" in chunk[0]:
            batch["mask_values"] = np.stack(
                [c["instance_masks"] for c in chunk]).astype(np.float32)
            batch["masked_image_values"] = np.stack(
                [c["instance_masked_images"] for c in chunk]
            ).astype(np.float32)
        return batch

    if num_workers <= 0:
        for ci in index_chunks():
            yield collate([dataset[i] for i in ci])
        return

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=num_workers,
                              thread_name_prefix="lora_tpu_torch_decode")
    pending: "collections.deque" = collections.deque()
    try:
        for ci in index_chunks():
            pending.append([pool.submit(dataset.__getitem__, i) for i in ci])
            if len(pending) >= 2:  # one batch of lookahead stays in flight
                yield collate([f.result() for f in pending.popleft()])
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
