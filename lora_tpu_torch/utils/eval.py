"""The evaluation harness, the counterpart of lora_tpu/utils/eval.py (the
reference's utils.py): the 32 <obj> prompt templates, image grids, the
CLIP text and image alignment scores of the textual-inversion paper,
evaluate_pipe and visualize_progress.

Images are uint8 (H, W, 3) numpy arrays where lora_tpu hands PIL images
around, so the module needs no Pillow. Scoring takes either the in-port
CLIP (models/clip_vision.py; a dict of params, configs and tokenizer) or
a local `transformers` CLIP checkpoint (LORA_TPU_AUX_MODELS/clip, imported
only when one is there). Without a scorer, evaluate_pipe still generates
and returns the images' statistics.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

EXAMPLE_PROMPTS = [
    "<obj> swimming in a pool",
    "<obj> at a beach with a view of seashore",
    "<obj> in times square",
    "<obj> wearing sunglasses",
    "<obj> in a construction outfit",
    "<obj> playing with a ball",
    "<obj> wearing headphones",
    "an oil painting of <obj> in the style of van gogh",
    "<obj> with the Eiffel Tower in the background",
    "<obj> near a body of water",
    "<obj> riding a bicycle",
    "<obj> wearing a red hat",
    "<obj> is playing the guitar",
    "<obj> reading a book",
    "<obj> eating a burger",
    "<obj> drinking a soda",
    "<obj> playing with a kite",
    "<obj> in a chef outfit",
    "<obj> as a firefighter",
    "<obj> as a police officer",
    "<obj> wearing a birthday hat",
    "<obj> on a boat in the sea",
    "<obj> in a supermarket",
    "<obj> at a park",
    "<obj> in the snow",
    "<obj> surfing a wave",
    "<obj> in the jungle",
    "<obj> in the desert",
    "<obj> climbing a mountain",
    "<obj> under a starry sky",
    "<obj> in a library full of books",
    "<obj> dancing in the rain",
]


def image_grid(imgs: List[np.ndarray], rows: Optional[int] = None,
               cols: Optional[int] = None) -> np.ndarray:
    """Equal-sized uint8 images tiled row-major into a rows x cols sheet,
    (rows * h, cols * w, 3) uint8 (the reference's utils.py:54-70); a
    missing count is inferred, empty tiles are black, and an image of
    another size is resized to the first one's first (bicubic, as Pillow's
    default resize, data/resample.py; with its alpha, before the alpha is
    dropped, as lora_tpu resizes and then converts)."""
    from ..data import resample
    from ..models.clip_vision import _rgb

    n = len(imgs)
    if rows is None and cols is None:
        rows = cols = math.ceil(n ** 0.5)
    elif rows is None:
        rows = math.ceil(n / cols)
    elif cols is None:
        cols = math.ceil(n / rows)
    h, w = np.asarray(imgs[0]).shape[:2]
    sheet = np.zeros((rows * cols, h, w, 3), np.uint8)
    sheet[:n] = [_rgb(im if np.asarray(im).shape[:2] == (h, w)
                      else resample.resize(im, (w, h), resample.BICUBIC))
                 for im in imgs]
    return (sheet.reshape(rows, cols, h, w, 3)
            .transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, 3))


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> uint8, clipped and truncated: lora_tpu's
    to_pil without the PIL image."""
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def prepare_clip_model_sets(model_dir: Optional[str] = None):
    """A local `transformers` CLIP (model, processor) for the alignment
    scores (the reference's utils.py:103-109), from `model_dir`/clip or
    $LORA_TPU_AUX_MODELS/clip; None when there is none."""
    model_dir = model_dir or os.environ.get("LORA_TPU_AUX_MODELS")
    if model_dir:
        model_dir = os.path.join(model_dir, "clip")
    if not model_dir or not os.path.isdir(model_dir):
        return None
    from transformers import CLIPModel, CLIPProcessor

    return (CLIPModel.from_pretrained(model_dir),
            CLIPProcessor.from_pretrained(model_dir))


def text_img_alignment(img_embeds, text_embeds, target_img_embeds):
    """The textual-inversion paper's alignment scores (the reference's
    utils.py:73-100): mean cosine similarity of the generated images to the
    prompts and to the target images."""
    def norm(x):
        return x / x.norm(dim=-1, keepdim=True)

    img_embeds, text_embeds = norm(img_embeds), norm(text_embeds)
    target_img_embeds = norm(target_img_embeds)
    return {"text_alignment_avg": (img_embeds @ text_embeds.T).mean().item(),
            "image_alignment_avg":
                (img_embeds @ target_img_embeds.T).mean().item()}


@torch.no_grad()
def clip_alignment_scores(gen_images, prompts, target_images, clip_params,
                          vision_cfg, text_cfg,
                          tokenizer) -> Dict[str, float]:
    """Text and image alignment with the in-port CLIP
    (models/clip_vision.py) on the device of `clip_params` (a flat dict
    holding HF CLIPModel's vision and text keys): lora_tpu's
    clip_alignment_scores_jax."""
    from ..models.clip_vision import (
        get_image_features,
        get_text_features,
        preprocess_images,
    )

    device = clip_params["visual_projection.weight"].device
    img_e = get_image_features(
        clip_params, preprocess_images(gen_images, vision_cfg.image_size,
                                       device), vision_cfg)
    ids = torch.tensor(tokenizer(prompts)["input_ids"], dtype=torch.long,
                       device=device)
    txt_e = get_text_features(clip_params, ids, text_cfg)
    tgt_e = get_image_features(
        clip_params, preprocess_images(target_images, vision_cfg.image_size,
                                       device), vision_cfg)
    return text_img_alignment(img_e, txt_e, tgt_e)


def evaluate_pipe(
    pipe,
    target_images: List[np.ndarray],
    class_token: str = "",
    learnt_token: str = "",
    guidance_scale: float = 5.0,
    seed: int = 0,
    clip_model_sets=None,
    n_test: int = 10,
    n_step: int = 50,
) -> Dict[str, float]:
    """Generate one image per canonical prompt (the first `n_test`, with
    `learnt_token`; prompt i from torch.Generator(pipe.device) seeded
    seed + i) and score CLIP alignment against `target_images` and the
    prompts with `class_token` (the reference's utils.py:112-163).
    `clip_model_sets` is the in-port scorer's dict ({"params",
    "vision_cfg", "text_cfg", "tokenizer"}), a transformers (model,
    processor) pair, or None for the image statistics alone."""
    results: Dict[str, float] = {}
    gen_images: List[np.ndarray] = []
    prompts: List[str] = []
    for i, template in enumerate(EXAMPLE_PROMPTS[:n_test]):
        imgs = pipe(template.replace("<obj>", learnt_token),
                    num_inference_steps=n_step,
                    guidance_scale=guidance_scale,
                    generator=torch.Generator(pipe.device).manual_seed(
                        seed + i))
        gen_images.append(to_uint8(imgs[0]))
        prompts.append(template.replace("<obj>", class_token))

    if isinstance(clip_model_sets, dict):  # the in-port CLIP
        results.update(clip_alignment_scores(
            gen_images, prompts, target_images,
            clip_model_sets["params"], clip_model_sets["vision_cfg"],
            clip_model_sets["text_cfg"], clip_model_sets["tokenizer"]))
    elif clip_model_sets is not None:  # a local transformers CLIP
        model, processor = clip_model_sets
        with torch.no_grad():
            inp = processor(images=gen_images, return_tensors="pt")
            img_embeds = model.get_image_features(**inp)
            inp = processor(text=prompts, return_tensors="pt", padding=True,
                            truncation=True)
            text_embeds = model.get_text_features(**inp)
            inp = processor(images=target_images, return_tensors="pt")
            target_embeds = model.get_image_features(**inp)
        results.update(text_img_alignment(img_embeds, text_embeds,
                                          target_embeds))
    arr = np.stack([np.asarray(im, np.float32) for im in gen_images])
    results["gen_mean"] = float(arr.mean())
    results["gen_std"] = float(arr.std())
    results["n_images"] = len(gen_images)
    return results


def visualize_progress(
    path_alls: str,
    prompt: str,
    pipe,
    n_imgs: int = 50,
    seed: int = 0,
    num_inference_steps: int = 50,
    guidance_scale: float = 5.0,
    offset: int = 0,
    limit: int = 10,
    height: int = 512,
    width: int = 512,
) -> List[np.ndarray]:
    """The same prompt and seed rendered through each checkpoint of a run
    (the glob's sorted matches [offset:limit]) as uint8 images (the
    reference's utils.py:166-214)."""
    imgs: List[np.ndarray] = []
    alls = sorted(glob.glob(path_alls))[offset:limit]
    print(f"Found {len(alls)} checkpoints")
    for ckpt in alls:
        pipe.patch_pipe(ckpt)
        out = pipe(prompt, num_inference_steps=num_inference_steps,
                   guidance_scale=guidance_scale,
                   generator=torch.Generator(pipe.device).manual_seed(seed),
                   height=height, width=width)
        imgs.append(to_uint8(out[0]))
    return imgs
