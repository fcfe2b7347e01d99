"""CLIP ViT vision tower and the projection heads of CLIPModel, in PyTorch:
the counterpart of lora_tpu/models/clip_vision.py. The eval harness
(utils/eval.py: the textual-inversion paper's text and image alignment,
the reference's utils.py:73-100) scores with it without `transformers`.

Param keys are HF CLIPModel's state_dict keys, its "pre_layrnorm" typo
included, so a local openai/clip-vit-large-patch14 checkpoint loads as an
identity map. Images are NHWC at the public functions, as everywhere in
the port; the patch embedding is a stride-`patch_size` conv on NCHW
inside. Attention goes through ops/attention.py: ViT-L/14's 257 tokens
fail the flash kernels' shape rule, so the tower takes the plain path, as
lora_tpu's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import attention
from .clip import clip_text_forward
from .config import CLIPTextConfig
from .layers import Initializer, ParamModule, Params, dense, layer_norm
from .layers import quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


CLIP_VIT_L14_VISION = CLIPVisionConfig()
TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=2,
                               image_size=28, patch_size=14,
                               projection_dim=16)


def init_clip_vision(cfg: CLIPVisionConfig,
                     generator: Optional[torch.Generator], *, device,
                     dtype=torch.float32) -> Params:
    """Random-init params (N(0, 0.02) weights and embeddings, zero biases,
    unit norms; uninitialised without a generator)."""
    d, ff, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    ini = Initializer(generator, device, dtype)
    p = ini.p

    def lin(name, i, o, bias=True):
        p[name + ".weight"] = ini.normal((o, i), 0.02)
        if bias:
            p[name + ".bias"] = ini.zeros((o,))

    p["vision_model.embeddings.class_embedding"] = ini.normal((d,), 0.02)
    p["vision_model.embeddings.patch_embedding.weight"] = ini.normal(
        (d, 3, cfg.patch_size, cfg.patch_size), 0.02)
    p["vision_model.embeddings.position_embedding.weight"] = ini.normal(
        (n_pos, d), 0.02)
    ini.norm("vision_model.pre_layrnorm", d)  # HF's key (typo upstream)
    for i in range(L):
        base = f"vision_model.encoder.layers.{i}"
        ini.norm(base + ".layer_norm1", d)
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            lin(f"{base}.self_attn.{proj}", d, d)
        ini.norm(base + ".layer_norm2", d)
        lin(base + ".mlp.fc1", d, ff)
        lin(base + ".mlp.fc2", ff, d)
    ini.norm("vision_model.post_layernorm", d)
    lin("visual_projection", d, cfg.projection_dim, bias=False)
    return p


def clip_vision_forward(params: Params, pixel_values: torch.Tensor,
                        cfg: CLIPVisionConfig,
                        dtype=torch.float32) -> torch.Tensor:
    """pixel_values: (B, H, W, 3) CLIP-normalized. The pooled CLS state
    after post_layernorm, (B, hidden)."""
    B = pixel_values.shape[0]
    d, h = cfg.hidden_size, cfg.num_attention_heads
    dh = d // h
    w = params["vision_model.embeddings.patch_embedding.weight"].to(dtype)
    patches = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2), w,
                       stride=cfg.patch_size)
    x = patches.flatten(2).transpose(1, 2)  # (B, patches, d), row-major
    cls = params["vision_model.embeddings.class_embedding"].to(dtype)
    x = torch.cat([cls.expand(B, 1, d), x], dim=1)
    x = x + params["vision_model.embeddings.position_embedding.weight"][
        :x.shape[1]].to(dtype)
    x = layer_norm(params, "vision_model.pre_layrnorm", x, cfg.layer_norm_eps)

    def heads(y):  # (B, T, d) -> (B, h, T, dh)
        return y.reshape(B, -1, h, dh).transpose(1, 2)

    def unheads(y):
        return y.transpose(1, 2).reshape(B, -1, d)

    for i in range(cfg.num_hidden_layers):
        base = f"vision_model.encoder.layers.{i}"
        y = layer_norm(params, base + ".layer_norm1", x, cfg.layer_norm_eps)
        sa = base + ".self_attn"
        att = unheads(attention(heads(dense(params, sa + ".q_proj", y)),
                                heads(dense(params, sa + ".k_proj", y)),
                                heads(dense(params, sa + ".v_proj", y))))
        x = x + dense(params, sa + ".out_proj", att)
        y = layer_norm(params, base + ".layer_norm2", x, cfg.layer_norm_eps)
        x = x + dense(params, base + ".mlp.fc2",
                      quick_gelu(dense(params, base + ".mlp.fc1", y)))
    return layer_norm(params, "vision_model.post_layernorm", x[:, 0],
                      cfg.layer_norm_eps)


def get_image_features(params: Params, pixel_values: torch.Tensor,
                       cfg: CLIPVisionConfig) -> torch.Tensor:
    """CLIPModel.get_image_features: the pooled state through
    visual_projection, (B, projection_dim)."""
    pooled = clip_vision_forward(params, pixel_values, cfg)
    return pooled @ params["visual_projection.weight"].to(pooled.dtype).T


def get_text_features(params: Params, input_ids: torch.Tensor,
                      text_cfg: CLIPTextConfig) -> torch.Tensor:
    """CLIPModel.get_text_features: the final state at each row's largest
    id (the EOS: argmax pooling) through text_projection."""
    hidden = clip_text_forward(params, input_ids, text_cfg)
    eos_pos = input_ids.argmax(dim=-1)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                    eos_pos]
    return pooled @ params["text_projection.weight"].to(pooled.dtype).T


class CLIPVision(ParamModule):
    """The vision half of HF CLIPModel (vision_model.* and
    visual_projection.weight) as an nn.Module; forward gives the image
    features of NHWC CLIP-normalized pixels."""

    def __init__(self, cfg: CLIPVisionConfig, *, device,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(init_clip_vision(cfg, generator, device=device,
                                          dtype=dtype))
        self.cfg = cfg

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return get_image_features(self.flat_params(), pixel_values, self.cfg)


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _rgb(img) -> np.ndarray:
    """An image as (H, W, 3) uint8, as Pillow's convert("RGB") gives it:
    gray replicated, alpha dropped."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    return np.ascontiguousarray(a[..., :3], dtype=np.uint8)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half up and clamp to [0, 255], as Pillow stores each pass."""
    return torch.floor(x + 0.5).clamp(0, 255)


def resize_bicubic(img, height: int, width: int, device="cpu") -> torch.Tensor:
    """An image resized to (height, width, 3) uint8 as Pillow's BICUBIC
    resize does it: F.interpolate(mode="bicubic", antialias=True) (the
    cubic a = -0.5, stretched over the scale when shrinking) in f32, the
    horizontal pass first, each pass rounded and clamped to 8 bits as
    Pillow stores it. Pillow sums in fixed point, so a pixel may differ
    from its by one level."""
    x = torch.from_numpy(_rgb(img)).to(device)
    h, w = x.shape[:2]
    if (h, w) == (height, width):
        return x
    y = x.permute(2, 0, 1)[None].float()
    for size, resized in (((h, width), w != width),
                          ((height, width), h != height)):
        if resized:
            y = _round_u8(F.interpolate(y, size=size, mode="bicubic",
                                        align_corners=False, antialias=True))
    return y[0].permute(1, 2, 0).to(torch.uint8)


def preprocess_images(images, image_size: int = 224,
                      device="cpu") -> torch.Tensor:
    """uint8 images ((H, W, 3) arrays, or a (B, H, W, 3) array) ->
    CLIP-normalized (B, S, S, 3) float32 on `device`, each resized as
    Pillow's BICUBIC (resize_bicubic)."""
    out = torch.stack([resize_bicubic(img, image_size, image_size, device)
                       for img in images]).float() / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=out.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=out.device)
    return (out - mean) / std
