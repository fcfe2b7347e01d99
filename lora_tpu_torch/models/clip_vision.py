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

CLIPSeg (models/clipseg.py) runs the same tower under its "clip." keys:
clip_vision_forward takes the position table resized to its patch grid
and returns the hidden states of the encoder layers it reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data import resample
from ..ops.attention import attention
from .clip import clip_text_forward
from .config import CLIPTextConfig
from .hf_dir import act_fn
from .layers import Initializer, ParamModule, Params, dense, layer_norm


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
    hidden_act: str = "quick_gelu"
    num_channels: int = 3


CLIP_VIT_L14_VISION = CLIPVisionConfig()
TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=2,
                               image_size=28, patch_size=14,
                               projection_dim=16)


def init_encoder_layer(ini: Initializer, base: str, d: int, ff: int):
    """The params of a CLIP encoder layer at `base` (layer_norm1, the
    self_attn projections, layer_norm2, mlp.fc1 and fc2): N(0, 0.02)
    weights, zero biases, unit norms."""

    def lin(name, i, o):
        ini.p[name + ".weight"] = ini.normal((o, i), 0.02)
        ini.p[name + ".bias"] = ini.zeros((o,))

    ini.norm(base + ".layer_norm1", d)
    for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
        lin(f"{base}.self_attn.{proj}", d, d)
    ini.norm(base + ".layer_norm2", d)
    lin(base + ".mlp.fc1", d, ff)
    lin(base + ".mlp.fc2", ff, d)


def init_clip_vision(cfg: CLIPVisionConfig,
                     generator: Optional[torch.Generator], *, device,
                     dtype=torch.float32) -> Params:
    """Random-init params (N(0, 0.02) weights and embeddings, zero biases,
    unit norms; uninitialised without a generator)."""
    d, L = cfg.hidden_size, cfg.num_hidden_layers
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    ini = Initializer(generator, device, dtype)
    p = ini.p
    p["vision_model.embeddings.class_embedding"] = ini.normal((d,), 0.02)
    p["vision_model.embeddings.patch_embedding.weight"] = ini.normal(
        (d, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02)
    p["vision_model.embeddings.position_embedding.weight"] = ini.normal(
        (n_pos, d), 0.02)
    ini.norm("vision_model.pre_layrnorm", d)  # HF's key (typo upstream)
    for i in range(L):
        init_encoder_layer(ini, f"vision_model.encoder.layers.{i}", d,
                           cfg.intermediate_size)
    ini.norm("vision_model.post_layernorm", d)
    p["visual_projection.weight"] = ini.normal((cfg.projection_dim, d), 0.02)
    return p


def self_attention(params: Params, base: str, x: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """CLIP's attention block at `base` (q/k/v/out_proj) on (B, T, d),
    unmasked."""
    B, T, d = x.shape

    def split(y):  # (B, T, d) -> (B, h, T, dh)
        return y.reshape(B, T, heads, d // heads).transpose(1, 2)

    att = attention(split(dense(params, base + ".q_proj", x)),
                    split(dense(params, base + ".k_proj", x)),
                    split(dense(params, base + ".v_proj", x)))
    return dense(params, base + ".out_proj",
                 att.transpose(1, 2).reshape(B, T, d))


def clip_vision_forward(params: Params, pixel_values: torch.Tensor,
                        cfg: CLIPVisionConfig, dtype=torch.float32, *,
                        positions: Optional[torch.Tensor] = None,
                        extract_layers: Optional[Sequence[int]] = None):
    """pixel_values: (B, H, W, 3) CLIP-normalized. The pooled CLS state
    after post_layernorm, (B, hidden). `positions` stands for the
    checkpoint's position table (a table resized to another patch grid).
    With `extract_layers`, the outputs of those encoder layers instead, a
    list in that order (the layers past the last are not run)."""
    B = pixel_values.shape[0]
    d = cfg.hidden_size
    act = act_fn(cfg.hidden_act)
    w = params["vision_model.embeddings.patch_embedding.weight"].to(dtype)
    patches = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2), w,
                       stride=cfg.patch_size)
    x = patches.flatten(2).transpose(1, 2)  # (B, patches, d), row-major
    cls = params["vision_model.embeddings.class_embedding"].to(dtype)
    x = torch.cat([cls.expand(B, 1, d), x], dim=1)
    if positions is None:
        positions = params["vision_model.embeddings.position_embedding.weight"]
    x = x + positions[:x.shape[1]].to(dtype)
    x = layer_norm(params, "vision_model.pre_layrnorm", x, cfg.layer_norm_eps)
    n_layers = (cfg.num_hidden_layers if extract_layers is None
                else max(extract_layers) + 1)
    states = []
    for i in range(n_layers):
        base = f"vision_model.encoder.layers.{i}"
        y = layer_norm(params, base + ".layer_norm1", x, cfg.layer_norm_eps)
        x = x + self_attention(params, base + ".self_attn", y,
                               cfg.num_attention_heads)
        y = layer_norm(params, base + ".layer_norm2", x, cfg.layer_norm_eps)
        x = x + dense(params, base + ".mlp.fc2",
                      act(dense(params, base + ".mlp.fc1", y)))
        states.append(x)
    if extract_layers is not None:
        return [states[i] for i in extract_layers]
    return layer_norm(params, "vision_model.post_layernorm", x[:, 0],
                      cfg.layer_norm_eps)


def get_image_features(params: Params, pixel_values: torch.Tensor,
                       cfg: CLIPVisionConfig) -> torch.Tensor:
    """CLIPModel.get_image_features: the pooled state through
    visual_projection, (B, projection_dim)."""
    pooled = clip_vision_forward(params, pixel_values, cfg)
    return pooled @ params["visual_projection.weight"].to(pooled.dtype).T


def get_text_features(params: Params, input_ids: torch.Tensor,
                      text_cfg: CLIPTextConfig,
                      eos_token_id: int = 2) -> torch.Tensor:
    """CLIPModel.get_text_features: the final state at each row's EOS
    through text_projection. The EOS is the largest id where eos_token_id
    is 2 (transformers' legacy rule, argmax pooling), else the first
    eos_token_id."""
    hidden = clip_text_forward(params, input_ids, text_cfg)
    eos_pos = (input_ids.argmax(dim=-1) if eos_token_id == 2
               else (input_ids == eos_token_id).int().argmax(dim=-1))
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
    gray replicated, alpha dropped (gray with alpha: the gray level)."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] in (1, 2):
        a = np.repeat(a[..., :1], 3, axis=-1)
    return np.ascontiguousarray(a[..., :3], dtype=np.uint8)


def preprocess_images(images, image_size: int = 224,
                      device="cpu") -> torch.Tensor:
    """uint8 images ((H, W, 3) arrays, or a (B, H, W, 3) array) ->
    CLIP-normalized (B, S, S, 3) float32 on `device`, each resized by
    Pillow's BICUBIC arithmetic (data/resample.py) on the host."""
    out = torch.from_numpy(np.stack([
        resample.resize(_rgb(img), (image_size, image_size),
                        resample.BICUBIC) for img in images]))
    out = out.to(device).float() / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=out.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=out.device)
    return (out - mean) / std
