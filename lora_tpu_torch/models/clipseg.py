"""CLIPSeg text-prompted segmentation in PyTorch, without `transformers`:
the counterpart of CLIPSegForImageSegmentation and CLIPSegProcessor, which
lora_tpu's clipseg_mask_generator (lora_tpu/data/preprocess.py:107-143)
runs on the host.

The towers are CLIP's under the "clip." keys: the ViT of
models/clip_vision.py, its learned positions interpolated bicubically
(align_corners=False) from the checkpoint's grid to the input's, read at
the outputs of its `extract_layers`; the text encoder of models/clip.py,
pooled at the first eos and projected (clip_vision.get_text_features);
the decoder: each extracted layer reduced to `reduce_dim` (deepest
first, summed into the running state), FiLM of the text embedding at
`conditional_layer`, a post-LN transformer layer (ReLU MLP) per extracted
layer, then the class token dropped and the patch grid up-sampled by a
transposed convolution (rd64-refined: a 3x3 conv, ReLU and two stride
patch/4 transposed convs) to one logit per input pixel. Param keys are the
checkpoint's state-dict keys.

`mask` is lora_tpu's mask step: sigmoid(logits / temp) + bias, clamped,
times 255, truncated to uint8, then Pillow's default resize (BICUBIC for
mode L, data/resample.py) back to the image's size.

No attention here reaches the flash kernels: the vision tower's 485
tokens (352 px, patch 16), the decoder's and the text's 77 causal ones
fail their shape rule, so every call takes ops/attention.py's plain path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data import resample
from ..data.tokenizer import CLIPTokenizer
from . import hf_dir
from .clip import init_clip_text
from .clip_vision import (
    CLIPVisionConfig,
    clip_vision_forward,
    get_text_features,
    init_clip_vision,
    init_encoder_layer,
    self_attention,
)
from .config import CLIPTextConfig
from .layers import Initializer, Params, dense, layer_norm


@dataclasses.dataclass(frozen=True)
class CLIPSegTextConfig:
    """transformers' CLIPSegTextConfig defaults."""
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 49406
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPSegVisionConfig:
    """transformers' CLIPSegVisionConfig defaults."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPSegConfig:
    """transformers' CLIPSegConfig defaults."""
    text: CLIPSegTextConfig = CLIPSegTextConfig()
    vision: CLIPSegVisionConfig = CLIPSegVisionConfig()
    projection_dim: int = 512
    extract_layers: Tuple[int, ...] = (3, 6, 9)
    reduce_dim: int = 64
    decoder_num_attention_heads: int = 4
    decoder_intermediate_size: int = 2048
    conditional_layer: int = 0
    use_complex_transposed_convolution: bool = False


# CIDAS/clipseg-rd64-refined: the defaults with a ViT-B/16 vision tower and
# the complex transposed convolution
CLIPSEG_RD64_REFINED = CLIPSegConfig(
    vision=CLIPSegVisionConfig(patch_size=16),
    use_complex_transposed_convolution=True)

# ViTImageProcessor's defaults (the published processor sets ImageNet's)
VIT_IMAGE_MEAN = (0.5, 0.5, 0.5)
VIT_IMAGE_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def config_from_json(d: dict) -> CLIPSegConfig:
    return hf_dir.config_from_dict(
        CLIPSegConfig, d,
        text=hf_dir.config_from_dict(CLIPSegTextConfig,
                                     d.get("text_config") or {}),
        vision=hf_dir.config_from_dict(CLIPSegVisionConfig,
                                       d.get("vision_config") or {}))


def config_to_json(cfg: CLIPSegConfig) -> dict:
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ("text", "vision")}
    d["extract_layers"] = list(cfg.extract_layers)
    return {"architectures": ["CLIPSegForImageSegmentation"],
            "model_type": "clipseg", **d,
            "text_config": dataclasses.asdict(cfg.text),
            "vision_config": dataclasses.asdict(cfg.vision)}


def _text_cfg(t: CLIPSegTextConfig) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        intermediate_size=t.intermediate_size,
        num_hidden_layers=t.num_hidden_layers,
        num_attention_heads=t.num_attention_heads,
        max_position_embeddings=t.max_position_embeddings,
        layer_norm_eps=t.layer_norm_eps, hidden_act=t.hidden_act)


def _vision_cfg(cfg: CLIPSegConfig) -> CLIPVisionConfig:
    v = cfg.vision
    return CLIPVisionConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_hidden_layers,
        num_attention_heads=v.num_attention_heads, image_size=v.image_size,
        patch_size=v.patch_size, projection_dim=cfg.projection_dim,
        layer_norm_eps=v.layer_norm_eps, hidden_act=v.hidden_act,
        num_channels=v.num_channels)


def _clip(params: Params) -> Params:
    """The CLIP towers' params under CLIPModel's keys ("clip." dropped)."""
    return {k[len("clip."):]: v for k, v in params.items()
            if k.startswith("clip.")}


def init_clipseg(cfg: CLIPSegConfig, generator: Optional[torch.Generator],
                 *, device, dtype=torch.float32) -> Params:
    """Random-init params (the towers as models/clip.py and
    models/clip_vision.py draw them; N(0, 0.02) weights elsewhere, zero
    biases, unit norms; uninitialised without a generator)."""
    ini = Initializer(generator, device, dtype)
    p = ini.p
    for tower in (init_clip_text(_text_cfg(cfg.text), generator,
                                 device=device, dtype=dtype),
                  init_clip_vision(_vision_cfg(cfg), generator,
                                   device=device, dtype=dtype)):
        p.update({"clip." + k: v for k, v in tower.items()})

    def lin(name, i, o, bias=True):
        p[name + ".weight"] = ini.normal((o, i), 0.02)
        if bias:
            p[name + ".bias"] = ini.zeros((o,))

    t, v, r = cfg.text, cfg.vision, cfg.reduce_dim
    lin("clip.text_projection", t.hidden_size, cfg.projection_dim,
        bias=False)
    p["clip.logit_scale"] = ini.zeros(())

    lin("decoder.film_mul", cfg.projection_dim, r)
    lin("decoder.film_add", cfg.projection_dim, r)
    tc = "decoder.transposed_convolution"
    if cfg.use_complex_transposed_convolution:
        k = v.patch_size // 4
        p[tc + ".0.weight"] = ini.normal((r, r, 3, 3), 0.02)
        p[tc + ".0.bias"] = ini.zeros((r,))
        p[tc + ".2.weight"] = ini.normal((r, r // 2, k, k), 0.02)
        p[tc + ".2.bias"] = ini.zeros((r // 2,))
        p[tc + ".4.weight"] = ini.normal((r // 2, 1, k, k), 0.02)
        p[tc + ".4.bias"] = ini.zeros((1,))
    else:
        p[tc + ".weight"] = ini.normal((r, 1, v.patch_size, v.patch_size),
                                       0.02)
        p[tc + ".bias"] = ini.zeros((1,))
    for i in range(len(cfg.extract_layers)):
        lin(f"decoder.reduces.{i}", v.hidden_size, r)
        init_encoder_layer(ini, f"decoder.layers.{i}", r,
                           cfg.decoder_intermediate_size)
    return p


def _positions(table: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """The position table for a (rows, cols) patch grid: the patch rows
    resized bicubically (align_corners=False) from the checkpoint's square
    grid when the grid differs, the class row kept."""
    n = table.shape[0] - 1
    if grid[0] * grid[1] == n and grid[0] == grid[1]:
        return table
    side = int(n ** 0.5)
    patch = table[1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, size=grid, mode="bicubic",
                          align_corners=False)
    return torch.cat([table[:1], patch.permute(0, 2, 3, 1).reshape(
        grid[0] * grid[1], -1)])


def vision_activations(params: Params, pixel_values: torch.Tensor,
                       cfg: CLIPSegConfig) -> list:
    """pixel_values (B, H, W, 3) -> the outputs of the vision layers in
    extract_layers, in that order (the layers past the last are not run:
    the mask does not read them)."""
    clip, p = _clip(params), cfg.vision.patch_size
    grid = (pixel_values.shape[1] // p, pixel_values.shape[2] // p)
    positions = _positions(
        clip["vision_model.embeddings.position_embedding.weight"], grid)
    return clip_vision_forward(clip, pixel_values, _vision_cfg(cfg),
                               positions=positions,
                               extract_layers=cfg.extract_layers)


def text_embeddings(params: Params, input_ids: torch.Tensor,
                    cfg: CLIPSegConfig) -> torch.Tensor:
    """get_text_features of the text tower and its projection."""
    return get_text_features(_clip(params), input_ids, _text_cfg(cfg.text),
                             cfg.text.eos_token_id)


def decoder_forward(params: Params, activations: list,
                    cond: torch.Tensor, cfg: CLIPSegConfig) -> torch.Tensor:
    """CLIPSegDecoder: logits (B, H, W) of the image pixels."""
    eps = cfg.vision.layer_norm_eps
    x = None
    for i, a in enumerate(activations[::-1]):
        r = dense(params, f"decoder.reduces.{i}", a)
        x = r if x is None else r + x
        if i == cfg.conditional_layer:
            x = (dense(params, "decoder.film_mul", cond)[:, None] * x
                 + dense(params, "decoder.film_add", cond)[:, None])
        b = f"decoder.layers.{i}"
        x = layer_norm(params, b + ".layer_norm1",
                       x + self_attention(params, b + ".self_attn", x,
                                          cfg.decoder_num_attention_heads),
                       eps)
        x = layer_norm(params, b + ".layer_norm2",
                       x + dense(params, b + ".mlp.fc2", torch.relu(
                           dense(params, b + ".mlp.fc1", x))), eps)
    x = x[:, 1:].transpose(1, 2)
    side = int(x.shape[2] ** 0.5)
    x = x.reshape(x.shape[0], x.shape[1], side, side)
    tc = "decoder.transposed_convolution"
    if cfg.use_complex_transposed_convolution:
        k = cfg.vision.patch_size // 4
        x = torch.relu(F.conv2d(x, params[tc + ".0.weight"],
                                params[tc + ".0.bias"], padding=1))
        x = torch.relu(F.conv_transpose2d(x, params[tc + ".2.weight"],
                                          params[tc + ".2.bias"], stride=k))
        x = F.conv_transpose2d(x, params[tc + ".4.weight"],
                               params[tc + ".4.bias"], stride=k)
    else:
        x = F.conv_transpose2d(x, params[tc + ".weight"],
                               params[tc + ".bias"],
                               stride=cfg.vision.patch_size)
    return x[:, 0]


def segmentation_logits(params: Params, pixel_values: torch.Tensor,
                        input_ids: torch.Tensor,
                        cfg: CLIPSegConfig) -> torch.Tensor:
    """CLIPSegForImageSegmentation(input_ids, pixel_values).logits."""
    return decoder_forward(params,
                           vision_activations(params, pixel_values, cfg),
                           text_embeddings(params, input_ids, cfg), cfg)


class CLIPSegMasker:
    """A CLIPSeg directory on a device: the params, the CLIP tokenizer
    (vocab.json and merges.txt) and the image processor's settings."""

    def __init__(self, model_dir: str, device="cuda"):
        device = hf_dir.check_device(device, "CLIPSeg masks")
        self.cfg = config_from_json(hf_dir.read_json(model_dir,
                                                     "config.json"))
        expected = hf_dir.shapes(init_clipseg(self.cfg, None, device="meta"))
        self.params = hf_dir.load_params(model_dir, expected, device=device)
        self.device = device
        tok_cfg = hf_dir.read_json(model_dir, "tokenizer_config.json",
                                   required=False)
        self.tokenizer = CLIPTokenizer.from_files(
            f"{model_dir}/vocab.json", f"{model_dir}/merges.txt",
            model_max_length=int(min(tok_cfg.get("model_max_length", 77),
                                     self.cfg.text.max_position_embeddings)))
        self.pre = hf_dir.read_json(model_dir, "preprocessor_config.json",
                                    required=False)

    def pixels(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """ViTImageProcessor on (H, W, 3) uint8 images: BILINEAR to the
        configured size, rescale, mean and std; (B, h, w, 3)."""
        s = self.cfg.vision.image_size
        px = [hf_dir.image_pixels(img, self.pre, size=(s, s),
                                  resample_filter=resample.BILINEAR,
                                  mean=VIT_IMAGE_MEAN, std=VIT_IMAGE_STD)
              for img in images]
        return torch.from_numpy(np.stack(px)).to(self.device)

    def input_ids(self, prompts: Sequence[str]) -> torch.Tensor:
        """The prompts padded to max_length and truncated, CLIP's way."""
        return torch.tensor(self.tokenizer(list(prompts))["input_ids"],
                            device=self.device)

    @torch.no_grad()
    def logits(self, image: np.ndarray, prompt: str) -> torch.Tensor:
        return segmentation_logits(self.params, self.pixels([image]),
                                   self.input_ids([prompt]), self.cfg)

    def mask(self, image: np.ndarray, prompt: str, bias: float = 0.01,
             temp: float = 1.0) -> np.ndarray:
        """lora_tpu's mask of one (H, W, 3) image: (H, W) uint8."""
        probs = torch.sigmoid(self.logits(image, prompt) / temp)
        probs = (probs + bias).clamp_(0, 1) * 255
        m = probs[0].cpu().numpy().astype(np.uint8)
        return resample.resize(m, (image.shape[1], image.shape[0]),
                               resample.BICUBIC)
