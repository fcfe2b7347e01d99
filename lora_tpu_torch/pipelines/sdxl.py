"""Stable Diffusion XL pipeline in PyTorch: txt2img, img2img and
latent-blend inpainting, the counterpart of lora_tpu/pipelines/sdxl.py.

What SDXL adds to pipelines/sd.py:

- two text encoders: CLIP ViT-L (te1) and OpenCLIP ViT-bigG (te2), both read
  at their penultimate hidden state (no final LayerNorm) and concatenated
  along features (768 + 1280 = 2048 = the UNet's cross_attention_dim);
- text_time micro-conditioning: te2's projected pooled EOS embedding and six
  time_ids (original size, crop corner, target size) feed the UNet's
  add_embedding MLP (models/unet.py);
- te2's tokens pad with "!" (id 0), not EOS: every position reaches
  cross-attention, so the pad identity is part of the conditioning.

The samplers, CFG, the denoising loop and LoRA as data are
pipelines/sd.py's. Adapters are kohya-XL or LyCORIS-XL files
(formats/kohya.py, formats/lycoris.py). Inpainting is always latent
blending: there is no 9-channel SDXL base. Every random draw comes from a
torch.Generator or is handed in, as in pipelines/sd.py.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.sites import text_encoder_locon_sites, unet_locon_sites
from ..data.tokenizer import CLIPTokenizer, default_tokenizer
from ..formats.kohya import load_kohya_xl
from ..formats.lycoris import is_lycoris, load_lycoris_xl
from ..formats.safetensors_io import SafetensorsFile
from ..models import schedulers
from ..models.clip import CLIPTextModel, dual_encode
from ..models.config import (
    CLIPTextConfig,
    SDXL_TEXT,
    SDXL_TEXT2,
    SDXL_UNET,
    SDXL_VAE,
)
from ..models.unet import UNet
from ..models.vae import VAE
from .sd import StableDiffusionPipeline, _check_device, _module_from

Cond = Tuple[torch.Tensor, torch.Tensor]  # (context, pooled)


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    """StableDiffusionPipeline plus te2 (`text_encoder_2`, `lora_text2`) and
    the text_time conditioning. text_encoder / lora_text are te1."""

    _MODELS = ("unet", "text_encoder", "text_encoder_2")
    _TEXT_LORAS = (("text_encoder", "lora_text"),
                   ("text_encoder_2", "lora_text2"))

    def __init__(self, unet: UNet, text_encoder: CLIPTextModel,
                 text_encoder_2: CLIPTextModel, vae: VAE,
                 tokenizer: CLIPTokenizer,
                 schedule: Optional[schedulers.NoiseSchedule] = None):
        if unet.cfg.addition_embed_type != "text_time":
            raise ValueError(
                "StableDiffusionXLPipeline needs an SDXL UNet config "
                "(addition_embed_type='text_time')")
        super().__init__(unet, text_encoder, vae, tokenizer, schedule)
        self.text_encoder_2 = text_encoder_2
        self.lora_text2: Optional[dict] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def random_init(cls, generator: torch.Generator, device,
                    dtype=torch.float32, unet_cfg=SDXL_UNET,
                    text_cfg=SDXL_TEXT, text2_cfg=SDXL_TEXT2,
                    vae_cfg=SDXL_VAE,
                    tokenizer: Optional[CLIPTokenizer] = None):
        """Random weights drawn from `generator` on `device`, in the order
        UNet, te1, te2, VAE. The tokenizer defaults to the hashed fallback
        sized to the smaller of the two vocabularies."""
        def make(cls_, cfg):
            return cls_(cfg, device=device, dtype=dtype, generator=generator)

        return cls(make(UNet, unet_cfg), make(CLIPTextModel, text_cfg),
                   make(CLIPTextModel, text2_cfg), make(VAE, vae_cfg),
                   tokenizer or default_tokenizer(vocab_size=min(
                       text_cfg.vocab_size, text2_cfg.vocab_size)))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32, device="cuda",
                        tokenizer: Optional[CLIPTokenizer] = None,
                        require_real_tokenizer: bool = True):
        """A diffusers-layout SDXL directory (unet/ vae/ text_encoder/
        text_encoder_2/ [scheduler/ tokenizer/]) on `device` in `dtype`; as
        StableDiffusionPipeline.from_pretrained, the card by default."""
        from ..models.hf_import import (
            load_pipeline_params,
            load_scheduler_config,
            load_text_encoder,
            load_upcast_attention,
        )

        _check_device(path, device)
        unet_p, text_p, vae_p, cfgs = load_pipeline_params(path, dtype, device)
        text2_p, text2_cfg = load_text_encoder(
            os.path.join(path, "text_encoder_2"), dtype, device)
        unet = _module_from(UNet, cfgs[0], unet_p, dtype)
        unet.upcast_attention = load_upcast_attention(
            os.path.join(path, "unet"))
        return cls(unet,
                   _module_from(CLIPTextModel, cfgs[1], text_p, dtype),
                   _module_from(CLIPTextModel, text2_cfg, text2_p, dtype),
                   _module_from(VAE, cfgs[2], vae_p, dtype),
                   tokenizer or default_tokenizer(
                       path, vocab_size=cfgs[1].vocab_size,
                       require_real=require_real_tokenizer),
                   schedule=load_scheduler_config(path))

    # -- adapters ------------------------------------------------------------
    def patch_pipe(self, path: str, patch_unet: bool = True,
                   patch_text: bool = True,
                   patch_ti: bool = True) -> Dict[str, np.ndarray]:
        """Load an SDXL kohya file (lora_unet_ with LDM names, lora_te1_,
        lora_te2_) or, when it carries a LyCORIS factor, an SDXL LyCORIS
        file dispatched per module, their entries in the pipeline's dtype on
        its device; a LyCORIS file's base deltas are installed on the three
        models. A model the file does not cover keeps its adapter. These
        files carry no TI embeds (`patch_ti` is accepted and unused)."""
        kw = dict(
            unet_cfg=self.unet.cfg,
            unet_sites=(unet_locon_sites(self.unet.cfg)
                        if patch_unet else None),
            text_sites=(text_encoder_locon_sites(self.text_encoder.cfg)
                        if patch_text else None),
            text2_sites=(text_encoder_locon_sites(self.text_encoder_2.cfg)
                         if patch_text else None),
            dtype=self.dtype, device=self.device)
        self._clear_base_deltas()  # a replaced file's norm / full deltas
        with SafetensorsFile(path) as f:
            lycoris = is_lycoris(list(f.keys()))
        if lycoris:
            trees = load_lycoris_xl(
                path, unet_params=self.unet.flat_params(),
                text_params=self.text_encoder.flat_params(),
                text2_params=self.text_encoder_2.flat_params(), **kw)
            trees = [self._install_base_deltas(m, t)
                     for m, t in zip(self._MODELS, trees)]
        else:
            trees = load_kohya_xl(path, **kw)
        for attr, tree in zip(("lora_unet", "lora_text", "lora_text2"),
                              trees):
            if tree is not None:
                setattr(self, attr, tree)
        self.adapter_generation += 1
        return {}

    # -- encoding ------------------------------------------------------------
    @torch.inference_mode()
    def encode_prompt_xl(self, prompt: Union[str, Sequence[str]]) -> Cond:
        """(context (B, 77, d1 + d2), pooled (B, projection_dim)): both
        encoders' penultimate states joined on the last axis (te2's cast to
        te1's dtype), and te2's projected pooled EOS embedding."""
        def ids(**kw):
            return torch.tensor(self.tokenizer(prompt, **kw)["input_ids"],
                                dtype=torch.long, device=self.device)

        return dual_encode(
            self.text_encoder.flat_params(),
            self.text_encoder_2.flat_params(), ids(), ids(pad_token_id=0),
            self.text_encoder.cfg, self.text_encoder_2.cfg, self.lora_text,
            self.lora_text2, self.dtype, int(self.tokenizer.eos_token_id))

    def _time_ids(self, rows: int, height: int, width: int,
                  original_size=None, crops_coords_top_left=(0, 0),
                  target_size=None) -> torch.Tensor:
        """(rows, 6) float32 on the device: original size, crop corner,
        target size, the first and last defaulting to (height, width)."""
        row = (list(original_size or (height, width))
               + list(crops_coords_top_left)
               + list(target_size or (height, width)))
        return torch.tensor(np.tile(np.asarray(row, np.float32), (rows, 1)),
                            device=self.device)

    def _resolve_cond_xl(self, prompt, negative_prompt, use_cfg: bool,
                         prompt_embeds: Optional[Cond] = None,
                         negative_prompt_embeds: Optional[Cond] = None):
        """(text_emb, uncond or None without CFG, add_text, B) from prompt
        strings or precomputed (context, pooled) pairs (the server's embed
        cache; with prompt_embeds the strings are ignored). add_text is the
        pooled rows, uncond stacked before cond under CFG."""
        def dev(pair):
            return [torch.as_tensor(e, device=self.device, dtype=self.dtype)
                    for e in pair]

        if prompt_embeds is not None:
            text_emb, pooled = dev(prompt_embeds)
            if use_cfg and negative_prompt_embeds is None:
                raise ValueError(
                    "negative_prompt_embeds required with prompt_embeds "
                    "when guidance_scale > 1")
            neg = dev(negative_prompt_embeds) if use_cfg else None
        else:
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            if isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * len(prompts)
            text_emb, pooled = self.encode_prompt_xl(prompts)
            neg = (self.encode_prompt_xl(list(negative_prompt))
                   if use_cfg else None)
        if neg is None:
            return text_emb, None, pooled, int(text_emb.shape[0])
        return (text_emb, neg[0], torch.cat([neg[1], pooled]),
                int(text_emb.shape[0]))

    def _added_cond(self, add_text: torch.Tensor, height: int, width: int,
                    **micro) -> Dict[str, torch.Tensor]:
        return {"text_embeds": add_text.to(self.dtype),
                "time_ids": self._time_ids(add_text.shape[0], height, width,
                                           **micro)}

    # -- sampling ------------------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: Union[str, Sequence[str]] = "",
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        height: int = 1024,
        width: int = 1024,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        scheduler: str = "ddim",
        lora_idx: Optional[Sequence[int]] = None,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        prompt_embeds: Optional[Cond] = None,
        negative_prompt_embeds: Optional[Cond] = None,
        return_latents: bool = False,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ):
        """txt2img under any scheduler: float32 images (B, height, width,
        3) in [0, 1], NHWC, as StableDiffusionPipeline.__call__, with the
        micro-conditioning (original_size and target_size default to the
        output size). prompt_embeds / negative_prompt_embeds are (context,
        pooled) pairs."""
        text_emb, uncond, add_text, B = self._resolve_cond_xl(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        added = self._added_cond(
            add_text, height, width, original_size=original_size,
            crops_coords_top_left=crops_coords_top_left,
            target_size=target_size)
        return self._txt2img(
            text_emb, uncond, B, added, num_inference_steps, guidance_scale,
            height, width, generator, latents, scheduler, lora_idx,
            return_latents, step_noise)

    @torch.inference_mode()
    def img2img(
        self,
        prompt: Union[str, Sequence[str]],
        init_image,                       # (B, H, W, 3) in [-1, 1]
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Union[str, Sequence[str]] = "",
        generator: Optional[torch.Generator] = None,
        lora_idx: Optional[Sequence[int]] = None,
        prompt_embeds: Optional[Cond] = None,
        negative_prompt_embeds: Optional[Cond] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """img2img with DDIM, as StableDiffusionPipeline.img2img; the
        time_ids take the image's size."""
        text_emb, uncond, add_text, B = self._resolve_cond_xl(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        image = self._image_input(init_image)
        added = self._added_cond(add_text, *image.shape[1:3])
        return self._img2img(
            text_emb, uncond, B, added, image, strength, num_inference_steps,
            guidance_scale, generator, lora_idx, posterior_noise, init_noise)

    @torch.inference_mode()
    def inpaint(
        self,
        prompt: Union[str, Sequence[str]],
        image,                            # (B, H, W, 3) in [-1, 1]
        mask,                             # (B, H, W, 1) in {0, 1}; 1 = repaint
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        negative_prompt: Union[str, Sequence[str]] = "",
        generator: Optional[torch.Generator] = None,
        scheduler: str = "ddim",
        lora_idx: Optional[Sequence[int]] = None,
        prompt_embeds: Optional[Cond] = None,
        negative_prompt_embeds: Optional[Cond] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        return_latents: bool = False,
    ):
        """Latent-blend inpainting with the 4-channel SDXL UNet (the only
        SDXL inpainting path), as StableDiffusionPipeline.inpaint_blend:
        any scheduler but pndm, strength as in img2img, the kept region's
        final latents equal to the original's; the time_ids take the
        image's size."""
        text_emb, uncond, add_text, B = self._resolve_cond_xl(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        image = self._image_input(image)
        added = self._added_cond(add_text, *image.shape[1:3])
        return self._inpaint_blend(
            text_emb, uncond, B, added, image, mask, strength,
            num_inference_steps, guidance_scale, generator, scheduler,
            lora_idx, posterior_noise, init_noise, step_noise,
            return_latents)

    inpaint_blend = inpaint
