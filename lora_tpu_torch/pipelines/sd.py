"""Stable Diffusion txt2img pipeline in PyTorch: the serving path.

The counterpart of lora_tpu/pipelines/sd.py for txt2img with the DDIM
sampler. The pipeline owns the UNet, the CLIP text encoder and the VAE as
nn.Modules and the loaded LoRAs as data (core/lora.py): patch_pipe loads a
LoRA (+ TI embeds) file in the indexed "{model}:{idx}:up|down" schema, and
every UNet / text-encoder call gets the LoRA tree passed in. The denoising
loop is a Python loop under torch.inference_mode(); latents and images are
NHWC, as in the JAX package. `from_pretrained` loads a diffusers-layout
directory (models/hf_import.py); `quantize_base` turns the base weights
int8 (core/quantize.py); `prompt_embeds` pass precomputed conditioning
through, as the serving embed cache does (serve.py).

Still to port (ROADMAP Queue A): the other samplers (PNDM, Euler,
DPM-Solver++), img2img and inpainting, kohya-ss / LyCORIS files in
patch_pipe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import lora as lora_core
from ..core.quantize import quantize_params_int8
from ..core.sites import text_encoder_lora_sites, unet_lora_sites
from ..data.tokenizer import CLIPTokenizer, default_tokenizer
from ..formats.safetensors_io import (
    SafetensorsFile,
    parse_safeloras,
    parse_safeloras_embeds,
)
from ..models import schedulers
from ..models.clip import CLIPTextModel, apply_ti
from ..models.config import SD15_TEXT, SD15_UNET, SD15_VAE
from ..models.unet import UNet, unet_forward
from ..models.vae import VAE

_TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


def _float_param(module: torch.nn.Module) -> torch.Tensor:
    """The module's first floating-point parameter (biases and norms stay
    float under quantize_base)."""
    return next(t for t in module.parameters() if t.is_floating_point())


class StableDiffusionPipeline:
    def __init__(self, unet: UNet, text_encoder: CLIPTextModel, vae: VAE,
                 tokenizer: CLIPTokenizer,
                 schedule: Optional[schedulers.NoiseSchedule] = None):
        self.unet = unet
        self.text_encoder = text_encoder
        self.vae = vae
        self.tokenizer = tokenizer
        self.schedule = schedule or schedulers.make_schedule()
        # the compute dtype and device, stored here rather than read from a
        # weight later: quantize_base() turns the weights int8
        ref = _float_param(unet)
        self.dtype: torch.dtype = ref.dtype
        self.device: torch.device = ref.device
        self.lora_unet: Optional[dict] = None
        self.lora_text: Optional[dict] = None
        # bumped whenever the loaded adapters change by means other than
        # tune_lora_scale (patch_pipe / apply_ti / remove_lora), so caches of
        # adapter-dependent results (the serving embed LRU) see the change
        self.adapter_generation = 0

    @classmethod
    def random_init(cls, generator: torch.Generator, device,
                    dtype=torch.float32, unet_cfg=SD15_UNET,
                    text_cfg=SD15_TEXT, vae_cfg=SD15_VAE,
                    tokenizer: Optional[CLIPTokenizer] = None):
        """Random weights drawn from `generator` on `device` (the serving
        bench's configuration needs no download). The tokenizer defaults to
        the hashed fallback sized to the text encoder's vocabulary."""
        return cls(
            UNet(unet_cfg, device=device, dtype=dtype, generator=generator),
            CLIPTextModel(text_cfg, device=device, dtype=dtype,
                          generator=generator),
            VAE(vae_cfg, device=device, dtype=dtype, generator=generator),
            tokenizer or default_tokenizer(vocab_size=text_cfg.vocab_size))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32, device="cuda",
                        tokenizer: Optional[CLIPTokenizer] = None,
                        require_real_tokenizer: bool = True):
        """A diffusers-layout directory (unet/ vae/ text_encoder/
        [scheduler/ tokenizer/]) on `device` in `dtype`. The device defaults
        to the card, as the JAX package lands on its accelerator; without
        CUDA this raises, and device="cpu" loads on the CPU.
        require_real_tokenizer: with pretrained weights a missing CLIP vocab
        raises rather than silently degrading to hashed ids
        (data/tokenizer.py)."""
        from ..models.hf_import import load_pipeline_params, load_scheduler_config

        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                f"from_pretrained({path!r}) loads onto device={device!r} "
                f"(the default) and no CUDA device is available; pass "
                f"device='cpu' to load on the CPU")

        unet_p, text_p, vae_p, cfgs = load_pipeline_params(path, dtype, device)
        modules = []
        for cls_, cfg, params in ((UNet, cfgs[0], unet_p),
                                  (CLIPTextModel, cfgs[1], text_p),
                                  (VAE, cfgs[2], vae_p)):
            m = cls_(cfg, device="meta", dtype=dtype)
            m.load_state_dict(params, strict=True, assign=True)
            modules.append(m)
        return cls(*modules,
                   tokenizer or default_tokenizer(
                       path, vocab_size=cfgs[1].vocab_size,
                       require_real=require_real_tokenizer),
                   schedule=load_scheduler_config(path))

    # -- LoRA / TI management (patch_pipe) ----------------------------------
    def unet_sites(self, target=None):
        return unet_lora_sites(self.unet.cfg, target)

    def text_sites(self, target=None):
        return text_encoder_lora_sites(self.text_encoder.cfg, target)

    def patch_pipe(self, path: str, patch_unet: bool = True,
                   patch_text: bool = True,
                   patch_ti: bool = True) -> Dict[str, np.ndarray]:
        """Load a LoRA (+ TI embeds) file in the indexed schema; returns the
        embeds. The reference's patch_pipe (lora.py:958-1022)."""
        with SafetensorsFile(path) as f:
            if any(k.startswith(("lora_unet_", "lora_te_")) for k in f.keys()):
                raise NotImplementedError(
                    f"{path} is a kohya-ss / LyCORIS file: not ported yet "
                    "(ROADMAP Queue A: kohya/LyCORIS in patch_pipe)")
            loras = parse_safeloras(f)
            embeds = parse_safeloras_embeds(f)
        for model, sites_of, attr, wanted in (
                ("unet", self.unet_sites, "lora_unet", patch_unet),
                ("text_encoder", self.text_sites, "lora_text", patch_text)):
            if wanted and model in loras:
                weights, _, target = loras[model]
                setattr(self, attr, lora_core.lora_from_flat(
                    weights, sites_of(set(target)), dtype=self.dtype,
                    device=self.device))
        if patch_ti and embeds:
            self.apply_ti(embeds)
        self.adapter_generation += 1
        return embeds

    def apply_ti(self, embeds: Dict[str, np.ndarray]) -> List[str]:
        """Add TI tokens to the tokenizer (a token already there keeps its
        id) and write their rows into the token table, grown as needed (the
        reference's apply_learned_embed_in_clip, lora.py:899-942)."""
        applied = []
        for token, vec in embeds.items():
            self.tokenizer.add_tokens(token)
            tok_id = self.tokenizer.convert_tokens_to_ids(token)
            table = self.text_encoder.get_parameter(_TOKEN_TABLE).detach()
            if tok_id >= table.shape[0]:
                table = torch.cat([table, table.new_zeros(
                    (tok_id + 1 - table.shape[0], table.shape[1]))])
            table = apply_ti(
                {_TOKEN_TABLE: table},
                torch.as_tensor(np.array(vec), device=table.device)[None],
                torch.tensor([tok_id], device=table.device))
            self.text_encoder.set_param(_TOKEN_TABLE, table)
            applied.append(token)
        self.adapter_generation += 1
        return applied

    def tune_lora_scale(self, alpha: float,
                        text_alpha: Optional[float] = None) -> None:
        if self.lora_unet is not None:
            self.lora_unet = lora_core.tune_lora_scale(self.lora_unet, alpha)
        if self.lora_text is not None:
            self.lora_text = lora_core.tune_lora_scale(
                self.lora_text, alpha if text_alpha is None else text_alpha)

    def remove_lora(self) -> None:
        """The reference's monkeypatch_remove_lora (lora.py:812-847)."""
        self.lora_unet = None
        self.lora_text = None
        self.adapter_generation += 1

    def has_base_deltas(self, model: str) -> bool:
        """Whether alpha-dependent base-param deltas (LyCORIS norm/full
        modules) are installed on `model`. None are until kohya/LyCORIS
        files load (ROADMAP Queue A); serving caches ask."""
        return False

    def quantize_base(self) -> None:
        """Serving memory lever: int8 per-channel base weights for the UNet,
        the text encoder and the VAE, in place (~2x less device memory for
        the weights); LoRA/TI stay full precision (core/quantize.py)."""
        for module in (self.unet, self.text_encoder, self.vae):
            for name, t in quantize_params_int8(module.flat_params()).items():
                module.set_param(name, t)

    # -- encoding -----------------------------------------------------------
    @torch.inference_mode()
    def encode_prompt(self, prompt: Union[str, Sequence[str]]) -> torch.Tensor:
        ids = torch.tensor(self.tokenizer(prompt)["input_ids"],
                           dtype=torch.long, device=self.device)
        return self.text_encoder(ids, lora=self.lora_text, dtype=self.dtype)

    def prepare_latents(self, batch: int, height: int, width: int,
                        generator: torch.Generator) -> torch.Tensor:
        self._check_size(height, width)
        shape = (batch, height // 8, width // 8, self.unet.cfg.out_channels)
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=self.dtype)

    def _check_size(self, height: int, width: int) -> None:
        """Sizes that do not survive the UNet's stride-2 round trip would
        fail deep inside it; reject them up front."""
        stride = 8 * 2 ** (len(self.unet.cfg.block_out_channels) - 1)
        if height % stride or width % stride:
            raise ValueError(
                f"height/width must be multiples of {stride} for this UNet "
                f"({len(self.unet.cfg.block_out_channels)} levels); got "
                f"{height}x{width}")

    # -- sampling -----------------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: Union[str, Sequence[str]] = "",
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        height: int = 512,
        width: int = 512,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        scheduler: str = "ddim",
        lora_idx: Optional[Sequence[int]] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        return_latents: bool = False,
    ):
        """txt2img: float32 images (B, height, width, 3) in [0, 1], NHWC
        (and the final latents with return_latents=True). Latents are drawn
        from `generator` unless given. lora_idx routes each prompt through
        its own adapter of a stacked LoRA. prompt_embeds (and, with CFG,
        negative_prompt_embeds) replace the prompt strings."""
        if scheduler != "ddim":
            raise NotImplementedError(
                f"scheduler={scheduler!r}: only 'ddim' is ported (ROADMAP "
                "Queue A: the other samplers)")
        use_cfg = guidance_scale > 1.0
        text_emb, uncond, B = self._resolve_cond(
            prompt, negative_prompt, use_cfg, prompt_embeds,
            negative_prompt_embeds)
        if latents is None:
            if generator is None:
                raise ValueError("pass generator= (or latents=)")
            latents = self.prepare_latents(B, height, width, generator)
        else:
            latents = torch.as_tensor(latents, device=self.device)
        latents = self._denoise_ddim(latents, text_emb, uncond,
                                     guidance_scale, num_inference_steps,
                                     lora_idx)
        images = self._decode(latents)
        if return_latents:
            return images, latents
        return images

    def _resolve_cond(self, prompt, negative_prompt, use_cfg: bool,
                      prompt_embeds=None, negative_prompt_embeds=None):
        """(text_emb, uncond or None without CFG, B) from prompt strings or
        precomputed embeddings (the serving embed cache's passthrough; with
        prompt_embeds the prompt strings are ignored)."""
        if prompt_embeds is not None:
            text_emb = torch.as_tensor(prompt_embeds, device=self.device,
                                       dtype=self.dtype)
            if use_cfg and negative_prompt_embeds is None:
                raise ValueError(
                    "negative_prompt_embeds required with prompt_embeds "
                    "when guidance_scale > 1")
            uncond = (torch.as_tensor(negative_prompt_embeds,
                                      device=self.device, dtype=self.dtype)
                      if use_cfg else None)
            return text_emb, uncond, int(text_emb.shape[0])
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts)
        if isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * B
        text_emb = self.encode_prompt(prompts)
        uncond = self.encode_prompt(list(negative_prompt)) if use_cfg else None
        return text_emb, uncond, B

    def _denoise_ddim(self, latents, text_emb, uncond, guidance_scale: float,
                      num_inference_steps: int, lora_idx=None):
        """The DDIM loop; CFG batches uncond before cond, as the JAX
        package does."""
        dev = latents.device
        sched = self.schedule.to(dev)
        ts = schedulers.ddim_timesteps(sched, num_inference_steps)
        step_delta = sched.num_train_timesteps // num_inference_steps
        use_cfg = uncond is not None
        ctx = torch.cat([uncond, text_emb]) if use_cfg else text_emb
        lora = self.lora_unet
        if lora_idx is not None and lora is not None:
            idx = torch.as_tensor(lora_idx, dtype=torch.long, device=dev)
            lora = {**lora, "idx": torch.cat([idx, idx]) if use_cfg else idx}
        params = self.unet.flat_params()
        B = latents.shape[0]
        n_in = 2 * B if use_cfg else B
        for t in ts.tolist():
            model_in = torch.cat([latents, latents]) if use_cfg else latents
            out = unet_forward(params, model_in,
                               torch.full((n_in,), t, device=dev), ctx,
                               self.unet.cfg, lora=lora)
            if use_cfg:
                u, c = out[:B], out[B:]
                out = u + guidance_scale * (c - u)
            latents = schedulers.ddim_step(
                sched, out, torch.full((B,), t, device=dev), latents,
                torch.full((B,), t - step_delta, device=dev))
        return latents

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """VAE-decode latents to [0, 1] float32 images on the host."""
        images = self.vae.decode(latents)
        return (images.float() / 2 + 0.5).clamp(0.0, 1.0).cpu().numpy()

    def img2img(self, *args, **kwargs):
        raise NotImplementedError(
            "img2img is not ported yet (ROADMAP Queue A: img2img and "
            "inpaint)")

    def inpaint(self, *args, **kwargs):
        raise NotImplementedError(
            "inpaint is not ported yet (ROADMAP Queue A: img2img and "
            "inpaint)")
