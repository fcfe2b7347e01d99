"""Stable Diffusion pipeline in PyTorch: txt2img, img2img, 9-channel
inpainting and latent-blend inpainting, the serving path.

The counterpart of lora_tpu/pipelines/sd.py. The pipeline owns the UNet, the
CLIP text encoder and the VAE as nn.Modules and the loaded LoRAs as data
(core/lora.py): patch_pipe loads a LoRA (+ TI embeds) file in the indexed
"{model}:{idx}:up|down" schema, or a kohya-ss / LoCon file
(formats/kohya.py) or a LyCORIS file (formats/lycoris.py) in the
lora_unet_* / lora_te_* schema, and every UNet / text-encoder call gets the
LoRA tree passed in. LyCORIS norm modules and bias diffs are base-param
deltas: the pipeline writes W + alpha * delta into its modules' params,
keeps the originals to restore them, and re-applies at every
tune_lora_scale; collapse_lora folds the LoRAs and these deltas into the
base weights. The denoising loop (_denoise: ddim | pndm | euler |
euler_a | dpm++, with Karras sigmas for the Euler pair) is a Python loop
under torch.inference_mode(); latents and images are NHWC, as in the JAX
package. Every random draw comes from a torch.Generator, or is handed in
(the latents, the VAE posterior noise, the init noise, Euler-ancestral's
per-step noise), so tests can reproduce the JAX package's draws.
`from_pretrained` loads a diffusers-layout directory (models/hf_import.py);
`quantize_base` turns the base weights int8 (core/quantize.py);
`prompt_embeds` pass precomputed conditioning through, as the serving embed
cache does (serve.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import lora as lora_core
from ..core.quantize import quantize_params_int8
from ..core.sites import (
    text_encoder_locon_sites,
    text_encoder_lora_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from ..data.tokenizer import CLIPTokenizer, default_tokenizer
from ..formats.kohya import load_kohya
from ..formats.lycoris import is_lycoris, load_lycoris
from ..formats.safetensors_io import (
    SafetensorsFile,
    parse_safeloras,
    parse_safeloras_embeds,
)
from ..models import schedulers
from ..models.clip import CLIPTextModel, apply_ti
from ..models.config import SD15_TEXT, SD15_UNET, SD15_VAE
from ..models.unet import UNet, unet_forward
from ..models.vae import VAE, vae_encode

_TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


# every scheduler name the pipeline takes, and the loop each runs: the
# Karras variants are the Euler loops on Karras sigmas
SCHEDULERS = {"ddim": "ddim", "pndm": "pndm", "euler": "euler",
              "euler_a": "euler_a", "dpm++": "dpm++",
              "euler_karras": "euler", "euler_a_karras": "euler_a"}
# the loops that step in sigma space (their latents start at sigmas[0])
_SIGMA_LOOPS = ("euler", "euler_a")


def _latent_mask(mask: torch.Tensor, h: int, w: int,
                 dtype) -> torch.Tensor:
    """Nearest-sample a pixel-space (B, H, W, 1) mask down to the (B, h, w,
    1) latent grid: rows and columns arange(n) * (N / n) in float32,
    truncated, as lora_tpu's _latent_mask picks them."""
    ys = (np.arange(h, dtype=np.float32)
          * np.float32(mask.shape[1] / h)).astype(np.int64)
    xs = (np.arange(w, dtype=np.float32)
          * np.float32(mask.shape[2] / w)).astype(np.int64)
    ys, xs = (torch.from_numpy(i).to(mask.device) for i in (ys, xs))
    return mask[:, ys][:, :, xs].to(dtype)


def _strength_start(num_inference_steps: int, strength: float) -> int:
    """The first of the schedule's steps that an img2img-style run takes
    (Python float arithmetic, as lora_tpu computes it)."""
    return max(num_inference_steps - int(num_inference_steps * strength), 0)


def _float_param(module: torch.nn.Module) -> torch.Tensor:
    """The module's first floating-point parameter (biases and norms stay
    float under quantize_base)."""
    return next(t for t in module.parameters() if t.is_floating_point())


def _module_from(cls_, cfg, params, dtype) -> torch.nn.Module:
    """A model module holding loaded `params` (built on the meta device,
    then the tensors assigned: no second copy of the weights). A token table
    longer than the config's vocabulary (the TI rows that `lora_add --mode
    upl` folds into the directory) is taken at its length."""
    m = cls_(cfg, device="meta", dtype=dtype)
    table = params.get(_TOKEN_TABLE)
    if table is not None:
        rows, width = m.get_parameter(_TOKEN_TABLE).shape
        if table.shape[0] > rows and table.shape[1] == width:
            m.set_param(_TOKEN_TABLE, torch.empty_like(table, device="meta"))
    m.load_state_dict(params, strict=True, assign=True)
    return m


def _check_device(path: str, device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"from_pretrained({path!r}) loads onto device={device!r} (the "
            f"default) and no CUDA device is available; pass device='cpu' "
            f"to load on the CPU")


class StableDiffusionPipeline:
    # the models whose params LyCORIS base deltas may change, and each text
    # model's LoRA attribute (the server's embed key reads them)
    _MODELS = ("unet", "text_encoder")
    _TEXT_LORAS = (("text_encoder", "lora_text"),)

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
        # a LyCORIS file's base-param deltas per model ("unet",
        # "text_encoder"): {"deltas": {name: f32}, "orig": {name: clone},
        # "alpha": the scale they were last applied at}
        self.base_deltas: Optional[Dict[str, dict]] = None

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
        from ..models.hf_import import (
            load_pipeline_params,
            load_scheduler_config,
            load_upcast_attention,
        )

        _check_device(path, device)
        unet_p, text_p, vae_p, cfgs = load_pipeline_params(path, dtype, device)
        modules = [_module_from(cls_, cfg, params, dtype)
                   for cls_, cfg, params in ((UNet, cfgs[0], unet_p),
                                             (CLIPTextModel, cfgs[1], text_p),
                                             (VAE, cfgs[2], vae_p))]
        modules[0].upcast_attention = load_upcast_attention(
            os.path.join(path, "unet"))
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
        """Load a LoRA (+ TI embeds) file; returns the embeds. The
        reference's patch_pipe (lora.py:958-1022). Files in the kohya-ss /
        webui key schema (lora_unet_* / lora_te_*) load through
        formats/kohya.py, or formats/lycoris.py when they carry a LyCORIS
        factor, against the LoCon site supersets; they carry no embeds.
        A new file first restores the base params an earlier LyCORIS file
        changed, whatever its format: base deltas never stack."""
        self._clear_base_deltas()
        with SafetensorsFile(path) as f:
            keys = list(f.keys())
            kohya = any(k.startswith(("lora_unet_", "lora_te_"))
                        for k in keys)
            if not kohya:
                loras = parse_safeloras(f)
                embeds = parse_safeloras_embeds(f)
        if kohya:
            self._patch_kohya(path, keys, patch_unet, patch_text)
            self.adapter_generation += 1
            return {}
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

    def _patch_kohya(self, path: str, keys: List[str], patch_unet: bool,
                     patch_text: bool) -> None:
        """A kohya / LoCon or LyCORIS file's trees, their entries in the
        pipeline's dtype on its device (LyCORIS modules composed there from
        the current base weights); the LyCORIS param deltas installed."""
        kw = dict(
            unet_sites=(unet_locon_sites(self.unet.cfg)
                        if patch_unet else None),
            text_sites=(text_encoder_locon_sites(self.text_encoder.cfg)
                        if patch_text else None),
            dtype=self.dtype, device=self.device)
        if is_lycoris(keys):
            lu, lt = load_lycoris(
                path, unet_params=self.unet.flat_params(),
                text_params=self.text_encoder.flat_params(), **kw)
            lu = self._install_base_deltas("unet", lu)
            lt = self._install_base_deltas("text_encoder", lt)
        else:
            lu, lt = load_kohya(path, **kw)
        if lu is not None:
            self.lora_unet = lu
        if lt is not None:
            self.lora_text = lt

    def _module(self, model: str) -> torch.nn.Module:
        if model not in self._MODELS:
            raise KeyError(f"no model {model!r} in this pipeline")
        return getattr(self, model)

    def _install_base_deltas(self, model: str, tree: Optional[dict]):
        """Pop a LyCORIS tree's `param_deltas`, record clones of the params
        they change, and apply them at scale 1. Returns the tree without
        them (None if it held nothing else)."""
        if tree is None or "param_deltas" not in tree:
            return tree
        tree = dict(tree)
        deltas = tree.pop("param_deltas")
        params = self._module(model).flat_params()
        if self.base_deltas is None:
            self.base_deltas = {}
        self.base_deltas[model] = {
            "deltas": deltas,
            "orig": {k: params[k].detach().clone() for k in deltas},
            "alpha": None}
        self._apply_base_deltas(model, 1.0)
        return tree if tree["sites"] else None

    def _apply_base_deltas(self, model: str, alpha: float) -> None:
        """W = orig + alpha * delta in f32, cast to the param's dtype."""
        rec = (self.base_deltas or {}).get(model)
        if rec is None:
            return
        module = self._module(model)
        for k, d in rec["deltas"].items():
            o = rec["orig"][k]
            module.set_param(k, (o.float() + alpha * d.float()).to(o.dtype))
        rec["alpha"] = float(alpha)

    def _clear_base_deltas(self, restore: bool = True) -> None:
        """Drop the base-delta records, first writing the original params
        back (bit for bit) unless `restore` is False."""
        for model, rec in (self.base_deltas or {}).items():
            if restore:
                module = self._module(model)
                for k, o in rec["orig"].items():
                    module.set_param(k, o)
        self.base_deltas = None

    def has_base_deltas(self, model: str) -> bool:
        """Whether alpha-dependent base-param deltas (LyCORIS norm/full
        modules) are installed on `model`: serving caches of that model's
        outputs must key on the alpha, as for a LoRA."""
        return bool((self.base_deltas or {}).get(model))

    def base_delta_alpha(self, model: str) -> Optional[float]:
        """The scale `model`'s base deltas were last applied at (None
        without base deltas)."""
        rec = (self.base_deltas or {}).get(model)
        return None if rec is None else rec["alpha"]

    def apply_ti(self, embeds: Dict[str, np.ndarray],
                 idempotent: bool = True) -> List[str]:
        """Add TI tokens to the tokenizer and write their rows into the
        token table, grown as needed (the reference's
        apply_learned_embed_in_clip, lora.py:899-942). Returns the tokens
        written. A token already in the tokenizer keeps its id; with
        idempotent=False it is renamed instead, its last character
        replaced by "-1>", "-2>", ... on the name so far until the
        tokenizer takes it, as lora_tpu renames it."""
        applied = []
        for token, vec in embeds.items():
            n_added = self.tokenizer.add_tokens(token)
            i = 1
            while n_added == 0 and not idempotent:
                token = f"{token[:-1]}-{i}>"
                n_added = self.tokenizer.add_tokens(token)
                i += 1
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
        """The LoRAs' scale, and the base deltas re-applied at it (the text
        encoders' at `text_alpha` when given)."""
        text_alpha = alpha if text_alpha is None else text_alpha
        if self.lora_unet is not None:
            self.lora_unet = lora_core.tune_lora_scale(self.lora_unet, alpha)
        self._apply_base_deltas("unet", alpha)
        for model, attr in self._TEXT_LORAS:
            if getattr(self, attr) is not None:
                setattr(self, attr, lora_core.tune_lora_scale(
                    getattr(self, attr), text_alpha))
            self._apply_base_deltas(model, text_alpha)

    def remove_lora(self) -> None:
        """The reference's monkeypatch_remove_lora (lora.py:812-847); base
        deltas are restored."""
        self.lora_unet = None
        for _, attr in self._TEXT_LORAS:
            setattr(self, attr, None)
        self._clear_base_deltas()
        self.adapter_generation += 1

    def collapse_lora(self, alpha: float = 1.0) -> None:
        """Fold the LoRAs into the base weights at `alpha` (lora.py:
        635-669; core/lora.collapse_lora: f32, cast back), and the base
        deltas at the same alpha, whose restore record is dropped. Delta
        entries fold as stored (in the pipeline's dtype). An int8 base
        raises: collapse before quantize_base."""
        loras = {"unet": self.lora_unet,
                 **{m: getattr(self, a) for m, a in self._TEXT_LORAS}}
        for model, lora in loras.items():
            if lora is None:
                continue
            module = self._module(model)
            params = module.flat_params()
            for k, v in lora_core.collapse_lora(params, lora, alpha).items():
                if v is not params[k]:
                    module.set_param(k, v)
        for model in self.base_deltas or {}:
            self._apply_base_deltas(model, alpha)
        self._clear_base_deltas(restore=False)
        self.remove_lora()

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
    def _scheduler_arrays(self, scheduler: str, num_inference_steps: int):
        """(timesteps (S,) int64, sigmas (S + 1,) float32 or None) of a
        scheduler, numpy on the host; PNDM's timesteps are S + 1 (its
        warm-up duplicate)."""
        sched = self.schedule
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; expected one "
                             f"of {', '.join(SCHEDULERS)}")
        if scheduler in ("euler_karras", "euler_a_karras"):
            sigmas, ts = schedulers.karras_sigmas(sched, num_inference_steps)
            return ts, sigmas
        if scheduler in _SIGMA_LOOPS:
            return (schedulers.euler_timesteps(sched, num_inference_steps),
                    schedulers.euler_sigmas(sched, num_inference_steps))
        tables = {"ddim": schedulers.ddim_timesteps,
                  "pndm": schedulers.pndm_timesteps,
                  "dpm++": schedulers.dpmpp_timesteps}
        return tables[scheduler](sched, num_inference_steps), None

    def _sigma_tensor(self, sigma) -> torch.Tensor:
        """A float32 table value as a 0-d float32 tensor on the device."""
        return torch.tensor(float(sigma), dtype=torch.float32,
                            device=self.device)

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
        step_noise: Optional[Sequence[torch.Tensor]] = None,
    ):
        """txt2img: float32 images (B, height, width, 3) in [0, 1], NHWC
        (and the final latents with return_latents=True). Latents are drawn
        from `generator` unless given; the Euler samplers scale them by
        sigmas[0] (in the latents' dtype, as lora_tpu does). euler_a draws
        one normal per step from `generator`, or takes them from
        `step_noise`. lora_idx routes each prompt through its own adapter
        of a stacked LoRA. prompt_embeds (and, with CFG,
        negative_prompt_embeds) replace the prompt strings."""
        text_emb, uncond, B = self._resolve_cond(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        return self._txt2img(
            text_emb, uncond, B, None, num_inference_steps, guidance_scale,
            height, width, generator, latents, scheduler, lora_idx,
            return_latents, step_noise)

    def _txt2img(self, text_emb, uncond, B: int, added_cond,
                 num_inference_steps: int, guidance_scale: float,
                 height: int, width: int, generator, latents, scheduler: str,
                 lora_idx, return_latents: bool, step_noise):
        """txt2img from resolved conditioning (and, for SDXL, the
        text_time rows in `added_cond`)."""
        ts, sigmas = self._scheduler_arrays(scheduler, num_inference_steps)
        if latents is None:
            if generator is None:
                raise ValueError("pass generator= (or latents=)")
            latents = self.prepare_latents(B, height, width, generator)
        else:
            latents = torch.as_tensor(latents, device=self.device)
        method = SCHEDULERS[scheduler]
        if method in _SIGMA_LOOPS:
            # unit-variance latents; the Euler loops start at sigma_max
            latents = latents * self._sigma_tensor(sigmas[0]).to(
                latents.dtype)
        latents = self._denoise(
            latents, text_emb, uncond, guidance_scale, num_inference_steps,
            ts, method, sigmas, lora_idx=lora_idx, generator=generator,
            step_noise=step_noise, added_cond=added_cond)
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

    def _denoise(self, latents, text_emb, uncond, guidance_scale: float,
                 num_inference_steps: int, ts: np.ndarray,
                 method: str = "ddim", sigmas: Optional[np.ndarray] = None,
                 lora_idx=None, extra_channels=None, blend=None,
                 generator: Optional[torch.Generator] = None,
                 step_noise: Optional[Sequence[torch.Tensor]] = None,
                 added_cond: Optional[Dict[str, torch.Tensor]] = None):
        """The denoising loop, lora_tpu's _denoise_loop: `method` is ddim |
        pndm | euler | euler_a | dpm++ over the timesteps `ts` (and, for the
        Euler pair, `sigmas`, one longer). CFG batches uncond before cond.
        extra_channels: the 9-channel UNet's [mask | masked-image latents],
        joined to each step's input on the last axis. blend = (mask, z0,
        noise), latent-blend inpainting: after every step the kept region
        (mask == 0) is overwritten with z0 renoised to the stepped-to level
        by the one fixed noise draw, and the last step blends z0 itself, so
        the kept region's final latents equal z0. euler_a's per-step noise
        comes from `step_noise` when given, else from `generator`.
        added_cond: SDXL's text_time rows ({"text_embeds", "time_ids"} on
        the device), stacked uncond before cond under CFG as ctx is. A
        v-prediction (or sample-prediction) schedule's output is turned
        into eps after CFG for every method but DDIM, whose step converts
        it: at the step's timestep (pndm, dpm++) or at its sigma on the
        unscaled latents (the Euler pair). lora_tpu's loop hands that
        output to these steps as eps. The tables are uploaded once; no
        step reads a value back to the host."""
        if method not in SCHEDULERS.values():
            raise ValueError(f"unknown scheduler method {method!r}")
        if method == "pndm" and blend is not None:
            raise ValueError(
                "latent-blend inpainting is not supported with the pndm "
                "scheduler (warmup duplicate step); use ddim/euler/dpm++")
        if method == "euler_a" and step_noise is None and generator is None:
            raise ValueError("euler_a draws noise every step: pass "
                             "generator= (or step_noise=)")
        dev = latents.device
        sched = self.schedule.to(dev)
        step_delta = sched.num_train_timesteps // num_inference_steps
        to_eps = sched.prediction_type != "epsilon"
        use_cfg = uncond is not None
        ctx = torch.cat([uncond, text_emb]) if use_cfg else text_emb
        lora = self.lora_unet
        if lora_idx is not None and lora is not None:
            idx = torch.as_tensor(lora_idx, dtype=torch.long, device=dev)
            lora = {**lora, "idx": torch.cat([idx, idx]) if use_cfg else idx}
        params = self.unet.flat_params()
        B = latents.shape[0]
        n_in = 2 * B if use_cfg else B
        ts_dev = torch.as_tensor(np.asarray(ts, np.int64), device=dev)
        sig = (None if sigmas is None else
               torch.as_tensor(np.asarray(sigmas, np.float32), device=dev))

        def eps_at(lat, t, scale_in=None):
            inp = lat if scale_in is None else scale_in
            if extra_channels is not None:
                inp = torch.cat([inp, extra_channels], dim=-1)
            model_in = torch.cat([inp, inp]) if use_cfg else inp
            out = unet_forward(params, model_in, t.expand(n_in), ctx,
                               self.unet.cfg, lora=lora,
                               added_cond=added_cond)
            if use_cfg:
                u, c = out[:B], out[B:]
                out = u + guidance_scale * (c - u)
            return out

        if blend is not None:
            mask, z0, noise0 = blend
            shape = (-1,) + (1,) * (z0.ndim - 1)

        def blend_t(lat, t_next):
            """The kept region at timestep t_next ((B,); < 0: z0 itself)."""
            if blend is None:
                return lat
            known = schedulers.add_noise(sched, z0, noise0,
                                         t_next.clamp(min=0))
            known = torch.where((t_next < 0).reshape(shape), z0, known)
            return (mask * lat + (1.0 - mask) * known).to(lat.dtype)

        def blend_sigma(lat, sigma_next):
            """The same in sigma space: z0 + sigma_next * noise (0 on the
            last step: z0 itself)."""
            if blend is None:
                return lat
            known = z0 + sigma_next * noise0
            return (mask * lat + (1.0 - mask) * known).to(lat.dtype)

        if method == "pndm":
            state = schedulers.pndm_init_state(latents.shape, device=dev)
        elif method == "dpm++":
            state = schedulers.dpmpp_init_state(latents.shape, device=dev)
            ts_next = torch.cat([ts_dev[1:], ts_dev.new_full((1,), -1)])
        for i in range(len(ts)):
            t = ts_dev[i]
            if method == "ddim":
                out = eps_at(latents, t)
                prev = (t - step_delta).expand(B)
                latents = schedulers.ddim_step(sched, out, t.expand(B),
                                               latents, prev)
                latents = blend_t(latents, prev)
            elif method == "pndm":
                out = eps_at(latents, t)
                if to_eps:  # each output as eps before PLMS combines them
                    out = schedulers.pred_to_x0_eps(
                        sched, out.float(), latents.float(), t)[1]
                latents, state = schedulers.pndm_step(
                    sched, state, out, t, latents, step_delta)
            elif method == "dpm++":
                out = eps_at(latents, t)
                if to_eps:
                    out = schedulers.pred_to_x0_eps(
                        sched, out.float(), latents.float(), t)[1]
                latents, state = schedulers.dpmpp_step(
                    sched, state, out, t, latents, ts_next[i])
                latents = blend_t(latents, ts_next[i].expand(B))
            else:  # euler | euler_a
                sigma, sigma_next = sig[i], sig[i + 1]
                scaled = schedulers.euler_scale_model_input(latents, sigma)
                out = eps_at(latents, t, scale_in=scaled)
                if to_eps:
                    out = schedulers.sigma_pred_to_eps(sched, out, latents,
                                                       sigma)
                if method == "euler":
                    latents = schedulers.euler_step(latents, out, sigma,
                                                    sigma_next)
                else:
                    noise = (torch.as_tensor(step_noise[i], device=dev)
                             if step_noise is not None else
                             torch.randn(latents.shape, generator=generator,
                                         device=dev, dtype=torch.float32))
                    latents = schedulers.euler_ancestral_step(
                        latents, out, sigma, sigma_next, noise)
                latents = blend_sigma(latents, sigma_next)
        return latents

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """VAE-decode latents to [0, 1] float32 images on the host."""
        images = self.vae.decode(latents)
        return (images.float() / 2 + 0.5).clamp(0.0, 1.0).cpu().numpy()

    def _encode_image(self, image, generator, noise) -> torch.Tensor:
        """VAE-encode an image (B, H, W, 3) in [-1, 1] in the pipeline's
        dtype to scaled latents, with a posterior sample: `noise` when
        given, else drawn from `generator`."""
        if noise is None and generator is None:
            raise ValueError("pass generator= (or the posterior noise)")
        return vae_encode(self.vae.flat_params(), image.to(self.dtype),
                          self.vae.cfg, generator, noise=noise)

    def _draw(self, shape, dtype, generator, given) -> torch.Tensor:
        """`given` on the device, or a standard normal draw from
        `generator`."""
        if given is not None:
            return torch.as_tensor(given, device=self.device).to(dtype)
        if generator is None:
            raise ValueError("pass generator= (or the draws themselves)")
        return torch.randn(tuple(shape), generator=generator,
                           device=self.device, dtype=dtype)

    def _image_input(self, image) -> torch.Tensor:
        image = torch.as_tensor(image, device=self.device)
        self._check_size(int(image.shape[1]), int(image.shape[2]))
        return image

    @torch.inference_mode()
    def img2img(
        self,
        prompt: Union[str, Sequence[str]],
        init_image,                       # (B, H, W, 3) in [-1, 1]
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Union[str, Sequence[str]] = "",
        generator: Optional[torch.Generator] = None,
        lora_idx: Optional[Sequence[int]] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """img2img with DDIM: encode the image (a posterior sample), noise
        it to the step the strength starts at (the last int(S * strength)
        of the S DDIM steps), then denoise. The posterior noise and the
        init noise are drawn from `generator` in that order, or given."""
        text_emb, uncond, B = self._resolve_cond(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        return self._img2img(
            text_emb, uncond, B, None, self._image_input(init_image),
            strength, num_inference_steps, guidance_scale, generator,
            lora_idx, posterior_noise, init_noise)

    def _img2img(self, text_emb, uncond, B: int, added_cond, image,
                 strength: float, num_inference_steps: int,
                 guidance_scale: float, generator, lora_idx, posterior_noise,
                 init_noise) -> np.ndarray:
        """img2img from resolved conditioning and a checked image."""
        ts = schedulers.ddim_timesteps(self.schedule, num_inference_steps)
        ts = ts[_strength_start(num_inference_steps, strength):]
        if len(ts) == 0:
            raise ValueError(
                f"strength={strength} leaves zero denoising steps at "
                f"num_inference_steps={num_inference_steps}")
        z = self._encode_image(image, generator, posterior_noise)
        noise = self._draw(z.shape, z.dtype, generator, init_noise)
        z = schedulers.add_noise(
            self.schedule.to(z.device), z, noise,
            torch.full((B,), int(ts[0]), device=z.device))
        latents = self._denoise(z, text_emb, uncond, guidance_scale,
                                num_inference_steps, ts, lora_idx=lora_idx,
                                added_cond=added_cond)
        return self._decode(latents)

    @torch.inference_mode()
    def inpaint(
        self,
        prompt: Union[str, Sequence[str]],
        image,                            # (B, H, W, 3) in [-1, 1]
        mask,                             # (B, H, W, 1) in {0, 1}; 1 = repaint
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Union[str, Sequence[str]] = "",
        generator: Optional[torch.Generator] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """9-channel SD-inpainting (the runwayml/stable-diffusion-inpainting
        layout) with DDIM: the UNet's input is [noisy latents | the mask on
        the latent grid | the masked image's latents] on the last axis. The
        posterior noise and the initial latents are drawn from `generator`
        in that order, or given."""
        cfg = self.unet.cfg
        if cfg.in_channels != 9:
            raise ValueError("inpaint() needs an inpainting UNet "
                             f"(in_channels=9), got {cfg.in_channels}")
        use_cfg = guidance_scale > 1.0
        text_emb, uncond, B = self._resolve_cond(
            prompt, negative_prompt, use_cfg, prompt_embeds,
            negative_prompt_embeds)
        image = self._image_input(image)
        mask = torch.as_tensor(mask, device=self.device)
        masked_latents = self._encode_image(image * (mask < 0.5), generator,
                                            posterior_noise)
        h, w = masked_latents.shape[1:3]
        extra = torch.cat([_latent_mask(mask, h, w, self.dtype),
                           masked_latents], dim=-1)
        latents = self._draw((B, h, w, cfg.out_channels), self.dtype,
                             generator, latents)
        ts = schedulers.ddim_timesteps(self.schedule, num_inference_steps)
        latents = self._denoise(latents, text_emb, uncond, guidance_scale,
                                num_inference_steps, ts,
                                extra_channels=extra)
        return self._decode(latents)

    @torch.inference_mode()
    def inpaint_blend(
        self,
        prompt: Union[str, Sequence[str]],
        image,                            # (B, H, W, 3) in [-1, 1]
        mask,                             # (B, H, W, 1) in {0, 1}; 1 = repaint
        strength: float = 0.8,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Union[str, Sequence[str]] = "",
        generator: Optional[torch.Generator] = None,
        scheduler: str = "ddim",
        lora_idx: Optional[Sequence[int]] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        posterior_noise: Optional[torch.Tensor] = None,
        init_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        return_latents: bool = False,
    ):
        """Latent-blend inpainting for plain 4-channel checkpoints (the
        diffusers legacy / A1111 technique): start img2img-style from the
        noised original, and after every step overwrite the kept region
        with the original latents renoised to the stepped-to level, so only
        the masked region is resampled; the kept region's final latents
        equal the original's exactly. Any scheduler but pndm; strength as
        in img2img. The posterior noise, the init noise (float32) and
        euler_a's step noise are drawn from `generator` in that order, or
        given. return_latents=True also returns the final latents and the
        original's (z0)."""
        cfg = self.unet.cfg
        if cfg.in_channels != cfg.out_channels:
            raise ValueError(
                "inpaint_blend() is the technique for plain checkpoints; a "
                "9-channel inpainting UNet should use inpaint()")
        text_emb, uncond, B = self._resolve_cond(
            prompt, negative_prompt, guidance_scale > 1.0, prompt_embeds,
            negative_prompt_embeds)
        return self._inpaint_blend(
            text_emb, uncond, B, None, self._image_input(image), mask,
            strength, num_inference_steps, guidance_scale, generator,
            scheduler, lora_idx, posterior_noise, init_noise, step_noise,
            return_latents)

    def _inpaint_blend(self, text_emb, uncond, B: int, added_cond, image,
                       mask, strength: float, num_inference_steps: int,
                       guidance_scale: float, generator, scheduler: str,
                       lora_idx, posterior_noise, init_noise, step_noise,
                       return_latents: bool):
        """Latent-blend inpainting from resolved conditioning and a checked
        image."""
        ts, sigmas = self._scheduler_arrays(scheduler, num_inference_steps)
        method = SCHEDULERS[scheduler]
        if method == "pndm":
            raise ValueError(
                "latent-blend inpainting is not supported with the pndm "
                "scheduler; use ddim/euler/euler_a/dpm++")
        t_start = _strength_start(num_inference_steps, strength)
        ts = ts[t_start:]
        if len(ts) == 0:
            raise ValueError(
                f"strength={strength} leaves zero denoising steps at "
                f"num_inference_steps={num_inference_steps}")
        mask = torch.as_tensor(mask, device=self.device)
        z0 = self._encode_image(image, generator, posterior_noise)
        h, w = z0.shape[1:3]
        mask_small = _latent_mask(mask, h, w, torch.float32)
        noise0 = self._draw(z0.shape, torch.float32, generator, init_noise)
        if method in _SIGMA_LOOPS:
            sigmas = sigmas[t_start:]
            latents = (z0 + self._sigma_tensor(sigmas[0]) * noise0).to(
                self.dtype)
        else:
            latents = schedulers.add_noise(
                self.schedule.to(z0.device), z0, noise0,
                torch.full((B,), int(ts[0]), device=z0.device)).to(
                    self.dtype)
        latents = self._denoise(
            latents, text_emb, uncond, guidance_scale, num_inference_steps,
            ts, method, sigmas, lora_idx=lora_idx,
            blend=(mask_small, z0.float(), noise0), generator=generator,
            step_noise=step_noise, added_cond=added_cond)
        images = self._decode(latents)
        if return_latents:
            return images, latents, z0
        return images
