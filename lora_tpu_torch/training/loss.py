"""The diffusion training loss, the counterpart of lora_tpu/training/loss.py.

The trainable leaves (LoRA trees and the TI buffer) are inputs of the loss,
as in the JAX package; the frozen base never requires grad, so autograd
reaches only them:

    trainable = {"lora_unet": LoraTree | None,
                 "lora_text": LoraTree | None,
                 "lora_text2": LoraTree | None,   # SDXL's te2
                 "ti": {"embeds": (K, D)} | None}

SDXL (a UNet config with text_time conditioning) conditions on both text
encoders (models/clip.py dual_encode) and on the text_time rows: te2's
pooled embedding and the batch's "add_time_ids".

Random draws (posterior noise of the VAE, diffusion noise, timesteps, the
LoRA dropout seed) come from an explicit torch.Generator, in that order.
torch cannot give jax.random's bits, so a caller can hand any of them in
instead (`noise=`, `timesteps=`, `vae_noise=`, `masked_vae_noise=`,
`dropout_seed=`): the parity tests draw them with jax.random and pass them.

Under a data-parallel mesh (parallel/mesh.py) each rank holds its block of
the global batch (its fsdp and tp peers hold the same block). Every draw is
the global batch's, from the same seeded generator on every rank (or
handed in for the global batch), cut to the rank's rows, dropout masks
included (a tensor-parallel rank's also cut to its features); the batch-wide reductions (the prior
term's counts, the mask's peak) are global. The returned loss is then the
rank's share: its mean over the dp ranks is the loss of the global batch,
and so is its gradient (training/train_step.py averages both).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models import schedulers
from ..models.clip import clip_text_forward, dual_encode
from ..models.config import CLIPTextConfig, UNetConfig, VAEConfig
from ..models.unet import unet_forward
from ..models.vae import vae_encode_moments, vae_sample


@dataclasses.dataclass(frozen=True)
class LossConfig:
    t_multiplier: float = 1.0
    mask_temperature: float = 1.0
    cached_latents: bool = True
    train_inpainting: bool = False
    with_prior_preservation: bool = False
    prior_loss_weight: float = 1.0
    lora_dropout_p: float = 0.0
    gradient_checkpointing: bool = False


def _resize_mask_nearest(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, 1) -> (B, h, w, 1) nearest, with the JAX package's index
    arithmetic (f32 product, truncated)."""
    _, H, W, _ = mask.shape
    ys = (torch.arange(h, dtype=torch.float32) * (H / h)).long()
    xs = (torch.arange(w, dtype=torch.float32) * (W / w)).long()
    return mask[:, ys.to(mask.device)][:, :, xs.to(mask.device)]


def _rows(mesh, b: int):
    """(first row, global rows) of this rank's block of b rows."""
    if mesh is None or mesh.shape["dp"] == 1:
        return 0, b
    return mesh.coords["dp"] * b, mesh.shape["dp"] * b


def _own(x: torch.Tensor, first: int, b: int, total: int) -> torch.Tensor:
    """This rank's rows of a global-batch draw."""
    return x if total == b else x[first:first + b]


def _encode(vae_params, x, vae_cfg, generator, noise, first, total):
    """vae_encode with the posterior noise drawn for the global batch."""
    moments = vae_encode_moments(vae_params, x, vae_cfg)
    b = x.shape[0]
    if noise is None:
        if generator is None:
            raise ValueError("vae_sample needs a generator or the noise")
        noise = torch.randn((total,) + tuple(moments.shape[1:-1])
                            + (moments.shape[-1] // 2,), generator=generator,
                            device=moments.device, dtype=moments.dtype)
    return vae_sample(moments, None, _own(noise, first, b, total)
                      ) * vae_cfg.scaling_factor


def ids2_from_ids(ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    """SDXL te2's token ids from te1's: both tokenizers share the BPE
    vocabulary and differ only in padding (te1 pads with EOS, te2 with id
    0). BPE never emits EOS inside the text, so every position after the
    first EOS is padding and becomes 0."""
    is_eos = (ids == eos_id).long()
    after = torch.cumsum(is_eos, dim=-1) - is_eos
    return torch.where(after > 0, torch.zeros_like(ids), ids)


def loss_step(
    trainable: Dict,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    unet_params,
    text_params,
    vae_params,
    unet_cfg: UNetConfig,
    text_cfg: CLIPTextConfig,
    vae_cfg: VAEConfig,
    sched: schedulers.NoiseSchedule,
    cfg: LossConfig,
    ti_ids: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    noise: Optional[torch.Tensor] = None,
    timesteps: Optional[torch.Tensor] = None,
    vae_noise: Optional[torch.Tensor] = None,
    masked_vae_noise: Optional[torch.Tensor] = None,
    dropout_seed: Optional[int] = None,
    text2_params=None,
    text2_cfg: Optional[CLIPTextConfig] = None,
    eos_id: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """The scalar f32 loss; differentiable in the trainable leaves.

    Batch keys (NHWC images and latents, as in the JAX package): "latents"
    (cached) or "pixel_values"; "encoder_hidden_states" (precomputed) or
    "input_ids"; optionally "mask" (pixel space), "is_instance", and for
    inpainting "masked_image_latents" + "mask_values" (cached) or
    "masked_image_values" + "mask_values". SDXL also reads "add_time_ids"
    (B, 6), and with "encoder_hidden_states" its "add_text_embeds" (te2's
    pooled rows); te2's ids are "input_ids_2", else derived from
    "input_ids" (ids2_from_ids). text2_params, text2_cfg and eos_id are
    te2's and the tokenizer's, for SDXL. mesh: a data-parallel
    parallel.mesh.Mesh (see the module note); draws handed in are then the
    global batch's."""
    ref = batch.get("latents", batch.get("pixel_values"))
    device = ref.device
    bsz = ref.shape[0]
    first, total = _rows(mesh, bsz)

    if cfg.cached_latents:
        latents = batch["latents"].to(dtype)
    else:
        latents = _encode(vae_params, batch["pixel_values"].to(dtype),
                          vae_cfg, generator, vae_noise, first, total)

    if noise is None:
        noise = torch.randn((total,) + tuple(latents.shape[1:]),
                            generator=generator, device=device,
                            dtype=latents.dtype)
    noise = _own(noise, first, bsz, total).to(device=device,
                                               dtype=latents.dtype)
    t_hi = int(sched.num_train_timesteps * cfg.t_multiplier)
    if timesteps is None:
        timesteps = torch.randint(0, t_hi, (total,), generator=generator,
                                  device=device)
    timesteps = _own(timesteps, first, bsz, total).to(device=device,
                                                       dtype=torch.long)

    noisy = schedulers.add_noise(sched, latents, noise, timesteps)

    if cfg.train_inpainting:
        if cfg.cached_latents:
            masked_latents = batch["masked_image_latents"].to(dtype)
            mask_small = batch["mask_values"].to(dtype)
        else:
            masked_latents = _encode(
                vae_params, batch["masked_image_values"].to(dtype), vae_cfg,
                generator, masked_vae_noise, first, total)
            mask_small = _resize_mask_nearest(
                batch["mask_values"].to(dtype), latents.shape[1],
                latents.shape[2])
        model_input = torch.cat([noisy, mask_small, masked_latents], dim=-1)
    else:
        model_input = noisy

    lora_text = trainable.get("lora_text")
    ti = trainable.get("ti")
    xl = unet_cfg.addition_embed_type == "text_time"
    pooled = None
    if "encoder_hidden_states" in batch:
        # precomputed text embeddings (only valid when neither the text LoRA
        # nor TI trains): CLIP leaves the hot loop, as VAE caching does. For
        # SDXL the cache also holds te2's pooled rows
        encoder_hidden = batch["encoder_hidden_states"].to(dtype)
        if xl:
            pooled = batch["add_text_embeds"].to(dtype)
    elif xl:
        if ti is not None:
            raise ValueError("textual inversion is not supported for SDXL "
                             "training (dual-tokenizer TI is out of scope)")
        ids = batch["input_ids"]
        ids2 = batch.get("input_ids_2")
        if ids2 is None:
            ids2 = ids2_from_ids(ids, eos_id)
        encoder_hidden, pooled = dual_encode(
            text_params, text2_params, ids, ids2, text_cfg, text2_cfg,
            lora_text, trainable.get("lora_text2"), dtype, eos_id)
    else:
        encoder_hidden = clip_text_forward(
            text_params, batch["input_ids"], text_cfg, lora=lora_text,
            ti_embeds=ti["embeds"] if ti is not None else None,
            ti_ids=ti_ids, dtype=dtype)

    lora_unet = trainable.get("lora_unet")
    if lora_unet is not None and cfg.lora_dropout_p > 0.0:
        if dropout_seed is None:
            # the per-site generators need a host int: with a CUDA generator
            # this is one sync per step, and only when dropout is on
            dropout_seed = int(torch.randint(
                0, 2**31 - 1, (1,), generator=generator, device=device).item())
        lora_unet = {**lora_unet, "rng": dropout_seed,
                     "dropout_p": cfg.lora_dropout_p}
        if total != bsz:  # the global batch's masks, cut to these rows
            lora_unet["rows"] = (first, total)
    added_cond = None
    if xl:
        added_cond = {"text_embeds": pooled.to(dtype),
                      "time_ids": batch["add_time_ids"].to(dtype)}
    model_pred = unet_forward(unet_params, model_input, timesteps,
                              encoder_hidden, unet_cfg, lora=lora_unet,
                              remat=cfg.gradient_checkpointing,
                              added_cond=added_cond)

    if sched.prediction_type == "epsilon":
        target = noise
    elif sched.prediction_type == "v_prediction":
        target = schedulers.get_velocity(sched, latents, noise, timesteps)
    else:
        raise ValueError(f"Unknown prediction type {sched.prediction_type}")

    if batch.get("mask") is not None:
        # pixel-space mask -> latent resolution, temperature-sharpened,
        # peak-normalised (the JAX loss.py:169-178)
        mask = _resize_mask_nearest(batch["mask"].float(),
                                    model_pred.shape[1], model_pred.shape[2])
        mask = (mask + 0.01) ** cfg.mask_temperature
        peak = mask.max()
        if total != bsz:  # the global batch's peak
            peak = mesh.all_reduce(peak.detach().clone(),
                                   op=torch.distributed.ReduceOp.MAX)
        mask = mask / peak
        model_pred = model_pred * mask.to(model_pred.dtype)
        target = target * mask.to(target.dtype)

    se = (model_pred.float() - target.float()) ** 2
    per_example = se.mean(dim=(1, 2, 3))

    if cfg.with_prior_preservation:
        return prior_preserving_reduce(per_example, batch.get("is_instance"),
                                       cfg.prior_loss_weight, mesh)
    return per_example.mean()


def prior_preserving_reduce(per_example: torch.Tensor,
                            is_instance: Optional[torch.Tensor],
                            prior_loss_weight: float,
                            mesh=None) -> torch.Tensor:
    """instance.mean() + w * class.mean(). `is_instance` (1.0 for instance
    rows, 0.0 for class rows) carries the row layout; without it the batch
    is split at its midpoint ([instance | class]).

    Under a data-parallel mesh the counts are the global batch's (a rank
    may hold only class rows) and the midpoint is the global batch's; the
    rank returns dp times its share of the two sums, so that the mean over
    the ranks is the global value."""
    b = per_example.shape[0]
    first, total = _rows(mesh, b)
    if total != b:
        if is_instance is not None:
            m = is_instance.float()
        else:
            m = (torch.arange(first, first + b, device=per_example.device)
                 < total // 2).float()
        counts = mesh.all_reduce(torch.stack([m.sum(), (1.0 - m).sum()]))
        share = ((per_example * m).sum() / counts[0] + prior_loss_weight
                 * (per_example * (1.0 - m)).sum() / counts[1])
        return share * mesh.shape["dp"]
    if is_instance is not None:
        m = is_instance.float()
        inst = (per_example * m).sum() / m.sum()
        prior = (per_example * (1.0 - m)).sum() / (1.0 - m).sum()
    else:
        half = per_example.shape[0] // 2
        inst = per_example[:half].mean()
        prior = per_example[half:].mean()
    return inst + prior_loss_weight * prior
