"""The legacy single-loop TI+LoRA trainer, the counterpart of
lora_tpu/training/ti_legacy.py (the reference's train_lora_w_ti.py).

One optimizer over the UNet LoRA, the TI row and optionally the text LoRA,
with each group's learning rate gated by the step (ti_legacy.py:95-105):
before unfreeze_lora_step only the TI row trains, from it on only the LoRA
groups. The gate reads the optimizer's count of applied updates, as the
optax schedule does: the update with count c (the (c + 1)-th step) trains
the TI row when c < unfreeze_lora_step. A gated-off group is updated at lr
0, which leaves it unchanged, while the global-norm clip is still taken
over every group's gradient.

Random draws come from torch.Generators on the pipeline's device: the
<rand-sigma> row from seed, the UNet LoRA from seed + 1, the text LoRA from
seed + 2, the steps from seed + 7. The host reads the loss at step 1 and
every 20th step.

Under a process group (lora_launch_torch), as in lora_tpu, it builds no
mesh: every rank trains the same run on its device, only rank 0 writes,
and a SIGTERM to any rank stops every rank at the same step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from ..core import lora as lora_core
from ..core.save import save_all
from ..core.sites import text_encoder_lora_sites, unet_lora_sites
from ..parallel.mesh import PreemptionCoordinator, is_main_process
from ..data.dataset import (
    DreamBoothTiDataset,
    data_loader,
    device_prefetch,
    prefetch,
)
from ..utils.metrics import MetricsLogger
from .checkpoint import PreemptionGuard
from .loss import LossConfig
from .optim import make_optimizer
from .pti import setup_ti
from .train_step import make_train_step, make_trainable


@dataclasses.dataclass
class LegacyTiConfig:
    instance_data_dir: str = ""
    output_dir: str = "./output"
    placeholder_token: str = "<s>"
    initializer_token: Optional[str] = None
    learnable_property: str = "object"
    stochastic_attribute: Optional[str] = None
    with_prior_preservation: bool = False
    class_data_dir: Optional[str] = None
    class_prompt: Optional[str] = None
    prior_loss_weight: float = 1.0
    resolution: int = 512
    train_batch_size: int = 1
    learning_rate: float = 1e-4
    learning_rate_text: float = 5e-5
    learning_rate_ti: float = 5e-4
    train_text_encoder: bool = False
    lora_rank: int = 4
    max_train_steps: int = 3000
    unfreeze_lora_step: int = 1500
    save_steps: int = 500
    max_grad_norm: float = 1.0
    seed: int = 42
    color_jitter: bool = False
    h_flip: bool = True
    mixed_precision: Optional[str] = None
    output_format: str = "both"  # safe | pt | both


def train_ti_lora_legacy(pipe, cfg: LegacyTiConfig) -> dict:
    os.makedirs(cfg.output_dir, exist_ok=True)
    device = pipe.device
    dtype = torch.bfloat16 if cfg.mixed_precision == "bf16" else torch.float32
    # only rank 0 writes artifacts and metrics to the shared output dir
    main = is_main_process()
    log = MetricsLogger(os.path.join(cfg.output_dir, "metrics.jsonl")
                        if main else None, echo=main)

    def generator(offset):
        return torch.Generator(device).manual_seed(cfg.seed + offset)

    init_tok = cfg.initializer_token or "<rand-0.017>"
    ti_ids, ti_init = setup_ti(pipe, [cfg.placeholder_token], [init_tok],
                               generator(0))

    usites = unet_lora_sites(pipe.unet.cfg)
    tsites = text_encoder_lora_sites(pipe.text_encoder.cfg)
    trainable = {
        "lora_unet": lora_core.init_lora(usites, r=cfg.lora_rank,
                                         generator=generator(1),
                                         device=device),
        "ti": {"embeds": ti_init},
    }
    if cfg.train_text_encoder:
        trainable["lora_text"] = lora_core.init_lora(
            tsites, r=cfg.lora_rank, generator=generator(2), device=device)
    make_trainable(trainable)

    # the legacy param-group switching as schedules of the update count
    def gated(lr, active_before):
        def sched(count):
            return lr if (count < cfg.unfreeze_lora_step) == active_before \
                else 0.0
        return sched

    lrs = {"lora_unet": gated(cfg.learning_rate, False),
           "ti": gated(cfg.learning_rate_ti, True)}
    if cfg.train_text_encoder:
        lrs["lora_text"] = gated(cfg.learning_rate_text, False)
    opt = make_optimizer(trainable, lrs, max_grad_norm=cfg.max_grad_norm)

    ds = DreamBoothTiDataset(
        cfg.instance_data_dir, "", pipe.tokenizer,
        class_data_root=cfg.class_data_dir if cfg.with_prior_preservation
        else None,
        class_prompt=cfg.class_prompt, size=cfg.resolution,
        color_jitter=cfg.color_jitter, h_flip=cfg.h_flip, seed=cfg.seed,
        placeholder_token=cfg.placeholder_token,
        learnable_property=cfg.learnable_property,
        stochastic_attribute=cfg.stochastic_attribute)
    host = prefetch(data_loader(
        ds, cfg.train_batch_size, seed=cfg.seed,
        prior_preservation=cfg.with_prior_preservation))
    loader = device_prefetch(host, device=device)

    step_fn = make_train_step(
        unet_cfg=pipe.unet.cfg, text_cfg=pipe.text_encoder.cfg,
        vae_cfg=pipe.vae.cfg, sched=pipe.schedule,
        loss_cfg=LossConfig(
            cached_latents=False,
            with_prior_preservation=cfg.with_prior_preservation,
            prior_loss_weight=cfg.prior_loss_weight),
        optimizer=opt, ti_ids=ti_ids, dtype=dtype)
    base = (pipe.unet.flat_params(), pipe.text_encoder.flat_params(),
            pipe.vae.flat_params())

    @torch.no_grad()
    def save(tr, name):
        if not main:
            return
        embeds = {cfg.placeholder_token:
                  tr["ti"]["embeds"][0].float().cpu().numpy()}
        kw = dict(lora_unet=tr["lora_unet"], unet_sites=usites,
                  lora_text=tr.get("lora_text"), text_sites=tsites,
                  embeds=embeds)
        if cfg.output_format in ("safe", "both"):
            save_all(os.path.join(cfg.output_dir, name + ".safetensors"),
                     **kw)
        if cfg.output_format in ("pt", "both"):
            save_all(os.path.join(cfg.output_dir, name + ".pt"),
                     safe_form=False, **kw)

    rng = generator(7)
    t0 = time.perf_counter()
    loss = torch.tensor(float("nan"))
    preempted = False
    stop = PreemptionCoordinator()  # the same stop step on every rank
    try:
        with PreemptionGuard() as guard:
            for step in range(cfg.max_train_steps):
                if stop.should_stop(guard.should_stop, step):
                    # SIGTERM: save the adapters and the row, stop cleanly
                    save(trainable, f"lora_ti_preempt_{step}")
                    preempted = True
                    print(f"Preempted at step {step}; artifacts saved")
                    break
                loss = step_fn(trainable, base, next(loader), generator=rng)
                if (step + 1) % 20 == 0 or step == 0:
                    log.log(step=step + 1, loss=float(loss),
                            phase="ti" if step < cfg.unfreeze_lora_step
                            else "lora")
                if cfg.save_steps and (step + 1) % cfg.save_steps == 0:
                    save(trainable, f"lora_ti_s{step + 1}")
    finally:
        for it in (loader, host):  # ends the prefetch thread
            it.close()

    if not preempted:
        save(trainable, "lora_ti_final")
    return {"trainable": trainable, "final_loss": float(loss),
            "preempted": preempted,
            "seconds": time.perf_counter() - t0}
