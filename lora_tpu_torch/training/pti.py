"""Pivotal tuning inversion, the two-phase trainer: the counterpart of
lora_tpu/training/pti.py.

Phase 1, inversion (pti.py:383-411): only the TI rows of the placeholder
tokens train; after each optimizer step the norm prior pulls each row's
norm toward 0.4 with lambda = min(1, 100 * lr). Phase 2, tuning
(pti.py:413-513): a fresh LoRA on the UNet (default, extended or LoCon
sites), optionally on the text encoder, and optionally the TI rows
further (continue_inversion); timesteps drawn below 0.8 of the schedule,
the gradient clipped to max_grad_norm.

The TI rows are a trainable (K, D) buffer written over the token table at
each forward (models/clip.py apply_ti), so the frozen rows of the table
need no restoring. Their gradient crosses the whole frozen UNet: every
micro-step of both phases runs the flash forward, dQ and dK/dV kernels at
every attention of the UNet.

Random draws come from torch.Generators on the pipeline's device: the
<rand-sigma> rows from seed, the UNet LoRA from seed + 1 and the text LoRA
from seed + 2, the cached-latent encodes from seed + 99, the steps of both
phases from seed + 7. The host reads the loss only where lora_tpu does, at
step 1 and every 20th step of each phase; in between nothing waits for the
device.

On an SDXL pipeline it ends where lora_tpu's does: the first inversion
step raises the loss's ValueError (textual inversion is not supported for
SDXL training). With log_wandb, each save step of tuning runs lora_tpu's
CLIP-alignment eval (eval_at_save, utils/eval.py) and logs it as
phase="eval"; a failing eval prints "eval skipped:" and training goes on.

Across processes (parallel/mesh.py) data_parallel and fsdp work as in
training/dreambooth.py: the TI rows' gradients are averaged over dp with
the LoRA's, the norm prior runs on every rank and leaves the rows the same
bits everywhere, only rank 0 writes (and evaluates), and a SIGTERM to any
rank stops every rank at the same step. tensor_parallel splits the
attention and MLP blocks over tp ranks (parallel/tensor.py). Under fsdp
or tp the pipe keeps its full weights beside the shards.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import time
from typing import List, Literal, Optional

import numpy as np
import torch

from ..core import lora as lora_core
from ..core.save import save_all
from ..core.sites import (
    text_encoder_locon_sites,
    text_encoder_lora_sites,
    unet_locon_sites,
    unet_lora_sites,
)
from ..data.dataset import (
    PivotalTuningDataset,
    data_loader,
    device_prefetch,
    prefetch,
    read_image,
)
from ..formats.kohya import save_kohya
from ..formats.pt_io import save_a1111_multi_embedding
from ..formats.safetensors_io import UNET_EXTENDED_TARGET_REPLACE
from ..models.clip import apply_ti
from ..models.vae import vae_encode
from ..parallel import mesh as mesh_lib
from ..utils.metrics import MetricsLogger
from .checkpoint import PreemptionGuard
from .loss import LossConfig, _resize_mask_nearest
from .optim import make_lr_schedule, make_optimizer
from .train_step import make_train_step, make_trainable, ti_norm_prior

_TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


@dataclasses.dataclass
class PTIConfig:
    instance_data_dir: str = ""
    output_dir: str = "./output"
    train_text_encoder: bool = True
    perform_inversion: bool = True
    use_template: Optional[Literal["object", "style", "null"]] = None
    train_inpainting: bool = False
    placeholder_tokens: str = ""
    placeholder_token_at_data: Optional[str] = None
    initializer_tokens: Optional[str] = None
    seed: int = 42
    resolution: int = 512
    color_jitter: bool = True
    train_batch_size: int = 1
    max_train_steps_tuning: int = 1000
    max_train_steps_ti: int = 1000
    save_steps: int = 100
    gradient_accumulation_steps: int = 4
    gradient_checkpointing: bool = False
    lora_rank: int = 4
    lora_unet_target_modules: frozenset = frozenset(
        {"CrossAttention", "Attention", "GEGLU"})
    lora_clip_target_modules: frozenset = frozenset({"CLIPAttention"})
    lora_dropout_p: float = 0.0
    lora_scale: float = 1.0
    use_extended_lora: bool = False
    # "default" | "extended" | "locon": locon trains the kohya/LoCon module
    # superset and saves <name>.safetensors in the kohya schema beside
    # <name>.embeds.pt, an A1111 embedding (neither format holds both)
    lora_targets: str = "default"
    clip_ti_decay: bool = True
    learning_rate_unet: float = 1e-4
    learning_rate_text: float = 1e-5
    learning_rate_ti: float = 5e-4
    continue_inversion: bool = False
    continue_inversion_lr: Optional[float] = None
    use_face_segmentation_condition: bool = False
    cached_latents: bool = True
    dataloader_num_workers: int = 0  # thread-pool sample decode (0 = serial)
    use_mask_captioned_data: bool = False
    mask_temperature: float = 1.0
    scale_lr: bool = False
    lr_scheduler: str = "linear"
    lr_warmup_steps: int = 0
    lr_scheduler_lora: str = "linear"
    lr_warmup_steps_lora: int = 0
    weight_decay_ti: float = 0.0
    weight_decay_lora: float = 0.001
    max_grad_norm: float = 1.0
    out_name: str = "final_lora"
    mixed_precision: Optional[str] = None
    # mesh flags (lora_tpu's, parallel/mesh.py)
    data_parallel: bool = False
    fsdp: int = 1
    tensor_parallel: int = 1
    preemption_sync_every: int = 10  # multi-process only
    log_wandb: bool = False


def parse_token_args(cfg: PTIConfig):
    """(placeholder tokens, initializer tokens, token map) of the flags
    (lora_tpu/training/pti.py:105-124): tokens split at "|", which must be
    sorted; <rand-0.017> for each token without an initializer."""
    if len(cfg.placeholder_tokens) == 0:
        placeholder_tokens: List[str] = []
    else:
        placeholder_tokens = cfg.placeholder_tokens.split("|")
        if sorted(placeholder_tokens) != placeholder_tokens:
            raise ValueError(
                "Placeholder tokens should be sorted. Use something like "
                f"{'|'.join(sorted(placeholder_tokens))}")
    if cfg.initializer_tokens is None:
        initializer_tokens = ["<rand-0.017>"] * len(placeholder_tokens)
    else:
        initializer_tokens = cfg.initializer_tokens.split("|")
    if len(initializer_tokens) != len(placeholder_tokens):
        raise ValueError("Unequal Initializer token for Placeholder tokens.")
    if cfg.placeholder_token_at_data is not None:
        tok, pat = cfg.placeholder_token_at_data.split("|")
        token_map = {tok: pat}
    else:
        token_map = {"DUMMY": "".join(placeholder_tokens)}
    return placeholder_tokens, initializer_tokens, token_map


@torch.no_grad()
def setup_ti(pipe, placeholder_tokens, initializer_tokens,
             generator: torch.Generator):
    """Add the placeholder tokens and build the initial TI rows
    (lora_tpu/training/pti.py:127-161): <rand-sigma> draws N(0, sigma^2)
    from `generator`, <zero> gives zeros, any other initializer copies its
    token's row (it must be one token). A token already in the tokenizer
    raises. The token table grows with zero rows to cover the new ids.
    Returns (ti_ids (K,) int64, ti_init (K, D) f32) on the pipeline's
    device."""
    device = pipe.device
    table = pipe.text_encoder.get_parameter(_TOKEN_TABLE)
    d = table.shape[1]
    ids, inits = [], []
    for token, init_tok in zip(placeholder_tokens, initializer_tokens):
        if pipe.tokenizer.add_tokens(token) == 0:
            raise ValueError(
                f"The tokenizer already contains the token {token}.")
        ids.append(pipe.tokenizer.convert_tokens_to_ids(token))
        if init_tok.startswith("<rand"):
            sigma = float(re.findall(r"<rand-(.*)>", init_tok)[0])
            inits.append(torch.randn(d, generator=generator, device=device,
                                     dtype=torch.float32) * sigma)
        elif init_tok == "<zero>":
            inits.append(torch.zeros(d, device=device))
        else:
            tids = pipe.tokenizer.encode(init_tok)
            if len(tids) > 1:
                raise ValueError(
                    "The initializer token must be a single token.")
            inits.append(table[tids[0]].float().clone())
    if not ids:
        return (torch.zeros((0,), dtype=torch.int64, device=device),
                torch.zeros((0, d), device=device))
    if max(ids) >= table.shape[0]:
        pad = table.new_zeros((max(ids) + 1 - table.shape[0], d))
        pipe.text_encoder.set_param(_TOKEN_TABLE,
                                    torch.cat([table.detach(), pad]))
    return torch.tensor(ids, dtype=torch.int64, device=device), \
        torch.stack(inits)


@torch.no_grad()
def cache_latents(pipe, dataset, generator: torch.Generator,
                  dtype=torch.float32) -> list:
    """Every example encoded once through the VAE
    (lora_tpu/training/pti.py:164-195), its augmentation fixed at cache
    time: a list of dicts of device tensors, "latents" (h, w, c) and
    "input_ids", with "mask" where the dataset has masks. Inpainting also
    caches "masked_image_latents" and the hole mask at latent resolution
    ("mask_values", nearest), so the loop never runs the VAE."""
    vae_p, vae_cfg = pipe.vae.flat_params(), pipe.vae.cfg
    device = pipe.device

    def encode(x):
        x = torch.from_numpy(np.ascontiguousarray(x[None])).to(device, dtype)
        return vae_encode(vae_p, x, vae_cfg, generator)[0]

    items = []
    for i in range(len(dataset)):
        ex = dataset[i]
        lat = encode(ex["instance_images"])
        item = {"latents": lat,
                "input_ids": torch.from_numpy(np.asarray(
                    ex["instance_prompt_ids"], np.int64)).to(device)}
        if "mask" in ex:
            item["mask"] = torch.from_numpy(np.ascontiguousarray(
                ex["mask"], np.float32)).to(device)
        if "instance_masks" in ex:
            item["masked_image_latents"] = encode(
                ex["instance_masked_images"])
            holes = torch.from_numpy(np.ascontiguousarray(
                ex["instance_masks"], np.float32)).to(device)
            item["mask_values"] = _resize_mask_nearest(
                holes[None], lat.shape[0], lat.shape[1])[0]
        items.append(item)
    return items


def cached_loader(items, batch_size: int, seed: int = 0,
                  shard=mesh_lib.BatchShard(0, 1)):
    """Endless batches of `batch_size` (global) cached items, shuffled each
    epoch by random.Random(seed), repeated for datasets smaller than a
    batch (lora_tpu/training/pti.py:198-218); every rank draws the same
    stream and keeps its block (shard: the dp index and count)."""
    rng = random.Random(seed)
    per = batch_size // shard.count
    while True:
        idxs = list(range(len(items)))
        rng.shuffle(idxs)
        while len(idxs) < batch_size:  # tiny datasets: repeat
            idxs = idxs + idxs
        for s in range(0, len(idxs) - batch_size + 1, batch_size):
            take = idxs[s:s + batch_size][shard.index * per:
                                          (shard.index + 1) * per]
            chunk = [items[i] for i in take]
            yield {key: torch.stack([c[key] for c in chunk])
                   for key in chunk[0]}


def _check_config(pipe, cfg: PTIConfig) -> None:
    if cfg.lora_targets not in ("default", "extended", "locon"):
        raise ValueError(f"lora_targets must be default|extended|locon, "
                         f"got {cfg.lora_targets!r}")
    if cfg.lora_targets == "locon" and cfg.use_extended_lora:
        raise ValueError("use_extended_lora conflicts with "
                         "lora_targets='locon' (locon already covers the "
                         "extended conv sites); pass exactly one")


def _sites(pipe, cfg: PTIConfig):
    """(UNet sites, text sites, the UNet target set saved in the file's
    metadata) of cfg.lora_targets."""
    ucfg, tcfg = pipe.unet.cfg, pipe.text_encoder.cfg
    if cfg.lora_targets == "locon":
        # kohya files carry no target-set metadata
        return unet_locon_sites(ucfg), text_encoder_locon_sites(tcfg), set()
    extended = cfg.use_extended_lora or cfg.lora_targets == "extended"
    targets = set(cfg.lora_unet_target_modules) | (
        UNET_EXTENDED_TARGET_REPLACE if extended else set())
    return (unet_lora_sites(ucfg, targets),
            text_encoder_lora_sites(tcfg, set(cfg.lora_clip_target_modules)),
            targets)


def eval_at_save(pipe, trainable: dict, embeds: Optional[dict],
                 instance_data_dir: str, class_token: str,
                 learnt_token: str) -> dict:
    """lora_tpu's eval at a save step (lora_tpu/training/pti.py:467-492):
    evaluate_pipe (4 prompts, 20 steps) with the step's LoRAs and TI rows,
    scored against the instance images (PNG, and JPEG where Pillow is
    installed) by the CLIP of prepare_clip_model_sets, where there is one.
    lora_tpu evaluates on a shallow copy of its pipeline; this pipeline
    holds modules, so the LoRA trees, the token table and the adapter
    generation it changes are put back, the same tensors, before it
    returns or raises."""
    from ..utils.eval import evaluate_pipe, prepare_clip_model_sets

    targets = [read_image(os.path.join(instance_data_dir, f))
               for f in sorted(os.listdir(instance_data_dir))
               if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    saved = (pipe.lora_unet, pipe.lora_text,
             pipe.text_encoder.get_parameter(_TOKEN_TABLE),
             pipe.adapter_generation)
    try:
        pipe.lora_unet = trainable.get("lora_unet")
        pipe.lora_text = trainable.get("lora_text")
        if embeds:
            pipe.apply_ti(embeds)
        return evaluate_pipe(pipe, targets, class_token=class_token,
                             learnt_token=learnt_token,
                             clip_model_sets=prepare_clip_model_sets(),
                             n_test=4, n_step=20)
    finally:
        pipe.lora_unet, pipe.lora_text, table, pipe.adapter_generation = \
            saved
        pipe.text_encoder.set_param(_TOKEN_TABLE, table)


def train_pti(pipe, cfg: PTIConfig) -> dict:
    _check_config(pipe, cfg)
    locon = cfg.lora_targets == "locon"
    os.makedirs(cfg.output_dir, exist_ok=True)
    device = pipe.device
    dtype = torch.bfloat16 if cfg.mixed_precision == "bf16" else torch.float32
    # only rank 0 writes artifacts and metrics to the shared output dir
    main = mesh_lib.is_main_process()
    log = MetricsLogger(os.path.join(cfg.output_dir, "metrics.jsonl")
                        if main else None, use_wandb=cfg.log_wandb and main,
                        echo=main)

    def generator(offset):
        return torch.Generator(device).manual_seed(cfg.seed + offset)

    placeholder_tokens, initializer_tokens, token_map = parse_token_args(cfg)
    ti_ids, ti_init = setup_ti(pipe, placeholder_tokens, initializer_tokens,
                               generator(0))

    mesh = mesh_lib.mesh_from_flags(cfg.data_parallel, cfg.fsdp,
                                    cfg.tensor_parallel)
    mesh_lib.warm_collectives(mesh)  # in lockstep, before the first step
    dp = mesh_lib.data_parallel_size(mesh)
    shard = mesh_lib.batch_sharding(mesh)
    ga = cfg.gradient_accumulation_steps
    batch_size = cfg.train_batch_size * dp  # per-chip batch semantics
    lr_scale = ga * batch_size if cfg.scale_lr else 1
    unet_lr = cfg.learning_rate_unet * lr_scale
    text_lr = cfg.learning_rate_text * lr_scale
    ti_lr = cfg.learning_rate_ti * lr_scale

    dataset = PivotalTuningDataset(
        instance_data_root=cfg.instance_data_dir,
        token_map=token_map,
        use_template=cfg.use_template,
        tokenizer=pipe.tokenizer,
        size=cfg.resolution,
        color_jitter=cfg.color_jitter,
        use_face_segmentation_condition=cfg.use_face_segmentation_condition,
        use_mask_captioned_data=cfg.use_mask_captioned_data,
        train_inpainting=cfg.train_inpainting,
        blur_amount=200,  # the inversion phase's (cli_lora_pti.py:853)
        seed=cfg.seed,
    )
    closers = []
    if cfg.cached_latents:
        items = cache_latents(pipe, dataset, generator(99), dtype)
        loader = cached_loader(items, batch_size, cfg.seed, shard)
    else:
        # each dp index loads its block from its shard of the sample stream
        host = prefetch(data_loader(dataset, batch_size // dp, seed=cfg.seed,
                                    process_index=shard.index,
                                    process_count=dp,
                                    num_workers=cfg.dataloader_num_workers))
        closers.append(host)
        loader = device_prefetch(host, device=device)
    closers.append(loader)

    usites, tsites, unet_targets = _sites(pipe, cfg)
    rng = generator(7)

    def base_params():
        base = (pipe.unet.flat_params(), pipe.text_encoder.flat_params(),
                pipe.vae.flat_params())
        if mesh is None:
            return base
        return tuple(mesh_lib.shard_params(
            p, mesh, use_fsdp=cfg.fsdp > 1, use_tp=cfg.tensor_parallel > 1)
            for p in base)

    base = base_params()

    def embeds_dict(ti_embeds):
        rows = ti_embeds.detach().float().cpu().numpy()
        return {tok: rows[i] for i, tok in enumerate(placeholder_tokens)}

    def run_phase(trainable, lrs, steps, loss_cfg, phase_name, save_fn,
                  ti_lr_sched=None):
        """steps optimizer steps of ga micro-steps; ti_lr_sched: the norm
        prior's schedule (inversion only)."""
        make_trainable(trainable)
        mesh_lib.replicate_tree(trainable, mesh)
        opt = make_optimizer(
            trainable, lrs, weight_decay=cfg.weight_decay_lora,
            max_grad_norm=cfg.max_grad_norm if phase_name == "tune"
            else None, grad_accum=ga)
        step_fn = make_train_step(
            unet_cfg=pipe.unet.cfg, text_cfg=pipe.text_encoder.cfg,
            vae_cfg=pipe.vae.cfg, sched=pipe.schedule, loss_cfg=loss_cfg,
            optimizer=opt, ti_ids=ti_ids if "ti" in trainable else None,
            dtype=dtype, mesh=mesh)
        t0 = time.perf_counter()
        global_step = 0
        loss = torch.zeros(())
        preempted = False
        # every rank stops at the same step, whichever got the signal
        stop = mesh_lib.PreemptionCoordinator(cfg.preemption_sync_every)
        with PreemptionGuard() as guard:  # handler restored even on raise
            for micro in range(steps * ga):
                if stop.should_stop(guard.should_stop, micro):
                    # SIGTERM: save the phase's adapters / rows and stop
                    save_fn(trainable, global_step)
                    preempted = True
                    print(f"Preempted in {phase_name} at step "
                          f"{global_step}; artifacts saved")
                    break
                loss = step_fn(trainable, base, next(loader), generator=rng)
                if (micro + 1) % ga:  # inside an accumulation window
                    continue
                global_step += 1
                if ti_lr_sched is not None and cfg.clip_ti_decay:
                    emb = trainable["ti"]["embeds"]
                    with torch.no_grad():
                        emb.copy_(ti_norm_prior(
                            emb, float(ti_lr_sched(global_step))))
                if global_step % 20 == 0 or global_step == 1:
                    lf = float(loss)
                    if not np.isfinite(lf):
                        raise FloatingPointError(
                            f"non-finite loss in {phase_name} at step "
                            f"{global_step}")
                    kw = dict(phase=phase_name, step=global_step, loss=lf)
                    if global_step > 1:  # step 1's window holds the warm-up
                        kw["sps"] = global_step / (time.perf_counter() - t0)
                    log.log(**kw)
                if cfg.save_steps and global_step % cfg.save_steps == 0:
                    save_fn(trainable, global_step)
                if global_step >= steps:
                    break
        return float(loss), preempted

    try:
        ti_embeds = ti_init
        # ---------------- phase 1: inversion ----------------
        if cfg.perform_inversion and placeholder_tokens:
            ti_sched = make_lr_schedule(cfg.lr_scheduler, ti_lr,
                                        cfg.max_train_steps_ti,
                                        cfg.lr_warmup_steps)
            trainable = {"ti": {"embeds": ti_init}}

            @torch.no_grad()
            def save_inv(tr, step):
                if not main:
                    return
                save_all(os.path.join(cfg.output_dir,
                                      f"step_inv_{step}.safetensors"),
                         embeds=embeds_dict(tr["ti"]["embeds"]),
                         save_lora=False)

            loss_cfg = LossConfig(
                cached_latents=cfg.cached_latents,
                train_inpainting=cfg.train_inpainting,
                gradient_checkpointing=cfg.gradient_checkpointing)
            inv_loss, preempted = run_phase(
                trainable, {"ti": ti_sched}, cfg.max_train_steps_ti,
                loss_cfg, "inversion", save_inv, ti_lr_sched=ti_sched)
            ti_embeds = trainable["ti"]["embeds"]
            log.log(phase="inversion", final_loss=inv_loss)
            if preempted:
                # SIGTERM in inversion: no tuning and no final artifact;
                # the step_inv_* save is the output
                return {"trainable": trainable,
                        "ti_ids": ti_ids.cpu().numpy(),
                        "placeholder_tokens": placeholder_tokens,
                        "final_loss": inv_loss, "preempted": True}

        # ---------------- phase 2: tuning ----------------
        dataset.blur_amount = 70  # (cli_lora_pti.py:1003)
        trainable = {"lora_unet": lora_core.init_lora(
            usites, r=cfg.lora_rank, generator=generator(1), device=device,
            scale=cfg.lora_scale)}
        lrs = {"lora_unet": make_lr_schedule(
            cfg.lr_scheduler_lora, unet_lr, cfg.max_train_steps_tuning,
            cfg.lr_warmup_steps_lora)}
        if cfg.continue_inversion and placeholder_tokens:
            trainable["ti"] = {"embeds": ti_embeds}
            lrs["ti"] = (cfg.continue_inversion_lr
                         if cfg.continue_inversion_lr is not None else ti_lr)
        elif placeholder_tokens:
            # the learned rows go into the table: phase 2 conditions on them
            table = pipe.text_encoder.get_parameter(_TOKEN_TABLE).detach()
            pipe.text_encoder.set_param(_TOKEN_TABLE, apply_ti(
                {_TOKEN_TABLE: table}, ti_embeds.detach(), ti_ids))
            base = base_params()
        if cfg.train_text_encoder:
            trainable["lora_text"] = lora_core.init_lora(
                tsites, r=cfg.lora_rank, generator=generator(2),
                device=device)
            lrs["lora_text"] = make_lr_schedule(
                cfg.lr_scheduler_lora, text_lr, cfg.max_train_steps_tuning,
                cfg.lr_warmup_steps_lora)

        @torch.no_grad()
        def save_tune(tr, step, name=None):
            if not main:
                return
            emb = (embeds_dict(tr["ti"]["embeds"] if "ti" in tr
                               else ti_embeds)
                   if placeholder_tokens else None)
            out = os.path.join(cfg.output_dir,
                               name or f"step_{step}.safetensors")
            if locon:
                save_kohya(out, lora_unet=tr.get("lora_unet"),
                           unet_sites=usites, lora_text=tr.get("lora_text"),
                           text_sites=tsites)
                if emb:
                    save_a1111_multi_embedding(
                        emb, out[:-len(".safetensors")] + ".embeds.pt",
                        name=cfg.out_name)
            else:
                save_all(out, lora_unet=tr.get("lora_unet"),
                         unet_sites=usites, lora_text=tr.get("lora_text"),
                         text_sites=tsites, embeds=emb,
                         save_ti=emb is not None,
                         target_replace_module_unet=unet_targets,
                         target_replace_module_text=set(
                             cfg.lora_clip_target_modules))
            if cfg.log_wandb and name is None:
                # the CLIP-alignment eval at the save steps
                # (cli_lora_pti.py:527-539); it must never end training
                try:
                    scores = eval_at_save(
                        pipe, tr, emb, cfg.instance_data_dir,
                        "".join(initializer_tokens),
                        "".join(placeholder_tokens))
                    log.log(phase="eval", step=step, **scores)
                except Exception as e:
                    print(f"eval skipped: {e}")

        loss_cfg = LossConfig(
            cached_latents=cfg.cached_latents,
            train_inpainting=cfg.train_inpainting, t_multiplier=0.8,
            mask_temperature=cfg.mask_temperature,
            lora_dropout_p=cfg.lora_dropout_p,
            gradient_checkpointing=cfg.gradient_checkpointing)
        tune_loss, preempted = run_phase(
            trainable, lrs, cfg.max_train_steps_tuning, loss_cfg, "tune",
            save_tune)
    finally:
        for it in reversed(closers):  # ends the prefetch thread
            it.close()

    with torch.no_grad():
        first = dict(list(trainable["lora_unet"]["sites"].items())[:4])
        drift = lora_core.inspect_lora({"sites": first})
    print("PTI : drift:", {k: round(v[0], 6) for k, v in drift.items()})
    if not preempted:
        # a preempted run keeps its step_* save; the completed-run name is
        # not written with a partly tuned adapter
        save_tune(trainable, 0, name=f"{cfg.out_name}.safetensors")
    log.log(phase="tune", final_loss=tune_loss)
    return {"trainable": trainable, "ti_ids": ti_ids.cpu().numpy(),
            "placeholder_tokens": placeholder_tokens,
            "final_loss": tune_loss, "preempted": preempted}
