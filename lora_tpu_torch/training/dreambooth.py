"""The DreamBooth-LoRA trainer, the counterpart of
lora_tpu/training/dreambooth.py: prior preservation with
class images generated on the fly, dual UNet / text learning rates, cached
latents and text embeddings, resume from .pt adapters or from a full train
state, preemption on SIGTERM, and periodic and final saves in the .pt and
safetensors forms (the kohya schema for lora_targets="locon").

SDXL pipelines (pipelines/sdxl.py) train the XL way: both text encoders
(a LoRA on te2 beside te1's when the text encoder trains), the text_time
conditioning with per-image original-size and crop rows from the dataset
(the constant training-size row with cached latents), and artifacts in
the kohya-XL schema only.

Random draws come from torch.Generators: the LoRA init from seed, seed + 1
(te1) and seed + 2 (te2), the cached-latent encode from seed + 99, the
steps from seed + 7 (one generator the step draws from, saved in the train
state), the class images from seed + 1000 + s. The host reads the loss
only where lora_tpu does, at step 1 and every 10th step; in between
nothing waits for the device.

Across processes (parallel/mesh.py; lora_launch_torch): data_parallel
spreads the global batch (train_batch_size x dp) over the ranks, fsdp
shards the frozen base (its full weights wait in host memory for the run).
Every rank draws the same sample stream and random draws and keeps its
block, so the run is one process's at the global batch. Only rank 0 writes
(metrics, artifacts, train state, class images; the others wait at a
barrier), and a SIGTERM to any rank stops all of them at the same step.
With one rank data_parallel and fsdp are no mesh, as in lora_tpu;
tensor_parallel > 1 raises (ROADMAP Slice 7b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import time
from typing import Optional

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
    DreamBoothDataset,
    IMAGE_SUFFIXES,
    data_loader,
    device_prefetch,
    prefetch,
)
from ..data.png import _png_bytes
from ..formats import pt_io
from ..formats.kohya import save_kohya, save_kohya_xl
from ..formats.safetensors_io import (
    UNET_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
)
from ..models.clip import clip_text_forward, dual_encode
from ..models.vae import vae_encode
from ..parallel import mesh as mesh_lib
from ..utils.metrics import MetricsLogger
from .checkpoint import PreemptionGuard, load_train_state, save_train_state
from .loss import LossConfig, ids2_from_ids
from .optim import make_lr_schedule, make_optimizer
from .train_step import make_train_step, make_trainable


@dataclasses.dataclass
class DreamBoothConfig:
    instance_data_dir: str = ""
    output_dir: str = "./output"
    instance_prompt: str = ""
    with_prior_preservation: bool = False
    class_data_dir: Optional[str] = None
    class_prompt: Optional[str] = None
    num_class_images: int = 100
    prior_loss_weight: float = 1.0
    resolution: int = 512
    train_batch_size: int = 1
    learning_rate: float = 1e-4
    learning_rate_text: float = 5e-5
    train_text_encoder: bool = False
    lora_rank: int = 4
    max_train_steps: int = 800
    save_steps: int = 500
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_grad_norm: float = 1.0
    adam_weight_decay: float = 1e-2
    use_8bit_adam: bool = False  # blockwise-int8 Adam (optim low_memory)
    dataloader_num_workers: int = 0  # thread-pool sample decode (0 = serial)
    seed: int = 0
    color_jitter: bool = False
    h_flip: bool = False
    resume_unet: Optional[str] = None
    resume_text_encoder: Optional[str] = None
    resume_state: Optional[str] = None  # full train-state checkpoint
    save_train_state: bool = False
    output_format: str = "both"  # pt | safe | both
    # which modules carry LoRA: "default" (attention + GEGLU), "extended"
    # (+ ResnetBlock2D convs), or "locon" (the kohya full-conv superset,
    # saved in the kohya schema)
    lora_targets: str = "default"
    mixed_precision: Optional[str] = None  # None | "bf16"
    cached_latents: bool = False
    cache_text_embeddings: bool = True  # off when the text encoder trains
    # mesh flags (lora_tpu's, parallel/mesh.py): data_parallel and fsdp
    # over the process group (no mesh on one rank); tensor_parallel > 1 is
    # not ported (ROADMAP Slice 7b)
    data_parallel: bool = False
    preemption_sync_every: int = 10  # multi-process only
    fsdp: int = 1
    tensor_parallel: int = 1
    scale_lr: bool = False   # lr *= ga * per-device batch * dp
    sample_guidance_scale: float = 7.5
    sample_steps: int = 50


def generate_class_images(pipe, cfg: DreamBoothConfig) -> None:
    """Prior-preservation class images: num_class_images in
    class_data_dir, the missing ones sampled from class_prompt in batches
    of 4 and written as gen_{i}.png (lora_tpu writes JPEGs through
    Pillow)."""
    os.makedirs(cfg.class_data_dir, exist_ok=True)
    cur = len([f for f in os.listdir(cfg.class_data_dir)
               if f.lower().endswith(IMAGE_SUFFIXES)])
    need = cfg.num_class_images - cur
    if need <= 0:
        return
    print(f"Generating {need} class images for prior preservation...")
    bs = 4
    for s in range(0, need, bs):
        n = min(bs, need - s)
        gen = torch.Generator(pipe.device).manual_seed(cfg.seed + 1000 + s)
        imgs = pipe([cfg.class_prompt] * n,
                    num_inference_steps=cfg.sample_steps,
                    guidance_scale=cfg.sample_guidance_scale,
                    height=cfg.resolution, width=cfg.resolution,
                    generator=gen)
        for j in range(n):
            path = os.path.join(cfg.class_data_dir, f"gen_{cur + s + j}.png")
            with open(path, "wb") as f:
                f.write(_png_bytes((imgs[j] * 255).astype(np.uint8)))


def _is_xl(pipe) -> bool:
    return pipe.unet.cfg.addition_embed_type == "text_time"


def _check_xl(cfg: DreamBoothConfig) -> None:
    """lora_tpu's refusals of an SDXL run."""
    if cfg.output_format != "safe":
        raise ValueError(
            "SDXL training saves in the kohya-XL schema only; set "
            "output_format='safe' (the reference's indexed format has no "
            "second text encoder)")
    if cfg.resume_unet or cfg.resume_text_encoder:
        raise ValueError(
            "SDXL training does not support .pt adapter resume; use "
            "save_train_state/resume_state for run continuation")


def _text2_sites(pipe, cfg: DreamBoothConfig):
    """te2's sites of an SDXL pipe (None otherwise), as te1's are chosen."""
    if not _is_xl(pipe):
        return None
    t2cfg = pipe.text_encoder_2.cfg
    return (text_encoder_locon_sites(t2cfg) if cfg.lora_targets == "locon"
            else text_encoder_lora_sites(t2cfg))


def _sites(pipe, cfg: DreamBoothConfig):
    """(UNet sites, text-encoder sites) of cfg.lora_targets, with
    lora_tpu's refusals."""
    ucfg, tcfg = pipe.unet.cfg, pipe.text_encoder.cfg
    if cfg.lora_targets == "locon":
        if cfg.output_format != "safe":
            raise ValueError(
                "lora_targets='locon' saves in the kohya schema only; set "
                "output_format='safe' (the flat .pt list has no key names "
                "to carry the extra modules)")
        if cfg.resume_unet or cfg.resume_text_encoder:
            raise ValueError(
                "lora_targets='locon' does not support .pt adapter resume; "
                "use save_train_state/resume_state for run continuation")
        return unet_locon_sites(ucfg), text_encoder_locon_sites(tcfg)
    if cfg.lora_targets == "extended":
        return (unet_lora_sites(ucfg, set(UNET_EXTENDED_TARGET_REPLACE)),
                text_encoder_lora_sites(tcfg))
    if cfg.lora_targets == "default":
        return unet_lora_sites(ucfg), text_encoder_lora_sites(tcfg)
    raise ValueError(f"lora_targets must be default|extended|locon, "
                     f"got {cfg.lora_targets!r}")


def _check_unported(cfg: DreamBoothConfig) -> None:
    if cfg.tensor_parallel > 1:
        raise NotImplementedError(
            f"tensor_parallel={cfg.tensor_parallel}: {mesh_lib.NO_TP}")


def _cached_latents(pipe, ds, cfg, dtype):
    """Every example encoded once (its augmentation fixed at cache time):
    ([(latent, host ids)] of the instances, the same of the class
    images)."""
    vae_p, vae_cfg = pipe.vae.flat_params(), pipe.vae.cfg
    gen = torch.Generator(pipe.device).manual_seed(cfg.seed + 99)

    def encode_items(n_take, get):
        items = []
        for i in range(n_take):
            img, ids = get(i)
            x = torch.from_numpy(np.ascontiguousarray(img[None])).to(
                pipe.device, dtype)
            with torch.no_grad():
                lat = vae_encode(vae_p, x, vae_cfg, gen)[0]
            items.append((lat, np.asarray(ids, np.int64)))
        return items

    inst = encode_items(
        ds.num_instance_images,
        lambda i: (ds[i]["instance_images"], ds[i]["instance_prompt_ids"]))
    cls_items = []
    if cfg.with_prior_preservation:
        cls_items = encode_items(
            ds.num_class_images,
            lambda i: (ds[i]["class_images"], ds[i]["class_prompt_ids"]))
    return inst, cls_items


def _cached_loader(inst, cls_items, cfg, batch_size, device, ids_on_host,
                   shard=mesh_lib.BatchShard(0, 1)):
    """lora_tpu's cached-latent sample stream: random.Random(seed) picks
    batch_size (global) instance items (and as many class items), [instance
    | class]; every rank draws the same picks and keeps its block (shard:
    the dp index and count), so with prior preservation on two ranks one
    holds only instance rows and the other only class rows."""
    r = random.Random(cfg.seed)
    rows = 2 * batch_size if cfg.with_prior_preservation else batch_size
    per = rows // shard.count
    own = slice(shard.index * per, (shard.index + 1) * per)
    is_inst = torch.cat([torch.ones(batch_size), torch.zeros(batch_size)]
                        )[own].to(device) if cfg.with_prior_preservation \
        else None
    dev_ids = {}
    while True:
        picks = [inst[r.randrange(len(inst))] for _ in range(batch_size)]
        if cfg.with_prior_preservation:
            picks += [cls_items[r.randrange(len(cls_items))]
                      for _ in range(batch_size)]
        picks = picks[own]
        ids = np.stack([i for _, i in picks])
        if not ids_on_host:  # each row layout uploaded once
            key = ids.tobytes()
            if key not in dev_ids:
                dev_ids[key] = torch.from_numpy(ids).to(device)
            ids = dev_ids[key]
        batch = {"latents": torch.stack([lat for lat, _ in picks]),
                 "input_ids": ids}
        if is_inst is not None:
            batch["is_instance"] = is_inst
        yield batch


def train_dreambooth(pipe, cfg: DreamBoothConfig) -> dict:
    is_xl = _is_xl(pipe)
    if is_xl:
        _check_xl(cfg)
    _check_unported(cfg)
    os.makedirs(cfg.output_dir, exist_ok=True)
    device = pipe.device
    dtype = torch.bfloat16 if cfg.mixed_precision == "bf16" else torch.float32
    # only rank 0 writes to the shared output directory
    main = mesh_lib.is_main_process()
    log = MetricsLogger(os.path.join(cfg.output_dir, "metrics.jsonl")
                        if main else None, echo=main)

    if cfg.with_prior_preservation:
        if not (cfg.class_data_dir and cfg.class_prompt):
            raise ValueError("with_prior_preservation needs class_data_dir "
                             "and class_prompt")
        if main:
            generate_class_images(pipe, cfg)
        # the other ranks wait for the files before building the dataset
        mesh_lib.multihost_barrier("class_images")
    mesh = mesh_lib.mesh_from_flags(cfg.data_parallel, cfg.fsdp,
                                    cfg.tensor_parallel)
    mesh_lib.warm_collectives(mesh)  # in lockstep, before the first step
    dp = mesh_lib.data_parallel_size(mesh)
    shard = mesh_lib.batch_sharding(mesh)
    # per-chip batch semantics: every rank sees train_batch_size examples
    batch_size = cfg.train_batch_size * dp

    usites, tsites = _sites(pipe, cfg)
    tsites2 = _text2_sites(pipe, cfg)
    trainable = {"lora_unet": lora_core.init_lora(
        usites, r=cfg.lora_rank,
        generator=torch.Generator(device).manual_seed(cfg.seed),
        device=device)}
    if cfg.resume_unet:
        trainable["lora_unet"] = lora_core.lora_from_flat(
            pt_io.load_lora_pt(cfg.resume_unet), usites, device=device)
    if cfg.train_text_encoder:
        trainable["lora_text"] = lora_core.init_lora(
            tsites, r=cfg.lora_rank,
            generator=torch.Generator(device).manual_seed(cfg.seed + 1),
            device=device)
        if cfg.resume_text_encoder:
            trainable["lora_text"] = lora_core.lora_from_flat(
                pt_io.load_lora_pt(cfg.resume_text_encoder), tsites,
                device=device)
        if is_xl:
            trainable["lora_text2"] = lora_core.init_lora(
                tsites2, r=cfg.lora_rank,
                generator=torch.Generator(device).manual_seed(cfg.seed + 2),
                device=device)
    make_trainable(trainable)
    mesh_lib.replicate_tree(trainable, mesh)

    ds = DreamBoothDataset(
        instance_data_root=cfg.instance_data_dir,
        instance_prompt=cfg.instance_prompt,
        tokenizer=pipe.tokenizer,
        class_data_root=(cfg.class_data_dir if cfg.with_prior_preservation
                         else None),
        class_prompt=cfg.class_prompt,
        size=cfg.resolution,
        color_jitter=cfg.color_jitter,
        h_flip=cfg.h_flip,
        seed=cfg.seed,
        # SDXL: each image's [orig_h, orig_w, crop_top, crop_left] for the
        # text_time rows (cached latents fix the augmentation at cache time
        # and take the constant training-size row)
        return_geometry=is_xl and not cfg.cached_latents,
    )
    # frozen-text fast path: the prompts are fixed, so their embeddings are
    # constants, encoded once and CLIP leaves the loop
    cache_text = cfg.cache_text_embeddings and not cfg.train_text_encoder
    closers = []
    if cfg.cached_latents:
        inst, cls_items = _cached_latents(pipe, ds, cfg, dtype)
        loader = _cached_loader(inst, cls_items, cfg, batch_size, device,
                                ids_on_host=cache_text, shard=shard)
    else:
        # each dp index loads its block from its shard of the sample stream
        host = prefetch(data_loader(
            ds, batch_size // dp, seed=cfg.seed,
            prior_preservation=cfg.with_prior_preservation,
            process_index=shard.index, process_count=dp,
            num_workers=cfg.dataloader_num_workers))
        closers.append(host)
        loader = device_prefetch(
            host, device=device,
            keep_on_host=("input_ids",) if cache_text else ())
    closers.append(loader)

    lr_scale = (cfg.gradient_accumulation_steps * cfg.train_batch_size * dp
                if cfg.scale_lr else 1)
    lrs = {"lora_unet": make_lr_schedule(
        cfg.lr_scheduler, cfg.learning_rate * lr_scale, cfg.max_train_steps,
        cfg.lr_warmup_steps)}
    if cfg.train_text_encoder:
        for group in ("lora_text",) + (("lora_text2",) if is_xl else ()):
            lrs[group] = make_lr_schedule(
                cfg.lr_scheduler, cfg.learning_rate_text * lr_scale,
                cfg.max_train_steps, cfg.lr_warmup_steps)
    opt = make_optimizer(trainable, lrs,
                         weight_decay=cfg.adam_weight_decay,
                         max_grad_norm=cfg.max_grad_norm,
                         grad_accum=cfg.gradient_accumulation_steps,
                         low_memory="int8" if cfg.use_8bit_adam else False)
    loss_cfg = LossConfig(
        cached_latents=cfg.cached_latents,
        with_prior_preservation=cfg.with_prior_preservation,
        prior_loss_weight=cfg.prior_loss_weight,
        gradient_checkpointing=cfg.gradient_checkpointing,
    )
    eos = int(pipe.tokenizer.eos_token_id)
    step_fn = make_train_step(
        unet_cfg=pipe.unet.cfg, text_cfg=pipe.text_encoder.cfg,
        vae_cfg=pipe.vae.cfg, sched=pipe.schedule, loss_cfg=loss_cfg,
        optimizer=opt, dtype=dtype, mesh=mesh,
        text2_cfg=pipe.text_encoder_2.cfg if is_xl else None,
        eos_id=eos if is_xl else None)
    modules = ((pipe.unet, pipe.text_encoder)
               + ((pipe.text_encoder_2,) if is_xl else ()) + (pipe.vae,))
    base = tuple(m.flat_params() for m in modules)
    fsdp = mesh is not None and mesh.shape["fsdp"] > 1
    if fsdp:
        base = tuple(mesh_lib.shard_params(p, mesh, use_fsdp=True)
                     for p in base)

    @torch.no_grad()
    def save(step_tag: str, final=False):
        if not main:
            return
        name = "lora_weight" if final else f"lora_weight_s{step_tag}"
        path = os.path.join(cfg.output_dir, name)
        lu, lt = trainable.get("lora_unet"), trainable.get("lora_text")
        if is_xl:
            save_kohya_xl(path + ".safetensors", unet_cfg=pipe.unet.cfg,
                          lora_unet=lu, unet_sites=usites, lora_text=lt,
                          text_sites=tsites,
                          lora_text2=trainable.get("lora_text2"),
                          text2_sites=tsites2)
            return
        if cfg.lora_targets == "locon":
            save_kohya(path + ".safetensors", lora_unet=lu, unet_sites=usites,
                       lora_text=lt, text_sites=tsites)
            return
        if cfg.output_format in ("safe", "both"):
            save_all(path + ".safetensors", lora_unet=lu, unet_sites=usites,
                     lora_text=lt, text_sites=tsites, save_ti=False,
                     target_replace_module_unet=(
                         UNET_EXTENDED_TARGET_REPLACE
                         if cfg.lora_targets == "extended"
                         else UNET_DEFAULT_TARGET_REPLACE))
        if cfg.output_format in ("pt", "both"):
            save_all(path + ".pt", lora_unet=lu, unet_sites=usites,
                     lora_text=lt, text_sites=tsites, save_ti=False,
                     safe_form=False)

    text_emb_cache = {}

    @torch.no_grad()
    def encode_rows(ids_np: np.ndarray):
        ids = torch.from_numpy(ids_np).to(device)
        if is_xl:  # (context, te2's pooled rows), both cached
            return dual_encode(
                base[1], base[2], ids, ids2_from_ids(ids, eos),
                pipe.text_encoder.cfg, pipe.text_encoder_2.cfg, None, None,
                dtype, eos)
        return clip_text_forward(base[1], ids, pipe.text_encoder.cfg, None,
                                 dtype=dtype)

    def embed_ids(ids_np: np.ndarray):
        key = ids_np.tobytes()
        if key not in text_emb_cache:
            text_emb_cache[key] = encode_rows(ids_np)
        return text_emb_cache[key]

    const_time_ids = {}

    def add_time_ids(batch) -> torch.Tensor:
        """SDXL's (B, 6) text_time rows: each image's original size and
        crop corner from the dataset and the training size, or without
        geometry (cached latents) the constant training-size row."""
        geom = batch.pop("time_ids_geom", None)
        res = float(cfg.resolution)
        if geom is not None:
            return torch.cat([geom.float(), geom.new_full(
                (geom.shape[0], 2), res, dtype=torch.float32)], dim=1)
        n = batch["latents" if cfg.cached_latents else "pixel_values"
                  ].shape[0]
        if n not in const_time_ids:  # uploaded once per batch size
            const_time_ids[n] = torch.tensor(
                [[res, res, 0.0, 0.0, res, res]] * n, device=device)
        return const_time_ids[n]

    rng = torch.Generator(device).manual_seed(cfg.seed + 7)
    state_path = os.path.join(cfg.output_dir, "train_state.safetensors")
    start_step = 0
    if cfg.resume_state:
        start_step = load_train_state(cfg.resume_state, trainable, opt, rng)
        print(f"Resumed full train state at step {start_step}")

    ga = cfg.gradient_accumulation_steps
    t_start = time.perf_counter()
    global_step = start_step
    preempted = False
    loss = torch.tensor(float("nan"))  # defined even if the loop never runs
    # every rank stops at the same step, whichever got the signal
    stop = mesh_lib.PreemptionCoordinator(cfg.preemption_sync_every)
    try:
        with contextlib.ExitStack() as stack:
            if fsdp:  # the device keeps the shards; the pipe's full weights
                # wait on the host
                stack.enter_context(mesh_lib.host_offloaded(modules))
            guard = stack.enter_context(PreemptionGuard())
            for micro in range(start_step * ga, cfg.max_train_steps * ga):
                if stop.should_stop(guard.should_stop, micro):
                    # checkpoint the full train state so resume_state goes
                    # on exactly here
                    if main:
                        save_train_state(state_path, trainable, opt,
                                         global_step, rng)
                        save(f"preempt_{global_step}")
                        print(f"Preempted at step {global_step}; train "
                              "state saved")
                    preempted = True
                    break
                batch = next(loader)
                if cache_text:
                    emb = embed_ids(batch.pop("input_ids"))
                    if is_xl:
                        (batch["encoder_hidden_states"],
                         batch["add_text_embeds"]) = emb
                    else:
                        batch["encoder_hidden_states"] = emb
                if is_xl:
                    batch["add_time_ids"] = add_time_ids(batch)
                loss = step_fn(trainable, base, batch, generator=rng)
                if micro == start_step * ga:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    t_start = time.perf_counter()  # steps/s without warm-up
                if (micro + 1) % ga:
                    continue
                global_step += 1
                if global_step % 10 == 0 or global_step == 1:
                    lf = float(loss)
                    if not np.isfinite(lf):
                        raise FloatingPointError(
                            f"non-finite loss at step {global_step} — check "
                            "LR (reference guidance: ~1e-4 for LoRA) / data")
                    kw = dict(step=global_step, loss=lf)
                    if global_step > 1:  # step 1's window holds the warm-up
                        kw["sps"] = global_step / (time.perf_counter()
                                                   - t_start)
                    log.log(**kw)
                if cfg.save_steps and global_step % cfg.save_steps == 0:
                    save(str(global_step))
                    if cfg.save_train_state and main:
                        save_train_state(state_path, trainable, opt,
                                         global_step, rng)
                    if main:
                        with torch.no_grad():
                            moved = sorted(lora_core.inspect_lora(
                                trainable["lora_unet"]).items())[:4]
                        print("moved:", json.dumps(
                            {k: round(v[0], 6) for k, v in moved}))
    finally:
        for it in reversed(closers):  # ends the prefetch thread
            it.close()

    if not preempted:
        # a preempted run must not overwrite the completed-run artifact
        # with a partly trained adapter
        save("final", final=True)
    elapsed = time.perf_counter() - t_start
    result = {"steps": global_step, "seconds": elapsed,
              "steps_per_sec": global_step / max(elapsed, 1e-9),
              "preempted": preempted,
              "final_loss": float(loss)}
    log.log(**result)
    return {**result, "trainable": trainable}
