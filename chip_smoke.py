#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one CUDA device

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build: compiles the flash-attention forward kernel from
     lora_tpu_torch/ops/csrc/ with nvcc (sm_90a) into lora_tpu_torch/_build/.
  3. kernel: the kernel against its plain PyTorch version on the card at the
     SD-1.5 512px attention shapes, bf16 and f32, plus one ragged call;
     max abs errors and median times (CUDA events).
  4. slice: the SD-1.5 txt2img serving path at full width with random
     weights from a seed: a rank-4 LoRA + one TI embed saved to a
     .safetensors file and loaded with patch_pipe, 2 prompts, 512x512,
     50 DDIM steps, CFG 7.5. Checks the images and that every spatial
     self-attention of every UNet call went through the kernel.

Any failed check raises, so the script exits nonzero. The last line of
stdout is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lora_tpu_torch.ops import flash_attention as fa

SEED = 0
# max |kernel - plain| over O and over L. bf16: O is stored in bf16 (an ulp
# is 2^-8 relative) and P is rounded to bf16 before P.V, as in the TPU
# kernel, while the plain version keeps P in f32. f32: the same f32
# arithmetic summed in another order. The scores and L are f32 in both.
TOL = {torch.bfloat16: {"o": 2e-2, "lse": 1e-3},
       torch.float32: {"o": 1e-4, "lse": 1e-5}}
# SD-1.5 at 512px: 64x64 latents; the spatial self-attention levels the
# kernel serves (T = S = 64^2, 32^2, 16^2 tokens, 8 heads of 320/640/1280
# channels)
SD15_ATTN_SHAPES = ((4096, 40), (1024, 80), (256, 160))
RAGGED = (300, 77, 64)  # (T, S, D): masked tails in T, S and in the tiles
PROMPTS = ["a photo of <s1> dog", "a <s1> style town"]
STEPS = 50
# routed self-attentions per UNet call at 512px: 2 transformers in each of
# the 3 attention down blocks and 3 in each of the 3 attention up blocks;
# the 8x8 mid block (T = 64) and all cross-attention (S = 77) stay plain
ROUTED_PER_UNET_CALL = 15


def log(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    # the f32 checks compare true f32 arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = fa.build()
    log(f"build: {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _qkv(B, H, T, S, D, dtype, gen, heads_inner: bool):
    """q (B, H, T, D), k and v (B, H, S, D) on the card. heads_inner=True
    gives the UNet's layout: transposed views of (B, T, H, D) projections."""
    def make(L):
        if heads_inner:
            x = torch.randn((B, L, H, D), generator=gen, device="cuda")
            return x.to(dtype).transpose(1, 2)
        return torch.randn((B, H, L, D), generator=gen, device="cuda").to(dtype)

    return make(T), make(S), make(S)


def check_kernel(B, H, T, S, D, dtype, gen, heads_inner=True, timed=True):
    q, k, v = _qkv(B, H, T, S, D, dtype, gen, heads_inner)
    scale = D ** -0.5
    with torch.inference_mode():
        o, lse = fa.flash_attention(q, k, v, scale)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        row = {"B": B, "H": H, "T": T, "S": S, "D": D,
               "dtype": str(dtype).replace("torch.", ""),
               "err_o": err_o, "err_lse": err_l}
        if timed:
            row["ms"] = _time_ms(lambda: fa.flash_attention(q, k, v, scale))
            row["plain_ms"] = _time_ms(
                lambda: fa.flash_attention_reference(q, k, v, scale))
    tol = TOL[dtype]
    log("kernel: " + json.dumps(row))
    if not (np.isfinite(err_o) and np.isfinite(err_l)
            and err_o <= tol["o"] and err_l <= tol["lse"]):
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{row} limits {tol}")
    return row


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_kernel(4, 8, T, T, D, dtype, gen))
        T, S, D = RAGGED
        check_kernel(1, 2, T, S, D, dtype, gen, heads_inner=False,
                     timed=False)
    return rows


def _random_lora_file(pipe, path, gen):
    """A rank-4 LoRA over the default UNet and text-encoder sites with
    nonzero up factors, plus one TI embed, in the indexed safetensors
    schema."""
    from lora_tpu_torch.core.lora import init_lora, lora_to_pairs
    from lora_tpu_torch.formats.safetensors_io import (
        TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
        UNET_DEFAULT_TARGET_REPLACE,
        save_safeloras_with_embeds,
    )

    modelmap = {}
    for model, sites, target in (
            ("unet", pipe.unet_sites(), UNET_DEFAULT_TARGET_REPLACE),
            ("text_encoder", pipe.text_sites(),
             TEXT_ENCODER_DEFAULT_TARGET_REPLACE)):
        lora = init_lora(sites, r=4, generator=gen, device="cuda")
        for entry in lora["sites"].values():
            entry["up"] = 0.05 * torch.randn(
                entry["up"].shape, generator=gen, device="cuda")
        modelmap[model] = (lora_to_pairs(lora, sites), target)
    hidden = pipe.text_encoder.cfg.hidden_size
    embeds = {"<s1>": torch.randn((hidden,), generator=gen, device="cuda")
              .cpu().numpy()}
    save_safeloras_with_embeds(modelmap, embeds, path)


def phase_slice(smi: str):
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    gen = torch.Generator("cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.random_init(
        generator=gen, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lora.safetensors")
        _random_lora_file(pipe, path, gen)
        embeds = pipe.patch_pipe(path)
    pipe.tune_lora_scale(0.8)
    if list(embeds) != ["<s1>"] or pipe.lora_unet is None or \
            pipe.lora_text is None:
        raise AssertionError(f"patch_pipe loaded {list(embeds)}, "
                             f"unet={pipe.lora_unet is not None}, "
                             f"text={pipe.lora_text is not None}")
    torch.cuda.synchronize()
    log(f"slice: SD-1.5 bf16 pipeline built and patched in "
        f"{time.perf_counter() - t0:.1f} s")

    def run():
        lat_gen = torch.Generator("cuda").manual_seed(SEED + 1)
        return pipe(PROMPTS, num_inference_steps=STEPS, guidance_scale=7.5,
                    height=512, width=512, generator=lat_gen)

    want = ROUTED_PER_UNET_CALL * STEPS
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    first = run()
    cold_s = time.perf_counter() - t0
    if fa.flash_attention.launches != want:
        raise AssertionError(f"warm-up call launched the kernel "
                             f"{fa.flash_attention.launches} times, not {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0  # the counted main-path run
    t0 = time.perf_counter()
    images = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != want:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times, not {want}")
    if images.shape != (len(PROMPTS), 512, 512, 3):
        raise AssertionError(f"images have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0):
        raise AssertionError("images are not finite values in [0, 1]")

    # one UNet call with the LoRA differs from one without it
    with torch.inference_mode():
        ctx = pipe.encode_prompt(PROMPTS)
        lat = pipe.prepare_latents(len(PROMPTS), 512, 512,
                                   torch.Generator("cuda").manual_seed(SEED))
        t = torch.full((len(PROMPTS),), 501, device="cuda")
        with_lora = pipe.unet(lat, t, ctx, lora=pipe.lora_unet)
        pipe.remove_lora()
        without = pipe.unet(lat, t, ctx, lora=None)
        lora_diff = (with_lora.float() - without.float()).abs().max().item()
    if not lora_diff > 0.0:
        raise AssertionError("the UNet's output ignores the LoRA")
    log("slice: " + json.dumps({
        "images": list(images.shape), "min": float(images.min()),
        "max": float(images.max()), "steps": STEPS, "cfg": 7.5,
        "cold_s": cold_s, "warm_s": warm_s, "peak_mem_gib": peak_gib,
        "launches": launches, "unet_lora_max_diff": lora_diff,
        "rerun_max_diff": float(np.abs(images - first).max()),
        "card": smi}))
    return launches


def main() -> int:
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_slice(smi)
    main_shape = next(r for r in rows if r["dtype"] == "bfloat16"
                      and r["T"] == SD15_ATTN_SHAPES[0][0])
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:104",
        "launches": launches,
        # worst O error over the bf16 shapes the main path runs
        "max_abs_err": max(r["err_o"] for r in rows
                           if r["dtype"] == "bfloat16"),
        # median per launch at the largest main-path shape, bf16
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
