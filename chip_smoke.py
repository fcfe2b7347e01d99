#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one CUDA device
    python3 chip_smoke.py --int8        # phases 1, 2 (int8 sources only), 8
    python3 chip_smoke.py --int8-tiles  # the same, then every wgmma tile
                                        # instance at every phase 8 shape
                                        # (the data of int8_matmul._TILE_US)
    python3 chip_smoke.py --flash       # phases 1, 2 (the three forward
                                        # sources only), the wgmma and
                                        # tf32x3 forward kernels' first
                                        # calls in child processes under a
                                        # timeout, 3 and its sums over one
                                        # UNet call (bf16 and f32) and one
                                        # f32 training step
    python3 chip_smoke.py --flash-bwd   # phases 1, 2 (flash_fwd.cu,
                                        # flash_fwd_wgmma.cu,
                                        # flash_fwd_tf32x3.cu, flash_bwd.cu,
                                        # flash_bwd_dkv_wgmma.cu,
                                        # flash_bwd_dq_wgmma.cu,
                                        # flash_bwd_dkv_tf32x3.cu,
                                        # flash_bwd_dkv_tf32x3_wide.cu,
                                        # flash_bwd_dq_tf32x3.cu and
                                        # flash_bwd_dq_tf32x3_wide.cu only),
                                        # the tf32x3 forward, wgmma dQ,
                                        # wgmma dK/dV, tf32x3 dQ, tf32x3
                                        # dK/dV, tf32x3_wide dQ and
                                        # tf32x3_wide dK/dV kernels' first
                                        # calls in child processes under a
                                        # timeout, 4 and its sums over one
                                        # training step (bf16 and f32)

Phases, each printing its own lines (about 5 minutes on one H100, most of
it the build of the kernels):
  1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build: compiles every kernel of lora_tpu_torch/ops/csrc/
     (flash_fwd.cu, flash_fwd_wgmma.cu, flash_fwd_tf32x3.cu, flash_bwd.cu,
     flash_bwd_dkv_wgmma.cu, flash_bwd_dq_wgmma.cu,
     flash_bwd_dkv_tf32x3.cu, flash_bwd_dkv_tf32x3_wide.cu,
     flash_bwd_dq_tf32x3.cu, flash_bwd_dq_tf32x3_wide.cu, int8_matmul.cu,
     int8_matmul_wgmma.cu; one
     nvcc each, in parallel) for sm_90a into the build directory, and
     prints ptxas's registers, shared memory and spills of the wgmma and
     tf32x3 kernels and each tf32x3 forward and backward instance's tiles;
     then the tf32x3 forward kernel's first calls (f32: the ragged call,
     the main serving shape and D = 160), the wgmma dQ kernel's first
     calls (that kernel alone), the wgmma dK/dV kernel's,
     the tf32x3 dQ kernel's (f32, that kernel alone), the tf32x3 dK/dV
     kernel's (f32), the tf32x3_wide dQ kernel's (f32, D = 104 and 160:
     its cluster pair, that kernel alone) and the tf32x3_wide dK/dV
     kernel's (f32, D = 160), each in a child process under a timeout.
  3. kernel: the forward kernels against their plain PyTorch version on the
     card at the SD-1.5 512px self-attention shapes, bf16 at the serving
     batch (4) and the training batch (1), each call through the wgmma
     kernel (flash_fwd_wgmma.cu; also called directly at the other q-tile
     height, and the mma kernel flash_fwd.cu on the same inputs), the same
     untimed at the other UNet batches of the main paths (8 and 2), plus
     the ragged call, one contiguous (B, H, T, D) call and a ragged call at
     every D the wgmma kernel takes (8 to 160); f32 the same way through
     the tf32x3 kernel (flash_fwd_tf32x3.cu: at the three levels at batch
     4 and 1, the ragged call, a ragged call at every D it takes, 8 to 160,
     and untimed long calls at SD-2.1's 768px level and at D = 160 over
     T = S = 4096). Every flash forward call of phases 5 to 9 is recorded
     (shapes, dtype, strides), and one that phase 3 did not check fails
     the run. Max abs errors; median times of the routed kernel through its
     C entry point (and its device time from CUDA-graph replays), the
     wrapper, the mma kernel on the same inputs, torch's SDPA (timed only),
     the plain version, the FLOP bound (f32: 3xTF32 at the TF32 rate, and
     the FFMA bound) and the exponential floor; their sums over one UNet
     call (5 launches per level), bf16 and f32 (at batch 1: the forward of
     one f32 training step).
  4. bwd kernel: the dQ and dK/dV kernels against their plain versions at
     the SD-1.5 training shapes (batch 1; bf16 also untimed at batch 2),
     bf16 and f32, plus the ragged call, a ragged call at every D the
     wgmma backward kernels take (8 to 160) and at every f32 D the tf32x3
     and tf32x3_wide kernels take (8 to 160), f32 at SD-2.1's 768px level
     (H = 5, T = S = 9216, D = 64; untimed) and at SD-1.5's widest heads
     over 4096 rows (H = 8, T = S = 4096, D = 160; untimed); each
     flash_bwd_dq and flash_bwd_dkv call must launch the kernel
     _dq_route / _bwd_route picks (bf16: flash_bwd_dq_wgmma.cu and
     flash_bwd_dkv_wgmma.cu, each also called directly at both tile
     heights, and the mma kernels of flash_bwd.cu on the same inputs; f32
     at D <= 96: flash_bwd_dq_tf32x3.cu and flash_bwd_dkv_tf32x3.cu, each
     also called directly at its tile heights, with both mma kernels on
     the same inputs; f32 at 96 < D <= 160: flash_bwd_dq_tf32x3_wide.cu
     and flash_bwd_dkv_tf32x3_wide.cu, each also called directly, with
     both mma kernels on the same inputs; else the mma kernels). Relative
     errors; at the training levels, median times
     of both dQ and both dK/dV kernels through their C entry points and as
     device time (CUDA-graph replays), the wgmma and tf32x3 kernels'
     device time at their other tile height, the tf32x3 kernels' shared
     hi/lo split (once per backward call; where both kernels read it, also
     the dK/dV part alone), the two wrappers, the plain
     versions, one autograd.grad of a retained SDPA graph (dQ, dK, dV
     together, bf16 and f32; timed only, its device time from
     torch.profiler), the FLOP bounds (tf32x3 and tf32x3_wide: at the TF32
     rate, beside their FFMA bound) and the exponential floor; their sums
     over one training step (5 launches of each kernel per level), bf16
     and f32.
  5. slice: the SD-1.5 txt2img serving path at full width with random
     weights from a seed: a rank-4 LoRA + one TI embed saved to a
     .safetensors file and loaded with patch_pipe, 2 prompts, 512x512,
     50 DDIM steps, CFG 7.5. Checks the images and that every spatial
     self-attention of every UNet call went through the wgmma forward
     kernel.
  6. train: the DreamBooth-LoRA step of bench.py at full SD-1.5 width
     (bf16, 512px, batch 1, rank-4 LoRA on the default UNet sites, cached
     latents and text embeddings, AdamW lr 1e-4, clip 1.0) through
     make_optimizer and make_train_step: 3 warm-up and 10 timed steps.
     Checks finite losses, moved LoRA up leaves, and 15 forward (all
     wgmma), 15 dQ and 15 dK/dV launches per step (dQ: wgmma at every
     D <= WGMMA_DQ_MAX_D; dK/dV: at every D <= WGMMA_DKV_MAX_D); prints
     step time, steps/s, peak memory; then one more warm step under
     torch.profiler: its device time by kernel class, busy share and
     longest kernels.
  7. grad: one loss-and-backward on a LoRA with nonzero up factors and
     fixed draws, through the kernels and through the plain attention path:
     the relative L2 distance of the two LoRA gradients; then the same with
     gradient checkpointing: the same loss, and 30 forward launches (every
     forward launch of the phase wgmma, every dQ and dK/dV launch as in
     phase 6). Then the same in f32 (the trainer's default dtype, the
     counted f32 path: 15 forward launches through flash_fwd_tf32x3.cu;
     of dQ 10 through flash_bwd_dq_tf32x3.cu (D = 40, 80) and 5 through
     flash_bwd_dq_tf32x3_wide.cu (D = 160); of dK/dV 10 through
     flash_bwd_dkv_tf32x3.cu and 5 through flash_bwd_dkv_tf32x3_wide.cu
     (D = 160); none through the mma kernels;
     the LoRA gradients within 1e-3), and 3 warm-up and 5 timed f32
     training steps (AdamW 1e-4, clip 1.0), each with those launches:
     their median.
  8. int8 kernel: the int8-weight matmul against its plain version at
     every (M, K, N) phase 9 runs (UNet at batch 2, 4 and 8, CLIP, the VAE
     decoder's attention), bf16 (each call must launch the wgmma kernel,
     int8_matmul_wgmma.cu) and f32 (the mma.sync kernel, int8_matmul.cu),
     plus ragged calls routed to each kernel and an unaligned bf16 call
     (mma); relative errors. At request A's shapes, median times of the
     routed kernel, of the mma kernel called directly on the same bf16
     inputs, of cuBLAS (F.linear on the dequantized bf16 weight), of the
     plain version, and the bound; their sums over one UNet call at
     batch 4. Every int8 call of phases 9 and 9a is recorded, and one at a
     shape not checked here fails the run.
  9a. serve_int8 f32: the SD-1.5 UNet in f32, quantized: one call at
     batch 4, within relative L2 5e-2 of the f32 UNet, 182 launches, all
     of the mma kernel (f32 x), and 15 flash forward launches, all of the
     tf32x3 kernel (flash_fwd_tf32x3.cu: f32).
  9. serve_int8: quantized serving at full SD-1.5 width through HTTP. The
     slice's bf16 pipeline with the LoRA + TI at scale 0.8, then
     quantize_base(): param bytes before and after (UNet <= 0.55x), one
     UNet call at batch 4 within relative L2 5e-2 of the bf16 one and 182
     int8 launches; a PipelineServer on localhost (max_batch 4, 500 ms
     window) warmed up, then request A (the 2 prompts, 50 steps, CFG 7.5):
     two 512x512 PNGs, exactly the int8 launches the weights imply (all of
     the wgmma kernel) and 750 forward-attention launches (all wgmma),
     pixels equal to
     the pipeline called directly; request B (4 concurrent one-prompt
     requests) coalesced into one device batch of 4; healthz, metrics and
     drain.

Any failed check raises, so the script exits nonzero. The last line of
stdout is {"ok": true, "device": {...}}; the line before it is the card
line from nvidia-smi, and the one before that lists the kernels with their
launch counts, errors, times, bounds and library times.
"""

from __future__ import annotations

import base64
import contextlib
import ctypes
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from lora_tpu_torch.ops import build as kernel_build
from lora_tpu_torch.ops import flash_attention as fa
from lora_tpu_torch.ops import int8_matmul as i8

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
FLASH_D_SWEEP = (200, 130)  # (T, S) of the sweep over the wgmma kernel's D
# (H, T = S, D) of SD-2.1's spatial self-attention at 768px (96x96 latents,
# 5 heads of 64 channels at the first level): the longest f32 sums the
# tf32x3 backward kernels run on a supported model
SD21_768_LEVEL = (5, 9216, 64)
# (H, T = S, D) of a long f32 call at SD-1.5's widest heads (its D = 160
# level, 256 tokens at 512px and 1024 at 1024px, here at 4096): the
# tf32x3_wide kernel's per-tile sums over 4096 q rows
WIDE_LONG_LEVEL = (8, 4096, 160)
# max |kernel - plain| / max |plain| of dQ, dK and dV, on the same inputs.
# bf16: the gradients are stored in bf16 (an ulp is 2^-8 = 3.9e-3 relative)
# and P and dS are rounded to bf16 before their products in both versions,
# but a value that lands on the other side of a rounding boundary changes by
# an ulp and the f32 sums run in another order; dQ is rounded twice (before
# and after the scale). 3e-2 is the forward's O limit (2e-2 absolute on
# outputs of magnitude ~1) with room for that second rounding. f32: the same
# f32 arithmetic summed in another order over up to 4096 terms.
BWD_REL_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
PROMPTS = ["a photo of <s1> dog", "a <s1> style town"]
STEPS = 50
# routed self-attentions per UNet call at 512px: 2 transformers in each of
# the 3 attention down blocks and 3 in each of the 3 attention up blocks;
# the 8x8 mid block (T = 64) and all cross-attention (S = 77) stay plain
ROUTED_PER_UNET_CALL = 15
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_F32_WARMUP, TRAIN_F32_STEPS = 3, 5  # phase 7's timed f32 steps
# relative L2 distance of the full-width LoRA gradient through the kernels
# from the one through the plain attention path (bf16 model, f32 LoRA
# leaves). The two paths round P, O and the attention gradients to bf16 at
# different places (2^-8 = 3.9e-3 relative each), and those differences
# pass through the backward of 16 transformer blocks and 25 resnets before
# they reach a LoRA leaf: a few parts in 100 bounds that; an attention
# gradient that is wrong in any one block moves the LoRA gradient by O(1).
GRAD_REL_L2_TOL = 5e-2
# the same in f32 (flash_fwd.cu and flash_bwd.cu's f32 kernels against the
# plain path): both keep every value in f32 and differ only in the order
# of their sums, which the backward carries to the LoRA leaves at a few
# parts in 1e5; 1e-3 leaves room and still catches any wrong block
GRAD_F32_REL_L2_TOL = 1e-3
# the same step with gradient checkpointing recomputes the same forward on
# the same inputs: the loss agrees to f32 rounding of the bf16 model's sums
REMAT_LOSS_RTOL = 1e-3
# max |kernel - plain| / max |plain| of the int8 matmul. Both round x to
# bf16 and sum exact bf16 x int8 products in f32, in another order (up to
# K = 5120 terms). f32 outputs: that order alone, 1e-5. bf16 outputs: the
# one rounding to bf16 (2^-8 = 3.9e-3 relative) may land on either side.
INT8_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# (M, K, N) that are not on the path, with the kernel each routes to:
# masked M and N tails and a K tail (48 < 64) through the TMA ring's zero
# fill; N % 8 != 0, K % 16 != 0 (W read element by element) and odd K (x
# too) through the mma kernel
INT8_RAGGED = (((7, 64, 72), "wgmma"), ((100, 320, 320), "wgmma"),
               ((16383, 320, 2560), "wgmma"), ((33, 48, 40), "wgmma"),
               ((7, 64, 77), "mma"), ((33, 40, 48), "mma"),
               ((5, 13, 9), "mma"))
INT8_MAIN_SHAPE = (16384, 320, 2560)  # the GEGLU projection at 64x64
# the card's published dense peaks (H100 SXM, NVIDIA's data sheet): the
# bound of a kernel is the larger of its FLOPs over the bf16 tensor-core
# rate and its bytes (each input read once, each output written once) over
# the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: the f32 mma kernel's FMAs
PEAK_TF32_FLOPS = 495e12  # dense TF32: the tf32x3 kernel's three products
PEAK_BYTES = 3.35e12
# exponentials per clock per SM (the SFU's ex2): the softmax's B*H*T*S
# exponentials at the card's maximum SM clock bound the forward kernel too
EXP_PER_CLOCK_PER_SM = 16
# the quantized UNet call at batch 4 against the bf16 one on the same
# inputs: per-channel int8 weights (half a step of 1/127 of each channel's
# largest value) through 16 transformers and 22 resnets
QUANT_UNET_REL_L2_TOL = 5e-2
QUANT_UNET_BYTES_MAX = 0.55  # of the bf16 UNet's parameter bytes
# 2-D int8 dense weights of SD-1.5 after quantize_base(), one int8_matmul
# launch each per call: UNet (16 transformers: q/k/v/out x 2 attentions,
# GEGLU proj, ff net.2; 22 resnets: time_emb_proj), CLIP (12 layers: q/k/v/
# out, fc1, fc2), the VAE decoder's mid-block attention (q/k/v/out)
INT8_PER_CALL = {"unet": 182, "clip_encode": 72, "vae_decode": 4}
B_REQUESTS = 4  # request B: concurrent one-prompt requests, one device batch


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


def phase_build(stems=None) -> None:
    """Builds the given csrc stems (all when None), one nvcc each, in
    parallel; prints ptxas's report of the wgmma kernels and the int8 mma
    kernel."""
    t0 = time.perf_counter()
    paths = kernel_build.build(stems)
    log(f"build: {sorted(os.path.relpath(p) for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for stem in ("int8_matmul", "int8_matmul_wgmma", "flash_fwd_wgmma",
                 "flash_fwd_tf32x3", "flash_bwd_dkv_wgmma",
                 "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3_wide",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3_wide"):
        if stem in paths:
            with open(paths[stem][:-3] + ".log") as f:
                for line in f:
                    if any(w in line for w in ("Compiling", "Used", "spill",
                                               "arning", "Potential")):
                        log(f"build: {stem}: {line.strip()}")
    # each wgmma backward instance's streamed tile (q rows for dK/dV, kv
    # rows for dQ), ring depth and dynamic shared memory (ptxas reports
    # static shared memory only); the tf32x3 kernels' also the rows a CTA
    # holds (kv rows for dK/dV, q rows for dQ and the forward; the
    # tf32x3_wide kernels' kv or q rows per cluster pair, and the dQ one's
    # column boxes of rank 0); the tf32x3 forward's kv rows per stage and
    # its split ring's depth
    for stem, keys, min_d, max_d, step in (
            ("flash_fwd_tf32x3", ("BN", "stages", "smem_bytes", "BM_MAX"), 8,
             fa.WGMMA_F32_FWD_MAX_D, 8),
            ("flash_bwd_dkv_wgmma", ("BQ", "stages", "smem_bytes"), 16,
             fa.WGMMA_DKV_MAX_D, 16),
            ("flash_bwd_dq_wgmma", ("BN", "stages", "smem_bytes"), 16,
             fa.WGMMA_DQ_MAX_D, 16),
            ("flash_bwd_dkv_tf32x3", ("BQ", "stages", "smem_bytes",
                                      "BN_MAX"), 8, fa.WGMMA_F32_DKV_MAX_D,
             8),
            ("flash_bwd_dkv_tf32x3_wide", ("BQ", "stages", "smem_bytes",
                                           "BN"),
             fa.WGMMA_F32_DKV_MAX_D + 8, fa.WGMMA_F32_DKV_WIDE_MAX_D, 8),
            ("flash_bwd_dq_tf32x3", ("BN", "stages", "smem_bytes",
                                     "BM_MAX"), 8, fa.WGMMA_F32_DQ_MAX_D, 8),
            ("flash_bwd_dq_tf32x3_wide", ("BN", "stages", "smem_bytes", "BM",
                                          "NB0"),
             fa.WGMMA_F32_DQ_MAX_D + 8, fa.WGMMA_F32_DQ_WIDE_MAX_D, 8)):
        if stem not in paths:
            continue
        config = getattr(kernel_build.load_library(stem), stem + "_config")
        config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        for dp in range(min_d, max_d + 1, step):
            out = (ctypes.c_int * (1 + len(keys)))()
            if config(dp, out) != 0:
                raise AssertionError(f"no {stem} instance for D = {dp}")
            log(f"build: {stem}: " + json.dumps(dict(zip(("DP", *keys),
                                                         out))))


def _bound(flops: float, nbytes: float,
           peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the FLOPs over
    the peak for their type (bf16 tensor cores by default) and the bytes
    over the memory rate, and which it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def _kernel_ms(fn, reps: int = 10) -> float:
    """Device time per call from torch.profiler: the kernels of `reps`
    calls (after one warm-up), their device times summed, over `reps`. For
    work a CUDA graph cannot capture."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / (
                   1e3 * reps)


_capture_stream = None  # the one stream of every capture (see _graph_ms)


def _graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time per call: n calls captured in one CUDA graph, the median
    over `reps` replays divided by n. Unlike _time_ms, no host launch path
    between the two events. Every capture runs on one side stream: cuBLAS
    keeps a workspace for each stream it has run on until the process
    ends, so a new stream per capture would hold ~1 GiB by phase 9."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    fn()
    torch.cuda.synchronize()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def _qkv(B, H, T, S, D, dtype, gen, heads_inner: bool):
    """q (B, H, T, D), k and v (B, H, S, D) on the card. heads_inner=True
    gives the UNet's layout: transposed views of (B, T, H, D) projections."""
    def make(L):
        if heads_inner:
            x = torch.randn((B, L, H, D), generator=gen, device="cuda")
            return x.to(dtype).transpose(1, 2)
        return torch.randn((B, H, L, D), generator=gen, device="cuda").to(dtype)

    return make(T), make(S), make(S)


_clock_hz = None


def _exp_floor_ms(B, H, T, S) -> float:
    """The least time the card's exponential units take for the softmax's
    B*H*T*S exponentials: 16 a clock per SM at the maximum SM clock
    (nvidia-smi)."""
    global _clock_hz
    if _clock_hz is None:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.split()[0]
        _clock_hz = float(mhz) * 1e6
    sms = i8._sm_count(torch.device("cuda"))
    return 1e3 * B * H * T * S / (sms * EXP_PER_CLOCK_PER_SM * _clock_hz)


def _only(route: str, n: int) -> dict:
    """flash_fwd.launches_by_kernel as a run that launched `route` n times
    and no other forward kernel leaves it (from zero)."""
    return {**dict.fromkeys(fa.flash_fwd.launches_by_kernel, 0), route: n}


def _flash_key(q, k, v):
    """What a forward launch depends on: the shapes, the dtype and the
    strides of q, k and v (the wgmma kernel's tensor maps are built from
    them)."""
    B, H, T, D = q.shape
    return (B, H, T, k.shape[2], D, str(q.dtype).replace("torch.", ""),
            tuple(tuple(t.stride()) for t in (q, k, v)))


def _row_key(row):
    return (row["B"], row["H"], row["T"], row["S"], row["D"], row["dtype"],
            tuple(tuple(s) for s in row["strides"]))


@contextlib.contextmanager
def recording_flash_shapes(seen: set):
    """Adds _flash_key of every flash forward call made inside on CUDA
    tensors to `seen` (through the route lookup flash_fwd makes; the wrapper
    and its counts are unchanged)."""
    route = fa._fwd_route

    def recorded(q, k, v):
        seen.add(_flash_key(q, k, v))
        return route(q, k, v)

    fa._fwd_route = recorded
    try:
        yield seen
    finally:
        fa._fwd_route = route


def _errs(got, want):
    (o, lse), (o_ref, lse_ref) = got, want
    return ((o.float() - o_ref.float()).abs().max().item(),
            (lse - lse_ref).abs().max().item())


def _fwd_want(dtype, D: int) -> str:
    """The forward kernel a call with TMA-able layouts takes: bf16 the wgmma
    kernel to WGMMA_MAX_D, f32 the tf32x3 kernel to WGMMA_F32_FWD_MAX_D,
    else the mma kernel (flash_fwd.cu)."""
    if dtype == torch.bfloat16:
        return "wgmma" if D <= fa.WGMMA_MAX_D else "mma"
    return "tf32x3" if D <= fa.WGMMA_F32_FWD_MAX_D else "mma"


def check_kernel(B, H, T, S, D, dtype, gen, heads_inner=True, timed=True):
    """flash_fwd against its plain version: the call must launch the kernel
    _fwd_want names (bf16 wgmma, f32 tf32x3). Where that is the wgmma or the
    tf32x3 kernel it also checks it at the other q-tile height (where the
    instance holds 128 rows) and the mma kernel (flash_fwd.cu) on the same
    inputs. Timed: the routed kernel through its C entry point (and its
    device time from CUDA-graph replays), the wrapper, the mma kernel on the
    same inputs, SDPA, the plain version, the FLOP bound (f32: 3xTF32 at the
    dense TF32 rate, beside the FFMA bound at the f32 rate) and the
    exponential floor."""
    q, k, v = _qkv(B, H, T, S, D, dtype, gen, heads_inner)
    scale = D ** -0.5
    bf16 = dtype == torch.bfloat16
    route = _fwd_want(dtype, D)
    with torch.inference_mode():
        before = dict(fa.flash_fwd.launches_by_kernel)
        got = fa.flash_fwd(q, k, v, scale)
        ran = [r for r, n in fa.flash_fwd.launches_by_kernel.items()
               if n != before[r]]
        want = fa.flash_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err_o, err_l = _errs(got, want)
        row = {"B": B, "H": H, "T": T, "S": S, "D": D,
               "dtype": str(dtype).replace("torch.", ""),
               "strides": [list(t.stride()) for t in (q, k, v)],
               "kernel": ran, "err_o": err_o, "err_lse": err_l}
        checked = [(err_o, err_l)]
        direct = {}
        if route != "mma":
            sms = i8._sm_count(q.device)
            bm = (fa._fwd_bm(T, B * H, sms) if bf16
                  else fa._fwd_tf32x3_bm(T, B * H, D, sms))
            row["bm"] = bm
            if bf16 or D <= fa.TF32X3_FWD_BM128_MAX_D:
                direct["other_bm"] = lambda: fa._fwd_launch(
                    route, q, k, v, scale, 192 - bm)
            direct["prev"] = lambda: fa._fwd_launch("mma", q, k, v, scale)
        for name, call in direct.items():
            e = _errs(call(), want)
            row[f"err_o_{name}"], row[f"err_lse_{name}"] = e
            checked.append(e)
        if timed:
            calls = {"": lambda: fa._fwd_launch(route, q, k, v, scale),
                     "library_": lambda: torch.nn.functional.
                     scaled_dot_product_attention(q, k, v, scale=scale)}
            if route != "mma":
                calls["prev_"] = direct["prev"]
            for name, call in calls.items():
                row[name + "ms"] = _time_ms(call)
                row[name + "device_ms"] = _graph_ms(call)
            row["wrapper_ms"] = _time_ms(lambda: fa.flash_fwd(q, k, v, scale))
            row["plain_ms"] = _time_ms(
                lambda: fa.flash_attention_reference(q, k, v, scale))
            e = q.element_size()
            # Q K^T and P V; q, k, v read, O and the f32 L written
            flops = 4 * B * H * T * S * D
            nbytes = e * B * H * (2 * T + 2 * S) * D + 4 * B * H * T
            if bf16:
                row.update(_bound(flops, nbytes))
            else:
                # on CUDA-core FMAs (the mma kernel's bound), and as 3xTF32
                # (three tf32 products for each) at the dense TF32 rate
                ffma = _bound(flops, nbytes, PEAK_F32_FLOPS)
                row["ffma_bound_ms"] = ffma["bound_ms"]
                row["ffma_bound_by"] = ffma["bound_by"]
                row.update(_bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
                           if route == "tf32x3" else ffma)
            row["exp_floor_ms"] = _exp_floor_ms(B, H, T, S)
    tol = TOL[dtype]
    log("kernel: " + json.dumps(row))
    if ran != [route] or not all(
            np.isfinite(eo) and np.isfinite(el) and eo <= tol["o"]
            and el <= tol["lse"] for eo, el in checked):
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"or ran another kernel than {route}: {row} "
                             f"limits {tol}")
    return row


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = []
    for B in (4, 1):  # serving, training
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_kernel(B, 8, T, T, D, torch.bfloat16, gen))
    # the other UNet batches of the main paths: the server's warm-up
    # buckets and request B (2 and 8 rows under CFG), the LoRA check of
    # phase 5 (2 rows, no CFG)
    for B in (8, 2):
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_kernel(B, 8, T, T, D, torch.bfloat16, gen,
                                     timed=False))
    T, S, D = RAGGED
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_kernel(1, 2, T, S, D, dtype, gen,
                                 heads_inner=False, timed=False))
    # one contiguous (B, H, T, D) call at a main-path shape
    rows.append(check_kernel(4, 8, 1024, 1024, 80, torch.bfloat16, gen,
                             heads_inner=False, timed=False))
    # every D the route sends to the wgmma kernel (each of its instances),
    # with ragged T and S
    for D in range(8, fa.WGMMA_MAX_D + 1, 8):
        rows.append(check_kernel(1, 2, *FLASH_D_SWEEP, D, torch.bfloat16,
                                 gen, timed=False))
    # f32 (the trainer's default) at the serving batch (phase 9a's f32 UNet
    # call) and the training batch (phase 7's f32 training run)
    for B in (4, 1):
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_kernel(B, 8, T, T, D, torch.float32, gen))
    # every f32 D the route sends to the tf32x3 kernel (each of its
    # instances), with ragged T and S
    for D in range(8, fa.WGMMA_F32_FWD_MAX_D + 1, 8):
        rows.append(check_kernel(1, 2, *FLASH_D_SWEEP, D, torch.float32,
                                 gen, timed=False))
    # the tf32x3 kernel's per-tile sums over long rows: SD-2.1's 768px level
    # (9216 kv rows) and SD-1.5's widest heads over 4096
    for H, T, D in (SD21_768_LEVEL, WIDE_LONG_LEVEL):
        rows.append(check_kernel(1, H, T, T, D, torch.float32, gen,
                                 timed=False))
    return rows


FLASH_SUM_KEYS = ("ms", "device_ms", "wrapper_ms", "prev_ms",
                  "prev_device_ms", "library_ms", "library_device_ms",
                  "plain_ms", "bound_ms", "exp_floor_ms")
# f32: the tf32x3 kernel ("prev": flash_fwd.cu on the same inputs), its
# 3xTF32 bound and the FFMA bound beside it
FLASH_F32_SUM_KEYS = FLASH_SUM_KEYS + ("ffma_bound_ms",)


def flash_call_sums(rows) -> dict:
    """Sums over the 15 forward launches of one UNet call (5 at each of
    the three levels) of each timed column, at the serving batch (4) and
    the training batch (1): bf16 ("B4", "B1") and f32 ("f32_B4": one f32
    UNet call, "f32_B1": the forward of one f32 training step)."""
    sums = {}
    n = ROUTED_PER_UNET_CALL // len(SD15_ATTN_SHAPES)
    for dtype, prefix, keys in (("bfloat16", "", FLASH_SUM_KEYS),
                                ("float32", "f32_", FLASH_F32_SUM_KEYS)):
        for B in (4, 1):
            level = [r for r in rows if r["dtype"] == dtype and r["B"] == B
                     and "ms" in r]
            if len(level) != len(SD15_ATTN_SHAPES):
                raise AssertionError(f"{len(level)} timed {dtype} rows at "
                                     f"B = {B}")
            sums[f"{prefix}B{B}"] = {k: n * sum(r[k] for r in level)
                                     for k in keys}
    log("flash per UNet call: " + json.dumps(
        {k: v for k, v in sums.items() if not k.startswith("f32_")}))
    log("flash f32 per UNet call (f32_B4) and per f32 training step "
        "(f32_B1): " + json.dumps(
            {k: v for k, v in sums.items() if k.startswith("f32_")}))
    return sums


def _probe(what: str, code: str, timeout_s: float) -> None:
    """A new kernel's first calls (`code`, checked against the plain
    version) in a child process under a timeout, so a kernel that hangs on
    its mbarriers is killed rather than held to the run's limit."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"the {what} kernel's first calls did not "
                             f"finish in {timeout_s} s") from e
    for line in (proc.stdout + proc.stderr).splitlines()[-20:]:
        log(f"probe: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the {what} kernel's first calls failed "
                             f"({proc.returncode})")
    log(f"probe: {what} passed in {time.perf_counter() - t0:.1f} s")


def flash_probe(timeout_s: float = 60.0) -> None:
    """The wgmma forward kernel's first calls: the ragged call and the
    main-path shape."""
    _probe("wgmma forward", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_kernel(1, 2, *c.RAGGED, torch.bfloat16, g, "
        "heads_inner=False, timed=False); "
        "c.check_kernel(4, 8, 4096, 4096, 40, torch.bfloat16, g, "
        "timed=False)"), timeout_s)


def tf32x3_fwd_probe(timeout_s: float = 60.0) -> None:
    """The tf32x3 forward kernel's first calls (its TMA thread, splitters
    and consumers hand tiles on through mbarriers): the f32 ragged call, the
    main serving shape in f32 and the 16x16 level at D = 160, each also at
    the other q-tile height where the instance holds it, with flash_fwd.cu
    on the same inputs; before anything else launches it (the f32 backward
    probes take their O and L from it)."""
    _probe("tf32x3 forward", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_kernel(1, 2, *c.RAGGED, torch.float32, g, "
        "heads_inner=False, timed=False); "
        "c.check_kernel(4, 8, 4096, 4096, 40, torch.float32, g, "
        "timed=False); "
        "c.check_kernel(1, 8, 256, 256, 160, torch.float32, g, "
        "timed=False)"), timeout_s)


def dkv_probe(timeout_s: float = 60.0) -> None:
    """The wgmma dK/dV kernel's first calls: the ragged call and the main
    training shape, each also at both kv tile heights."""
    _probe("wgmma dK/dV", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_bwd_kernels(1, 2, *c.RAGGED, torch.bfloat16, g, "
        "heads_inner=False, timed=False); "
        "c.check_bwd_kernels(1, 8, 4096, 4096, 40, torch.bfloat16, g, "
        "timed=False)"), timeout_s)


def tf32x3_probe(timeout_s: float = 60.0) -> None:
    """The tf32x3 dK/dV kernel's first calls: the f32 ragged call and the
    main training shape in f32, each also at the kv tile heights its
    instance holds (the tf32x3 dQ kernel, which tf32x3_dq_probe tried
    first, and the mma kernels beside it on the same inputs)."""
    _probe("tf32x3 dK/dV", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_bwd_kernels(1, 2, *c.RAGGED, torch.float32, g, "
        "heads_inner=False, timed=False); "
        "c.check_bwd_kernels(1, 8, 4096, 4096, 40, torch.float32, g, "
        "timed=False)"), timeout_s)


def tf32x3_wide_probe(timeout_s: float = 60.0) -> None:
    """The tf32x3_wide dK/dV kernel's first calls (a cluster of two CTAs
    with mbarriers across them): an f32 ragged call at D = 160 and the
    16x16 training level (T = S = 256, D = 160) in f32 (the mma kernels
    beside it on the same inputs, dQ through the tf32x3_wide dQ kernel,
    which tf32x3_wide_dq_probe tried first)."""
    _probe("tf32x3_wide dK/dV", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_bwd_kernels(1, 2, *c.RAGGED[:2], 160, torch.float32, g, "
        "heads_inner=False, timed=False); "
        "c.check_bwd_kernels(1, 8, 256, 256, 160, torch.float32, g, "
        "timed=False)"), timeout_s)


def check_dq_direct(B, H, T, S, D, gen, heads_inner=True,
                    dtype=torch.bfloat16) -> None:
    """One dQ kernel alone, through its C entry point at each q tile
    height its instance holds, against flash_bwd_dq_reference (the
    forward kernel makes O and L): bf16 the wgmma kernel (64 and 128),
    f32 the tf32x3 kernel on its split operands (128 only where
    D <= TF32X3_DQ_BM128_MAX_D), above WGMMA_F32_DQ_MAX_D the tf32x3_wide
    kernel (64 only). The calls of dq_probe, tf32x3_dq_probe and
    tf32x3_wide_dq_probe."""
    route = ("wgmma" if dtype == torch.bfloat16 else "tf32x3"
             if D <= fa.WGMMA_F32_DQ_MAX_D else "tf32x3_wide")
    q, k, v = _qkv(B, H, T, S, D, dtype, gen, heads_inner)
    do = _qkv(B, H, T, T, D, dtype, gen, heads_inner)[0]
    scale = D ** -0.5
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, scale)
        delta = fa._delta(o, do)
        want = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                         scale).float()
        qt = fa._q_tilde(q, scale)
        ops = (fa._tf32x3_operands(qt, do, k, v, ("dq",))["dq"]
               if route in fa.TF32X3_ROUTES else None)
        bms = (64, 128) if route == "wgmma" or (
            D <= fa.TF32X3_DQ_BM128_MAX_D) else (64,)
        rel = {}
        for bm in bms:
            got = fa._dq_launch(route, qt, k, v, do, lse, delta, scale, bm,
                                ops)
            rel[bm] = ((got.float() - want).abs().max()
                       / want.abs().max()).item()
    log(f"dq probe: {route} (B, H, T, S, D) = {(B, H, T, S, D)}, relative "
        f"error by q tile height {rel}")
    if not all(np.isfinite(r) and r <= BWD_REL_TOL[dtype]
               for r in rel.values()):
        raise AssertionError(f"the {route} dQ kernel is {rel} from its "
                             f"plain version, limit {BWD_REL_TOL[dtype]}")


def dq_probe(timeout_s: float = 60.0) -> None:
    """The wgmma dQ kernel's first calls: the ragged call and the main
    training shape, each at both q tile heights, before anything else
    launches it (dkv_probe's calls go through it too)."""
    _probe("wgmma dQ", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_dq_direct(1, 2, *c.RAGGED, g, heads_inner=False); "
        "c.check_dq_direct(1, 8, 4096, 4096, 40, g)"), timeout_s)


def tf32x3_dq_probe(timeout_s: float = 60.0) -> None:
    """The tf32x3 dQ kernel's first calls: the f32 ragged call and the
    main training shape in f32, each at the q tile heights its instance
    holds, before anything else launches it (tf32x3_probe's calls go
    through it too)."""
    _probe("tf32x3 dQ", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_dq_direct(1, 2, *c.RAGGED, g, heads_inner=False, "
        "dtype=torch.float32); "
        "c.check_dq_direct(1, 8, 4096, 4096, 40, g, dtype=torch.float32)"),
        timeout_s)


def tf32x3_wide_dq_probe(timeout_s: float = 60.0) -> None:
    """The tf32x3_wide dQ kernel's first calls (a cluster of two CTAs that
    hand their scores to each other through mbarriers across them): f32
    ragged calls at D = 160 and at D = 104 (the pair's column boxes
    unequal), and the 16x16 training level (T = S = 256, D = 160), that
    kernel alone, before anything else launches it (tf32x3_wide_probe's
    calls go through it too)."""
    _probe("tf32x3_wide dQ", (
        "import torch, chip_smoke as c; "
        "g = torch.Generator('cuda').manual_seed(c.SEED); "
        "c.check_dq_direct(1, 2, *c.RAGGED[:2], 160, g, heads_inner=False, "
        "dtype=torch.float32); "
        "c.check_dq_direct(1, 2, *c.FLASH_D_SWEEP, 104, g, "
        "dtype=torch.float32); "
        "c.check_dq_direct(1, 8, 256, 256, 160, g, dtype=torch.float32)"),
        timeout_s)


def check_bwd_kernels(B, H, T, S, D, dtype, gen, heads_inner=True,
                      timed=True):
    """flash_bwd_dq and flash_bwd_dkv against their plain versions on the
    same inputs: q, k, v, dO as the UNet passes them, O and L from the
    forward kernel, delta = rowsum(dO * O). Each wrapper must launch the
    kernel _dq_route / _bwd_route picks. Where a route is wgmma, tf32x3
    or tf32x3_wide it also checks the mma kernel of that wrapper on the
    same inputs, and the routed kernel called directly at its tile heights
    (dQ: bm 64 and 128, tf32x3 128 only where its instance holds it;
    dK/dV: bn 64 and 128, the same; tf32x3_wide 64 only). Timed: each
    routed kernel (a wgmma or tf32x3 one on Q~ formed beforehand, the
    tf32x3 ones also on the split operands formed beforehand, once for
    both kernels, whose forming is timed apart, and where both read it
    the dK/dV part alone) and each mma kernel it
    replaced, through its C entry point and as device time (CUDA-graph
    replays), and each wgmma or tf32x3 kernel's device time at its other
    tile height; both wrappers (Q~ and the split included); the plain
    versions; SDPA's backward; the FLOP bounds (the tf32x3 routes also
    their FFMA bound) and the exponential floor."""
    q, k, v = _qkv(B, H, T, S, D, dtype, gen, heads_inner)
    do = _qkv(B, H, T, T, D, dtype, gen, heads_inner)[0]
    scale = D ** -0.5
    bf16 = dtype == torch.bfloat16
    route = fa._bwd_route(q, k, v, do)
    dq_route = fa._dq_route(q, k, v, do)
    row = {"B": B, "H": H, "T": T, "S": S, "D": D,
           "dtype": str(dtype).replace("torch.", ""), "route": route,
           "dq_route": dq_route}
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, scale)
        delta = fa._delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        qt = fa._q_tilde(q, scale)
        before = (dict(fa.flash_bwd_dq.launches_by_kernel),
                  dict(fa.flash_bwd_dkv.launches_by_kernel))
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        for key, fn, was in (("dq_kernel", fa.flash_bwd_dq, before[0]),
                             ("kernel", fa.flash_bwd_dkv, before[1])):
            row[key] = [r for r, n in fn.launches_by_kernel.items()
                        if n != was[r]]
        ref_dq = fa.flash_bwd_dq_reference(*args)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*args)
        checks = [("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)]
        direct_dq, direct = {}, {}
        if dq_route != "mma":
            direct_dq["prev"] = lambda: fa._dq_launch("mma", *args)
        if route != "mma":
            direct["prev"] = lambda: fa._dkv_launch("mma", *args)
        # the split the tf32x3 kernels read, formed once
        tf32x3 = [n for n, r in (("dq", dq_route), ("dkv", route))
                  if r in fa.TF32X3_ROUTES]
        ops = fa._tf32x3_operands(qt, do, k, v, tf32x3) if tf32x3 else {}
        bms = (64, 128) if dq_route == "wgmma" or (
            dq_route == "tf32x3" and D <= fa.TF32X3_DQ_BM128_MAX_D) else (64,)
        if dq_route != "mma":
            for bm in bms:
                direct_dq[f"bm{bm}"] = lambda bm=bm: fa._dq_launch(
                    dq_route, qt, k, v, do, lse, delta, scale, bm,
                    ops.get("dq"))
        bns = (64, 128) if route == "wgmma" or (
            route == "tf32x3" and D <= fa.TF32X3_BN128_MAX_D) else (64,)
        if route != "mma":
            for bn in bns:
                direct[f"bn{bn}"] = lambda bn=bn: fa._dkv_launch(
                    route, qt, k, v, do, lse, delta, scale, bn,
                    ops.get("dkv"))
        for name, call in direct_dq.items():
            checks.append((f"dq_{name}", call(), ref_dq))
        for name, call in direct.items():
            got_k, got_v = call()
            checks += [(f"dk_{name}", got_k, ref_dk),
                       (f"dv_{name}", got_v, ref_dv)]
        torch.cuda.synchronize()
        for name, a, b in checks:
            err = (a.float() - b.float()).abs().max().item()
            row[f"err_{name}"] = err
            row[f"rel_{name}"] = err / max(b.float().abs().max().item(),
                                           1e-30)
        if timed:
            def q_for(r):  # the wgmma and tf32x3 kernels read Q~ formed
                return q if r == "mma" else qt  # beforehand

            calls = {"dq_": lambda: fa._dq_launch(
                         dq_route, q_for(dq_route), k, v, do, lse, delta,
                         scale, operands=ops.get("dq")),
                     "dkv_": lambda: fa._dkv_launch(
                         route, q_for(route), k, v, do, lse, delta, scale,
                         operands=ops.get("dkv"))}
            if dq_route != "mma":
                calls["dq_prev_"] = direct_dq["prev"]
            if route != "mma":
                calls["dkv_prev_"] = direct["prev"]
            if tf32x3:  # the split the tf32x3 kernels read, once per call
                calls["split_"] = lambda: fa._tf32x3_operands(
                    qt, do, k, v, tf32x3)
            if len(tf32x3) == 2:  # and the part dK/dV reads alone
                calls["split_dkv_only_"] = lambda: fa._tf32x3_operands(
                    qt, do, k, v, ("dkv",))
            for name, call in calls.items():
                row[name + "ms"] = _time_ms(call)
                row[name + "device_ms"] = _graph_ms(call)
            if not bf16:
                # f32 beyond the tf32x3 kernels: the mma kernel is both the
                # routed and the earlier kernel, and nothing is split
                for key in ("ms", "device_ms"):
                    for name, r in (("dq_", dq_route), ("dkv_", route)):
                        if r == "mma":
                            row[name + "prev_" + key] = row[name + key]
                    if not tf32x3:
                        row["split_" + key] = 0.0
            row["dq_wrapper_ms"] = _time_ms(lambda: fa.flash_bwd_dq(*args))
            row["dkv_wrapper_ms"] = _time_ms(lambda: fa.flash_bwd_dkv(*args))
            sms = i8._sm_count(q.device)
            # the tile height _dq_bm / _dkv_bn did not pick
            if len(bms) == 2:
                other = 192 - (fa._dq_bm(T, B * H, sms) if dq_route == "wgmma"
                               else fa._dq_tf32x3_bm(T, B * H, D, sms))
                row["dq_other_bm"] = other
                row["dq_other_bm_device_ms"] = _graph_ms(
                    direct_dq[f"bm{other}"])
            if len(bns) == 2:
                other = 192 - (fa._dkv_bn(S, B * H, sms) if route == "wgmma"
                               else fa._dkv_tf32x3_bn(S, B * H, D, sms))
                row["dkv_other_bn"] = other
                row["dkv_other_bn_device_ms"] = _graph_ms(
                    direct[f"bn{other}"])
            for name, plain in (("dq", fa.flash_bwd_dq_reference),
                                ("dkv", fa.flash_bwd_dkv_reference)):
                row[f"{name}_plain_ms"] = _time_ms(lambda: plain(*args))
            # q, k, v, dO read (and the f32 L and delta); dQ recomputes
            # Q K^T and dO V^T and forms dS K, dK/dV also P^T dO and dS^T Q
            e = q.element_size()
            reads = e * B * H * (2 * T + 2 * S) * D + 8 * B * H * T
            for name, f, out in (("dq", 6, B * H * T * D),
                                 ("dkv", 8, 2 * B * H * S * D)):
                b = _bound(f * B * H * T * S * D, reads + e * out,
                           PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
                row[f"{name}_bound_ms"] = b["bound_ms"]
                row[f"{name}_bound_by"] = b["bound_by"]
            if not bf16:
                # the f32 dQ and dK/dV on CUDA-core FMAs (the mma kernels'
                # bounds), and on the tensor cores as 3xTF32: three tf32
                # products for each of their three or four, at the dense
                # TF32 rate
                for name, f, out, r in (("dq", 6, B * H * T * D, dq_route),
                                        ("dkv", 8, 2 * B * H * S * D, route)):
                    row[f"{name}_ffma_bound_ms"] = row[f"{name}_bound_ms"]
                    row[f"{name}_ffma_bound_by"] = row[f"{name}_bound_by"]
                    if r in fa.TF32X3_ROUTES:
                        b = _bound(3 * f * B * H * T * S * D, reads + e * out,
                                   PEAK_TF32_FLOPS)
                        row[f"{name}_bound_ms"] = b["bound_ms"]
                        row[f"{name}_bound_by"] = b["bound_by"]
            # each kernel recomputes P: B*H*T*S exponentials
            row["exp_floor_ms"] = _exp_floor_ms(B, H, T, S)
    if timed:
        # one PyTorch call for the same gradients: autograd.grad of a
        # retained SDPA graph computes dQ, dK and dV together. Its device
        # time is the profiler's: autograd's backward cannot be captured
        # in a CUDA graph here (it makes the legacy stream wait on the
        # capturing one)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o_sdpa = torch.nn.functional.scaled_dot_product_attention(
                *leaves, scale=scale)

            def sdpa_bwd():
                return torch.autograd.grad(o_sdpa, leaves, do,
                                           retain_graph=True)

            row["library_ms"] = _time_ms(sdpa_bwd)
            row["library_device_ms"] = _kernel_ms(sdpa_bwd)
        del o_sdpa, leaves
    log("bwd kernel: " + json.dumps(row))
    tol = BWD_REL_TOL[dtype]
    bad = [n for n, _, _ in checks
           if not (np.isfinite(row[f"rel_{n}"]) and row[f"rel_{n}"] <= tol)]
    want = {"route": ("wgmma" if bf16 and D <= fa.WGMMA_DKV_MAX_D
                      else "tf32x3" if not bf16
                      and D <= fa.WGMMA_F32_DKV_MAX_D
                      else "tf32x3_wide" if not bf16
                      and D <= fa.WGMMA_F32_DKV_WIDE_MAX_D else "mma"),
            "dq_route": ("wgmma" if bf16 and D <= fa.WGMMA_DQ_MAX_D
                         else "tf32x3" if not bf16
                         and D <= fa.WGMMA_F32_DQ_MAX_D
                         else "tf32x3_wide" if not bf16
                         and D <= fa.WGMMA_F32_DQ_WIDE_MAX_D else "mma")}
    if bad or row["kernel"] != [route] or row["dq_kernel"] != [dq_route] \
            or {key: row[key] for key in want} != want:
        raise AssertionError(f"flash_bwd kernels disagree with their plain "
                             f"versions on {bad} or ran other kernels "
                             f"than {want}: {row}, limit {tol}")
    return row


def phase_bwd_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_bwd_kernels(1, 8, T, T, D, dtype, gen))
        T, S, D = RAGGED
        rows.append(check_bwd_kernels(1, 2, T, S, D, dtype, gen,
                                      heads_inner=False, timed=False))
    # batch 2 at the three levels (two instance prompts, or prior
    # preservation)
    for T, D in SD15_ATTN_SHAPES:
        rows.append(check_bwd_kernels(2, 8, T, T, D, torch.bfloat16, gen,
                                      timed=False))
    # every D the routes send to the wgmma dQ and dK/dV kernels and to the
    # tf32x3 and tf32x3_wide dQ and dK/dV kernels (each of their
    # instances), with ragged T and S
    for D in range(8, max(fa.WGMMA_DQ_MAX_D, fa.WGMMA_DKV_MAX_D) + 1, 8):
        rows.append(check_bwd_kernels(1, 2, *FLASH_D_SWEEP, D,
                                      torch.bfloat16, gen, timed=False))
    for D in range(8, max(fa.WGMMA_F32_DQ_WIDE_MAX_D,
                          fa.WGMMA_F32_DKV_WIDE_MAX_D) + 1, 8):
        rows.append(check_bwd_kernels(1, 2, *FLASH_D_SWEEP, D,
                                      torch.float32, gen, timed=False))
    # f32 at SD-2.1's 768px level: the tf32x3 kernels' per-tile sums over
    # 9216 q and kv rows
    H, T, D = SD21_768_LEVEL
    rows.append(check_bwd_kernels(1, H, T, T, D, torch.float32, gen,
                                  timed=False))
    # and the tf32x3_wide kernels' over 4096 q and kv rows at D = 160
    H, T, D = WIDE_LONG_LEVEL
    rows.append(check_bwd_kernels(1, H, T, T, D, torch.float32, gen,
                                  timed=False))
    return rows


BWD_SUM_KEYS = ("dq_ms", "dq_device_ms", "dq_prev_ms", "dq_prev_device_ms",
                "dq_wrapper_ms", "dkv_ms", "dkv_device_ms",
                "dkv_prev_ms", "dkv_prev_device_ms", "dkv_wrapper_ms",
                "dq_plain_ms", "dkv_plain_ms", "library_ms",
                "library_device_ms", "dq_bound_ms", "dkv_bound_ms",
                "exp_floor_ms")
# f32: dQ and dK/dV run the tf32x3 and tf32x3_wide kernels where the
# routes send them ("prev": the mma kernels on the same inputs), with the
# split they read (formed once per backward call) and both bounds
BWD_F32_SUM_KEYS = ("dq_ms", "dq_device_ms", "dq_prev_ms",
                    "dq_prev_device_ms", "dq_wrapper_ms", "dkv_ms",
                    "dkv_device_ms", "dkv_prev_ms", "dkv_prev_device_ms",
                    "split_ms", "split_device_ms", "dkv_wrapper_ms",
                    "dq_plain_ms", "dkv_plain_ms", "library_ms",
                    "library_device_ms", "dq_bound_ms", "dkv_bound_ms",
                    "dq_ffma_bound_ms", "dkv_ffma_bound_ms", "exp_floor_ms")


def bwd_step_sums(rows) -> dict:
    """Sums over one training step's backward launches (5 of each kernel
    at each of the three levels, batch 1) of each timed column, bf16 (the
    bench's dtype) and f32 (the trainer's default)."""
    n = ROUTED_PER_UNET_CALL // len(SD15_ATTN_SHAPES)
    sums = {}
    for dtype, keys in (("bfloat16", BWD_SUM_KEYS),
                        ("float32", BWD_F32_SUM_KEYS)):
        level = [r for r in rows if r["dtype"] == dtype and "dq_ms" in r]
        if len(level) != len(SD15_ATTN_SHAPES):
            raise AssertionError(f"{len(level)} timed {dtype} backward rows")
        sums[dtype] = {k: n * sum(r[k] for r in level) for k in keys}
    log("bwd per training step: " + json.dumps(sums["bfloat16"]))
    log("bwd f32 per training step: " + json.dumps(sums["float32"]))
    return sums


def per_call_launches(fn, tiers) -> dict:
    """A flash wrapper's launches per UNet call (the forward) or per
    training step (the backward pair) by kernel (every key of
    fn.launches_by_kernel): 5 at each level, through the route of the first
    (max_d, route) of `tiers` (widest last) with D <= max_d (bf16: "wgmma"
    to WGMMA_MAX_D for flash_fwd, to WGMMA_DQ_MAX_D for flash_bwd_dq, to
    WGMMA_DKV_MAX_D for flash_bwd_dkv; f32: "tf32x3" to
    WGMMA_F32_FWD_MAX_D, to WGMMA_F32_DQ_MAX_D then "tf32x3_wide" to
    WGMMA_F32_DQ_WIDE_MAX_D, and to WGMMA_F32_DKV_MAX_D then "tf32x3_wide"
    to WGMMA_F32_DKV_WIDE_MAX_D), else through the mma kernel."""
    n = ROUTED_PER_UNET_CALL // len(SD15_ATTN_SHAPES)
    counts = dict.fromkeys(fn.launches_by_kernel, 0)
    for _, D in SD15_ATTN_SHAPES:
        counts[next((r for max_d, r in tiers if D <= max_d), "mma")] += n
    return counts


def unet_int8_calls(b: int):
    """(M, K, N) of every int8 launch of one SD-1.5 UNet call at 512px and
    device batch b (CFG rows), with repeats: 182."""
    hw = 64 * 64 * b
    calls = []
    # 16 transformers: 5 at each of 64x64, 32x32 and 16x16 (2 down, 3 up)
    # and the 8x8 mid block. Each runs q/k/v/out of self-attention and q/out
    # of cross-attention, the GEGLU proj, ff net.2, and cross-attention k/v
    # on the 77 text tokens
    for m, c, n in ((hw, 320, 5), (hw // 4, 640, 5), (hw // 16, 1280, 5),
                    (hw // 64, 1280, 1)):
        calls += n * ([(m, c, c)] * 6 + [(m, c, 8 * c), (m, 4 * c, c)]
                      + [(b * 77, 768, c)] * 2)
    # 22 resnets' time_emb_proj: 5 at 320 channels, 5 at 640, 12 at 1280
    for c, n in ((320, 5), (640, 5), (1280, 12)):
        calls += [(b, 1280, c)] * n
    return calls


def int8_path_shapes(unet_batches=(4,), clip_prompts=(2, 1),
                     vae_latents=(2,)):
    """Every (M, K, N) the int8 kernels run at in SD-1.5 at 512px: the
    UNet at each device batch (CFG rows), CLIP on each encode's prompt
    count, the VAE decoder's mid-block attention on each latent count. The
    defaults are request A's: the UNet at batch 4 (2 prompts under CFG),
    CLIP on the 2 prompts and on the 1 negative prompt, 2 latents."""
    shapes = []
    for b in unet_batches:
        shapes += unet_int8_calls(b)
    for n in clip_prompts:                 # CLIP q/k/v/out, fc1, fc2
        m = 77 * n
        shapes += [(m, 768, 768), (m, 768, 3072), (m, 3072, 768)]
    for n in vae_latents:                  # VAE decoder attention
        shapes.append((n * 64 * 64, 512, 512))
    return list(dict.fromkeys(shapes))


def int8_phase_shapes():
    """The shapes phase 9 runs besides request A's: warmup of the batch
    buckets 1, 2 and 4 (UNet at batch 2, 4, 8; CLIP on 1 or 2 new prompts;
    1, 2, 4 latents) and request B (4 coalesced prompts: UNet at batch 8,
    CLIP on 4 prompts, 4 latents)."""
    request_a = set(int8_path_shapes())
    return [s for s in int8_path_shapes((2, 4, 2 * B_REQUESTS),
                                        (1, 2, B_REQUESTS), (1, 2, 4))
            if s not in request_a]


@contextlib.contextmanager
def recording_int8_shapes(seen: set):
    """Adds (M, K, N, dtype) of every int8 dense call made inside to `seen`
    (the name models/layers.py calls; the wrapper and its count are
    unchanged)."""
    from lora_tpu_torch.models import layers

    kernel = layers.int8_matmul

    def recorded(x, wq, scale):
        seen.add((x.numel() // x.shape[-1], x.shape[-1], wq.shape[0],
                  str(x.dtype).replace("torch.", "")))
        return kernel(x, wq, scale)

    layers.int8_matmul = recorded
    try:
        yield seen
    finally:
        layers.int8_matmul = kernel


def _int8_inputs(M, K, N, dtype, gen):
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.05
    scale = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    wq = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    return x, wq, scale


def _int8_direct(route, x, wq, scale, tile=None):
    """One kernel's C entry point called directly (no routing, no count):
    the mma kernel on bf16 inputs for its time beside the wgmma kernel's,
    or the wgmma kernel at a given tile."""
    (M, K), N = x.shape, wq.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    tail = tile if route == "wgmma" else (int(x.dtype == torch.bfloat16),)
    rc = i8._entry(route)(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), M, N, K, *tail,
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{route} entry failed: cudaError {rc} at "
                           f"{(M, K, N)} tile {tile}")
    return out


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def check_int8(M, K, N, dtype, gen, timed=True, route=None):
    """The wrapper against the plain version at one shape; `route` is the
    kernel it must launch (by default wgmma for bf16, mma for f32). Timed:
    the routed kernel and the mma kernel (bf16), each through its C entry
    point on the same inputs (one launch path for both), the wrapper,
    cuBLAS (F.linear on the dequantized weight in x's dtype, made once
    before timing), the plain version, and the bound."""
    route = route or ("wgmma" if dtype == torch.bfloat16 else "mma")
    x, wq, scale = _int8_inputs(M, K, N, dtype, gen)
    with torch.inference_mode():
        before = dict(i8.int8_matmul.launches_by_kernel)
        got = i8.int8_matmul(x, wq, scale)
        ran = [k for k, v in i8.int8_matmul.launches_by_kernel.items()
               if v != before[k]]
        want = i8.int8_matmul_reference(x, wq, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        row = {"M": M, "K": K, "N": N,
               "dtype": str(dtype).replace("torch.", ""), "kernel": ran,
               "err": err, "rel": _rel(got, want)}
        if timed:
            if dtype == torch.bfloat16:
                row["rel_prev"] = _rel(_int8_direct("mma", x, wq, scale),
                                       want)
            w_lib = (wq.float() * scale[:, None]).to(dtype)
            tile = (i8._tile(M, K, N, torch.cuda.get_device_properties(
                0).multi_processor_count) if route == "wgmma" else None)
            calls = {"": lambda: _int8_direct(route, x, wq, scale, tile),
                     "wrapper_": lambda: i8.int8_matmul(x, wq, scale),
                     "library_": lambda: torch.nn.functional.linear(x, w_lib)}
            if dtype == torch.bfloat16:
                calls["prev_"] = lambda: _int8_direct("mma", x, wq, scale)
            for name, call in calls.items():
                row[name + "ms"] = _time_ms(call)
                if name != "wrapper_":  # the same kernel as ""
                    row[name + "device_ms"] = _graph_ms(call)
            del w_lib
            row["plain_ms"] = _time_ms(
                lambda: i8.int8_matmul_reference(x, wq, scale))
            e = x.element_size()
            row.update(_bound(2 * M * N * K,
                              e * M * K + N * K + 4 * N + e * M * N))
    log("int8 kernel: " + json.dumps(row))
    tol = INT8_REL_TOL[dtype]
    if got.shape != (M, N) or got.dtype != dtype or ran != [route] or not (
            np.isfinite(row["rel"]) and row["rel"] <= tol
            and row.get("rel_prev", 0.0) <= tol):
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"or ran another kernel than {route}: {row}, "
                             f"limit {tol}")
    return row


def int8_call_sums(rows) -> dict:
    """Sums over the 182 launches of one UNet call at batch 4 (bf16) of
    each timed column, weighted by each shape's count per call; over all
    launches and over the M >= 1024 ones. The *ms columns time each call
    alone, its host launch path included (it sets the time at M <= 308:
    ctypes for the kernels, the Python wrapper for wrapper_ms, PyTorch's
    dispatcher for cuBLAS); the *device_ms columns replay CUDA graphs of
    the calls."""
    counts = {}
    for s in unet_int8_calls(4):
        counts[s] = counts.get(s, 0) + 1
    by_shape = {(r["M"], r["K"], r["N"]): r for r in rows
                if r["dtype"] == "bfloat16" and "ms" in r}
    sums = {"launches": sum(counts.values()),
            "launches_m_ge_1024": sum(c for s, c in counts.items()
                                      if s[0] >= 1024)}
    for key in ("ms", "wrapper_ms", "prev_ms", "library_ms", "plain_ms",
                "device_ms", "prev_device_ms", "library_device_ms",
                "bound_ms"):
        sums[key] = sum(c * by_shape[s][key] for s, c in counts.items())
        sums[key + "_m_ge_1024"] = sum(c * by_shape[s][key]
                                       for s, c in counts.items()
                                       if s[0] >= 1024)
    log("int8 per UNet call: " + json.dumps(sums))
    return sums


def phase_int8_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in int8_path_shapes():
            rows.append(check_int8(M, K, N, dtype, gen))
        for M, K, N in int8_phase_shapes():
            rows.append(check_int8(M, K, N, dtype, gen, timed=False))
        for (M, K, N), route in INT8_RAGGED:
            check_int8(M, K, N, dtype, gen, timed=False,
                       route=route if dtype == torch.bfloat16 else "mma")
        # a leading batch dimension and an x whose rows are not contiguous
        x = torch.randn((2, 7, 96), generator=gen, device="cuda").to(dtype)
        wq = torch.randint(-127, 128, (40, 64), generator=gen, device="cuda",
                           dtype=torch.int8)
        s = torch.rand((40,), generator=gen, device="cuda")
        with torch.inference_mode():
            got = i8.int8_matmul(x[..., 16:80], wq, s)
            want = i8.int8_matmul_reference(x[..., 16:80], wq, s)
        rel = _rel(got, want)
        if got.shape != (2, 7, 40) or not rel <= INT8_REL_TOL[dtype]:
            raise AssertionError(f"int8_matmul on a strided 3-D x: rel {rel}")
    # bf16 x whose base is 2 bytes past a 16-byte boundary: the mma kernel
    M, K, N = 100, 320, 320
    x = torch.randn((M * K + 8,), generator=gen, device="cuda").to(
        torch.bfloat16)[1:M * K + 1].view(M, K)
    _, wq, s = _int8_inputs(M, K, N, torch.bfloat16, gen)
    with torch.inference_mode():
        before = i8.int8_matmul.launches_by_kernel["mma"]
        got = i8.int8_matmul(x, wq, s)
        rel = _rel(got, i8.int8_matmul_reference(x, wq, s))
    if i8.int8_matmul.launches_by_kernel["mma"] != before + 1 or \
            not rel <= INT8_REL_TOL[torch.bfloat16]:
        raise AssertionError(f"int8_matmul on an unaligned bf16 x: rel {rel}")
    log(f"int8 kernel: unaligned bf16 x {(M, K, N)} through mma: rel {rel}")
    return rows


def int8_tile_sweep(shapes=None):
    """The wgmma kernel at every tile instance, called directly, at request
    A's bf16 shapes: each instance checked against the plain version and
    its device time taken (CUDA graph replay); the tile _tile picks beside
    them."""
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, N in shapes or int8_path_shapes():
        x, wq, scale = _int8_inputs(M, K, N, torch.bfloat16, gen)
        row = {"M": M, "K": K, "N": N, "picked": list(i8._tile(M, K, N, sms))}
        with torch.inference_mode():
            want = i8.int8_matmul_reference(x, wq, scale)
            for tile in i8.TILES:
                rel = _rel(_int8_direct("wgmma", x, wq, scale, tile), want)
                if not rel <= INT8_REL_TOL[torch.bfloat16]:
                    raise AssertionError(f"wgmma tile {tile} at {(M, K, N)}: "
                                         f"rel {rel}")
                row[f"{tile[0]}x{tile[1]}"] = _graph_ms(
                    lambda: _int8_direct("wgmma", x, wq, scale, tile))
        log("int8 tiles: " + json.dumps(row))


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


def _patched_pipe(phase: str):
    """The serving configuration: SD-1.5 in bf16 with random weights from
    the seed, the rank-4 LoRA + one TI embed loaded with patch_pipe, at
    scale 0.8."""
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
    log(f"{phase}: SD-1.5 bf16 pipeline built and patched in "
        f"{time.perf_counter() - t0:.1f} s")
    return pipe


def phase_slice(smi: str):
    pipe = _patched_pipe("slice")

    def run():
        lat_gen = torch.Generator("cuda").manual_seed(SEED + 1)
        return pipe(PROMPTS, num_inference_steps=STEPS, guidance_scale=7.5,
                    height=512, width=512, generator=lat_gen)

    want = ROUTED_PER_UNET_CALL * STEPS
    _zero_counts()
    t0 = time.perf_counter()
    first = run()
    cold_s = time.perf_counter() - t0
    if fa.flash_fwd.launches != want:
        raise AssertionError(f"warm-up call launched the kernel "
                             f"{fa.flash_fwd.launches} times, not {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # the counted main-path run
    t0 = time.perf_counter()
    images = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches, *bwd_launches = _counts()
    by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    if bwd_launches != [0, 0]:
        raise AssertionError(f"serving launched backward kernels: "
                             f"{bwd_launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != want or by_kernel != _only("wgmma", want):
        raise AssertionError(f"main path launched the forward kernels "
                             f"{by_kernel} times, not {want} wgmma")
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
        "launches": launches, "launches_by_kernel": by_kernel,
        "unet_lora_max_diff": lora_diff,
        "rerun_max_diff": float(np.abs(images - first).max()),
        "card": smi}))
    if i8.int8_matmul.launches:
        raise AssertionError("the bf16 pipeline launched the int8 kernel")
    del pipe
    torch.cuda.empty_cache()
    return by_kernel, warm_s


def _counts():
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _zero_counts():
    for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
               i8.int8_matmul):
        fn.launches = 0
        fn.launches_by_kernel.update(dict.fromkeys(fn.launches_by_kernel, 0))


def _train_models(gen, dt=torch.bfloat16):
    """SD-1.5 UNet (in `dt`, random weights from `gen`), the bench.py
    trainable (a rank-4 LoRA on the default UNet sites, f32 leaves that
    require grad), and a cached batch: 64x64x4 latents and the text
    embeddings of one random prompt from the SD-1.5 CLIP text encoder."""
    from lora_tpu_torch.core.lora import init_lora
    from lora_tpu_torch.core.sites import unet_lora_sites
    from lora_tpu_torch.models.clip import CLIPTextModel
    from lora_tpu_torch.models.config import SD15_TEXT, SD15_UNET
    from lora_tpu_torch.models.unet import UNet

    unet = UNet(SD15_UNET, device="cuda", dtype=dt, generator=gen)
    text = CLIPTextModel(SD15_TEXT, device="cuda", dtype=dt, generator=gen)
    ids = torch.randint(0, SD15_TEXT.vocab_size, (1, 77), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        enc = text(ids, dtype=dt)
    batch = {"latents": torch.randn((1, 64, 64, 4), generator=gen,
                                    device="cuda").to(dt),
             "encoder_hidden_states": enc.clone()}
    lora = init_lora(unet_lora_sites(SD15_UNET), r=4, generator=gen,
                     device="cuda")
    return unet, batch, lora


def _make_step(optimizer, remat=False, dtype=torch.bfloat16):
    from lora_tpu_torch.models.config import SD15_TEXT, SD15_UNET, SD15_VAE
    from lora_tpu_torch.models.schedulers import make_schedule
    from lora_tpu_torch.training.loss import LossConfig
    from lora_tpu_torch.training.train_step import make_train_step

    return make_train_step(
        unet_cfg=SD15_UNET, text_cfg=SD15_TEXT, vae_cfg=SD15_VAE,
        sched=make_schedule(),
        loss_cfg=LossConfig(cached_latents=True,
                            gradient_checkpointing=remat),
        optimizer=optimizer, dtype=dtype)


# device kernels by class in the profile of a training step: the first
# pattern a kernel's name matches (lower case) names its class
KERNEL_CLASSES = (
    ("flash_bwd_dkv_wgmma", "flash_bwd_dkv_wgmma"),
    ("flash_bwd_dkv_tf32x3_wide", "flash_bwd_dkv_tf32x3_wide"),
    ("flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3"),
    ("flash_bwd_dkv_mma", "bwd_dkv"),
    ("flash_bwd_dq_wgmma", "flash_bwd_dq_wgmma"),
    ("flash_bwd_dq_tf32x3_wide", "flash_bwd_dq_tf32x3_wide"),
    ("flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3"),
    ("flash_bwd_dq_mma", "bwd_dq"),
    ("flash_fwd", "flash_fwd"),
    ("conv", "conv|fprop|dgrad|wgrad|winograd"),
    ("gemm", "gemm|cutlass|xmma|cublas|matmul"),
    ("layout", "nchw|nhwc|transpose|permute"),
    ("copy_cast", "copy|memcpy|memset|fill"),
    ("norm_reduce", "norm|moments|reduce|softmax"),
    ("elementwise", "elementwise"),
)


def profile_step(run) -> dict:
    """One call of `run` (a warm training step, synchronised) under
    torch.profiler: its wall time, the device time of its kernels by class
    (KERNEL_CLASSES) with their share of it, the busy share (device time
    over wall time, one stream), and the ten longest kernels."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class = {}
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, name)),
                   "other")
        c = by_class.setdefault(cls, {"ms": 0.0, "launches": 0})
        c["ms"] += e.self_device_time_total / 1e3
        c["launches"] += e.count
    for c in by_class.values():
        c["share"] = c["ms"] / device_ms if device_ms else None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches": sum(e.count for e in kernels),
            "busy_share": device_ms / wall_ms,
            "by_class": dict(sorted(by_class.items(),
                                    key=lambda kv: -kv[1]["ms"])),
            "top": [[e.key[:90], e.count, e.self_device_time_total / 1e3]
                    for e in top]}


def phase_train(smi: str):
    from lora_tpu_torch.training.optim import make_optimizer, tree_leaves
    from lora_tpu_torch.training.train_step import make_trainable

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    t0 = time.perf_counter()
    unet, batch, lora = _train_models(gen)
    trainable = make_trainable({"lora_unet": lora})
    opt = make_optimizer(trainable, {"lora_unet": 1e-4})
    step = _make_step(opt)
    base = (unet.flat_params(), {}, {})
    torch.cuda.synchronize()
    log(f"train: SD-1.5 bf16 UNet + rank-4 LoRA "
        f"({sum(x.numel() for x in tree_leaves(trainable))} trainable "
        f"params) built in {time.perf_counter() - t0:.1f} s")

    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        losses.append(step(trainable, base, batch, gen))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    bwd_fns = (fa.flash_bwd_dq, fa.flash_bwd_dkv)
    bwd_want = _per_step_want(torch.bfloat16)[:2]
    _zero_counts()  # the counted main-path run
    for _ in range(TRAIN_STEPS):
        before = _counts()
        bwd_before = [dict(f.launches_by_kernel) for f in bwd_fns]
        t0 = time.perf_counter()
        losses.append(step(trainable, base, batch, gen))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step = tuple(a - b for a, b in zip(_counts(), before))
        bwd_step = tuple({r: n - was[r] for r, n in
                          f.launches_by_kernel.items()}
                         for f, was in zip(bwd_fns, bwd_before))
        if per_step != (ROUTED_PER_UNET_CALL,) * 3 or bwd_step != bwd_want:
            raise AssertionError(f"a training step launched (fwd, dq, dkv) "
                                 f"= {per_step}, not 15 each, (dQ, dK/dV) "
                                 f"{bwd_step}, not {bwd_want}")
    launches = _counts()
    by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    dq_by_kernel = dict(fa.flash_bwd_dq.launches_by_kernel)
    dkv_by_kernel = dict(fa.flash_bwd_dkv.launches_by_kernel)
    if by_kernel != _only("wgmma", launches[0]):
        raise AssertionError(f"training launched the forward kernels "
                             f"{by_kernel} times")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    ups = [e["up"] for e in lora["sites"].values()]
    still_zero = sum(int(not (u.detach().abs().max() > 0)) for u in ups)
    if still_zero:
        raise AssertionError(f"{still_zero} of {len(ups)} LoRA up leaves "
                             f"never moved from zero")
    med = statistics.median(step_ms)
    # one more warm step, after the counted run, under the profiler
    log("train profile: " + json.dumps(profile_step(
        lambda: step(trainable, base, batch, gen))))
    log("train: " + json.dumps({
        "steps": TRAIN_WARMUP + TRAIN_STEPS, "timed_steps": TRAIN_STEPS,
        "losses": [round(x, 6) for x in losses.tolist()],
        "warmup_s": warmup_s, "step_ms_median": med,
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "steps_per_s": 1e3 / med, "peak_mem_gib": peak_gib,
        "launches": dict(zip(("fwd", "dq", "dkv"), launches)),
        "fwd_launches_by_kernel": by_kernel,
        "dq_launches_by_kernel": dq_by_kernel,
        "dkv_launches_by_kernel": dkv_by_kernel,
        "up_max_abs": max(u.detach().abs().max().item() for u in ups),
        "card": smi}))
    del step, opt, trainable, base, unet, batch, lora
    torch.cuda.empty_cache()
    return launches, by_kernel, dq_by_kernel, dkv_by_kernel


def phase_grad(dt=torch.bfloat16):
    """The full-width LoRA gradient through the kernels against the one
    through the plain attention path; in bf16 (the bench's dtype) also
    with gradient checkpointing. f32 (the trainer's default) runs the f32
    kernels: flash_fwd_tf32x3.cu, dQ through flash_bwd_dq_tf32x3.cu at
    D <= WGMMA_F32_DQ_MAX_D and flash_bwd_dq_tf32x3_wide.cu above it to
    WGMMA_F32_DQ_WIDE_MAX_D, dK/dV through
    flash_bwd_dkv_tf32x3.cu at D <= WGMMA_F32_DKV_MAX_D and
    flash_bwd_dkv_tf32x3_wide.cu above it to WGMMA_F32_DKV_WIDE_MAX_D; then
    TRAIN_F32_WARMUP and TRAIN_F32_STEPS timed f32 training steps
    (train_f32_steps)."""
    from lora_tpu_torch.ops.attention import set_use_memory_efficient_attention
    from lora_tpu_torch.training.optim import make_optimizer, tree_leaves
    from lora_tpu_torch.training.train_step import make_trainable

    bf16 = dt == torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    unet, batch, lora = _train_models(gen, dt)
    for entry in lora["sites"].values():
        entry["up"] = 0.05 * torch.randn(entry["up"].shape, generator=gen,
                                         device="cuda")
    trainable = make_trainable({"lora_unet": lora})
    leaves = tree_leaves(trainable)
    base = (unet.flat_params(), {}, {})
    draws = {"noise": torch.randn((1, 64, 64, 4), generator=gen,
                                  device="cuda").to(dt),
             "timesteps": torch.tensor([500], device="cuda")}

    def loss_and_grad(remat=False):
        # lr 0 and no clip: the step computes the loss and the gradients
        # and leaves the leaves where they are
        opt = make_optimizer(trainable, {"lora_unet": 0.0},
                             weight_decay=0.0, max_grad_norm=None)
        captured = []
        opt.step = lambda: captured.append(torch.cat(
            [x.grad.flatten() for x in leaves]))
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _make_step(opt, remat, dt)(trainable, base, batch, **draws)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        for x in leaves:
            x.grad = None
        return loss.float().item(), captured[0], tuple(
            a - b for a, b in zip(_counts(), before))

    ms = []  # wall time of each single step (one sample each)
    fwd_before = dict(fa.flash_fwd.launches_by_kernel)
    dq_before = dict(fa.flash_bwd_dq.launches_by_kernel)
    dkv_before = dict(fa.flash_bwd_dkv.launches_by_kernel)
    loss_k, g_k, n_k = loss_and_grad()
    set_use_memory_efficient_attention(False)
    try:
        loss_p, g_p, n_p = loss_and_grad()
    finally:
        set_use_memory_efficient_attention(True)
    row = {"dtype": str(dt).replace("torch.", ""), "loss_kernels": loss_k,
           "loss_plain": loss_p}
    if bf16:
        loss_r, g_r, n_r = loss_and_grad(remat=True)
        rel_r = ((g_r - g_k).norm() / g_k.norm()).item()
        row.update(loss_remat=loss_r, grad_rel_l2_remat_vs_kernels=rel_r,
                   launches_remat=n_r)
    fwd_by_kernel = {r: n - fwd_before[r]
                     for r, n in fa.flash_fwd.launches_by_kernel.items()}
    dq_by_kernel = {r: n - dq_before[r]
                    for r, n in fa.flash_bwd_dq.launches_by_kernel.items()}
    dkv_by_kernel = {r: n - dkv_before[r]
                     for r, n in fa.flash_bwd_dkv.launches_by_kernel.items()}
    rel = ((g_k - g_p).norm() / g_p.norm()).item()
    tol = GRAD_REL_L2_TOL if bf16 else GRAD_F32_REL_L2_TOL
    row.update({"grad_rel_l2_kernels_vs_plain": rel,
                "grad_norm": g_k.norm().item(), "launches_kernels": n_k,
                "launches_plain": n_p,
                "fwd_launches_by_kernel": fwd_by_kernel,
                "dq_launches_by_kernel": dq_by_kernel,
                "dkv_launches_by_kernel": dkv_by_kernel,
                "step_ms_kernels_plain_remat": ms,
                "limits": {"grad_rel_l2": tol,
                           "remat_loss_rtol": REMAT_LOSS_RTOL}})
    log("grad: " + json.dumps(row))
    # bf16: two steps through the kernels (plain, checkpointed), the
    # forward twice in the checkpointed one; f32: one step, the forward all
    # tf32x3, dQ and dK/dV tf32x3 and tf32x3_wide (_per_step_want)
    want_dq, want_dkv, want_fwd = _per_step_want(dt)
    if bf16:
        want_dq, want_dkv = ({r: 2 * n for r, n in w.items()}
                             for w in (want_dq, want_dkv))
        want_fwd = _only("wgmma", 45)
    if n_k != (15, 15, 15) or n_p != (0, 0, 0) or (
            bf16 and n_r != (30, 15, 15)) or fwd_by_kernel != want_fwd or \
            dq_by_kernel != want_dq or dkv_by_kernel != want_dkv:
        raise AssertionError(f"launch counts {row}: forward "
                             f"{fwd_by_kernel}, not {want_fwd}; dQ "
                             f"{dq_by_kernel}, not {want_dq}; dK/dV "
                             f"{dkv_by_kernel}, not {want_dkv}")
    if not (np.isfinite(rel) and rel <= tol):
        raise AssertionError(f"LoRA gradient through the kernels is {rel} "
                             f"(relative L2) from the plain path's")
    if bf16 and not (abs(loss_r - loss_k) <= REMAT_LOSS_RTOL * abs(loss_k)
                     and np.isfinite(rel_r) and rel_r <= GRAD_REL_L2_TOL):
        raise AssertionError(f"gradient checkpointing changed the step: "
                             f"{row}")
    if not bf16:
        row["train_f32"] = train_f32_steps(trainable, base, batch, gen)
    del unet, batch, lora, trainable, base
    torch.cuda.empty_cache()
    return row


def _per_step_want(dt):
    """(dQ, dK/dV, forward) launches by kernel of one training step in
    `dt`."""
    if dt == torch.bfloat16:
        return (per_call_launches(fa.flash_bwd_dq,
                                  ((fa.WGMMA_DQ_MAX_D, "wgmma"),)),
                per_call_launches(fa.flash_bwd_dkv,
                                  ((fa.WGMMA_DKV_MAX_D, "wgmma"),)),
                per_call_launches(fa.flash_fwd, ((fa.WGMMA_MAX_D, "wgmma"),)))
    return (per_call_launches(fa.flash_bwd_dq,
                              ((fa.WGMMA_F32_DQ_MAX_D, "tf32x3"),
                               (fa.WGMMA_F32_DQ_WIDE_MAX_D, "tf32x3_wide"))),
            per_call_launches(fa.flash_bwd_dkv,
                              ((fa.WGMMA_F32_DKV_MAX_D, "tf32x3"),
                               (fa.WGMMA_F32_DKV_WIDE_MAX_D, "tf32x3_wide"))),
            per_call_launches(fa.flash_fwd,
                              ((fa.WGMMA_F32_FWD_MAX_D, "tf32x3"),)))


def train_f32_steps(trainable, base, batch, gen) -> dict:
    """The f32 DreamBooth-LoRA step (the trainer's default dtype; AdamW lr
    1e-4, clip 1.0) on phase 7's f32 model: TRAIN_F32_WARMUP warm-up and
    TRAIN_F32_STEPS timed steps, each launching the kernels _per_step_want
    gives; their median wall time."""
    from lora_tpu_torch.training.optim import make_optimizer

    step = _make_step(make_optimizer(trainable, {"lora_unet": 1e-4}),
                      dtype=torch.float32)
    fns = (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd)
    want = _per_step_want(torch.float32)
    losses, step_ms = [], []
    for i in range(TRAIN_F32_WARMUP + TRAIN_F32_STEPS):
        before = [dict(f.launches_by_kernel) for f in fns]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(trainable, base, batch, gen))
        torch.cuda.synchronize()
        if i >= TRAIN_F32_WARMUP:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        got = tuple({r: n - was[r] for r, n in f.launches_by_kernel.items()}
                    for f, was in zip(fns, before))
        if got != want:
            raise AssertionError(f"an f32 training step launched (dQ, "
                                 f"dK/dV, forward) {got}, not {want}")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite f32 loss: {losses.tolist()}")
    out = {"warmup": TRAIN_F32_WARMUP, "timed_steps": TRAIN_F32_STEPS,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "dq_launches_per_step": want[0], "dkv_launches_per_step": want[1]}
    log("train f32: " + json.dumps(out))
    return out


def _param_bytes(module) -> int:
    return sum(t.numel() * t.element_size() for t in module.parameters())


def _int8_dense(module, prefix: str = "") -> int:
    """2-D int8 weights under `prefix`: the int8_matmul launches of one
    call through them."""
    return sum(1 for name, t in module.named_parameters()
               if t.dtype == torch.int8 and t.ndim == 2
               and name.startswith(prefix))


def _http(port: int, path: str, payload=None):
    """(status, JSON body) of a request to the server on localhost; any
    status but 200 raises."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _check_pngs(images, n: int, size: int) -> None:
    """n base64 PNGs, each 8-bit RGB of size x size (signature and IHDR)."""
    if len(images) != n:
        raise AssertionError(f"{len(images)} images, not {n}")
    for b64 in images:
        png = base64.b64decode(b64)
        w, h, depth, color = struct.unpack(">IIBB", png[16:26])
        if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR" or \
                (w, h, depth, color) != (size, size, 8, 2):
            raise AssertionError(f"not a {size}x{size} RGB PNG: {png[:32]!r}")


def phase_serve_int8(smi: str, bf16_request_s: float):
    """Quantized serving at full SD-1.5 width through PipelineServer."""
    from lora_tpu_torch import serve

    pipe = _patched_pipe("serve_int8")
    # one UNet call at batch 4 (the 2 prompts under CFG), bf16 weights
    with torch.inference_mode():
        ctx = torch.cat([pipe.encode_prompt([""] * len(PROMPTS)),
                         pipe.encode_prompt(PROMPTS)])
        lat = pipe.prepare_latents(2 * len(PROMPTS), 512, 512,
                                   torch.Generator("cuda").manual_seed(SEED))
        t = torch.full((2 * len(PROMPTS),), 501, device="cuda")
        ref = pipe.unet(lat, t, ctx, lora=pipe.lora_unet).float()
    modules = {"unet": pipe.unet, "text_encoder": pipe.text_encoder,
               "vae": pipe.vae}
    bytes_bf16 = {k: _param_bytes(m) for k, m in modules.items()}
    t0 = time.perf_counter()
    pipe.quantize_base()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    bytes_int8 = {k: _param_bytes(m) for k, m in modules.items()}
    per_call = {"unet": _int8_dense(pipe.unet),
                "clip_encode": _int8_dense(pipe.text_encoder),
                "vae_decode": _int8_dense(pipe.vae, "decoder.")}
    if per_call != INT8_PER_CALL:
        raise AssertionError(f"2-D int8 weights per call {per_call}, not "
                             f"{INT8_PER_CALL}")
    ratio = bytes_int8["unet"] / bytes_bf16["unet"]
    _zero_counts()
    with torch.inference_mode():
        out = pipe.unet(lat, t, ctx, lora=pipe.lora_unet).float()
    torch.cuda.synchronize()
    unet_launches = i8.int8_matmul.launches
    unet_by_kernel = dict(i8.int8_matmul.launches_by_kernel)
    rel = ((out - ref).norm() / ref.norm()).item()
    log("serve_int8: " + json.dumps({
        "param_bytes_bf16": bytes_bf16, "param_bytes_int8": bytes_int8,
        "unet_bytes_ratio": ratio, "quantize_s": quantize_s,
        "unet_call_rel_l2_vs_bf16": rel, "unet_call_int8_launches":
        unet_by_kernel, "limits": {"rel_l2": QUANT_UNET_REL_L2_TOL,
                                  "unet_bytes_ratio": QUANT_UNET_BYTES_MAX}}))
    if ratio > QUANT_UNET_BYTES_MAX:
        raise AssertionError(f"quantized UNet holds {ratio:.3f}x its bf16 "
                             f"bytes")
    if unet_by_kernel != {"wgmma": per_call["unet"], "mma": 0} or \
            unet_launches != per_call["unet"]:
        raise AssertionError(f"one UNet call launched int8_matmul "
                             f"{unet_by_kernel} times")
    if not (np.isfinite(rel) and rel <= QUANT_UNET_REL_L2_TOL):
        raise AssertionError(f"quantized UNet call is {rel} (relative L2) "
                             f"from the bf16 one")
    del ref, out, ctx, lat

    encodes = [0]  # CLIP encode calls, each one int8 launch per 2-D weight
    encode_prompt = pipe.encode_prompt

    def counted_encode(prompts):
        encodes[0] += 1
        return encode_prompt(prompts)

    pipe.encode_prompt = counted_encode
    srv = serve.PipelineServer(pipe, port=0, max_batch=4,
                               batch_window_ms=500.0).start()
    try:
        warmup_s = srv.warmup(steps=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def want(encode_calls):
            return (per_call["unet"] * STEPS + per_call["clip_encode"]
                    * encode_calls + per_call["vae_decode"])

        # request A: the 2 prompts at 50 steps, CFG 7.5; the counted run
        encodes[0] = 0
        _zero_counts()
        t0 = time.perf_counter()
        _, body = _http(srv.port, "/generate", {
            "prompt": PROMPTS, "steps": STEPS, "guidance": 7.5,
            "height": 512, "width": 512, "seed": 1})
        wall_a = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches_a, fwd_a = i8.int8_matmul.launches, fa.flash_fwd.launches
        by_kernel_a = dict(i8.int8_matmul.launches_by_kernel)
        fwd_by_kernel_a = dict(fa.flash_fwd.launches_by_kernel)
        encodes_a = encodes[0]
        _check_pngs(body["images"], len(PROMPTS), 512)
        # every bf16 int8 call of the request launched the wgmma kernel
        if launches_a != want(encodes_a) or \
                by_kernel_a != {"wgmma": launches_a, "mma": 0} or \
                fwd_a != ROUTED_PER_UNET_CALL * STEPS or \
                fwd_by_kernel_a != _only("wgmma", fwd_a):
            raise AssertionError(
                f"request A launched int8_matmul {by_kernel_a} times (want "
                f"{want(encodes_a)}, {encodes_a} CLIP encodes) and flash_fwd "
                f"{fwd_by_kernel_a} times")
        # the pipeline called directly with the same latents and the
        # embeddings the server used gives the same PNGs
        with srv.lock:
            key = srv._embed_key_alpha()
            emb = torch.stack([srv._embeds[(p, key)] for p in PROMPTS])
            neg = torch.stack([srv._embeds[("", key)]] * len(PROMPTS))
            t0 = time.perf_counter()
            direct = pipe(None, num_inference_steps=STEPS, guidance_scale=7.5,
                          height=512, width=512, prompt_embeds=emb,
                          negative_prompt_embeds=neg,
                          latents=pipe.prepare_latents(
                              len(PROMPTS), 512, 512,
                              torch.Generator("cuda").manual_seed(1)))
            direct_s = time.perf_counter() - t0
        if [serve._png_b64(im) for im in direct] != body["images"]:
            raise AssertionError("request A's PNGs differ from the pipeline "
                                 "called directly")

        # request B: concurrent one-prompt requests in one device batch
        results = [None] * B_REQUESTS
        errors = []

        def fire(i):
            try:
                results[i] = _http(srv.port, "/generate", {
                    "prompt": f"a <s1> request {i}", "steps": STEPS,
                    "guidance": 7.5, "height": 512, "width": 512,
                    "seed": 10 + i})[1]
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        encodes[0] = 0
        _zero_counts()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(B_REQUESTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_b = time.perf_counter() - t0
        if errors:
            raise errors[0]
        launches_b, encodes_b = i8.int8_matmul.launches, encodes[0]
        by_kernel_b = dict(i8.int8_matmul.launches_by_kernel)
        fwd_b = fa.flash_fwd.launches
        fwd_by_kernel_b = dict(fa.flash_fwd.launches_by_kernel)
        for r in results:
            _check_pngs(r["images"], 1, 512)
        batched = [r["batched_with"] for r in results]
        if batched != [B_REQUESTS] * B_REQUESTS or \
                srv.last_device_batch != B_REQUESTS:
            raise AssertionError(f"request B ran as batched_with {batched}, "
                                 f"device batch {srv.last_device_batch}")
        if launches_b != want(encodes_b) or \
                by_kernel_b != {"wgmma": launches_b, "mma": 0} or \
                fwd_b != ROUTED_PER_UNET_CALL * STEPS or \
                fwd_by_kernel_b != _only("wgmma", fwd_b):
            raise AssertionError(f"request B launched int8_matmul "
                                 f"{by_kernel_b} times (want "
                                 f"{want(encodes_b)}) and flash_fwd "
                                 f"{fwd_by_kernel_b}")

        _, health = _http(srv.port, "/healthz")
        _, metrics = _http(srv.port, "/metrics")
        expect = {"requests": 1 + B_REQUESTS,
                  "images": len(PROMPTS) + B_REQUESTS, "shed": 0,
                  "inflight": 0, "queued_rows": 0, "scheduler_alive": True,
                  "last_device_batch": B_REQUESTS}
        got = {k: metrics[k] for k in expect}
        if health.get("ok") is not True or got != expect:
            raise AssertionError(f"healthz {health}, metrics {got} "
                                 f"(want {expect})")
        if srv.drain(timeout=60) is not True:
            raise AssertionError("the server did not drain")
    finally:
        srv.stop()
    log("serve_int8: " + json.dumps({
        "request_a_wall_s": wall_a, "request_a_latency_ms": body["latency_ms"],
        "request_a_peak_mem_gib": peak_gib, "direct_call_s": direct_s,
        "bf16_slice_request_s": bf16_request_s,
        "request_b_wall_s": wall_b, "request_b_batched_with": batched,
        "warmup_s": warmup_s, "int8_launches_per_call": per_call,
        "launches_a": {"int8_matmul": by_kernel_a,
                       "flash_fwd": fwd_by_kernel_a,
                       "clip_encodes": encodes_a},
        "launches_b": {"int8_matmul": by_kernel_b,
                       "flash_fwd": fwd_by_kernel_b,
                       "clip_encodes": encodes_b},
        "healthz_devices": health["devices"], "metrics": metrics,
        "card": smi}))
    del srv, pipe
    torch.cuda.empty_cache()
    return launches_a + launches_b, {
        r: fwd_by_kernel_a[r] + fwd_by_kernel_b[r] for r in fwd_by_kernel_a}


def phase_serve_int8_f32(smi: str):
    """The SD-1.5 UNet served in f32 with int8 weights: one call at batch 4
    (random weights and inputs from the seed) through the int8 mma kernel
    (the wgmma kernel takes bf16 x only) and the tf32x3 flash forward
    kernel (f32 at every level), within QUANT_UNET_REL_L2_TOL of the same
    UNet unquantized. Returns the int8 mma kernel's launches and the flash
    forward's by kernel."""
    from lora_tpu_torch.core.quantize import quantize_params_int8
    from lora_tpu_torch.models.config import SD15_UNET
    from lora_tpu_torch.models.unet import UNet

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    unet = UNet(SD15_UNET, device="cuda", dtype=torch.float32, generator=gen)
    b = 2 * len(PROMPTS)
    lat = torch.randn((b, 64, 64, SD15_UNET.in_channels), generator=gen,
                      device="cuda")
    ctx = torch.randn((b, 77, SD15_UNET.cross_attention_dim), generator=gen,
                      device="cuda")
    t = torch.full((b,), 501, device="cuda")
    with torch.inference_mode():
        ref = unet(lat, t, ctx)
        for name, v in quantize_params_int8(unet.flat_params()).items():
            unet.set_param(name, v)
        torch.cuda.synchronize()
        _zero_counts()  # the counted main-path run
        out = unet(lat, t, ctx)
        torch.cuda.synchronize()
    by_kernel = dict(i8.int8_matmul.launches_by_kernel)
    fwd_by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    rel = ((out - ref).norm() / ref.norm()).item()
    log("serve_int8_f32: " + json.dumps({
        "unet_call_rel_l2_vs_f32": rel, "int8_launches": by_kernel,
        "flash_fwd_launches": fwd_by_kernel,
        "limit": QUANT_UNET_REL_L2_TOL, "card": smi}))
    if by_kernel != {"wgmma": 0, "mma": INT8_PER_CALL["unet"]} or \
            fwd_by_kernel != _per_step_want(torch.float32)[2]:
        raise AssertionError(f"the f32 quantized UNet call launched "
                             f"{by_kernel} int8 and {fwd_by_kernel} flash "
                             f"forward kernels")
    if not (out.shape == ref.shape and np.isfinite(rel)
            and rel <= QUANT_UNET_REL_L2_TOL):
        raise AssertionError(f"f32 quantized UNet call is {rel} (relative "
                             f"L2) from the f32 one")
    del unet, ref, out
    torch.cuda.empty_cache()
    return by_kernel["mma"], fwd_by_kernel


def main_flash() -> int:
    """The three forward kernels alone: the device line, their builds, the
    wgmma and tf32x3 kernels' first calls in child processes under a
    timeout, phase 3 and its per-call sums."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3"])
    flash_probe()
    tf32x3_fwd_probe()
    flash_call_sums(phase_kernels())
    log(smi)
    return 0


def main_flash_bwd() -> int:
    """The backward kernels alone: the device line, the builds of the three
    forward kernels (the residuals, bf16 and f32), flash_bwd.cu,
    flash_bwd_dkv_wgmma.cu, flash_bwd_dq_wgmma.cu, flash_bwd_dkv_tf32x3.cu,
    flash_bwd_dkv_tf32x3_wide.cu, flash_bwd_dq_tf32x3.cu and
    flash_bwd_dq_tf32x3_wide.cu, the tf32x3 forward's, wgmma dQ, wgmma
    dK/dV, tf32x3 dQ, tf32x3 dK/dV, tf32x3_wide dQ and tf32x3_wide dK/dV
    kernels' first calls in child processes under a timeout, phase 4 and
    its sums over one training step (bf16 and f32)."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3",
                 "flash_bwd",
                 "flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3_wide",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3_wide"])
    tf32x3_fwd_probe()
    dq_probe()
    dkv_probe()
    tf32x3_dq_probe()
    tf32x3_probe()
    tf32x3_wide_dq_probe()
    tf32x3_wide_probe()
    bwd_step_sums(phase_bwd_kernels())
    log(smi)
    return 0


def main_int8(tiles: bool) -> int:
    """The int8 kernels alone: the device line, their two builds, phase 8
    with its per-call sums, and with `tiles` every wgmma tile instance."""
    smi = phase_device()
    phase_build(["int8_matmul", "int8_matmul_wgmma"])
    int8_call_sums(phase_int8_kernels())
    if tiles:
        int8_tile_sweep(int8_path_shapes() + int8_phase_shapes())
    log(smi)
    return 0


def main() -> int:
    smi = phase_device()
    phase_build()
    tf32x3_fwd_probe()
    dq_probe()
    dkv_probe()
    tf32x3_dq_probe()
    tf32x3_probe()
    tf32x3_wide_dq_probe()
    tf32x3_wide_probe()
    rows = phase_kernels()
    fwd_sums = flash_call_sums(rows)
    bwd_rows = phase_bwd_kernels()
    bwd_sums = bwd_step_sums(bwd_rows)
    with recording_flash_shapes(set()) as flash_seen:
        serve_fwd, bf16_request_s = phase_slice(smi)
        train_launches, train_fwd, train_dq, train_dkv = phase_train(smi)
        phase_grad()
        _zero_counts()  # the counted f32 training run
        grad_f32 = phase_grad(torch.float32)
        int8_rows = phase_int8_kernels()
        int8_sums = int8_call_sums(int8_rows)
        with recording_int8_shapes(set()) as seen:
            f32_launches, f32_fwd = phase_serve_int8_f32(smi)
            int8_launches, serve_int8_fwd = phase_serve_int8(smi,
                                                             bf16_request_s)
    unchecked = seen - {(r["M"], r["K"], r["N"], r["dtype"])
                        for r in int8_rows}
    if unchecked:
        raise AssertionError(f"quantized serving ran int8_matmul at shapes "
                             f"phase 8 did not check: {sorted(unchecked)}")
    unchecked = flash_seen - {_row_key(r) for r in rows}
    if unchecked:
        raise AssertionError(f"phases 5-9 ran flash_fwd at shapes or "
                             f"layouts phase 3 did not check: "
                             f"{sorted(unchecked)}")
    log(f"flash_fwd: phases 5-9 ran {len(flash_seen)} shapes and layouts, "
        f"each checked in phase 3")

    def at_main_shape(rs, dtype="bfloat16"):  # the largest main-path shape
        # (the forward's first such row is batch 4's, the backward's only)
        return next(r for r in rs if r["dtype"] == dtype
                    and r["T"] == SD15_ATTN_SHAPES[0][0])

    def timed(row, prefix=""):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by")
        return {k: row[prefix + k] for k in keys}

    fwd, bwd = at_main_shape(rows), at_main_shape(bwd_rows)
    fwd_f32 = at_main_shape(rows, "float32")
    bf16_bwd = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    # the per-kernel counts each bf16 main path measured, summed
    by_path = {"txt2img": serve_fwd, "train": train_fwd,
               "serve_int8": serve_int8_fwd}
    fwd_by_kernel = {r: sum(c[r] for c in by_path.values())
                     for r in fa.flash_fwd.launches_by_kernel}
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_fwd_wgmma.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:104",
        # the serving run (50 UNet calls), the timed training steps and the
        # two quantized HTTP requests (50 UNet calls each): all bf16, all
        # through the wgmma kernel (each phase checks it)
        "launches": fwd_by_kernel["wgmma"],
        "launches_by_path": {p: c["wgmma"] for p, c in by_path.items()},
        "launches_by_kernel": fwd_by_kernel,
        # worst O error over the bf16 calls of phase 3
        "max_abs_err": max(r["err_o"] for r in rows
                           if r["dtype"] == "bfloat16"),
        # median per launch at the largest main-path shape, bf16 (batch 4),
        # through the kernel's C entry point; device: CUDA-graph replay;
        # prev: the mma kernel (flash_fwd.cu) the same way on the same
        # inputs; library: torch's SDPA on the same q, k, v; exp_floor: the
        # softmax's exponentials at 16 a clock per SM
        **timed(fwd),
        "device_ms": fwd["device_ms"],
        "prev_ms": fwd["prev_ms"],
        "prev_device_ms": fwd["prev_device_ms"],
        "library_ms": fwd["library_ms"],
        "exp_floor_ms": fwd["exp_floor_ms"],
        # every column summed over the 15 launches of one UNet call
        "per_unet_call": {k: v for k, v in fwd_sums.items()
                          if not k.startswith("f32_")},
    }]
    # the f32 forward: the f32 quantized UNet call of phase 9a and the
    # counted f32 training run of phase 7 (f32 attention)
    f32_by_path = {"serve_int8_f32": f32_fwd,
                   "train_f32_grad": grad_f32["fwd_launches_by_kernel"]}
    f32_fwd_by_kernel = {r: sum(c[r] for c in f32_by_path.values())
                         for r in fa.flash_fwd.launches_by_kernel}
    f32_rows = [r for r in rows if r["dtype"] == "float32"]
    tf32x3_rows = [r for r in f32_rows if r["kernel"] == ["tf32x3"]]
    long_rows = {name: next(r for r in f32_rows
                            if (r["H"], r["T"], r["D"]) == level)
                 for name, level in (("sd21_768", SD21_768_LEVEL),
                                     ("wide_long", WIDE_LONG_LEVEL))}
    kernels += [{
        "name": "flash_fwd_tf32x3",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_fwd_tf32x3.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:104",
        # every f32 forward launch of both counted f32 paths at
        # D <= WGMMA_F32_FWD_MAX_D (phases 7 and 9a check it)
        "launches": f32_fwd_by_kernel["tf32x3"],
        "launches_by_path": {p: c["tf32x3"] for p, c in f32_by_path.items()},
        "launches_by_kernel": f32_fwd_by_kernel,
        # worst O and L errors over the f32 calls of phase 3 routed here
        # (the SD-1.5 levels at batch 4 and 1, the ragged calls at every D,
        # the long calls), both q-tile heights
        "max_abs_err": max(r[k] for r in tf32x3_rows
                           for k in ("err_o", "err_o_other_bm")
                           if k in r),
        "max_abs_err_lse": max(r[k] for r in tf32x3_rows
                               for k in ("err_lse", "err_lse_other_bm")
                               if k in r),
        "long_t_abs_err": {n: {"o": r["err_o"], "lse": r["err_lse"]}
                           for n, r in long_rows.items()},
        # at the largest main-path shape in f32 (batch 4), through the C
        # entry point; device: CUDA-graph replay; wrapper: flash_fwd;
        # prev: flash_fwd.cu on the same inputs; bound: 3xTF32 at the dense
        # TF32 rate, ffma_bound: the same work on CUDA-core FMAs; library:
        # SDPA in f32
        **timed(fwd_f32),
        "device_ms": fwd_f32["device_ms"],
        "wrapper_ms": fwd_f32["wrapper_ms"],
        "prev_ms": fwd_f32["prev_ms"],
        "prev_device_ms": fwd_f32["prev_device_ms"],
        "ffma_bound_ms": fwd_f32["ffma_bound_ms"],
        "library_ms": fwd_f32["library_ms"],
        "library_device_ms": fwd_f32["library_device_ms"],
        "exp_floor_ms": fwd_f32["exp_floor_ms"],
        # every column summed over the 15 launches of one f32 UNet call
        # (batch 4) and of one f32 training step (batch 1)
        "per_f32_unet_call": fwd_sums["f32_B4"],
        "per_f32_training_step": fwd_sums["f32_B1"],
    }, {
        "name": "flash_fwd_mma",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:104",
        # f32 beyond WGMMA_F32_FWD_MAX_D and broadcast strides: none of the
        # counted paths' calls
        "launches": f32_fwd_by_kernel["mma"] + fwd_by_kernel["mma"],
        "launches_by_path": {**{p: c["mma"] for p, c in f32_by_path.items()},
                             **{p: c["mma"] for p, c in by_path.items()}},
        # worst f32 O error of phase 3: the kernel called directly beside
        # the tf32x3 one on the same inputs
        "max_abs_err": max(r["err_o_prev"] for r in f32_rows
                           if "err_o_prev" in r),
        # at the largest main-path shape in f32 (batch 4), called directly
        # on the tf32x3 kernel's inputs; the bound at the f32 rate (the
        # kernel's CUDA-core FMAs); library: SDPA in f32
        "ms": fwd_f32["prev_ms"],
        "device_ms": fwd_f32["prev_device_ms"],
        "plain_ms": fwd_f32["plain_ms"],
        "bound_ms": fwd_f32["ffma_bound_ms"],
        "bound_by": fwd_f32["ffma_bound_by"],
        "library_ms": fwd_f32["library_ms"],
        "exp_floor_ms": fwd_f32["exp_floor_ms"],
    }]
    bwd_f32 = at_main_shape(bwd_rows, "float32")
    # median per launch at T = S = 4096, D = 40, bf16, B = 1, H = 8,
    # through each kernel's C entry point; device: CUDA-graph replay;
    # library: one autograd.grad of SDPA, which computes dQ, dK and dV
    # together (compare it with the two kernels' sum; its device time is
    # the profiler's); exp_floor: the recomputed P's exponentials at 16 a
    # clock per SM
    kernels.append({
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dq_wgmma.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:178",
        # the timed training steps: every launch at D <= WGMMA_DQ_MAX_D
        # (phase 6 checks it)
        "launches": train_dq["wgmma"],
        "launches_by_path": {"train": train_dq["wgmma"]},
        "launches_by_kernel": train_dq,
        # worst dQ error over the bf16 calls of phase 4 routed here
        "max_abs_err": max(r[f"err_{e}"] for r in bf16_bwd
                           if r["dq_route"] == "wgmma"
                           for e in ("dq", "dq_bm64", "dq_bm128")),
        # the kernel on Q~ formed beforehand; wrapper: flash_bwd_dq with
        # its Q~; prev: the mma kernel (flash_bwd.cu) on the same inputs
        **timed(bwd, "dq_"),
        "device_ms": bwd["dq_device_ms"],
        "wrapper_ms": bwd["dq_wrapper_ms"],
        "prev_ms": bwd["dq_prev_ms"],
        "prev_device_ms": bwd["dq_prev_device_ms"],
        "library_ms": bwd["library_ms"],
        "library_device_ms": bwd["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd["exp_floor_ms"],
        # every column summed over the 15 launches of one training step
        "per_training_step": {k: v for k, v in bwd_sums["bfloat16"].items()
                              if not k.startswith("dkv_")},
    })
    f32_dq = grad_f32["dq_launches_by_kernel"]
    f32_bwd = [r for r in bwd_rows if r["dtype"] == "float32"]
    sd21 = next(r for r in f32_bwd if (r["H"], r["T"], r["D"])
                == SD21_768_LEVEL)
    kernels.append({
        "name": "flash_bwd_dq_tf32x3",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dq_tf32x3.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:178",
        # the counted f32 training run of phase 7: every dQ launch at
        # D <= WGMMA_F32_DQ_MAX_D (phase 7 checks it)
        "launches": f32_dq["tf32x3"],
        "launches_by_path": {"train_f32_grad": f32_dq["tf32x3"]},
        "launches_by_kernel": f32_dq,
        # worst dQ error over the f32 calls of phase 4 routed here
        "max_abs_err": max(r[f"err_{e}"] for r in f32_bwd
                           if r["dq_route"] == "tf32x3"
                           for e in ("dq", "dq_bm64", "dq_bm128")
                           if f"err_{e}" in r),
        # dQ, dK and dV at SD-2.1's 768px level (H = 5, T = S = 9216,
        # D = 64), relative to the plain versions' largest values
        "sd21_768_rel_err": {n: sd21[f"rel_{n}"] for n in ("dq", "dk", "dv")},
        # at the main training shape in f32: the kernel on Q~ and its split
        # operands formed beforehand; split: forming the split both tf32x3
        # kernels read, once per backward call; wrapper: flash_bwd_dq with
        # its Q~ and split; prev: the mma kernel (flash_bwd.cu) on the same
        # inputs; bound: 3xTF32 at the dense TF32 rate, ffma_bound: the
        # same work on CUDA-core FMAs; library: SDPA's backward in f32
        **timed(bwd_f32, "dq_"),
        "device_ms": bwd_f32["dq_device_ms"],
        "split_ms": bwd_f32["split_ms"],
        "split_device_ms": bwd_f32["split_device_ms"],
        "wrapper_ms": bwd_f32["dq_wrapper_ms"],
        "prev_ms": bwd_f32["dq_prev_ms"],
        "prev_device_ms": bwd_f32["dq_prev_device_ms"],
        "ffma_bound_ms": bwd_f32["dq_ffma_bound_ms"],
        "library_ms": bwd_f32["library_ms"],
        "library_device_ms": bwd_f32["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd_f32["exp_floor_ms"],
        # every f32 column summed over the 15 launches of one f32 step
        # (the D = 160 level's through the tf32x3_wide kernel)
        "per_training_step": {k: v for k, v in bwd_sums["float32"].items()
                              if not k.startswith("dkv_")},
        "train_f32_step_ms_median": grad_f32["train_f32"]["step_ms_median"],
    })
    wide = next(r for r in f32_bwd if "dq_ms" in r
                and (r["T"], r["D"]) == SD15_ATTN_SHAPES[-1])
    wide_long = next(r for r in f32_bwd if (r["H"], r["T"], r["D"])
                     == WIDE_LONG_LEVEL)
    wide_dq_rows = [r for r in f32_bwd if r["dq_route"] == "tf32x3_wide"]
    kernels.append({
        "name": "flash_bwd_dq_tf32x3_wide",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dq_tf32x3_wide.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:178",
        # the counted f32 training run of phase 7: every dQ launch at
        # WGMMA_F32_DQ_MAX_D < D <= WGMMA_F32_DQ_WIDE_MAX_D (phase 7 checks
        # it)
        "launches": f32_dq["tf32x3_wide"],
        "launches_by_path": {"train_f32_grad": f32_dq["tf32x3_wide"]},
        "launches_by_kernel": f32_dq,
        # worst dQ error over the f32 calls of phase 4 routed here (the
        # 16x16 level, the ragged sweep of D from 104 to 160 and
        # T = S = 4096), absolute and relative to the plain version's
        # largest value
        "max_abs_err": max(r[f"err_{e}"] for r in wide_dq_rows
                           for e in ("dq", "dq_bm64")),
        "max_rel_err": max(r[f"rel_{e}"] for r in wide_dq_rows
                           for e in ("dq", "dq_bm64")),
        "long_t_rel_err": wide_long["rel_dq"],
        # at the 16x16 training level in f32 (T = S = 256, D = 160, B = 1,
        # H = 8): the kernel on Q~ and its split operands formed
        # beforehand; split: forming them for both kernels, split_dkv_only:
        # the dK/dV kernel's part alone (what was formed at this level
        # before this kernel read it); wrapper: flash_bwd_dq with its Q~
        # and split; prev: the mma kernel (flash_bwd.cu) on the same
        # inputs; bound: 3xTF32 at the dense TF32 rate, ffma_bound: the same
        # work on CUDA-core FMAs; library: SDPA's backward in f32
        **timed(wide, "dq_"),
        "device_ms": wide["dq_device_ms"],
        "split_ms": wide["split_ms"],
        "split_device_ms": wide["split_device_ms"],
        "split_dkv_only_device_ms": wide["split_dkv_only_device_ms"],
        "wrapper_ms": wide["dq_wrapper_ms"],
        "prev_ms": wide["dq_prev_ms"],
        "prev_device_ms": wide["dq_prev_device_ms"],
        "ffma_bound_ms": wide["dq_ffma_bound_ms"],
        "library_ms": wide["library_ms"],
        "library_device_ms": wide["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": wide["exp_floor_ms"],
    })
    kernels.append({
        "name": "flash_bwd_dq_mma",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:178",
        # the f32 training run of phase 7 at D > WGMMA_F32_DQ_WIDE_MAX_D,
        # and the bf16 training steps at D > WGMMA_DQ_MAX_D: none at
        # SD-1.5's levels
        "launches": f32_dq["mma"] + train_dq["mma"],
        "launches_by_path": {"train_f32_grad": f32_dq["mma"],
                             "train": train_dq["mma"]},
        # worst f32 error of phase 4: the calls routed here, and the
        # kernel called directly beside the tf32x3 and tf32x3_wide ones
        "max_abs_err": max(r[f"err_{e}"] for r in f32_bwd
                           for e in (("dq",) if r["dq_route"] == "mma"
                                     else ("dq_prev",))),
        # at the main training shape in f32 (called directly on the tf32x3
        # kernel's inputs), the bound at the f32 rate (the kernel's
        # CUDA-core FMAs); library: SDPA's backward in f32
        "ms": bwd_f32["dq_prev_ms"],
        "device_ms": bwd_f32["dq_prev_device_ms"],
        "plain_ms": bwd_f32["dq_plain_ms"],
        "bound_ms": bwd_f32["dq_ffma_bound_ms"],
        "bound_by": bwd_f32["dq_ffma_bound_by"],
        "library_ms": bwd_f32["library_ms"],
        "library_device_ms": bwd_f32["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd_f32["exp_floor_ms"],
    })
    kernels.append({
        "name": "flash_bwd_dkv",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dkv_wgmma.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:210",
        # the timed training steps: every launch at D <= WGMMA_DKV_MAX_D
        # (phase 6 checks it)
        "launches": train_dkv["wgmma"],
        "launches_by_path": {"train": train_dkv["wgmma"]},
        "launches_by_kernel": train_dkv,
        # worst dK / dV error over the bf16 calls of phase 4 routed here
        "max_abs_err": max(r[f"err_{e}"] for r in bf16_bwd
                           if r["route"] == "wgmma"
                           for e in ("dk", "dv", "dk_bn64", "dv_bn64",
                                     "dk_bn128", "dv_bn128")),
        # the kernel on Q~ formed beforehand; wrapper: flash_bwd_dkv with
        # its Q~; prev: the mma kernel (flash_bwd.cu) on the same inputs
        **timed(bwd, "dkv_"),
        "device_ms": bwd["dkv_device_ms"],
        "wrapper_ms": bwd["dkv_wrapper_ms"],
        "prev_ms": bwd["dkv_prev_ms"],
        "prev_device_ms": bwd["dkv_prev_device_ms"],
        "library_ms": bwd["library_ms"],
        "library_device_ms": bwd["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd["exp_floor_ms"],
        # every column summed over the 15 launches of one training step
        "per_training_step": {k: v for k, v in bwd_sums["bfloat16"].items()
                              if not k.startswith("dq_")},
    })
    f32_dkv = grad_f32["dkv_launches_by_kernel"]
    kernels.append({
        "name": "flash_bwd_dkv_tf32x3",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dkv_tf32x3.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:210",
        # the counted f32 training run of phase 7: every dK/dV launch at
        # D <= WGMMA_F32_DKV_MAX_D (phase 7 checks it)
        "launches": f32_dkv["tf32x3"],
        "launches_by_path": {"train_f32_grad": f32_dkv["tf32x3"]},
        "launches_by_kernel": f32_dkv,
        # worst dK / dV error over the f32 calls of phase 4 routed here
        "max_abs_err": max(r[f"err_{e}"] for r in f32_bwd
                           if r["route"] == "tf32x3"
                           for e in ("dk", "dv", "dk_bn64", "dv_bn64",
                                     "dk_bn128", "dv_bn128")
                           if f"err_{e}" in r),
        # at the main training shape in f32: the kernel on Q~ and its split
        # operands formed beforehand; split: forming the split both tf32x3
        # kernels read; wrapper: flash_bwd_dkv with its Q~ and split (its
        # own part only); prev: the mma kernel
        # (flash_bwd.cu) on the same inputs; bound: 3xTF32 at the dense
        # TF32 rate, ffma_bound: the same work on CUDA-core FMAs; library:
        # SDPA's backward in f32
        **timed(bwd_f32, "dkv_"),
        "device_ms": bwd_f32["dkv_device_ms"],
        "split_ms": bwd_f32["split_ms"],
        "split_device_ms": bwd_f32["split_device_ms"],
        "wrapper_ms": bwd_f32["dkv_wrapper_ms"],
        "prev_ms": bwd_f32["dkv_prev_ms"],
        "prev_device_ms": bwd_f32["dkv_prev_device_ms"],
        "ffma_bound_ms": bwd_f32["dkv_ffma_bound_ms"],
        "library_ms": bwd_f32["library_ms"],
        "library_device_ms": bwd_f32["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd_f32["exp_floor_ms"],
        # every f32 column summed over the 15 launches of one f32 step
        # (the D = 160 level's through the tf32x3_wide kernel)
        "per_training_step": {k: v for k, v in bwd_sums["float32"].items()
                              if not k.startswith("dq_")},
        "train_f32_step_ms_median": grad_f32["train_f32"]["step_ms_median"],
    })
    wide_rows = [r for r in f32_bwd if r["route"] == "tf32x3_wide"]
    kernels.append({
        "name": "flash_bwd_dkv_tf32x3_wide",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd_dkv_tf32x3_wide.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:210",
        # the counted f32 training run of phase 7: every dK/dV launch at
        # WGMMA_F32_DKV_MAX_D < D <= WGMMA_F32_DKV_WIDE_MAX_D (phase 7
        # checks it)
        "launches": f32_dkv["tf32x3_wide"],
        "launches_by_path": {"train_f32_grad": f32_dkv["tf32x3_wide"]},
        "launches_by_kernel": f32_dkv,
        # worst dK / dV error over the f32 calls of phase 4 routed here
        # (the 16x16 level, the ragged sweep of D from 104 to 160 and
        # T = S = 4096), absolute and relative to the plain version's
        # largest value
        "max_abs_err": max(r[f"err_{e}"] for r in wide_rows
                           for e in ("dk", "dv", "dk_bn64", "dv_bn64")),
        "max_rel_err": max(r[f"rel_{e}"] for r in wide_rows
                           for e in ("dk", "dv", "dk_bn64", "dv_bn64")),
        "long_t_rel_err": {n: wide_long[f"rel_{n}"] for n in ("dk", "dv")},
        # at the 16x16 training level in f32 (T = S = 256, D = 160, B = 1,
        # H = 8): the kernel on Q~ and its split operands formed
        # beforehand; split: forming them; wrapper: flash_bwd_dkv with its
        # Q~ and split; prev: the mma kernel (flash_bwd.cu) on the same
        # inputs; bound: 3xTF32 at the dense TF32 rate, ffma_bound: the
        # same work on CUDA-core FMAs; library: SDPA's backward in f32
        **timed(wide, "dkv_"),
        "device_ms": wide["dkv_device_ms"],
        "split_ms": wide["split_ms"],
        "split_device_ms": wide["split_device_ms"],
        "wrapper_ms": wide["dkv_wrapper_ms"],
        "prev_ms": wide["dkv_prev_ms"],
        "prev_device_ms": wide["dkv_prev_device_ms"],
        "ffma_bound_ms": wide["dkv_ffma_bound_ms"],
        "library_ms": wide["library_ms"],
        "library_device_ms": wide["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": wide["exp_floor_ms"],
    })
    kernels.append({
        "name": "flash_bwd_dkv_mma",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:210",
        # the f32 training run of phase 7 at D > WGMMA_F32_DKV_WIDE_MAX_D,
        # and the bf16 training steps at D > WGMMA_DKV_MAX_D: none at
        # SD-1.5's levels
        "launches": f32_dkv["mma"] + train_dkv["mma"],
        "launches_by_path": {"train_f32_grad": f32_dkv["mma"],
                             "train": train_dkv["mma"]},
        # worst f32 error of phase 4: the calls routed here, and the
        # kernel called directly beside the tf32x3 and tf32x3_wide ones
        "max_abs_err": max(r[f"err_{e}"] for r in f32_bwd
                           for e in (("dk", "dv") if r["route"] == "mma"
                                     else ("dk_prev", "dv_prev"))),
        # at the main training shape in f32 (called directly on the tf32x3
        # kernel's inputs), the bound at the f32 rate (the kernel's
        # CUDA-core FMAs); library: SDPA's backward in f32
        "ms": bwd_f32["dkv_prev_ms"],
        "device_ms": bwd_f32["dkv_prev_device_ms"],
        "plain_ms": bwd_f32["dkv_plain_ms"],
        "bound_ms": bwd_f32["dkv_ffma_bound_ms"],
        "bound_by": bwd_f32["dkv_ffma_bound_by"],
        "library_ms": bwd_f32["library_ms"],
        "library_device_ms": bwd_f32["library_device_ms"],
        "library_computes": "dq, dk, dv",
        "exp_floor_ms": bwd_f32["exp_floor_ms"],
    })
    main_int8 = {r["dtype"]: r for r in int8_rows if "ms" in r
                 and (r["M"], r["K"], r["N"]) == INT8_MAIN_SHAPE}
    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/int8_matmul_wgmma.cu",
        "replaces": "lora_tpu/ops/int8_matmul.py:35",
        # quantized serving: request A and request B, every bf16 call (all
        # of them wgmma), at shapes phase 8 checked
        "launches": int8_launches,
        "launches_by_path": {"serve_int8": int8_launches},
        "launches_by_kernel": {"wgmma": int8_launches, "mma": f32_launches},
        # worst error over the bf16 shapes of phase 8 (all through wgmma)
        "max_abs_err": max(r["err"] for r in int8_rows
                           if r["dtype"] == "bfloat16"),
        # median per launch at the GEGLU projection at 64x64, bf16, through
        # the kernel's C entry point; prev: the mma kernel the same way on
        # the same inputs; library: cuBLAS F.linear on the dequantized bf16
        # weight
        **timed(main_int8["bfloat16"]),
        "prev_ms": main_int8["bfloat16"]["prev_ms"],
        "library_ms": main_int8["bfloat16"]["library_ms"],
        # every column summed over the 182 launches of one UNet call at
        # batch 4 (each launch timed alone, host launch path included)
        "per_unet_call": int8_sums,
    })
    kernels.append({
        "name": "int8_matmul_mma",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "lora_tpu/ops/int8_matmul.py:35",
        # the f32 quantized UNet call of phase 9a (f32 x)
        "launches": f32_launches,
        "launches_by_path": {"serve_int8_f32": f32_launches},
        "max_abs_err": max(r["err"] for r in int8_rows
                           if r["dtype"] == "float32"),
        # at the GEGLU projection at 64x64, f32 x; library: F.linear in f32
        **timed(main_int8["float32"]),
        "library_ms": main_int8["float32"]["library_ms"],
    })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] in (["--int8"], ["--int8-tiles"]):
        sys.exit(main_int8(sys.argv[1] == "--int8-tiles"))
    if sys.argv[1:] == ["--flash"]:
        sys.exit(main_flash())
    if sys.argv[1:] == ["--flash-bwd"]:
        sys.exit(main_flash_bwd())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--int8 | --int8-tiles | --flash | "
                 f"--flash-bwd]")
    sys.exit(main())
