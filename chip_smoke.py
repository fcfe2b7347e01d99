#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lora_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, one CUDA device
    python3 chip_smoke.py --int8        # phases 1, 2 (int8 sources only,
                                        # the f32 wgmma kernel's first calls
                                        # in a child process under a
                                        # timeout), 8
    python3 chip_smoke.py --int8-tiles  # the same, then every tile
                                        # instance of both wgmma kernels at
                                        # every phase 8 shape and each
                                        # kernel's fitted time model (the
                                        # data of int8_matmul._TILE_US and
                                        # _TILE_US_F32)
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
    python3 chip_smoke.py --modes       # phases 1, 2 (flash_fwd.cu,
                                        # flash_fwd_wgmma.cu, int8_matmul.cu
                                        # and int8_matmul_wgmma.cu only),
                                        # 10, then phase 3's bf16 UNet
                                        # calls and phase 8's bf16 shapes
                                        # (untimed), every shape phase 10
                                        # reached checked against them
    python3 chip_smoke.py --adapters    # phases 1, 2 (flash_fwd.cu,
                                        # flash_fwd_wgmma.cu,
                                        # flash_fwd_tf32x3.cu, int8_matmul.cu
                                        # and int8_matmul_wgmma.cu only), the
                                        # tf32x3 forward's first calls in a
                                        # child process, 11, then phase 3's
                                        # UNet calls (bf16, and f32 at batch
                                        # 4) and request A's int8 shapes
                                        # (untimed), every shape phase 11
                                        # reached checked against them
    python3 chip_smoke.py --train       # phases 1, 2 (the flash sources
                                        # and adam8bit.cu only), the
                                        # tf32x3 and wgmma backward
                                        # kernels' first calls in child
                                        # processes under a timeout, 12
                                        # (with its own flash checks at
                                        # the trainer's shapes), and the
                                        # kernels line's adam8bit row
    python3 chip_smoke.py --pti         # phases 1, 2 (the flash sources
                                        # only), the tf32x3 and wgmma
                                        # kernels' first calls in child
                                        # processes under a timeout, 13
                                        # (with its own flash checks at
                                        # phase 13's shapes)
    python3 chip_smoke.py --sdxl        # phases 1, 2 (the forward and int8
                                        # sources only), the tf32x3 forward's
                                        # and the f32 int8 kernel's first
                                        # calls in child processes, 14 (with
                                        # its own flash and int8 checks at
                                        # phase 14's shapes)
    python3 chip_smoke.py --sdxl-train  # phases 1, 2 (the forward sources,
                                        # the bf16 and f32 D <= 96 backward
                                        # sources and flash_bwd.cu), those
                                        # kernels' first calls in child
                                        # processes, 15 (with its own flash
                                        # checks at phase 15's shapes)
    python3 chip_smoke.py --dist        # phases 1, 2 (the flash sources
                                        # and adam8bit.cu), the tf32x3
                                        # kernels' first calls in child
                                        # processes, 17, and phase 17's
                                        # launches by kernel
    python3 chip_smoke.py --dist-cards  # on a host of 2, 4, ... cards:
                                        # phases 1, 2 (the f32 flash
                                        # sources) and 17e, one rank a card
                                        # over NCCL
    python3 chip_smoke.py --ppim        # phases 1 and 18 (nothing to
                                        # build: the path launches no
                                        # kernel)
    python3 chip_smoke.py --tools       # phases 1, 2 (flash_fwd.cu and
                                        # flash_fwd_wgmma.cu only), 16
                                        # (writing its own SDXL directory),
                                        # then phase 3's bf16 calls at
                                        # batch 4 and 2, every shape phase
                                        # 16 ran checked against them, and
                                        # the flash_fwd row
    python3 chip_smoke.py --sd21        # phases 1, 19 while nvcc builds the
                                        # sources it and 19a run, 2 for
                                        # their ptxas reports, then 19a and
                                        # the kernels line's rows with
                                        # phase 19's launches

Phases, each printing its own lines and the full run its phases' end
times (about 13 minutes on one H100; a slow host takes up to a third as
long again). nvcc builds every source at the lowest CPU priority, one
thread and nvcc a source, while the full run goes through the phases
that launch none of the mma backward kernels (flash_bwd.cu, the build's
longest): 18 (no kernel of the port), 19, 3, 8, 5, 9a, 9, 10 and 11, each
waiting only for the libraries it launches. They launch the forward and
int8 kernels (none of them new) before phase 2's probes, and phase 19 is
checked against the plain versions in 19a, after phase 4; then 6, 7 and
12-17:
  1. device: the card's name and power limit (nvidia-smi); no CUDA, no run.
  2. build: compiles every kernel of lora_tpu_torch/ops/csrc/
     (flash_fwd.cu, flash_fwd_wgmma.cu, flash_fwd_tf32x3.cu, flash_bwd.cu,
     flash_bwd_dkv_wgmma.cu, flash_bwd_dq_wgmma.cu,
     flash_bwd_dkv_tf32x3.cu, flash_bwd_dkv_tf32x3_wide.cu,
     flash_bwd_dq_tf32x3.cu, flash_bwd_dq_tf32x3_wide.cu, int8_matmul.cu,
     int8_matmul_wgmma.cu, int8_matmul_wgmma_f32.cu, adam8bit.cu; one
     nvcc each, in parallel) for sm_90a into the build directory, and
     prints ptxas's registers, shared memory and spills of the wgmma and
     tf32x3 kernels, each tf32x3 forward and backward instance's tiles and
     each f32 int8 instance's ring; then the f32 int8 wgmma kernel's first
     calls (a ragged call, the main shape and K = 5120 at every tile
     instance), the tf32x3 forward kernel's first calls (f32: the ragged call,
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
     every (M, K, N) phases 9 and 9a run (UNet at batch 2, 4 and 8, CLIP,
     the VAE decoder's attention), bf16 (each call must launch the wgmma
     kernel, int8_matmul_wgmma.cu) and f32 (the f32 wgmma kernel,
     int8_matmul_wgmma_f32.cu), plus ragged calls routed to each kernel
     (the mma.sync kernel, int8_matmul.cu, for K % 16 != 0 and N % 8 != 0),
     a strided 3-D x and an unaligned bf16 call (mma); relative errors. At
     request A's shapes, median times of the routed kernel, of the mma
     kernel called directly on the same inputs ("prev", both dtypes), of
     cuBLAS (F.linear on the dequantized weight in x's dtype), of the plain
     version, and the bound; their sums over one UNet call at batch 4, bf16
     and f32. Every int8 call of phases 9 and 9a is recorded, and one at a
     shape not checked here fails the run.
  9a. serve_int8 f32: the SD-1.5 UNet in f32, quantized: one call at
     batch 4, within relative L2 5e-2 of the f32 UNet, 182 int8 launches,
     all of the f32 wgmma kernel, and 15 flash forward launches, all of the
     tf32x3 kernel (flash_fwd_tf32x3.cu: f32); then a warm call's wall and
     device time; then the prompts encoded by the f32 CLIP text encoder,
     quantized (72 launches, all of the f32 wgmma kernel), within relative
     L2 5e-2 of the unquantized one.
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
  10. modes: the rest of SD-1.5 sampling at full width, bf16, 512x512, 2
     prompts, MODE_STEPS (20) steps, CFG 7.5, on the slice's pipeline
     (LoRA + TI at 0.8): txt2img under pndm, euler, euler_a, dpm++,
     euler_karras and euler_a_karras; img2img (ddim) and latent-blend
     inpainting (ddim and euler_a) at strength 0.8 (16 steps), the blend's
     kept region checked
     to end at the image's latents exactly and the repainted region to
     move; the 9-channel inpaint (ddim) on a second random pipeline whose
     UNet is SD15_UNET with in_channels=9 (the runwayml/stable-diffusion-
     inpainting layout); then the slice's pipeline quantized behind a
     PipelineServer on localhost (max_batch 2) warmed over both image
     modes, and one img2img and one inpaint request over HTTP with PNGs
     encoded here: every int8 launch the weights imply (UNet, CLIP, the
     VAE encoder's and decoder's attention; all wgmma), the PNGs decoded
     to 512x512, the img2img pixels equal to the pipeline called directly.
     Each request is counted alone: 15 flash launches per UNet call, all
     through the wgmma kernel; its wall time is printed.
  11. adapters: kohya / LoCon and LyCORIS files at full SD-1.5 width,
     written from the seed: K (kohya LoCon over every UNet and text LoCon
     site, rank 8, alpha 4, every third 3x3 conv CP-decomposed) and L (one
     LyCORIS module per LoCon site, the algorithms of LYCORIS_LINEAR and
     LYCORIS_CONV round-robin: LoRA, LoHa flat and Tucker, LoKr full,
     factored and Tucker, IA3, DoRA, OFT with rescale, BOFT, GLoRA, full
     with diff_b; norm modules on every resnet norm1 and CLIP
     layer_norm1). Each file loaded in f32 on the card and on the CPU from
     the same base weights: every entry and param delta within 1e-5 of its
     largest value. On a bf16 pipeline: patch_pipe of K and of L timed,
     bf16 UNet calls at batch 4 without an adapter, with K and with L
     (median wall, profiler device time, 15 wgmma flash launches each);
     L served over HTTP (2 prompts, 512px, 20 DDIM steps, seed 7) at alpha
     1.0, 0.5, 1.0: requests 1 and 3 the same PNG bytes, request 2 not,
     the embed cache one entry per text and alpha; then K patched on the
     live server: every norm and bias param back to its original bit for
     bit, and one more request. L at alpha 0.7 against collapse_lora(0.7)
     in one UNet call at batch 4: bf16 printed, f32 within relative L2
     1e-4 (15 tf32x3 flash launches). Quantized: a second pipeline patched
     with a LyCORIS file without base-weight-dependent modules, then
     quantize_base(), one HTTP request (every int8 launch wgmma); then L
     refused on the int8 base with a ValueError. Every flash and int8 call
     of phases 5 to 11 is recorded, and one at a shape phase 3 or phase 8
     did not check fails the run.
  12. trainer: DreamBooth training through its entry point,
     cli.lora_db.train. 12a: the blockwise-int8 Adam kernel
     (csrc/adam8bit.cu) against its plain version at the counted run's
     UNet and CLIP group sizes, 256 * 1000 + 37 and 1 elements, 3 updates
     each with the clip scale on the device: params, codes and scales bit
     for bit; at the UNet group its wrapper, device (CUDA graph), plain
     and bound times. The flash kernels against their plain versions
     (untimed) at the trainer's shapes: f32 forward at batch 4 and 2, f32
     dQ and dK/dV at batch 2, bf16 at batch 1. 12b: a random full-width
     SD-1.5 pipeline from the seed written as an fp16 diffusers directory
     without a CLIP vocabulary (the hashed tokenizer, opted in), and four
     instance PNGs (512^2, 480x640, 720x480, 768^2). 12c: the counted run,
     f32 at 512px, rank 4, the text encoder trained, prior preservation
     with 2 class images sampled at 10 steps, the 8-bit Adam, uncached
     latents, lr 1e-4, 20 steps, saves every 10 with the train state, .pt
     and safetensors: 20 steps, no preemption, finite losses at steps 1,
     10 and 20, every artifact, the class PNGs at 512^2, the final file
     through patch_pipe moving a UNet call, and exactly the launches of 20
     f32 steps (per step 15 forward through flash_fwd_tf32x3.cu, dQ and
     dK/dV 10 through the tf32x3 and 5 through the tf32x3_wide kernels, 2
     adam8bit) and of 10 sampling UNet calls, none through an mma.sync
     kernel; the median step time (CUDA events around each step), peak
     memory and the 8-bit state's bytes against f32 AdamW's. 12d: resumed
     from 12c's train state to 25 steps. 12e: bf16, cached latents, LoCon
     targets in the kohya schema, AdamW, 5 steps, every flash launch
     through the wgmma kernels, the file through patch_pipe. 12f: `python
     -m lora_tpu_torch.cli.lora_db` as a child process, 2 steps with
     cached latents. Every flash forward call of 12c-12e is recorded and
     must be at a checked shape.
  13. pti: pivotal tuning through cli.lora_pti.train and the legacy TI
     trainer through cli.lora_ti.train. The flash kernels against their
     plain versions (untimed) at phase 13's shapes phases 3 and 4 did not
     check. 13a: 12b's pipeline, directory and PNGs, and a 9-channel
     SD-1.5 (in_channels=9) from the seed in bf16, written the same way.
     13b: the counted run, f32 at 512px, placeholder tokens <s1>|<s2>,
     the object template, face masks written by the dataset as gray PNGs
     (the ellipse fallback), the text encoder, continue_inversion, cached
     latents, rank 4, 4 inversion and 4 tuning steps of 2 micro-steps,
     saves every 2: every artifact (step_inv_2, step_inv_4, step_2,
     step_4, final_lora), finite losses of both phases, each TI row's
     norm nearer 0.4 after inversion than at its init, the final file
     through patch_pipe moving a text encode of a prompt with <s1> and a
     UNet call, and exactly 15 forward (tf32x3), 10 tf32x3 + 5
     tf32x3_wide dQ and dK/dV launches per tuning micro-step, one tf32x3
     dQ and dK/dV fewer per inversion micro-step (the first
     self-attention precedes every cross-attention, so no gradient
     reaches it while only the TI rows train), none through an mma.sync
     kernel; the median micro-step of each phase (CUDA events)
     and peak memory. 13c: the 9-channel UNet in bf16, train_inpainting,
     cached latents, LoCon targets, 2 + 2 steps: every flash launch
     wgmma, the kohya file through patch_pipe moving a 9-channel UNet
     call, the .embeds.pt sidecar through load_a1111_embedding. 13d: the
     legacy trainer, f32, 4 steps, unfreeze_lora_step 2, saves every 2 in
     .pt and safetensors: the TI row of lora_ti_s2 and lora_ti_final the
     same bits, the LoRA's up factors zero at s2, the launches as in 13b
     per step. 13e: `python -m lora_tpu_torch.cli.lora_pti` as a child
     process, 1 + 1 steps. Every flash forward call of 13b-13d is
     recorded and must be at a checked shape; each flash row of the
     kernels line gains the "pti" and "pti_bf16" launches.
  14. sdxl: SDXL serving at full width (models/config.py SDXL_UNET,
     SDXL_TEXT, SDXL_TEXT2, SDXL_VAE, the published
     stabilityai/stable-diffusion-xl-base-1.0 configs) and 1024x1024, random
     weights from the seed. 14a: the bf16 pipeline's parameters and weight
     bytes per model. 14b: the forward kernels against their plain versions
     at the SDXL self-attention levels (H 10, T = S = 4096 and H 20,
     T = S = 1024, D 64), timed at batch 2 in bf16 (wgmma) and f32
     (tf32x3), untimed in bf16 at batch 4; one UNet call at batch 2 with
     flash on against off (relative L2 within SDXL_FLASH_REL_L2), its
     flash launches by level (10 at T = 4096, 60 at T = 1024) and the
     timed columns summed over them, and one call under torch.profiler.
     14c: a txt2img request, 2 prompts, 20 DDIM
     steps, CFG 5.0: 70 wgmma flash launches per UNet call, its wall time
     and peak memory. 14e: a PipelineServer on localhost (max_batch 1):
     one txt2img, one img2img and one blend-inpaint (euler_a) request over
     HTTP, 10 steps (8 at strength 0.8), each answered with a 1024x1024
     PNG, counted alone. 14f: a LyCORIS-XL LoHa file (the UNet's and
     te2's default sites) and a kohya-XL file (rank 4 over the UNet's,
     te1's and te2's) from the seed, each through patch_pipe and
     tune_lora_scale(0.7) and one UNet call moving against the bare one;
     then the kohya-XL file folded by collapse_lora(0.7): the UNet call,
     te1's and te2's parts of the context and the pooled embedding within
     SDXL_COLLAPSE_REL_L2 of the patched pipe's (bf16), where alpha 1.0 is
     at least twice as far. 14g: that pipeline quantize_base()d in bf16
     (as `serve --quantize` builds it) behind a PipelineServer: one
     txt2img request over HTTP, 10 steps, 70 wgmma flash launches per UNet
     call and exactly the wgmma int8 launches its weights imply. 14d: the
     pipeline from the same seed in f32 with quantize_base() (UNet, te1
     and the VAE int8, te2 float): a UNet call's and a te1 encode's int8
     launches, all wgmma_f32, te2's none; then one prompt, 4 steps: 70
     tf32x3 flash launches per UNet call and exactly the int8 launches the
     weights imply. Every flash and int8 call of 14c-14g is recorded and
     checked against its plain version (the GEGLU projection at 64x64
     timed in f32 and bf16); each flash forward and int8 row of the
     kernels line gains the "sdxl" and "sdxl_f32" launches and the SDXL
     levels' times.
  15. sdxl train: SDXL training at full width and 1024x1024, random
     weights from the seed. 15c: the dQ and dK/dV kernels at the SDXL
     levels at batch 1 (H 10, T = S = 4096 and H 20, T = S = 1024, D 64)
     against their plain versions, bf16 (wgmma) and f32 (tf32x3), timed
     (device time by CUDA-graph replay, the mma kernels on the same
     inputs, SDPA's backward, the FLOP bounds), with their sums over one
     training step (10 launches at T = 4096, 60 at 1024); the forward
     kernels at batch 1 the same way. 15a: bench.py's SDXL step
     (xl_train_cached_bs1_1024): a rank-8 LoRA on the UNet's default
     sites, cached (1, 128, 128, 4) latents, the (1, 77, 2048) context
     and (1, 1280) pooled row of one prompt through both text encoders,
     the training-size time_ids, AdamW 1e-4; in bf16 its LoRA gradient
     through the kernels against the plain attention path (limit as
     phase 7's) and with gradient checkpointing against without; then 1
     warm-up and 3 timed steps without and with checkpointing: the median
     step (CUDA events), the peak memory, one step without checkpointing
     under torch.profiler, and each step's flash launches by kernel and level (70 forward, 140
     with checkpointing, 70 dQ and 70 dK/dV: 10 at T = 4096 and 60 at
     1024, all wgmma; no int8). 15d: the bf16 pipeline written as an fp16
     diffusers directory and three instance PNGs (1024^2, 1280x1024,
     1024x1536); lora_db's command line on it in this process, the
     recipe's flags (bf16, both text encoders, gradient checkpointing,
     rank 8, kohya-XL output), 4 steps at 1024px with the native resize
     (LORA_TPU_TORCH_NATIVE_IMGOPS=1, built from native/imgops.c): every
     launch counted, every image through the native resize, the file
     kohya-XL with te1's and te2's modules, through patch_pipe and one
     1024px UNet call with it. 15b: the same step in f32 (tf32x3; a step
     without checkpointing that does not fit is recorded as such). Every
     flash forward call of 15a, 15b and 15d is recorded and must be at a
     shape 15c checked; each flash row of the kernels line gains the
     "sdxl_train" and "sdxl_train_f32" launches and its 15c times.

  16. tools: the adapter tooling at full width, random weights from the
     seed. 16a: an SD-1.5 base and a tuned copy that adds a known rank-4
     delta at every default UNet and text site, both written in f32;
     `lora_distill` (its command line) at clamp 1.0 on the card: per site
     up @ down within DISTILL_REL_L2 of the delta (the saved trees and the
     fp16 file); core/svd.py's svd_distill on the CPU at every
     DISTILL_CPU_EVERY-th site's weights, within DISTILL_REL_L2 of the
     delta and the card's within DISTILL_DEVICE_REL_L2 of it there;
     seconds per site and in total.
     16b: a random kohya-XL file of rank 4 over the SDXL UNet's, te1's and
     te2's default sites, `lora_distill --from_lora` against phase 15's
     SDXL directory (--tools: one written from the seed the same way):
     a kohya-XL file whose up @ down, loaded back, is within
     DISTILL_REL_L2 of the input's at every site. 16c: `lora_add` on two
     rank-4 files with TI rows: lpl (the fp16 merge, TI passed through),
     ljl (ranks summed, tokens renamed), upl into a directory (its bf16
     UNet call at batch 4 against the patched pipe's at 0.7 within
     TOOLS_COLLAPSE_REL_L2, the bare call at least twice as far; 15 wgmma
     flash launches a call) and upl-ckpt-v2 (params_from_ckpt gives the
     collapsed fp16 params exactly; the A1111 embedding). 16d:
     `LoRAManager` over both files on the bf16 pipeline: a counted
     2-prompt 512px request of STEPS steps with the manager's prompts (15
     wgmma launches a UNet call), tune([1, 0]) against file 1 alone. 16e:
     `evaluate_pipe` (2 prompts, 10 steps) scored by a random CLIP
     ViT-L/14 tower and an SD-1.5 text model with a projection on the
     card: finite scores in [-1, 1], 15 wgmma launches a UNet call, the
     tower on the card within VISION_DEVICE_REL_L2 of the CPU's. Every
     flash call of 16c-16e is recorded and must be at a checked shape;
     the flash_fwd row of the kernels line gains the "tools" launches.
  17. dist: training across processes, on phase 12's inputs (random
     SD-1.5 at full width, 512px, f32), through lora_launch_torch and the
     lora_db CLI's main in each rank (`chip_smoke.py --dist-rank SPEC`,
     which records each rank's per-step losses, step times, gradient
     all-reduce times, launches and peak memory). 17a: one rank over NCCL
     with --data_parallel, DIST_STEPS steps of 12c's run, against the same
     run in this process: the same per-step losses and LoRA, every flash
     launch through the tf32x3 kernels. 17b: two ranks sharing the card
     over gloo, dp = 2 at train_batch_size 1 (cached latents, prior
     preservation: rank 0 holds the instance rows, rank 1 the class rows,
     the text encoder's LoRA too), against one process at 2: per-step
     losses within DIST_LOSS_RTOL, the final LoRA within DIST_TREE_TOL of
     its largest entry, the output directory rank 0's alone. 17c: fsdp = 2
     on the two ranks, against the unsharded run the same way; each
     rank's peak memory. 17d: SIGTERM to rank 1
     alone after its first step: both ranks stop at the same step, rank 0
     writes train_state.safetensors, and a resume from it runs the rest.
     17f: 17a's run with --tensor_parallel 2 on the two ranks (every
     attention and FF block of the UNet and the text encoder split, 4
     heads a rank; the VAE's one-head attention gathered): per-step losses
     within DIST_TP_LOSS_RTOL of 12c's, each rank's flash launches counted
     and every one at 4 heads, the forward, dQ and dK/dV kernels against
     their plain versions at each of those shapes, each rank's step, its
     tp all-reduces' count and host time a step, and its peak memory
     against 17a's. The flash rows and the adam8bit row gain the "dist"
     launches of every rank of 17a-17d and the "dist_tp" launches of
     17f's. 17e (`--dist-cards` only, a host of N >= 2 cards): one rank a
     card over NCCL, dp = N at train_batch_size 1, dp = N / 2 x fsdp = 2
     at 2, dp = N / 2 x tp = 2 at 2 and (four cards) tp = 4 at 4, each
     against one process at the global batch N.

  18. ppim: the model-backed preprocessing (lora_ppim) at the published
     widths, random weights from SEED: 18a writes BLIP-large, CLIPSeg
     rd64-refined and Swin2SR x2-64 directories as the published ones lay
     them out (config.json, model.safetensors, preprocessor_config.json,
     a synthetic vocab.txt / vocab.json and merges.txt), without
     transformers; 18b runs data/preprocess.py preprocess_images on the
     card on two PNG inputs (PPIM_IMAGES, one cropped under the target so
     Swin2SR runs), writes the masks and caption.txt as lora_ppim does
     (the JPEGs need Pillow, which the card's machine lacks) and prints
     its wall time and images/s; 18c times each stage with its tower
     loaded (caption, mask, crop, super-resolution, resize) and profiles
     one caption of PPIM_PROFILE_TOKENS (kernels a token, the busy
     share); 18d holds
     the card against the port's CPU run of the same weights: BLIP's
     greedy ids equal and its teacher-forced logits within
     PPIM_BLIP_DEVICE_REL (TF32 off), CLIPSeg masks and Swin2SR pixels (at
     PPIM_SR_CHECK) within PPIM_PIXEL_TOL on at most PPIM_PIXEL_OFF_SHARE
     of the pixels. No flash or int8 kernel launches in the phase; the
     kernels line is unchanged by it.

  19. sd21: SD-2.1 768-v at full width (models/config.py SD21_UNET,
     SD21_TEXT, SD21_VAE: the published stabilityai/stable-diffusion-2-1
     configs, OpenCLIP-H text encoder of 23 layers, linear proj_in and
     proj_out, 1024-wide context) and 768x768, random weights from the
     seed, in bf16, with the published scheduler config (DDIM,
     scaled_linear 0.00085-0.012, steps_offset 1, set_alpha_to_one false,
     v_prediction) and upcast_attention. Flash serves 10 self-attentions a
     UNet call (5 at T = S = 9216, H 5; 5 at 2304, H 10; D 64); the 576-
     and 144-token levels and every cross-attention take the plain path.
     The pipe is first written as an fp16 diffusers directory with three
     instance PNGs (19f's inputs). 19b: a rank-4 LoRA and one TI embed
     patched at 0.8; a warm txt2img request (2 prompts, 50 DDIM steps,
     CFG 7.5): exactly 500 wgmma forward launches and no backward, images
     finite in [0, 1], its wall time and peak memory; one UNet call at
     batch 4 through flash against the plain path (relative L2 within
     SD21_FLASH_REL_L2), one under torch.profiler. 19c: txt2img under
     every other sampler (MODE_SAMPLERS), img2img (ddim) and blend
     inpaint (euler_a) at strength 0.8, SD21_SAMPLER_STEPS (10) steps
     each, 10 wgmma launches a UNet call, the blend's kept region ending
     at z0. 19d: quantize_base: 214 int8 launches a UNet call (SD-2's
     linear proj_in and proj_out among them), 138 a text encode, all
     wgmma; the int8 UNet call within QUANT_UNET_REL_L2_TOL of 19b's bf16
     one. 19e: the quantized pipe behind a PipelineServer (max_batch 2):
     two requests of both prompts, 20 steps, 768x768 PNGs, exactly the
     int8 launches their weights imply, the second's embeddings (1024
     wide) from the cache. 19f: cli.lora_db.train on the directory at
     768px with the v target (every step's get_velocity counted): 4 steps
     in f32 with the text encoder (10 tf32x3 forward, dQ and dK/dV
     launches a step) and 2 in bf16 with cached latents (10 wgmma each a
     step), finite losses, the f32 file through patch_pipe moving a UNet
     call of the quantized pipe. 19a (after phase 4, or after the build
     with --sd21): every flash forward layout, dQ and dK/dV shape and
     int8 shape phase 19 ran, against its plain version; the forward
     timed at (4, 5, 9216, 64) in bf16 and (1, 5, 9216, 64) in f32, dQ and
     dK/dV at (1, 5, 9216, 64) in bf16 and f32, the int8 kernel at
     proj_in there (36864, 320, 320).
     Each flash and int8 row of the kernels line gains the "sd21",
     "sd21_train" and "sd21_train_bf16" launches and its "sd21_768" rows.

Any failed check raises, so the script exits nonzero. The last line of
stdout is {"ok": true, "device": {...}}; the line before it is the card
line from nvidia-smi, and the one before that lists the kernels with their
launch counts, errors, times, bounds and library times.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import shutil
import signal
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

from lora_tpu_torch.models import blip as blip_cfg
from lora_tpu_torch.models import clipseg as clipseg_cfg
from lora_tpu_torch.models import swin2sr as swin2sr_cfg
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
# (M, K, N) that are not on the path, with the kernel each routes to
# ("wgmma": the wgmma kernel of x's dtype): masked M and N tails and a K
# tail (48 < 64: in f32 one 32-column box of the last K step lies wholly
# past K) through the TMA ring's zero fill; N % 8 != 0, K % 16 != 0 (W read
# element by element) and odd K (x too) through the mma kernel
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
# phase 10: every txt2img sampler but phase 5's ddim, each on one 2-prompt
# request of MODE_STEPS steps; the image modes' strength (img2img and blend
# inpainting run the last int(MODE_STEPS * 0.8) = 16 of the steps). Phase
# 11's HTTP requests take MODE_STEPS too
MODE_STEPS = 20
MODE_SAMPLERS = ("pndm", "euler", "euler_a", "dpm++", "euler_karras",
                 "euler_a_karras")
MODE_STRENGTH = 0.8
# 2-D int8 weights of the VAE encoder's mid-block attention (q/k/v/out):
# one launch each per encode in quantized serving's image modes
INT8_VAE_ENCODE = 4
# phase 3's bf16 UNet batches: timed (serving, training), then untimed (the
# server's other buckets under CFG, phase 5's LoRA check)
FLASH_TIMED_BATCHES, FLASH_OTHER_BATCHES = (4, 1), (8, 2)
# phase 11: the kohya LoCon file K (rank 8, .alpha 4, every third 3x3 conv
# CP-decomposed) and the LyCORIS file L (one module per LoCon site, the
# algorithms below assigned round-robin, linear and conv sites apart, and
# norm modules on every resnet norm1 and CLIP layer_norm1)
ADAPTER_RANK, ADAPTER_ALPHA, ADAPTER_CP_EVERY = 8, 4.0, 3
LYCORIS_LINEAR = ("lora", "loha", "lokr_full", "lokr_factored", "ia3",
                  "dora", "oft", "boft", "glora", "full")
LYCORIS_CONV = ("lora", "loha", "loha_tucker", "lokr_full", "lokr_factored",
                "lokr_tucker", "ia3", "dora", "oft", "boft", "glora", "full")
# the algorithms whose delta is composed from the base weight: a file for
# an int8 base leaves them out
BASE_DEPENDENT = ("ia3", "dora", "oft", "boft", "glora")
# max |card - CPU| of every composed entry and param delta, over its own
# max |value|: both compose the same f32 products (TF32 off), the card's
# cuBLAS / cuSOLVER summing in another order (the Cayley inverse of blocks
# of 16 and the GLoRA W @ A over up to 1280 terms are the longest sums)
ADAPTER_COMPOSE_REL = 1e-5
# f32 UNet call (batch 4) with L at alpha 0.7 against the same UNet after
# collapse_lora(0.7): W x + 0.7 (dW x) against (W + 0.7 dW) x, f32 sums in
# another order through 16 transformers and 22 resnets (the flash kernel's
# 3xTF32 the same on both sides)
ADAPTER_COLLAPSE_REL_L2 = 1e-4
ADAPTER_ALPHAS = (1.0, 0.5, 1.0)  # the three HTTP requests on L
ADAPTER_COLLAPSE_ALPHA = 0.7
ADAPTER_UNET_REPS = 10  # timed UNet calls per adapter (after 2 warm-up)


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


def _build_each(stems, times: dict, nice=None) -> list:
    """Starts one thread per csrc stem (every source when None), each
    building its own library (kernel_build.build([stem]): its own lock, so
    the libraries build side by side and each is loadable as soon as its
    nvcc ends), at the given CPU priority where one is given (a child nvcc
    takes its thread's). times[stem] gets the seconds, or the error.
    Returns the threads."""
    def run(stem):
        if nice is not None:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
        t0 = time.perf_counter()
        try:
            kernel_build.build([stem])
            times[stem] = time.perf_counter() - t0
        except BaseException as e:  # raised in the caller's thread
            times[stem] = e

    stems = sorted(kernel_build._sources()) if stems is None else stems
    threads = [threading.Thread(target=run, args=(stem,), name=f"nvcc {stem}",
                                daemon=True) for stem in stems]
    for thread in threads:
        thread.start()
    return threads


def _joined(threads, times: dict) -> dict:
    for thread in threads:
        thread.join()
    errors = [e for e in times.values() if isinstance(e, BaseException)]
    if errors:
        raise errors[0]
    return times


@contextlib.contextmanager
def building_in_background(stems=None):
    """Compiles the csrc stems (every source when None) while the block
    runs, one thread and nvcc per source at the lowest CPU priority (nice
    19), so that the block's host work keeps the cores; a kernel the block
    launches waits for its own library only. Waits for the build at the
    block's end and raises its error there; logs each source's seconds."""
    times = {}
    t0 = time.perf_counter()
    threads = _build_each(stems, times, nice=19)
    try:
        yield
    finally:
        _joined(threads, times)
    log(f"build: every source in {time.perf_counter() - t0:.1f} s, at nice "
        f"19 beside the block; seconds by source (cached: ~0) "
        + json.dumps({k: round(v, 1) for k, v in sorted(times.items())}))


def phase_build(stems=None) -> None:
    """Builds the given csrc stems (all when None), one nvcc each, in
    parallel (a library already built is loaded as it is); prints each
    source's seconds and ptxas's report of the wgmma kernels and the int8
    mma kernel."""
    t0 = time.perf_counter()
    times = {}
    _joined(_build_each(stems, times), times)
    paths = kernel_build.build(stems)
    log(f"build: {sorted(os.path.relpath(p) for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s; seconds by source (cached: ~0) "
        + json.dumps({k: round(v, 1) for k, v in sorted(times.items())}))
    for stem in ("int8_matmul", "int8_matmul_wgmma", "int8_matmul_wgmma_f32",
                 "adam8bit", "flash_fwd_wgmma",
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
    # each f32 int8 instance's ring depth and dynamic shared memory
    stem = "int8_matmul_wgmma_f32"
    if stem in paths:
        config = getattr(kernel_build.load_library(stem), stem + "_config")
        config.argtypes = [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
        for bm, bn in i8.TILES:
            out = (ctypes.c_int * 4)()
            if config(bm, bn, out) != 0:
                raise AssertionError(f"no {stem} instance for {(bm, bn)}")
            log(f"build: {stem}: " + json.dumps(dict(zip(
                ("BM", "BN", "stages", "smem_bytes"), out))))


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


def _only(route: str, n: int, wrapper=fa.flash_fwd) -> dict:
    """wrapper.launches_by_kernel (flash_fwd's by default) as a run that
    launched `route` n times and no other of its kernels leaves it (from
    zero)."""
    return {**dict.fromkeys(wrapper.launches_by_kernel, 0), route: n}


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
def recording_flash_shapes(seen):
    """Adds _flash_key of every flash forward call made inside on CUDA
    tensors to `seen`, a set (or counts it, in a collections.Counter),
    through the route lookup flash_fwd makes; the wrapper and its counts
    are unchanged."""
    route = fa._fwd_route

    def recorded(q, k, v):
        if isinstance(seen, collections.Counter):
            seen[_flash_key(q, k, v)] += 1
        else:
            seen.add(_flash_key(q, k, v))
        return route(q, k, v)

    fa._fwd_route = recorded
    try:
        yield seen
    finally:
        fa._fwd_route = route


@contextlib.contextmanager
def recording_launch_shapes(seen: dict):
    """Counts (B, H, T, S, D, dtype) of every flash launch made inside on
    CUDA tensors into seen[wrapper] (collections.Counters keyed
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), through the forward's
    route lookup and the backward kernels' launch functions; the wrappers
    and their counts are unchanged."""
    def key(q, k):
        B, H, T, D = q.shape
        return B, H, T, k.shape[2], D, str(q.dtype).replace("torch.", "")

    reals = {"flash_bwd_dq": fa._dq_launch, "flash_bwd_dkv": fa._dkv_launch}

    def wrap(name, real):
        def recorded(route, q, k, *a, **kw):
            seen[name][key(q, k)] += 1
            return real(route, q, k, *a, **kw)
        return recorded

    fa._dq_launch = wrap("flash_bwd_dq", reals["flash_bwd_dq"])
    fa._dkv_launch = wrap("flash_bwd_dkv", reals["flash_bwd_dkv"])
    fwd = collections.Counter()
    try:
        with recording_flash_shapes(fwd):
            yield seen
    finally:
        fa._dq_launch = reals["flash_bwd_dq"]
        fa._dkv_launch = reals["flash_bwd_dkv"]
        for k, n in fwd.items():
            seen["flash_fwd"][k[:6]] += n


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
    for B in FLASH_TIMED_BATCHES:  # serving, training
        for T, D in SD15_ATTN_SHAPES:
            rows.append(check_kernel(B, 8, T, T, D, torch.bfloat16, gen))
    # the other UNet batches of the main paths: the server's warm-up
    # buckets and request B (2 and 8 rows under CFG), the LoRA check of
    # phase 5 (2 rows, no CFG)
    for B in FLASH_OTHER_BATCHES:
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


_PROBE_BATCH = None  # probes_together's list while its block runs
PROBE_START_S = 60.0  # the start of probes started together, beside each
# probe's own timeout


def _probe(what: str, code: str, timeout_s: float) -> None:
    """A new kernel's first calls (`code`, checked against the plain
    version) in a child process under a timeout, so a kernel that hangs on
    its mbarriers is killed rather than held to the run's limit. Inside
    probes_together the call only enrolls the probe."""
    if _PROBE_BATCH is not None:
        _PROBE_BATCH.append((what, code, timeout_s))
        return
    _run_probes([(what, code, timeout_s)], start_s=0.0)


@contextlib.contextmanager
def probes_together():
    """The probes called in the block run at its end, their child
    processes started together, each under its own timeout (plus
    PROBE_START_S for the processes' start side by side)."""
    global _PROBE_BATCH
    _PROBE_BATCH = []
    try:
        yield
        batch = _PROBE_BATCH
    finally:
        _PROBE_BATCH = None
    _run_probes(batch, start_s=PROBE_START_S)


def _run_probes(batch, start_s: float) -> None:
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [(what, timeout_s, subprocess.Popen(
        [sys.executable, "-c", code], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for what, code, timeout_s in batch]
    try:
        for what, timeout_s, proc in procs:
            left = timeout_s + start_s - (time.perf_counter() - t0)
            try:
                out, err = proc.communicate(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired as e:
                raise AssertionError(f"the {what} kernel's first calls did "
                                     f"not finish in {timeout_s} s") from e
            for line in (out + err).splitlines()[-20:]:
                log(f"probe: {line}")
            if proc.returncode != 0:
                raise AssertionError(f"the {what} kernel's first calls "
                                     f"failed ({proc.returncode})")
            log(f"probe: {what} passed in {time.perf_counter() - t0:.1f} s")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def int8_f32_probe(timeout_s: float = 60.0) -> None:
    """The f32 int8 wgmma kernel's first calls (its TMA thread, converters
    and consumers hand stages on through mbarriers): a ragged call (M, N
    and K tails, one f32 box in the last K step), the main shape and a
    K = 5120 shape at every tile instance, each against the plain
    version."""
    _probe("f32 int8 wgmma", (
        "import torch, chip_smoke as c; "
        "c.int8_tile_sweep([(33, 48, 40), c.INT8_MAIN_SHAPE, "
        "(256, 5120, 1280)], (torch.float32,), timed=False)"), timeout_s)


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
    the mma kernel on the inputs of a wgmma kernel for its time beside
    theirs, or a wgmma kernel at a given tile."""
    (M, K), N = x.shape, wq.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    tail = (int(x.dtype == torch.bfloat16),) if route == "mma" else tile
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


# the wgmma kernel of each dtype
WGMMA_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "wgmma_f32"}


def check_int8(M, K, N, dtype, gen, timed=True, route=None):
    """The wrapper against the plain version at one shape; `route` is the
    kernel it must launch (by default the wgmma kernel of x's dtype).
    Timed: the routed kernel and the mma kernel ("prev"), each through its
    C entry point on the same inputs (one launch path for both), the
    wrapper, cuBLAS (F.linear on the dequantized weight in x's dtype, made
    once before timing), the plain version, and the bound."""
    route = route or WGMMA_ROUTE[dtype]
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
            prev = _int8_direct("mma", x, wq, scale)
            row["err_prev"] = (prev.float() - want.float()).abs().max().item()
            row["rel_prev"] = _rel(prev, want)
            del prev
            w_lib = (wq.float() * scale[:, None]).to(dtype)
            tile = (None if route == "mma" else i8._tile(
                M, K, N, torch.cuda.get_device_properties(
                    0).multi_processor_count, route))
            calls = {"": lambda: _int8_direct(route, x, wq, scale, tile),
                     "wrapper_": lambda: i8.int8_matmul(x, wq, scale),
                     "library_": lambda: torch.nn.functional.linear(x, w_lib),
                     "prev_": lambda: _int8_direct("mma", x, wq, scale)}
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


INT8_SUM_KEYS = ("ms", "wrapper_ms", "prev_ms", "library_ms", "plain_ms",
                 "device_ms", "prev_device_ms", "library_device_ms",
                 "bound_ms")


def int8_call_sums(rows) -> dict:
    """Sums over the 182 launches of one UNet call at batch 4, bf16 and
    (keys "f32_*") f32, of each timed column, weighted by each shape's
    count per call; over all launches and over the M >= 1024 ones. The *ms
    columns time each call alone, its host launch path included (it sets
    the time at M <= 308: ctypes for the kernels, the Python wrapper for
    wrapper_ms, PyTorch's dispatcher for cuBLAS); the *device_ms columns
    replay CUDA graphs of the calls. prev: the mma kernel on the same
    inputs."""
    counts = {}
    for s in unet_int8_calls(4):
        counts[s] = counts.get(s, 0) + 1
    sums = {"launches": sum(counts.values()),
            "launches_m_ge_1024": sum(c for s, c in counts.items()
                                      if s[0] >= 1024)}
    for dtype, prefix in (("bfloat16", ""), ("float32", "f32_")):
        by_shape = {(r["M"], r["K"], r["N"]): r for r in rows
                    if r["dtype"] == dtype and "ms" in r}
        for key in INT8_SUM_KEYS:
            sums[prefix + key] = sum(c * by_shape[s][key]
                                     for s, c in counts.items())
            sums[prefix + key + "_m_ge_1024"] = sum(
                c * by_shape[s][key] for s, c in counts.items()
                if s[0] >= 1024)
    log("int8 per UNet call: " + json.dumps(
        {k: v for k, v in sums.items() if not k.startswith("f32_")}))
    log("int8 f32 per UNet call: " + json.dumps(
        {k: v for k, v in sums.items() if k.startswith("f32_")}))
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
            rows.append(check_int8(
                M, K, N, dtype, gen, timed=False,
                route=WGMMA_ROUTE[dtype] if route == "wgmma" else route))
        # a leading batch dimension and an x whose rows are not contiguous
        # (the wrapper copies it: then TMA takes it)
        x = torch.randn((2, 7, 96), generator=gen, device="cuda").to(dtype)
        wq = torch.randint(-127, 128, (40, 64), generator=gen, device="cuda",
                           dtype=torch.int8)
        s = torch.rand((40,), generator=gen, device="cuda")
        with torch.inference_mode():
            before = dict(i8.int8_matmul.launches_by_kernel)
            got = i8.int8_matmul(x[..., 16:80], wq, s)
            want = i8.int8_matmul_reference(x[..., 16:80], wq, s)
            ran = [k for k, v in i8.int8_matmul.launches_by_kernel.items()
                   if v != before[k]]
        rel = _rel(got, want)
        if got.shape != (2, 7, 40) or ran != [WGMMA_ROUTE[dtype]] or \
                not rel <= INT8_REL_TOL[dtype]:
            raise AssertionError(f"int8_matmul on a strided 3-D {dtype} x: "
                                 f"rel {rel}, ran {ran}")
        log(f"int8 kernel: strided 3-D {dtype} x through {ran}: rel {rel}")
    # bf16 x whose base is 2 bytes past a 16-byte boundary: the mma kernel
    M, K, N = 100, 320, 320
    x = torch.randn((M * K + 8,), generator=gen, device="cuda").to(
        torch.bfloat16)[1:M * K + 1].view(M, K)
    _, wq, s = _int8_inputs(M, K, N, torch.bfloat16, gen)
    with torch.inference_mode():
        before = i8.int8_matmul.launches_by_kernel["mma"]
        got = i8.int8_matmul(x, wq, s)
        want = i8.int8_matmul_reference(x, wq, s)
        rel = _rel(got, want)
    if i8.int8_matmul.launches_by_kernel["mma"] != before + 1 or \
            not rel <= INT8_REL_TOL[torch.bfloat16]:
        raise AssertionError(f"int8_matmul on an unaligned bf16 x: rel {rel}")
    log(f"int8 kernel: unaligned bf16 x {(M, K, N)} through mma: rel {rel}")
    rows.append({"M": M, "K": K, "N": N, "dtype": "bfloat16",
                 "kernel": ["mma"], "rel": rel,
                 "err": (got.float() - want.float()).abs().max().item()})
    return rows


def _fit_tile_model(times, tiles) -> dict:
    """Per tile, the (us per wave, us per K step of 64) of _tile's model,
    fit to {(M, K, N): {tile: ms}} with the least squared relative error:
    waves * (a + b * k_steps) against each time, a linear least-squares
    problem once each row is divided by its time."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fit = {}
    for tile in tiles:
        bm, bn = tile
        rows, ones = [], []
        for (M, K, N), by_tile in times.items():
            waves = -(-(-(-M // bm) * -(-N // bn)) // sms)
            t_us = 1e3 * by_tile[tile]
            rows.append([waves / t_us, waves * -(-K // 64) / t_us])
            ones.append(1.0)
        (a, b), *_ = np.linalg.lstsq(np.array(rows), np.array(ones),
                                     rcond=None)
        fit[f"{bm}x{bn}"] = [round(float(a), 2), round(float(b), 2)]
    return fit


def int8_tile_sweep(shapes=None, dtypes=(torch.bfloat16, torch.float32),
                    timed=True):
    """Each dtype's wgmma kernel at every tile instance, called directly,
    at request A's shapes (or `shapes`): each instance checked against the
    plain version and (timed) its device time taken (CUDA graph replay),
    the tile _tile picks beside them; then each kernel's time model fit to
    those times, as _TILE_US and _TILE_US_F32 hold it."""
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in dtypes:
        route = WGMMA_ROUTE[dtype]
        tiles = tuple(i8._TILE_MODELS[route])
        times = {}
        for M, K, N in shapes or int8_path_shapes():
            x, wq, scale = _int8_inputs(M, K, N, dtype, gen)
            row = {"dtype": str(dtype).replace("torch.", ""), "M": M, "K": K,
                   "N": N, "picked": list(i8._tile(M, K, N, sms, route))}
            with torch.inference_mode():
                want = i8.int8_matmul_reference(x, wq, scale)
                for tile in tiles:
                    rel = _rel(_int8_direct(route, x, wq, scale, tile), want)
                    row[f"rel_{tile[0]}x{tile[1]}"] = rel
                    if not rel <= INT8_REL_TOL[dtype]:
                        raise AssertionError(f"{route} tile {tile} at "
                                             f"{(M, K, N)}: rel {rel}")
                    if timed:
                        row[f"{tile[0]}x{tile[1]}"] = _graph_ms(
                            lambda: _int8_direct(route, x, wq, scale, tile))
            if timed:
                times[(M, K, N)] = {t: row[f"{t[0]}x{t[1]}"] for t in tiles}
            log("int8 tiles: " + json.dumps(row))
            del x, wq, scale, want
        if timed:
            log(f"int8 tiles: {route} time model (us per wave, per K step): "
                + json.dumps(_fit_tile_model(times, tiles)))


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
    ("int8_matmul", "int8_"),
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
    if unet_by_kernel != _only("wgmma", per_call["unet"],
                                i8.int8_matmul) or \
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
                by_kernel_a != _only("wgmma", launches_a, i8.int8_matmul) or \
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
                by_kernel_b != _only("wgmma", launches_b, i8.int8_matmul) or \
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
    """The SD-1.5 UNet and CLIP text encoder served in f32 with int8
    weights (from_pretrained's default dtype): one UNet call at batch 4
    (random weights and inputs from the seed) through the f32 int8 wgmma
    kernel and the tf32x3 flash forward kernel (f32 at every level), within
    QUANT_UNET_REL_L2_TOL of the same UNet unquantized; a warm call's wall
    and device time; then the prompts encoded by the quantized f32 CLIP,
    its 72 int8 launches all on the f32 wgmma kernel, within the same limit
    of the unquantized encoder. Returns the int8 launches of the counted
    UNet call and encode, by kernel, and the flash forward's."""
    from lora_tpu_torch.core.quantize import quantize_params_int8
    from lora_tpu_torch.data.tokenizer import default_tokenizer
    from lora_tpu_torch.models.clip import CLIPTextModel
    from lora_tpu_torch.models.config import SD15_TEXT, SD15_UNET
    from lora_tpu_torch.models.unet import UNet

    def quantize(module):
        for name, v in quantize_params_int8(module.flat_params()).items():
            module.set_param(name, v)

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
        quantize(unet)
        torch.cuda.synchronize()
        _zero_counts()  # the counted main-path run
        out = unet(lat, t, ctx)
        torch.cuda.synchronize()
        by_kernel = dict(i8.int8_matmul.launches_by_kernel)
        fwd_by_kernel = dict(fa.flash_fwd.launches_by_kernel)
        t0 = time.perf_counter()
        unet(lat, t, ctx)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        # one more warm call under torch.profiler: device time by kernel
        # class (int8_matmul among them) and the busy share
        warm_profile = profile_step(lambda: unet(lat, t, ctx))
    rel = ((out - ref).norm() / ref.norm()).item()
    del unet, ref, out
    torch.cuda.empty_cache()

    text = CLIPTextModel(SD15_TEXT, device="cuda", dtype=torch.float32,
                         generator=gen)
    ids = torch.tensor(default_tokenizer(vocab_size=SD15_TEXT.vocab_size)(
        PROMPTS)["input_ids"], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        text_ref = text(ids)
        quantize(text)
        torch.cuda.synchronize()
        _zero_counts()  # the counted encode
        text_out = text(ids)
        torch.cuda.synchronize()
    clip_by_kernel = dict(i8.int8_matmul.launches_by_kernel)
    clip_rel = ((text_out - text_ref).norm() / text_ref.norm()).item()
    log("serve_int8_f32: " + json.dumps({
        "unet_call_rel_l2_vs_f32": rel, "int8_launches": by_kernel,
        "flash_fwd_launches": fwd_by_kernel,
        "warm_unet_call_s": warm_s, "warm_unet_call_profile": {
            k: warm_profile[k] for k in ("wall_ms", "device_ms", "launches",
                                         "busy_share", "by_class")},
        "clip_encode_rel_l2_vs_f32": clip_rel,
        "clip_encode_int8_launches": clip_by_kernel,
        "limit": QUANT_UNET_REL_L2_TOL, "card": smi}))
    if by_kernel != _only("wgmma_f32", INT8_PER_CALL["unet"],
                          i8.int8_matmul) or \
            fwd_by_kernel != _per_step_want(torch.float32)[2]:
        raise AssertionError(f"the f32 quantized UNet call launched "
                             f"{by_kernel} int8 and {fwd_by_kernel} flash "
                             f"forward kernels")
    if clip_by_kernel != _only("wgmma_f32", INT8_PER_CALL["clip_encode"],
                                i8.int8_matmul):
        raise AssertionError(f"the f32 quantized CLIP encode launched "
                             f"{clip_by_kernel} int8 kernels")
    for what, r in (("UNet call", rel), ("CLIP encode", clip_rel)):
        if not (np.isfinite(r) and r <= QUANT_UNET_REL_L2_TOL):
            raise AssertionError(f"f32 quantized {what} is {r} (relative "
                                 f"L2) from the f32 one")
    del text, text_ref, text_out
    torch.cuda.empty_cache()
    return {k: by_kernel[k] + clip_by_kernel[k] for k in by_kernel}, \
        fwd_by_kernel


def _unet_calls(scheduler: str = "ddim", strength=None,
                steps: int = STEPS) -> int:
    """UNet calls of one request of `steps` steps: PNDM visits one timestep
    twice; a strength runs the last int(steps * strength) steps."""
    if strength is not None:
        return min(int(steps * strength), steps)
    return steps + (scheduler == "pndm")


def _mode_inputs(batch: int, gen, size: int = 512):
    """A smooth random image (batch, size, size, 3) in [-1, 1] (8x8 random
    colours, bilinearly upsampled) and its inpainting mask (1 = repaint):
    a centred box of half the side and, in the last row, the bottom
    quarter too."""
    low = torch.rand((batch, 3, 8, 8), generator=gen, device="cuda")
    image = torch.nn.functional.interpolate(
        low, size=(size, size), mode="bilinear", align_corners=False)
    image = (image * 2 - 1).permute(0, 2, 3, 1).contiguous()
    mask = torch.zeros((batch, size, size, 1), device="cuda")
    q = size // 4
    mask[:, q:3 * q, q:3 * q] = 1.0
    mask[-1, 3 * q:] = 1.0
    return image, mask


def _check_images(images, n: int, what: str, size: int = 512) -> None:
    if images.shape != (n, size, size, 3):
        raise AssertionError(f"{what}: images have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0):
        raise AssertionError(f"{what}: images are not finite values in "
                             f"[0, 1]")


def counted_request(report: dict, tag: str, name: str, calls: int, fn,
                    per_call: int = ROUTED_PER_UNET_CALL,
                    route: str = "wgmma", int8_want=lambda: 0,
                    int8_route: str = "wgmma", totals=None):
    """fn() as one counted request of `calls` UNet calls (the counts set to
    0 just before it, read just after): its wall time, peak memory and
    launches by kernel go to report[name]. It must launch `per_call` flash
    forwards of `route` per UNet call and int8_want() int8 matmuls of
    `int8_route` (asked after it), else an AssertionError. `totals` (by
    wrapper name, "flash_fwd" / "int8_matmul") gains the launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    fwd = dict(fa.flash_fwd.launches_by_kernel)
    int8 = dict(i8.int8_matmul.launches_by_kernel)
    report[name] = {"wall_s": time.perf_counter() - t0, "unet_calls": calls,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "flash_fwd": fwd, "int8_matmul": int8}
    log(f"{tag}: {name}: " + json.dumps(report[name]))
    if fwd != _only(route, per_call * calls):
        raise AssertionError(f"{name}: flash_fwd launched {fwd}, not "
                             f"{per_call} {route} per UNet call x {calls}")
    if int8 != _only(int8_route, int8_want(), i8.int8_matmul):
        raise AssertionError(f"{name}: int8_matmul launched {int8}, not "
                             f"{int8_want()} {int8_route}")
    for wrapper, total in (totals or {}).items():
        for k in total:
            total[k] += report[name][wrapper][k]
    return out


def phase_modes(smi: str):
    """Phase 10: the rest of SD-1.5 sampling at full width, bf16, 512x512,
    2 prompts, MODE_STEPS steps, CFG 7.5, on the slice's pipeline (LoRA + TI at
    0.8): txt2img under every other sampler; img2img and latent-blend
    inpainting (ddim, euler_a) at strength 0.8, the blend's kept region
    checked to end at the image's latents exactly and the repainted region
    to move; the 9-channel inpaint on a second random pipeline with the
    runwayml/stable-diffusion-inpainting UNet layout (SD15_UNET with
    in_channels=9); then the pipeline quantized behind a PipelineServer on
    localhost (max_batch 2): warmup over both image modes, one img2img and
    one inpaint request over HTTP with PNGs encoded here, every int8 and
    flash launch counted, the PNGs decoded to 512x512, and the img2img
    pixels equal to the pipeline called directly. Each request is counted
    alone (counts set to 0 just before, read just after): 15 flash launches
    per UNet call, all through the wgmma kernel. Returns the flash
    launches by kernel over all requests and the int8 launches by kernel
    over the HTTP requests."""
    from lora_tpu_torch import serve
    from lora_tpu_torch.models.config import SD15_UNET
    from lora_tpu_torch.pipelines.sd import (
        StableDiffusionPipeline,
        _latent_mask,
    )

    pipe = _patched_pipe("modes")
    image, mask = _mode_inputs(len(PROMPTS),
                               torch.Generator("cuda").manual_seed(SEED + 8))
    fwd_total = dict.fromkeys(fa.flash_fwd.launches_by_kernel, 0)
    int8_total = dict.fromkeys(i8.int8_matmul.launches_by_kernel, 0)
    report = {}
    # each request of `calls` UNet calls: 15 wgmma flash launches each
    counted = functools.partial(
        counted_request, report, "modes",
        totals={"flash_fwd": fwd_total, "int8_matmul": int8_total})

    def gen(offset):
        return torch.Generator("cuda").manual_seed(SEED + offset)

    # one short uncounted call: first-use costs (cuDNN plans, allocator)
    pipe(PROMPTS, num_inference_steps=2, height=512, width=512,
         generator=gen(1))
    kw = dict(num_inference_steps=MODE_STEPS, guidance_scale=7.5)
    for sched in MODE_SAMPLERS:
        images = counted(f"txt2img {sched}",
                         _unet_calls(sched, steps=MODE_STEPS),
                         lambda: pipe(PROMPTS, height=512, width=512,
                                      generator=gen(1), scheduler=sched,
                                      **kw))
        _check_images(images, len(PROMPTS), f"txt2img {sched}")
    blend_calls = _unet_calls(strength=MODE_STRENGTH, steps=MODE_STEPS)
    images = counted("img2img ddim", blend_calls,
                     lambda: pipe.img2img(PROMPTS, image,
                                          strength=MODE_STRENGTH,
                                          generator=gen(2), **kw))
    _check_images(images, len(PROMPTS), "img2img")
    keep = None
    for sched in ("ddim", "euler_a"):
        images, lat, z0 = counted(
            f"inpaint_blend {sched}", blend_calls,
            lambda: pipe.inpaint_blend(PROMPTS, image, mask,
                                       strength=MODE_STRENGTH,
                                       generator=gen(3), scheduler=sched,
                                       return_latents=True, **kw))
        _check_images(images, len(PROMPTS), f"inpaint_blend {sched}")
        if keep is None:
            keep = (_latent_mask(mask, 64, 64, torch.float32) == 0).expand(
                lat.shape)
        kept_equal = torch.equal(lat[keep], z0[keep])
        moved = (lat[~keep].float() - z0[~keep].float()).abs().max().item()
        report[f"inpaint_blend {sched}"].update(
            kept_region_equals_z0=kept_equal, repainted_max_abs_diff=moved)
        if not kept_equal or not moved > 0.0:
            raise AssertionError(
                f"inpaint_blend {sched}: kept region equal to z0: "
                f"{kept_equal}; repainted region moved by {moved}")
        del lat, z0

    inpaint_pipe = StableDiffusionPipeline.random_init(
        generator=gen(9), device="cuda", dtype=torch.bfloat16,
        unet_cfg=dataclasses.replace(SD15_UNET, in_channels=9))
    images = counted("inpaint 9-channel ddim", MODE_STEPS,
                     lambda: inpaint_pipe.inpaint(PROMPTS, image, mask,
                                                  generator=gen(4), **kw))
    _check_images(images, len(PROMPTS), "inpaint 9-channel")
    del inpaint_pipe
    torch.cuda.empty_cache()

    # quantized serving of both image modes over HTTP
    pipe.quantize_base()
    torch.cuda.empty_cache()
    per_call = {"unet": _int8_dense(pipe.unet),
                "clip_encode": _int8_dense(pipe.text_encoder),
                "vae_encode": _int8_dense(pipe.vae, "encoder."),
                "vae_decode": _int8_dense(pipe.vae, "decoder.")}
    if per_call != {**INT8_PER_CALL, "vae_encode": INT8_VAE_ENCODE}:
        raise AssertionError(f"2-D int8 weights per call {per_call}")
    encodes = [0]  # CLIP encode calls, each one int8 launch per 2-D weight
    encode_prompt = pipe.encode_prompt

    def counted_encode(prompts):
        encodes[0] += 1
        return encode_prompt(prompts)

    pipe.encode_prompt = counted_encode
    image_png = serve._png_b64(((image[0] + 1) / 2).cpu().numpy())
    mask_png = serve._png_b64(mask[0].expand(-1, -1, 3).cpu().numpy())
    srv = serve.PipelineServer(pipe, port=0, max_batch=2,
                               batch_window_ms=100.0).start()
    http, http_seed = {}, 5
    try:
        t0 = time.perf_counter()
        srv.warmup(steps=2, modes=("img2img", "inpaint"),
                   strength=MODE_STRENGTH)
        torch.cuda.synchronize()
        report["http warmup"] = {"wall_s": time.perf_counter() - t0}
        for mode in ("img2img", "inpaint"):
            payload = {"mode": mode, "prompt": PROMPTS, "image": image_png,
                       "steps": MODE_STEPS, "guidance": 7.5,
                       "strength": MODE_STRENGTH, "seed": http_seed}
            if mode == "inpaint":
                payload["mask"] = mask_png
            encodes[0] = 0
            body = counted(
                f"http {mode}", blend_calls,
                lambda: _http(srv.port, "/generate", payload)[1],
                int8_want=lambda: (per_call["unet"] * blend_calls
                                   + per_call["clip_encode"] * encodes[0]
                                   + per_call["vae_encode"]
                                   + per_call["vae_decode"]))
            name = f"http {mode}"
            report[name].update(clip_encodes=encodes[0],
                                latency_ms=body["latency_ms"],
                                batched_with=body["batched_with"])
            if len(body["images"]) != len(PROMPTS):
                raise AssertionError(f"{name}: {len(body['images'])} images")
            for b64 in body["images"]:
                rgb = serve._png_decode(base64.b64decode(b64))
                if rgb.shape != (512, 512, 3):
                    raise AssertionError(f"{name}: a PNG decodes to "
                                         f"{rgb.shape}")
            http[mode] = body["images"]
        # the pipeline called directly on the decoded PNG, with a generator
        # seeded as the server seeds it and the embeddings the server used
        with srv.lock:
            key = srv._embed_key_alpha()
            emb = torch.stack([srv._embeds[(p, key)] for p in PROMPTS])
            neg = torch.stack([srv._embeds[("", key)]] * len(PROMPTS))
            sent = torch.from_numpy(serve._b64_to_image(
                image_png, len(PROMPTS))).cuda()
            direct = pipe.img2img(
                None, sent, strength=MODE_STRENGTH,
                generator=torch.Generator("cuda").manual_seed(http_seed),
                prompt_embeds=emb, negative_prompt_embeds=neg, **kw)
        if [serve._png_b64(im) for im in direct] != http["img2img"]:
            raise AssertionError("the img2img request's PNGs differ from "
                                 "the pipeline called directly")
        if srv.drain(timeout=60) is not True:
            raise AssertionError("the server did not drain")
    finally:
        srv.stop()
    log("modes: " + json.dumps({
        "requests": report, "flash_fwd_launches": fwd_total,
        "http_int8_launches": int8_total, "int8_per_call": per_call,
        "steps": MODE_STEPS, "strength": MODE_STRENGTH, "cfg": 7.5,
        "card": smi}))
    del srv, pipe
    torch.cuda.empty_cache()
    return fwd_total, int8_total


def _file_array(x: torch.Tensor) -> np.ndarray:
    """A tensor as a file holds it: float16 on the host (bool as it is)."""
    x = x.detach()
    return (x if x.dtype == torch.bool else x.to(torch.float16)).cpu().numpy()


def _divisor(n: int) -> int:
    """LoKr's first kron factor along an axis of n: 4, 2 or 1."""
    return next((d for d in (4, 2) if n % d == 0), 1)


def _oft_block(n: int, stages: int = 1):
    """The even OFT block b (16 down to 2) whose butterfly stages tile n
    channels (n % (b 2^(stages - 1)) == 0), or None."""
    return next((b for b in (16, 8, 4, 2)
                 if n % (b * 2 ** (stages - 1)) == 0), None)


def _fits(algo: str, site) -> bool:
    if algo == "oft":
        return _oft_block(site.out_dim) is not None
    if algo == "boft":
        return _oft_block(site.out_dim, 2) is not None
    return True


def _lycoris_leaves(algo: str, site, w: torch.Tensor, gen, i: int) -> dict:
    """{leaf: tensor} of one LyCORIS module of `algo` on `site`, drawn from
    `gen` on w's device; w: the site's f32 base weight (DoRA's magnitude is
    drawn around the merged weight's row norms); i: the site's index in its
    cycle (IA3 alternates its axis). DoRA, OFT and BOFT store W' - W, a
    difference of two values of W's size: their draws move W by tens of
    percent, so that f32 rounding of W (eps |W|) stays far below the
    ADAPTER_COMPOSE_REL of max |W' - W| that the loaders are held to."""
    def rn(*shape, s=1.0):
        return s * torch.randn(shape, generator=gen, device=w.device)

    conv = site.kind == "conv"
    k = tuple(site.kernel) if conv else ()
    one = (1, 1) if conv else ()
    flat = site.in_dim * int(np.prod(k or (1,)))
    r = 4
    alpha = torch.tensor(float(r))
    if algo in ("lora", "dora"):
        down = rn(r, site.in_dim, *k, s=flat ** -0.5)
        up = rn(site.out_dim, r, *one, s=0.1)
        out = {"lora_down": down, "lora_up": up,
               "alpha": torch.tensor(r / 2.0)}
        if algo == "dora":
            merged = w.reshape(site.out_dim, -1) + 0.5 * (
                up.reshape(site.out_dim, r) @ down.reshape(r, -1))
            m = merged.norm(dim=1) * (1 + rn(site.out_dim, s=0.1))
            out["dora_scale"] = m.reshape((-1,) + (1,) * (w.ndim - 1))
        return out
    if algo == "loha":
        return {"hada_w1_a": rn(site.out_dim, r, s=0.5),
                "hada_w1_b": rn(r, flat, s=flat ** -0.5),
                "hada_w2_a": rn(site.out_dim, r, s=0.5),
                "hada_w2_b": rn(r, flat, s=flat ** -0.5), "alpha": alpha}
    if algo == "loha_tucker":
        return {"hada_t1": rn(r, r, *k, s=0.5),
                "hada_w1_a": rn(r, site.out_dim, s=0.5),
                "hada_w1_b": rn(r, site.in_dim, s=flat ** -0.5),
                "hada_t2": rn(r, r, *k, s=0.5),
                "hada_w2_a": rn(r, site.out_dim, s=0.5),
                "hada_w2_b": rn(r, site.in_dim, s=flat ** -0.5),
                "alpha": alpha}
    if algo.startswith("lokr"):
        o1, i1 = _divisor(site.out_dim), _divisor(site.in_dim)
        o2, i2 = site.out_dim // o1, site.in_dim // i1
        out = {"lokr_w1": rn(o1, i1, s=0.5)}
        if algo == "lokr_full":
            out["lokr_w2"] = rn(o2, i2, *k, s=0.1 * flat ** -0.5)
        elif algo == "lokr_factored":
            out.update(lokr_w2_a=rn(o2, r, s=0.5),
                       lokr_w2_b=rn(r, flat // i1, s=0.1 * flat ** -0.5),
                       alpha=alpha)
        else:  # lokr_tucker
            out.update(lokr_t2=rn(r, r, *k, s=0.5),
                       lokr_w2_a=rn(r, o2, s=0.5),
                       lokr_w2_b=rn(r, i2, s=0.1 * flat ** -0.5),
                       alpha=alpha)
        return out
    if algo == "ia3":
        on_input = i % 2 == 0
        return {"weight": rn(site.in_dim if on_input else site.out_dim,
                             s=0.05),
                "on_input": torch.tensor(on_input)}
    if algo == "oft":
        b = _oft_block(site.out_dim)
        return {"oft_blocks": rn(site.out_dim // b, b, b, s=0.05),
                "rescale": 1 + rn(site.out_dim, 1, s=0.01)}
    if algo == "boft":
        # alpha 0.01: ||Q||_F clamped to 0.01 * out_dim over both stages
        # (a factor of ~0.2-0.5 at these widths)
        b = _oft_block(site.out_dim, 2)
        return {"oft_blocks": rn(2, site.out_dim // b, b, b, s=0.05),
                "alpha": torch.tensor(0.01)}
    if algo == "glora":
        return {"a1": rn(r, site.in_dim, *one, s=0.1),
                "a2": rn(site.in_dim, r, *one, s=0.1),
                "b1": rn(r, site.in_dim, *one, s=0.1),
                "b2": rn(site.out_dim, r, *k, s=0.1 * flat ** -0.5),
                "alpha": alpha}
    if algo == "full":
        return {"diff": rn(*w.shape, s=0.05) * w.std()}
    raise ValueError(f"unknown algorithm {algo!r}")


# leaves stored as "<base>.<leaf>.weight"; every other leaf as "<base>.<leaf>"
_WEIGHT_LEAVES = ("lora_up", "lora_down", "lora_mid", "a1", "a2", "b1", "b2")


def _adapter_sites(pipe):
    from lora_tpu_torch.core.sites import (
        text_encoder_locon_sites,
        unet_locon_sites,
    )

    return (("unet", pipe.unet, unet_locon_sites(pipe.unet.cfg)),
            ("text_encoder", pipe.text_encoder,
             text_encoder_locon_sites(pipe.text_encoder.cfg)))


def _kohya_file(pipe, path: str, gen) -> dict:
    """K: a kohya LoCon file over every UNet and text LoCon site, rank
    ADAPTER_RANK, `.alpha` ADAPTER_ALPHA (not the rank), every
    ADAPTER_CP_EVERY-th 3x3 conv CP-decomposed (1x1 down, kxk lora_mid).
    Returns its counts."""
    from lora_tpu_torch.formats.kohya import kohya_key
    from lora_tpu_torch.formats.reader import save_file

    r, dev = ADAPTER_RANK, pipe.device
    tensors, n_sites, n_cp, n_3x3 = {}, 0, 0, 0

    def rn(*shape, s=1.0):
        return s * torch.randn(shape, generator=gen, device=dev)

    for model, _, sites in _adapter_sites(pipe):
        for s in sites:
            base = kohya_key(model, s.name)
            k = tuple(s.kernel) if s.kind == "conv" else ()
            flat = s.in_dim * int(np.prod(k or (1,)))
            cp = k not in ((), (1, 1)) and n_3x3 % ADAPTER_CP_EVERY == 0
            n_3x3 += k not in ((), (1, 1))
            if cp:
                down = rn(r, s.in_dim, 1, 1, s=s.in_dim ** -0.5)
                tensors[base + ".lora_mid.weight"] = _file_array(
                    rn(r, r, *k, s=(r * k[0] * k[1]) ** -0.5))
                n_cp += 1
            else:
                down = rn(r, s.in_dim, *k, s=flat ** -0.5)
            tensors[base + ".lora_down.weight"] = _file_array(down)
            tensors[base + ".lora_up.weight"] = _file_array(
                rn(s.out_dim, r, *((1, 1) if k else ()), s=0.1))
            tensors[base + ".alpha"] = np.asarray(ADAPTER_ALPHA, np.float16)
            n_sites += 1
    save_file(tensors, path)
    return {"modules": n_sites, "cp_convs": n_cp, "convs_3x3": n_3x3,
            "bytes": os.path.getsize(path)}


def _lycoris_file(pipe, path: str, gen, exclude=()) -> dict:
    """L: a LyCORIS file with one module on every UNet and text LoCon site,
    the algorithms of LYCORIS_LINEAR / LYCORIS_CONV (less `exclude`)
    assigned round-robin, each site taking the next one its shapes allow
    (one cycle per model and site kind); a full module's diff_b where the
    site has a bias; norm modules (w_norm, b_norm) on every resnet norm1
    and every CLIP layer_norm1. Returns {"plan": {(model, site): algo},
    "counts": {kind: {algo: n}}, "norms": n, ...}."""
    from lora_tpu_torch.formats.kohya import kohya_key
    from lora_tpu_torch.formats.reader import save_file

    tensors, plan = {}, {}
    counts = {"linear": {}, "conv": {}}
    n_norms = 0
    for model, module, sites in _adapter_sites(pipe):
        params = module.flat_params()
        cursor = {"linear": 0, "conv": 0}
        for s in sites:
            cycle = [a for a in (LYCORIS_LINEAR if s.kind == "linear"
                                 else LYCORIS_CONV) if a not in exclude]
            j = cursor[s.kind]
            while not _fits(cycle[j % len(cycle)], s):
                j += 1
            algo = cycle[j % len(cycle)]
            cursor[s.kind] = j + 1
            w = params[s.name + ".weight"].float()
            leaves = _lycoris_leaves(algo, s, w, gen, j)
            if algo == "full" and s.name + ".bias" in params:
                leaves["diff_b"] = 0.01 * torch.randn(
                    (s.out_dim,), generator=gen, device=w.device)
            base = kohya_key(model, s.name)
            for leaf, v in leaves.items():
                key = (f"{base}.{leaf}.weight" if leaf in _WEIGHT_LEAVES
                       else f"{base}.{leaf}")
                tensors[key] = _file_array(v)
            plan[(model, s.name)] = algo
            counts[s.kind][algo] = counts[s.kind].get(algo, 0) + 1
        prefix = "lora_unet" if model == "unet" else "lora_te"
        for name, t in params.items():
            if (model == "unet" and ".resnets." in name
                    and name.endswith(".norm1.weight")) or \
                    name.endswith(".layer_norm1.weight"):
                base = prefix + "_" + name[:-len(".weight")].replace(".", "_")
                for leaf in ("w_norm", "b_norm"):
                    tensors[f"{base}.{leaf}"] = _file_array(0.05 * torch.randn(
                        t.shape, generator=gen, device=t.device))
                n_norms += 1
    for kind, algos in (("linear", LYCORIS_LINEAR), ("conv", LYCORIS_CONV)):
        missing = [a for a in algos
                   if a not in exclude and not counts[kind].get(a)]
        if missing:
            raise AssertionError(f"L has no {kind} site for {missing}")
    save_file(tensors, path)
    return {"plan": plan, "counts": counts, "norm_modules": n_norms,
            "bytes": os.path.getsize(path)}


def _compose_errors(pipe, path: str, lycoris: bool, plan: dict) -> dict:
    """The file loaded in f32 on the card and on the CPU from the same base
    params: max |card - CPU| / max |CPU| of each entry and param delta, the
    worst per algorithm ("norm", "full diff_b" for param deltas); and the
    card's load time. Fails above ADAPTER_COMPOSE_REL, or when the two
    loads hold other sites or keys."""
    from lora_tpu_torch.formats.kohya import load_kohya
    from lora_tpu_torch.formats.lycoris import load_lycoris

    (_, unet, u_sites), (_, text, t_sites) = _adapter_sites(pipe)
    params = {"unet": unet.flat_params(), "text": text.flat_params()}

    def load(device):
        kw = dict(unet_sites=u_sites, text_sites=t_sites, dtype=torch.float32,
                  device=device)
        if not lycoris:
            return load_kohya(path, **kw)
        p = {m: {k: v.to(device) for k, v in d.items()}
             for m, d in params.items()}
        return load_lycoris(path, unet_params=p["unet"],
                            text_params=p["text"], **kw)

    t0 = time.perf_counter()
    card = load(pipe.device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = load("cpu")
    worst = {}
    for model, tc, tp in zip(("unet", "text_encoder"), card, cpu):
        if list(tc["sites"]) != list(tp["sites"]) or \
                set(tc.get("param_deltas", {})) != set(
                    tp.get("param_deltas", {})):
            raise AssertionError(f"{path}: the card's and the CPU's {model} "
                                 f"trees hold other sites or keys")
        pairs = [(plan.get((model, site), "lora"), got, entry[leaf])
                 for site, entry in tp["sites"].items()
                 for leaf, got in tc["sites"][site].items()]
        pairs += [("full diff_b" if k[:-len(".bias")] in tp["sites"]
                   else "norm", tc["param_deltas"][k], want)
                  for k, want in tp.get("param_deltas", {}).items()]
        for algo, got, want in pairs:
            worst[algo] = max(worst.get(algo, 0.0), _rel(got.cpu(), want))
    if max(worst.values()) > ADAPTER_COMPOSE_REL:
        raise AssertionError(f"{path}: composed on the card, off the CPU by "
                             f"{worst} (limit {ADAPTER_COMPOSE_REL})")
    return {"card_load_s": card_s, "worst_rel_err_by_algo": worst}


def _norm_and_bias(pipe) -> dict:
    """Clones of every norm and bias param of the UNet and the text
    encoder."""
    return {(m, k): v.detach().clone()
            for m, module in (("unet", pipe.unet),
                              ("text_encoder", pipe.text_encoder))
            for k, v in module.flat_params().items()
            if k.endswith(".bias") or "norm" in k.rsplit(".", 2)[-2]}


def _unet_inputs(dtype, gen, channels: int = 4):
    """One UNet call's inputs at batch 4 (2 prompts under CFG), 512px
    (`channels` latent channels in: 9 for an inpainting UNet)."""
    b = 2 * len(PROMPTS)
    return (torch.randn((b, 64, 64, channels), generator=gen, device="cuda",
                        dtype=dtype),
            torch.full((b,), 501, device="cuda"),
            torch.randn((b, 77, 768), generator=gen, device="cuda",
                        dtype=dtype))


def _unet_out(pipe, inputs, lora) -> torch.Tensor:
    with torch.inference_mode():
        return pipe.unet(*inputs, lora=lora)


def _time_unet(pipe, inputs, lora, route: str) -> dict:
    """ADAPTER_UNET_REPS UNet calls (after 2 warm-up), each synchronized:
    their median and min wall ms, the flash launches per call (which must
    be ROUTED_PER_UNET_CALL of `route`), and the device ms per call from
    torch.profiler."""
    for _ in range(2):
        _unet_out(pipe, inputs, lora)
    torch.cuda.synchronize()
    _zero_counts()
    walls = []
    for _ in range(ADAPTER_UNET_REPS):
        t0 = time.perf_counter()
        _unet_out(pipe, inputs, lora)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    fwd = dict(fa.flash_fwd.launches_by_kernel)
    if fwd != _only(route, ROUTED_PER_UNET_CALL * ADAPTER_UNET_REPS):
        raise AssertionError(f"{ADAPTER_UNET_REPS} UNet calls launched "
                             f"flash_fwd {fwd}, not {ROUTED_PER_UNET_CALL} "
                             f"{route} each")
    return {"wall_ms_median": statistics.median(walls),
            "wall_ms_min": min(walls),
            "device_ms": _kernel_ms(lambda: _unet_out(pipe, inputs, lora),
                                    reps=3),
            "flash_fwd_per_call": {k: v / ADAPTER_UNET_REPS
                                   for k, v in fwd.items()}}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def phase_adapters(smi: str):
    """Phase 11: kohya / LoCon and LyCORIS files through patch_pipe, the
    base-param deltas, collapse_lora and the server, at full SD-1.5 width.
    Returns the bf16 and f32 flash forward launches and the int8 launches
    of its counted runs, by kernel."""
    from lora_tpu_torch import serve
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    report = {"card": smi}
    fwd_total = dict.fromkeys(fa.flash_fwd.launches_by_kernel, 0)
    f32_total = dict(fwd_total)
    int8_total = dict.fromkeys(i8.int8_matmul.launches_by_kernel, 0)

    def new_pipe(dtype):
        return StableDiffusionPipeline.random_init(
            generator=torch.Generator("cuda").manual_seed(SEED),
            device="cuda", dtype=dtype)

    counted = functools.partial(
        counted_request, report, "adapters",
        totals={"flash_fwd": fwd_total, "int8_matmul": int8_total})

    with tempfile.TemporaryDirectory() as tmp:
        k_path, l_path, l0_path = (os.path.join(tmp, n) for n in (
            "locon.safetensors", "lycoris.safetensors",
            "lycoris_int8.safetensors"))
        pipe = new_pipe(torch.bfloat16)
        orig = _norm_and_bias(pipe)
        report["file_K"] = _kohya_file(pipe, k_path, gen)
        lyco = _lycoris_file(pipe, l_path, gen)
        plan = lyco.pop("plan")
        report["file_L"] = lyco
        log("adapters: files: " + json.dumps(
            {"K": report["file_K"], "L": report["file_L"]}))

        # the loaders on the card against the same files composed on the CPU
        report["compose"] = {
            "K": _compose_errors(pipe, k_path, False, {}),
            "L": _compose_errors(pipe, l_path, True, plan),
            "limit": ADAPTER_COMPOSE_REL}
        log("adapters: compose: " + json.dumps(report["compose"]))

        # bf16 UNet calls at batch 4: no adapter, K, L; each file's load
        inputs = _unet_inputs(torch.bfloat16, gen)
        unet = {"none": _time_unet(pipe, inputs, None, "wgmma")}
        loads = {}
        for name, path in (("K", k_path), ("L", l_path)):
            t0 = time.perf_counter()
            pipe.patch_pipe(path)
            torch.cuda.synchronize()
            loads[name] = time.perf_counter() - t0
            unet[name] = _time_unet(pipe, inputs, pipe.lora_unet, "wgmma")
        report["patch_pipe_s"], report["unet_bf16_b4"] = loads, unet
        log("adapters: unet bf16 batch 4: " + json.dumps(
            {"patch_pipe_s": loads, "unet": unet, "card": smi}))
        if not (pipe.has_base_deltas("unet")
                and pipe.has_base_deltas("text_encoder")):
            raise AssertionError("L installed no base deltas")

        # serving L over HTTP at alpha 1.0, 0.5, 1.0; then K patched live
        srv = serve.PipelineServer(pipe, port=0, max_batch=2,
                                   batch_window_ms=50.0).start()
        try:
            images = []
            for i, alpha in enumerate(ADAPTER_ALPHAS):
                body = counted(f"http L alpha {alpha} ({i + 1})", MODE_STEPS,
                               lambda: _http(srv.port, "/generate", {
                                   "prompt": PROMPTS, "steps": MODE_STEPS,
                                   "guidance": 7.5, "height": 512,
                                   "width": 512, "seed": 7,
                                   "alpha": alpha})[1])
                _check_pngs(body["images"], len(PROMPTS), 512)
                images.append(body["images"])
            with srv.lock:
                per_text = {t: sum(1 for tt, _ in srv._embeds if tt == t)
                            for t in PROMPTS + [""]}
                alpha_keys = len({k for _, k in srv._embeds})
            serving = {"requests_1_3_equal": images[0] == images[2],
                       "request_2_differs": images[1] != images[0],
                       "embed_entries_per_text": per_text,
                       "embed_alpha_keys": alpha_keys}
            with srv.lock:
                t0 = time.perf_counter()
                pipe.patch_pipe(k_path)
                torch.cuda.synchronize()
                serving["live_patch_K_s"] = time.perf_counter() - t0
            now = _norm_and_bias(pipe)
            serving["norm_bias_params"] = len(orig)
            serving["restored_bit_for_bit"] = sum(
                torch.equal(now[k], v) for k, v in orig.items())
            body = counted("http K after live patch", MODE_STEPS,
                           lambda: _http(srv.port, "/generate", {
                               "prompt": PROMPTS, "steps": MODE_STEPS,
                               "guidance": 7.5, "height": 512,
                               "width": 512, "seed": 7})[1])
            _check_pngs(body["images"], len(PROMPTS), 512)
            if srv.drain(timeout=60) is not True:
                raise AssertionError("the server did not drain")
        finally:
            srv.stop()
        report["serving"] = serving
        log("adapters: serving: " + json.dumps(serving))
        if not (serving["requests_1_3_equal"]
                and serving["request_2_differs"]
                and per_text == dict.fromkeys(PROMPTS + [""], 2)
                and alpha_keys == 2
                and serving["restored_bit_for_bit"] == len(orig)):
            raise AssertionError(f"serving L: {serving}")

        # bf16: L at 0.7 against collapse_lora(0.7) (no limit: bf16 weights
        # round W + 0.7 dW once more)
        a = ADAPTER_COLLAPSE_ALPHA
        pipe.patch_pipe(l_path)
        pipe.tune_lora_scale(a)
        patched = _unet_out(pipe, inputs, pipe.lora_unet)
        pipe.collapse_lora(a)
        report["collapse_bf16_rel_l2"] = _rel_l2(
            _unet_out(pipe, inputs, None), patched)
        del pipe, patched, srv
        torch.cuda.empty_cache()

        # f32: the same, within ADAPTER_COLLAPSE_REL_L2
        pipe = new_pipe(torch.float32)
        inputs = _unet_inputs(torch.float32, gen)
        pipe.patch_pipe(l_path)
        pipe.tune_lora_scale(a)
        _zero_counts()
        patched = _unet_out(pipe, inputs, pipe.lora_unet)
        torch.cuda.synchronize()
        f32_fwd = dict(fa.flash_fwd.launches_by_kernel)
        if f32_fwd != _only("tf32x3", ROUTED_PER_UNET_CALL):
            raise AssertionError(f"the f32 UNet call launched flash_fwd "
                                 f"{f32_fwd}")
        for k in f32_total:
            f32_total[k] += f32_fwd[k]
        pipe.collapse_lora(a)
        rel = _rel_l2(_unet_out(pipe, inputs, None), patched)
        report["collapse_f32_rel_l2"] = rel
        log("adapters: collapse: " + json.dumps({
            "alpha": a, "bf16_rel_l2": report["collapse_bf16_rel_l2"],
            "f32_rel_l2": rel, "f32_limit": ADAPTER_COLLAPSE_REL_L2,
            "f32_flash_fwd": f32_fwd}))
        if not rel <= ADAPTER_COLLAPSE_REL_L2:
            raise AssertionError(f"f32 UNet call with L at {a} is {rel} "
                                 f"(relative L2) from collapse_lora({a})")
        del pipe, patched, inputs
        torch.cuda.empty_cache()

        # quantized: a LyCORIS file without base-weight-dependent modules,
        # patched before quantize_base, served over HTTP; then L refused
        pipe = new_pipe(torch.bfloat16)
        report["file_L_int8"] = _lycoris_file(pipe, l0_path, gen,
                                              exclude=BASE_DEPENDENT)
        report["file_L_int8"].pop("plan")
        pipe.patch_pipe(l0_path)
        pipe.quantize_base()
        torch.cuda.empty_cache()
        per_call = {"unet": _int8_dense(pipe.unet),
                    "clip_encode": _int8_dense(pipe.text_encoder),
                    "vae_decode": _int8_dense(pipe.vae, "decoder.")}
        if per_call != INT8_PER_CALL:
            raise AssertionError(f"2-D int8 weights per call {per_call}")
        encodes = [0]
        encode_prompt = pipe.encode_prompt

        def counted_encode(prompts):
            encodes[0] += 1
            return encode_prompt(prompts)

        pipe.encode_prompt = counted_encode
        srv = serve.PipelineServer(pipe, port=0, max_batch=2,
                                   batch_window_ms=50.0).start()
        try:
            body = counted("http int8 L without base-dependent modules",
                           MODE_STEPS,
                           lambda: _http(srv.port, "/generate", {
                               "prompt": PROMPTS, "steps": MODE_STEPS,
                               "guidance": 7.5, "height": 512,
                               "width": 512, "seed": 7})[1],
                           int8_want=lambda: (
                               per_call["unet"] * MODE_STEPS
                               + per_call["clip_encode"] * encodes[0]
                               + per_call["vae_decode"]))
            _check_pngs(body["images"], len(PROMPTS), 512)
            if srv.drain(timeout=60) is not True:
                raise AssertionError("the server did not drain")
        finally:
            srv.stop()
        try:
            pipe.patch_pipe(l_path)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("the int8 pipe composed L's base-weight-"
                                 "dependent modules")
        if "int8-quantized" not in refused or "quantize_base" not in refused:
            raise AssertionError(f"the int8 pipe refused L with {refused!r}")
        report["int8_refusal"] = refused
        log("adapters: int8: " + json.dumps({
            "file": report["file_L_int8"], "clip_encodes": encodes[0],
            "refusal": refused}))
        del srv, pipe
        torch.cuda.empty_cache()
    log("adapters: " + json.dumps({
        "flash_fwd_launches": fwd_total, "f32_flash_fwd_launches": f32_total,
        "http_int8_launches": int8_total, "steps": MODE_STEPS, "cfg": 7.5,
        "card": smi}))
    return fwd_total, f32_total, int8_total


# ---------------------------------------------------------------------------
# phase 12: the DreamBooth trainer through lora_db
# ---------------------------------------------------------------------------

# 12a: extra group sizes of the blockwise-int8 Adam check (a ragged last
# block, one element) beside the counted run's UNet and CLIP groups
ADAM8BIT_EXTRA_N = (256 * 1000 + 37, 1)
ADAM8BIT_UPDATES = 3
# f32 operations per element of the update (csrc/adam8bit.cu: the clip,
# two dequantizations, the moments, the step, the decayed update, the
# absmax and two encodes): the operation side of its bound; 16 bytes per
# element (g and p read, p written, two int8 codes read and written) and
# 16 per block of 256 (two scales read and written) are the byte side
ADAM8BIT_OPS_PER_ELEMENT = 32
# 12b-12f: the counted run and the runs after it
TRAINER_STEPS, TRAINER_SAVE_STEPS = 20, 10
TRAINER_RESUME_STEPS = 25
TRAINER_BF16_STEPS = 5
TRAINER_CLI_STEPS = 2
TRAINER_CLASS_IMAGES, TRAINER_SAMPLE_STEPS = 2, 10
TRAINER_RANK = 4
# the instance images: (height, width), each resized to 512 on its short
# side and center-cropped
TRAINER_IMAGES = ((512, 512), (480, 640), (720, 480), (768, 768))


def lora_group_size(sites, rank: int) -> int:
    """Elements of a rank-`rank` LoRA group raveled: every site's down and
    up, and the scale leaf."""
    n = 1
    for s in sites:
        kh, kw = (1, 1) if s.kind == "linear" else tuple(s.kernel)
        n += rank * s.in_dim * kh * kw + s.out_dim * rank
    return n


def check_adam8bit(n: int, gen, timed: bool) -> dict:
    """adam8bit_update against its plain version on the card: a group of n
    elements, ADAM8BIT_UPDATES updates with the clip scale as a device
    tensor; params, codes and scales must be bit-identical after each.
    Timed: the wrapper (host launch path included), its device time from
    CUDA-graph replays, the plain version, and the bound."""
    from lora_tpu_torch.ops import adam8bit as a8
    from lora_tpu_torch.training.optim import _bias_corrections

    p = torch.randn(n, generator=gen, device="cuda")
    q, s = a8.quantize(torch.zeros(n, device="cuda"))
    kern = [p.clone(), q.clone(), s.clone(), q.clone(), s.clone()]
    plain = [t.clone() for t in kern]
    clip = torch.tensor(0.7, device="cuda")
    for count in range(1, ADAM8BIT_UPDATES + 1):
        g = 0.01 * torch.randn(n, generator=gen, device="cuda")
        c1, c2 = _bias_corrections((0.9, 0.999), count)
        kw = dict(lr=1e-4, wd=1e-2, b1=0.9, b2=0.999, eps=1e-8, c1=c1, c2=c2)
        before = a8.adam8bit_update.launches
        a8.adam8bit_update(g, clip, *kern, **kw)
        a8.adam8bit_update_reference(g, clip, *plain, **kw)
        torch.cuda.synchronize()
        if a8.adam8bit_update.launches != before + 1:
            raise AssertionError("adam8bit_update did not launch its kernel")
        for name, a, b in zip(("p", "mu_q", "mu_s", "nu_q", "nu_s"), kern,
                              plain):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"adam8bit kernel and plain version differ in {name} at "
                    f"n = {n}, update {count}: max |diff| "
                    f"{(a.float() - b.float()).abs().max().item()}")
    nb = a8.n_blocks(n)
    row = {"n": n, "blocks": nb, "updates": ADAM8BIT_UPDATES,
           "bit_identical": True,
           "max_abs_err": (kern[0] - plain[0]).abs().max().item()}
    if timed:
        row["ms"] = _time_ms(lambda: a8.adam8bit_update(g, clip, *kern, **kw))
        row["device_ms"] = _graph_ms(
            lambda: a8.adam8bit_update(g, clip, *kern, **kw))
        row["plain_ms"] = _time_ms(
            lambda: a8.adam8bit_update_reference(g, clip, *plain, **kw))
        row.update(_bound(ADAM8BIT_OPS_PER_ELEMENT * n, 16 * n + 16 * nb,
                          PEAK_F32_FLOPS))
    log("adam8bit: " + json.dumps(row))
    return row


def _trainer_groups():
    from lora_tpu_torch.core.sites import (
        text_encoder_lora_sites,
        unet_lora_sites,
    )
    from lora_tpu_torch.models.config import SD15_TEXT, SD15_UNET

    return (lora_group_size(unet_lora_sites(SD15_UNET), TRAINER_RANK),
            lora_group_size(text_encoder_lora_sites(SD15_TEXT),
                            TRAINER_RANK))


def _instance_pngs(inst: str, sizes, seed: int) -> str:
    """Instance images of the given (height, width) sizes, written to the
    new directory `inst` as PNGs by the port's encoder: gradients with
    noise from `seed`."""
    from lora_tpu_torch.data.png import _png_bytes

    os.makedirs(inst)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                        (xx + yy) % 256], -1) + rng.integers(-20, 20,
                                                             (h, w, 3))
        with open(os.path.join(inst, f"{i}.png"), "wb") as f:
            f.write(_png_bytes(np.clip(rgb, 0, 255).astype(np.uint8)))
    return inst


def _trainer_inputs(root: str):
    """12b: a random full-width SD-1.5 pipeline from the seed in f32 on the
    card, written as an fp16 diffusers directory (no CLIP vocabulary: the
    hashed tokenizer, opted in through LORA_TPU_ALLOW_HASHED_TOKENIZER),
    and TRAINER_IMAGES as PNGs by the port's encoder."""
    from lora_tpu_torch.models.hf_import import save_pipeline_params
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED), "cuda")
    model = os.path.join(root, "model")
    save_pipeline_params(pipe, model, fp16=True)
    inst = _instance_pngs(os.path.join(root, "instance"), TRAINER_IMAGES,
                          SEED)
    os.environ["LORA_TPU_ALLOW_HASHED_TOKENIZER"] = "1"
    log(f"trainer: inputs {model} (fp16) and {len(TRAINER_IMAGES)} PNGs "
        f"{TRAINER_IMAGES} in {time.perf_counter() - t0:.1f} s")
    return pipe, model, inst


@contextlib.contextmanager
def timing_trainer_steps(record: dict, trainer=None, progress=None,
                         loop_peak=False):
    """Wraps a trainer module's step factory (make_train_step of
    training/dreambooth.py unless `trainer` names another): CUDA events
    around each step (read after the run, so the loop gains no host sync),
    each step's loss tensor (record["losses"]) and the optimizer it was
    built with. Each factory call (one per training phase) starts a new
    list of events in record["phases"]; record["events"] is the latest.
    progress: a file that each step overwrites with the count of steps
    made. loop_peak: at the first step, record["setup_peak_gib"] is the
    peak memory so far and the peak is reset, so that the peak after the
    run is the training loop's."""
    if trainer is None:
        from lora_tpu_torch.training import dreambooth as trainer

    real = trainer.make_train_step

    def make_train_step(**kw):
        step = real(**kw)
        record["optimizer"] = kw["optimizer"]
        record["events"] = []
        record.setdefault("phases", []).append(record["events"])

        def timed_step(*a, **kw2):
            if loop_peak and "setup_peak_gib" not in record:
                torch.cuda.synchronize()
                record["setup_peak_gib"] = (torch.cuda.max_memory_allocated()
                                            / 2 ** 30)
                torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*a, **kw2)
            end.record()
            record["events"].append((start, end))
            record.setdefault("losses", []).append(loss)
            if progress is not None:
                with open(progress, "w") as f:
                    f.write(str(len(record["losses"])))
            return loss

        return timed_step

    trainer.make_train_step = make_train_step
    try:
        yield record
    finally:
        trainer.make_train_step = real


def _step_ms(record: dict, skip: int = 2, events=None) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in
            (record["events"] if events is None else events)[skip:]]


def _launches():
    from lora_tpu_torch.ops.adam8bit import adam8bit_update

    return {"flash_fwd": dict(fa.flash_fwd.launches_by_kernel),
            "flash_bwd_dq": dict(fa.flash_bwd_dq.launches_by_kernel),
            "flash_bwd_dkv": dict(fa.flash_bwd_dkv.launches_by_kernel),
            "adam8bit": adam8bit_update.launches}


def _zero_trainer_counts():
    from lora_tpu_torch.ops.adam8bit import adam8bit_update

    _zero_counts()
    adam8bit_update.launches = 0


def _scaled(counts: dict, k: int) -> dict:
    return {r: k * n for r, n in counts.items()}


def _added(a: dict, b: dict) -> dict:
    return {r: a[r] + b[r] for r in a}


def _expect_launches(what: str, got: dict, steps: int, unet_calls: int,
                     dt, adam: int) -> None:
    """Every flash launch of `steps` training steps and `unet_calls`
    sampling UNet calls through the routes _per_step_want names for `dt`
    (no mma.sync kernel), and `adam` blockwise-int8 updates."""
    dq, dkv, fwd = _per_step_want(dt)
    want = {"flash_fwd": _scaled(fwd, steps + unet_calls),
            "flash_bwd_dq": _scaled(dq, steps),
            "flash_bwd_dkv": _scaled(dkv, steps), "adam8bit": adam}
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want}")


def _metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_trainer_result(res: dict, steps: int, what: str) -> None:
    if res["steps"] != steps or res["preempted"]:
        raise AssertionError(f"{what}: {res['steps']} steps, preempted "
                             f"{res['preempted']}; wanted {steps}")
    if not np.isfinite(res["final_loss"]):
        raise AssertionError(f"{what}: non-finite final loss")


def _patched_unet_check(pipe, path: str, what: str) -> dict:
    """The file through the port's patch_pipe: one UNet call at batch 4,
    finite and apart from the call without it."""
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    inputs = _unet_inputs(pipe.dtype, gen)
    pipe.remove_lora()
    plain = _unet_out(pipe, inputs, None)
    pipe.patch_pipe(path)
    out = _unet_out(pipe, inputs, pipe.lora_unet)
    pipe.remove_lora()
    moved = (out.float() - plain.float()).abs().max().item()
    if not torch.isfinite(out).all() or moved == 0.0:
        raise AssertionError(f"{what}: the UNet call with {path} is not "
                             f"finite or equals the call without it "
                             f"(max |diff| {moved})")
    return {"file": os.path.basename(path), "unet_max_abs_change": moved}


def _level_key(row) -> tuple:
    return row["B"], row["H"], row["T"], row["S"], row["D"], row["dtype"]


def flash_rows_at(gen, fwd_levels, bwd_levels, fwd_rows=(),
                  bwd_rows=()) -> list:
    """The flash kernels against their plain versions, untimed, at every
    SD-1.5 level of each (batch, dtype) of fwd_levels (the forward) and
    bwd_levels (dQ and dK/dV) that phases 3 and 4 (fwd_rows, bwd_rows) did
    not check. Returns the forward rows, the given ones included."""
    rows = list(fwd_rows)
    done = {_level_key(r) for r in fwd_rows}
    done_bwd = {_level_key(r) for r in bwd_rows}
    for levels, checked, check in ((fwd_levels, done, check_kernel),
                                   (bwd_levels, done_bwd,
                                    check_bwd_kernels)):
        for B, dtype in levels:
            for T, D in SD15_ATTN_SHAPES:
                key = (B, 8, T, T, D, str(dtype).replace("torch.", ""))
                if key not in checked:
                    row = check(B, 8, T, T, D, dtype, gen, timed=False)
                    if check is check_kernel:
                        rows.append(row)
    return rows


def trainer_flash_rows(gen, fwd_rows=(), bwd_rows=()) -> list:
    """Phase 12's shapes: f32 forward at batch 4 (the class images'
    sampling) and batch 2 (prior preservation's [instance | class] rows),
    f32 dQ and dK/dV at batch 2, bf16 forward, dQ and dK/dV at batch 1
    (12e)."""
    return flash_rows_at(
        gen, ((4, torch.float32), (2, torch.float32), (1, torch.bfloat16)),
        ((2, torch.float32), (1, torch.bfloat16)), fwd_rows, bwd_rows)


def phase_trainer(smi: str, fwd_rows=(), bwd_rows=(), root=None) -> dict:
    """Phase 12: 12a the blockwise-int8 Adam kernel against its plain
    version; 12b the inputs; 12c the counted run through
    cli.lora_db.train; 12d its resume; 12e bf16 with cached latents and
    LoCon targets; 12f the console entry as a subprocess. Every flash
    forward call of 12c-12e is recorded and must be at a shape checked
    against the plain version (fwd_rows: phase 3's, and this phase's
    own; bwd_rows: phase 4's, whose levels this phase does not check
    again). root: a directory that keeps the inputs and 12c's class
    images for phase 17 (else a temporary one)."""
    from lora_tpu_torch.cli import lora_db
    from lora_tpu_torch.data.png import png_size

    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    # 12a
    n_unet, n_text = _trainer_groups()
    adam_rows = [check_adam8bit(n, gen, timed=(n == n_unet))
                 for n in (n_unet, n_text) + ADAM8BIT_EXTRA_N]
    rows = trainer_flash_rows(gen, fwd_rows, bwd_rows)
    out = {"adam8bit_rows": adam_rows}
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="lora_db_"))
        pipe, model, inst = _trainer_inputs(root)
        common = dict(instance_data_dir=inst,
                      instance_prompt="a photo of sks dog", resolution=512,
                      lora_rank=TRAINER_RANK, seed=SEED, learning_rate=1e-4)
        with recording_flash_shapes(set()) as seen:
            out.update(_trainer_runs(lora_db, pipe, model, root, common,
                                     png_size))
        unchecked = seen - {_row_key(r) for r in rows}
        if unchecked:
            raise AssertionError(f"the trainer ran flash_fwd at shapes or "
                                 f"layouts no check covered: "
                                 f"{sorted(unchecked)}")
        log(f"trainer: flash_fwd ran {len(seen)} shapes and layouts, each "
            f"checked against its plain version")
        out["cli"] = _trainer_cli(model, inst, root)
    log(f"trainer: {smi}")
    return out


def _trainer_runs(lora_db, pipe, model, root, common, png_size) -> dict:
    out = {}
    # 12c: the counted run
    run = os.path.join(root, "run")
    cls = os.path.join(root, "class")
    flags = dict(common, output_dir=run, train_text_encoder=True,
                 with_prior_preservation=True, class_data_dir=cls,
                 class_prompt="a photo of a dog",
                 num_class_images=TRAINER_CLASS_IMAGES,
                 sample_steps=TRAINER_SAMPLE_STEPS, use_8bit_adam=True,
                 max_train_steps=TRAINER_STEPS,
                 save_steps=TRAINER_SAVE_STEPS, save_train_state=True,
                 output_format="both")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_trainer_counts()
    t0 = time.perf_counter()
    with timing_trainer_steps({}) as rec:
        res = lora_db.train(model, device="cuda", **flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launches()
    _check_trainer_result(res, TRAINER_STEPS, "12c")
    # the class images' sampling: ceil(2 / 4) batch of 2 prompts under CFG
    unet_calls = TRAINER_SAMPLE_STEPS * -(-TRAINER_CLASS_IMAGES // 4)
    _expect_launches("12c", got, TRAINER_STEPS, unet_calls, torch.float32,
                     adam=2 * TRAINER_STEPS)
    records = _metrics(os.path.join(run, "metrics.jsonl"))
    steps = [r["step"] for r in records if "step" in r]
    if steps != [1, TRAINER_SAVE_STEPS, TRAINER_STEPS] or not all(
            np.isfinite(r["loss"]) and (r["step"] == 1 or "sps" in r)
            for r in records if "step" in r):
        raise AssertionError(f"12c metrics.jsonl: {records}")
    want = {f"lora_weight{s}.{e}" for s in ("", f"_s{TRAINER_SAVE_STEPS}")
            for e in ("safetensors", "pt", "text_encoder.pt")}
    want |= {"train_state.safetensors", "metrics.jsonl"}
    missing = want - set(os.listdir(run))
    gen_pngs = sorted(f for f in os.listdir(cls) if f.startswith("gen_"))
    if missing or len(gen_pngs) != TRAINER_CLASS_IMAGES or any(
            png_size(os.path.join(cls, f)) != (512, 512) for f in gen_pngs):
        raise AssertionError(f"12c artifacts: missing {sorted(missing)}, "
                             f"class images {gen_pngs}")
    patched = _patched_unet_check(
        pipe, os.path.join(run, "lora_weight.safetensors"), "12c")
    opt = rec["optimizer"]
    state_bytes = sum(t.numel() * t.element_size()
                      for t in opt.state_tensors()[1:])
    n_params = sum(p.numel() for p in opt.params)
    step_ms = _step_ms(rec)
    out["counted"] = {
        "steps": res["steps"], "wall_s": wall,
        "steps_per_sec": res["steps_per_sec"],
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": {r["step"]: r["loss"] for r in records if "step" in r},
        "step_losses": [float(x) for x in rec["losses"]],
        "sps": {r["step"]: r["sps"] for r in records if "sps" in r},
        "launches": got,
        "launches_per_step": {k: {r: n / TRAINER_STEPS for r, n in v.items()}
                              if isinstance(v, dict) else v / TRAINER_STEPS
                              for k, v in got.items()},
        "class_image_unet_calls": unet_calls,
        "params": n_params, "int8_adam_state_bytes": state_bytes,
        "f32_adamw_state_bytes": 8 * n_params,
        "patched": patched}
    log("trainer 12c: " + json.dumps(out["counted"]))
    # 12d: resume from 12c's train state to TRAINER_RESUME_STEPS
    _zero_trainer_counts()
    with timing_trainer_steps({}) as rec:
        res = lora_db.train(model, device="cuda", **dict(
            flags, output_dir=os.path.join(root, "resumed"),
            max_train_steps=TRAINER_RESUME_STEPS,
            resume_state=os.path.join(run, "train_state.safetensors")))
    _check_trainer_result(res, TRAINER_RESUME_STEPS, "12d")
    ran = len(rec["events"])
    if ran != TRAINER_RESUME_STEPS - TRAINER_STEPS:
        raise AssertionError(f"12d ran {ran} steps, not "
                             f"{TRAINER_RESUME_STEPS - TRAINER_STEPS}: the "
                             f"resume did not start at {TRAINER_STEPS}")
    got = _launches()
    _expect_launches("12d", got, ran, 0, torch.float32, adam=2 * ran)
    out["resumed"] = {"start": TRAINER_STEPS, "end": res["steps"],
                      "final_loss": res["final_loss"], "launches": got}
    log("trainer 12d: " + json.dumps(out["resumed"]))
    # 12e: bf16, cached latents, LoCon targets, plain AdamW
    bf16 = os.path.join(root, "bf16")
    _zero_trainer_counts()
    with timing_trainer_steps({}) as rec:
        res = lora_db.train(model, device="cuda", mixed_precision="bf16",
                            **dict(common, output_dir=bf16,
                                   cached_latents=True, lora_targets="locon",
                                   output_format="safe",
                                   max_train_steps=TRAINER_BF16_STEPS,
                                   save_steps=0))
    _check_trainer_result(res, TRAINER_BF16_STEPS, "12e")
    got = _launches()
    _expect_launches("12e", got, TRAINER_BF16_STEPS, 0, torch.bfloat16,
                     adam=0)
    out["bf16"] = {"steps": res["steps"], "launches": got,
                   "step_ms_median": statistics.median(_step_ms(rec, 1)),
                   "final_loss": res["final_loss"],
                   "patched": _patched_unet_check(
                       pipe, os.path.join(bf16, "lora_weight.safetensors"),
                       "12e")}
    log("trainer 12e: " + json.dumps(out["bf16"]))
    return out


def _console_entry(what: str, cli: str, args, outdir: str,
                   artifact: str) -> dict:
    """`python -m lora_tpu_torch.cli.<cli> ARGS --output_dir OUTDIR` in a
    child process from the repo root: exit 0 and OUTDIR/ARTIFACT."""
    cmd = [sys.executable, "-m", f"lora_tpu_torch.cli.{cli}", *args,
           "--output_dir", outdir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    for line in (proc.stdout + proc.stderr).splitlines()[-8:]:
        log(f"{what}: {line}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(
            os.path.join(outdir, artifact)):
        raise AssertionError(f"{what}: the console entry exited "
                             f"{proc.returncode} or wrote no {artifact}")
    log(f"{what}: exit 0 in {wall:.1f} s")
    return {"exit": proc.returncode, "wall_s": wall}


def _trainer_cli(model: str, inst: str, root: str) -> dict:
    """12f: `python -m lora_tpu_torch.cli.lora_db`, 2 steps with cached
    latents."""
    return _console_entry(
        "trainer 12f", "lora_db",
        ["--pretrained_model_name_or_path", model, "--instance_data_dir",
         inst, "--instance_prompt", "a photo of sks dog",
         "--max_train_steps", str(TRAINER_CLI_STEPS), "--cached_latents",
         "--save_steps", "0"],
        os.path.join(root, "cli"), "lora_weight.safetensors")


def adam8bit_kernel_row(trainer: dict) -> dict:
    """The kernels-line row of csrc/adam8bit.cu: launches from the counted
    run (12c), the worst error and the times from 12a at the UNet group."""
    rows = trainer["adam8bit_rows"]
    main = rows[0]
    return {
        "name": "adam8bit",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/adam8bit.cu",
        # not a Pallas kernel: lora_tpu's blockwise-int8 Adam is jnp under
        # optax (scale_by_adam_8bit)
        "replaces": "lora_tpu/training/optim.py:28",
        "launches": trainer["counted"]["launches"]["adam8bit"],
        "launches_by_path": {"trainer": trainer["counted"]["launches"][
            "adam8bit"]},
        # params, codes and scales bit-identical to the plain version at
        # every size of 12a
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "group_elements": main["n"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no one PyTorch call computes the blockwise-int8 update
        "library_ms": None,
    }


# phase 13: pivotal tuning through lora_pti and the legacy TI trainer
# through lora_ti. 13b: inversion and tuning steps (each of PTI_GA
# micro-steps), saves every PTI_SAVE_STEPS; 13c: bf16 inpainting, 2 + 2
# steps of one micro-step; 13d: legacy TI steps, the TI row on until
# PTI_TI_UNFREEZE; 13e: the console entry, 1 + 1 steps
PTI_STEPS, PTI_GA, PTI_SAVE_STEPS = 4, 2, 2
PTI_BF16_STEPS = 2
PTI_TI_STEPS, PTI_TI_UNFREEZE = 4, 2
PTI_TOKENS = ("<s1>", "<s2>")
PTI_PROMPT = "a photo of <s1> dog"


def pti_flash_rows(gen, fwd_rows=(), bwd_rows=()) -> list:
    """Phase 13's shapes: forward, dQ and dK/dV at batch 1 in f32 (13b,
    13d) and bf16 (13c), and the forward at batch 4 in both (the UNet
    calls through patch_pipe)."""
    at_1 = ((1, torch.float32), (1, torch.bfloat16))
    return flash_rows_at(gen, at_1 + ((4, torch.float32),
                                      (4, torch.bfloat16)),
                         at_1, fwd_rows, bwd_rows)


@contextlib.contextmanager
def recording_ti_init(record: dict):
    """Wraps training/pti.py setup_ti: the initial TI rows it returns go to
    record["ti_init"]."""
    from lora_tpu_torch.training import pti

    real = pti.setup_ti

    def setup_ti(*a, **kw):
        ids, rows = real(*a, **kw)
        record["ti_init"] = rows.detach().clone()
        return ids, rows

    pti.setup_ti = setup_ti
    try:
        yield record
    finally:
        pti.setup_ti = real


def _expect_pti_launches(what: str, got: dict, dt, inversion: int,
                         tuning: int) -> None:
    """The flash launches of `inversion` + `tuning` PTI micro-steps in
    `dt`: _per_step_want's each, less one dQ and one dK/dV launch per
    inversion micro-step at the first level (T = S = 4096, D = 40, routed
    to "tf32x3" in f32 and "wgmma" in bf16). The first spatial
    self-attention comes before every cross-attention, so while only the
    TI rows train its q, k and v carry no gradient, and autograd runs no
    backward for it."""
    dq, dkv, fwd = _per_step_want(dt)
    first = "tf32x3" if dt == torch.float32 else "wgmma"
    micro = inversion + tuning
    want = {"flash_fwd": _scaled(fwd, micro),
            "flash_bwd_dq": _scaled(dq, micro),
            "flash_bwd_dkv": _scaled(dkv, micro), "adam8bit": 0}
    for w in ("flash_bwd_dq", "flash_bwd_dkv"):
        want[w][first] -= inversion
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want}")


def _embeds(path: str) -> dict:
    from lora_tpu_torch.formats.safetensors_io import load_safeloras_embeds

    return load_safeloras_embeds(path)


def _expect_files(what: str, out: str, want) -> None:
    missing = set(want) - set(os.listdir(out))
    if missing:
        raise AssertionError(f"{what}: missing {sorted(missing)} in "
                             f"{sorted(os.listdir(out))}")


def _check_pti_metrics(what: str, out: str) -> dict:
    """lora_pti's records: step 1 and the final loss of each phase, every
    loss finite; returns {phase: final loss}."""
    records = _metrics(os.path.join(out, "metrics.jsonl"))
    got = [(r.get("phase"), r.get("step"), "final_loss" in r)
           for r in records]
    want = [("inversion", 1, False), ("inversion", None, True),
            ("tune", 1, False), ("tune", None, True)]
    if got != want or not all(np.isfinite(r.get("loss",
                                                r.get("final_loss")))
                              for r in records):
        raise AssertionError(f"{what} metrics.jsonl: {records}")
    return {r["phase"]: r["final_loss"] for r in records
            if "final_loss" in r}


def _pti_text_check(pipe, path: str) -> float:
    """A text encode of PTI_PROMPT without the adapter and after
    patch_pipe of `path` (its LoRA and TI rows): max |difference|, which
    must be finite and nonzero."""
    pipe.remove_lora()
    with torch.inference_mode():
        plain = pipe.encode_prompt([PTI_PROMPT]).float()
        pipe.patch_pipe(path)
        moved = pipe.encode_prompt([PTI_PROMPT]).float()
    pipe.remove_lora()
    diff = (moved - plain).abs().max().item()
    if not torch.isfinite(moved).all() or diff == 0.0:
        raise AssertionError(f"13b: the text encode with {path} is not "
                             f"finite or equals the one without it "
                             f"(max |diff| {diff})")
    return diff


def _pti_inputs(root: str):
    """13a: 12b's f32 pipeline, fp16 directory and instance PNGs, and a
    9-channel SD-1.5 (SD15_UNET with in_channels=9) from the seed in bf16,
    written the same way."""
    from lora_tpu_torch.models.config import SD15_UNET
    from lora_tpu_torch.models.hf_import import save_pipeline_params
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    pipe, model, inst = _trainer_inputs(root)
    t0 = time.perf_counter()
    ipipe = StableDiffusionPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED + 13), "cuda",
        dtype=torch.bfloat16,
        unet_cfg=dataclasses.replace(SD15_UNET, in_channels=9))
    imodel = os.path.join(root, "model_inpaint")
    save_pipeline_params(ipipe, imodel, fp16=True)
    log(f"pti: the 9-channel bf16 pipeline written to {imodel} in "
        f"{time.perf_counter() - t0:.1f} s")
    return pipe, model, inst, ipipe, imodel


def phase_pti(smi: str, fwd_rows=(), bwd_rows=()) -> dict:
    """Phase 13: the flash kernels at phase 13's shapes phases 3 and 4 did
    not check; 13a the inputs; 13b the counted lora_pti run; 13c bf16
    inpainting with LoCon targets; 13d the legacy TI trainer through
    lora_ti; 13e the console entry as a child process. Every flash
    forward call of 13b-13d is recorded and must be at a shape checked
    against the plain version."""
    from lora_tpu_torch.cli import lora_pti, lora_ti

    gen = torch.Generator("cuda").manual_seed(SEED + 13)
    rows = pti_flash_rows(gen, fwd_rows, bwd_rows)
    out = {}
    with tempfile.TemporaryDirectory(prefix="lora_pti_") as root:
        pipe, model, inst, ipipe, imodel = _pti_inputs(root)
        common = dict(instance_data_dir=inst, resolution=512,
                      lora_rank=TRAINER_RANK, seed=SEED,
                      placeholder_tokens="|".join(PTI_TOKENS),
                      use_template="object")
        with recording_flash_shapes(set()) as seen:
            out["counted"] = _pti_counted(lora_pti, pipe, model, inst, root,
                                          common)
            out["bf16"] = _pti_bf16(lora_pti, ipipe, imodel, root, common)
            out["ti"] = _pti_legacy(lora_ti, pipe, model, inst, root)
        unchecked = seen - {_row_key(r) for r in rows}
        if unchecked:
            raise AssertionError(f"phase 13 ran flash_fwd at shapes or "
                                 f"layouts no check covered: "
                                 f"{sorted(unchecked)}")
        log(f"pti: flash_fwd ran {len(seen)} shapes and layouts, each "
            f"checked against its plain version")
        out["cli"] = _pti_cli(model, inst, root)
    log(f"pti: {smi}")
    return out


def _pti_counted(lora_pti, pipe, model, inst, root, common) -> dict:
    """13b: f32 at 512px, face masks written by the dataset (the ellipse
    fallback), the text encoder, continue_inversion, cached latents;
    PTI_STEPS steps of PTI_GA micro-steps in each phase."""
    from lora_tpu_torch.data.png import png_size
    from lora_tpu_torch.training import pti

    run = os.path.join(root, "pti")
    # a constant TI schedule keeps the norm prior's pull (lambda = 100 lr)
    # on at every inversion step
    flags = dict(common, output_dir=run, lr_scheduler="constant",
                 use_face_segmentation_condition=True,
                 train_text_encoder=True, continue_inversion=True,
                 cached_latents=True, max_train_steps_ti=PTI_STEPS,
                 max_train_steps_tuning=PTI_STEPS,
                 gradient_accumulation_steps=PTI_GA,
                 save_steps=PTI_SAVE_STEPS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_trainer_counts()
    t0 = time.perf_counter()
    with timing_trainer_steps({}, pti) as rec, \
            recording_ti_init({}) as ti:
        res = lora_pti.train(model, device="cuda", **flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launches()
    micro = 2 * PTI_STEPS * PTI_GA
    if res["preempted"] or not np.isfinite(res["final_loss"]):
        raise AssertionError(f"13b: preempted {res['preempted']}, final "
                             f"loss {res['final_loss']}")
    _expect_pti_launches("13b", got, torch.float32, micro // 2,
                         micro // 2)
    final_losses = _check_pti_metrics("13b", run)
    saves = [f"step_inv_{s}" for s in range(PTI_SAVE_STEPS, PTI_STEPS + 1,
                                            PTI_SAVE_STEPS)]
    saves += [f"step_{s}" for s in range(PTI_SAVE_STEPS, PTI_STEPS + 1,
                                         PTI_SAVE_STEPS)]
    _expect_files("13b", run, [f"{s}.safetensors" for s in saves]
                  + ["final_lora.safetensors", "metrics.jsonl"])
    # the face masks the dataset wrote: gray PNGs at each image's size
    masks = {}
    for i, (h, w) in enumerate(TRAINER_IMAGES):
        path = os.path.join(inst, f"{i}.mask.png")
        with open(path, "rb") as f:
            head = f.read(26)
        if head[25] != 0 or png_size(path) != (w, h):
            raise AssertionError(f"13b: {path} is not a gray PNG of "
                                 f"{w}x{h}")
        masks[f"{i}.mask.png"] = [w, h]
    # the norm prior: each row nearer 0.4 after inversion than at its init
    inv = _embeds(os.path.join(run, f"step_inv_{PTI_STEPS}.safetensors"))
    norms = {}
    for tok, row0 in zip(PTI_TOKENS, ti["ti_init"]):
        n0 = row0.norm().item()
        n1 = float(np.linalg.norm(inv[tok]))
        if not abs(n1 - 0.4) < abs(n0 - 0.4):
            raise AssertionError(f"13b: {tok}'s norm went {n0} -> {n1}, "
                                 f"not toward 0.4")
        norms[tok] = [n0, n1]
    final = os.path.join(run, "final_lora.safetensors")
    text_moved = _pti_text_check(pipe, final)
    patched = _patched_unet_check(pipe, final, "13b")
    phases = [_step_ms(rec, events=e) for e in rec["phases"]]
    result = {
        "micro_steps": micro, "wall_s": wall,
        "micro_step_ms_median": {p: statistics.median(ms) for p, ms in
                                 zip(("inversion", "tune"), phases)},
        "micro_step_ms": dict(zip(("inversion", "tune"), phases)),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "final_losses": final_losses, "launches": got,
        "launches_per_micro_step": {
            k: {r: n / micro for r, n in v.items()}
            for k, v in got.items() if isinstance(v, dict)},
        "masks": masks, "ti_norms": norms,
        "text_max_abs_change": text_moved, "patched": patched}
    log("pti 13b: " + json.dumps(result))
    return result


def _pti_bf16(lora_pti, ipipe, imodel, root, common) -> dict:
    """13c: the 9-channel UNet in bf16, train_inpainting with cached
    latents, LoCon targets (a kohya file and an A1111 sidecar)."""
    from lora_tpu_torch.formats.pt_io import load_a1111_embedding
    from lora_tpu_torch.training import pti

    run = os.path.join(root, "pti_bf16")
    _zero_trainer_counts()
    with timing_trainer_steps({}, pti) as rec:
        res = lora_pti.train(imodel, device="cuda", mixed_precision="bf16",
                             **dict(common, output_dir=run,
                                    train_inpainting=True,
                                    cached_latents=True,
                                    lora_targets="locon",
                                    max_train_steps_ti=PTI_BF16_STEPS,
                                    max_train_steps_tuning=PTI_BF16_STEPS,
                                    gradient_accumulation_steps=1,
                                    save_steps=0))
    got = _launches()
    if res["preempted"] or not np.isfinite(res["final_loss"]):
        raise AssertionError(f"13c: preempted {res['preempted']}, final "
                             f"loss {res['final_loss']}")
    _expect_pti_launches("13c", got, torch.bfloat16, PTI_BF16_STEPS,
                         PTI_BF16_STEPS)
    _check_pti_metrics("13c", run)
    _expect_files("13c", run, ["final_lora.safetensors",
                               "final_lora.embeds.pt", "metrics.jsonl"])
    name, embeds = load_a1111_embedding(
        os.path.join(run, "final_lora.embeds.pt"))
    if name != "final_lora" or sorted(embeds) != list(PTI_TOKENS) or any(
            v.shape != (768,) or not np.isfinite(v).all()
            for v in embeds.values()):
        raise AssertionError(f"13c: the sidecar holds {name!r}, "
                             f"{ {k: v.shape for k, v in embeds.items()} }")
    # the kohya file through patch_pipe on the 9-channel pipeline
    inputs = _unet_inputs(torch.bfloat16,
                          torch.Generator("cuda").manual_seed(SEED + 13), 9)
    plain = _unet_out(ipipe, inputs, None)
    ipipe.patch_pipe(os.path.join(run, "final_lora.safetensors"))
    n_sites = len(ipipe.lora_unet["sites"])
    moved_out = _unet_out(ipipe, inputs, ipipe.lora_unet)
    ipipe.remove_lora()
    moved = (moved_out.float() - plain.float()).abs().max().item()
    if not torch.isfinite(moved_out).all() or moved == 0.0:
        raise AssertionError(f"13c: the 9-channel UNet call with the kohya "
                             f"file is not finite or unchanged ({moved})")
    result = {"micro_steps": 2 * PTI_BF16_STEPS, "launches": got,
              "micro_step_ms_median": {
                  p: statistics.median(_step_ms(rec, 1, e))
                  for p, e in zip(("inversion", "tune"), rec["phases"])},
              "final_loss": res["final_loss"], "kohya_unet_sites": n_sites,
              "unet_max_abs_change": moved,
              "sidecar_tokens": sorted(embeds)}
    log("pti 13c: " + json.dumps(result))
    return result


def _pti_legacy(lora_ti, pipe, model, inst, root) -> dict:
    """13d: the legacy TI trainer, f32, PTI_TI_STEPS steps, the TI row on
    until PTI_TI_UNFREEZE and the LoRA after, .pt and safetensors saves."""
    from lora_tpu_torch.training import ti_legacy

    run = os.path.join(root, "ti")
    _zero_trainer_counts()
    with timing_trainer_steps({}, ti_legacy) as rec:
        res = lora_ti.train(model, device="cuda", instance_data_dir=inst,
                            output_dir=run, resolution=512,
                            placeholder_token=PTI_TOKENS[0],
                            lora_rank=TRAINER_RANK, seed=SEED,
                            max_train_steps=PTI_TI_STEPS,
                            unfreeze_lora_step=PTI_TI_UNFREEZE,
                            save_steps=PTI_TI_UNFREEZE,
                            output_format="both")
    got = _launches()
    if res["preempted"] or not np.isfinite(res["final_loss"]):
        raise AssertionError(f"13d: preempted {res['preempted']}, final "
                             f"loss {res['final_loss']}")
    _expect_launches("13d", got, PTI_TI_STEPS, 0, torch.float32, adam=0)
    saves = (f"lora_ti_s{PTI_TI_UNFREEZE}", "lora_ti_final")
    _expect_files("13d", run, [s + e for s in saves for e in (
        ".safetensors", ".pt", ".ti.pt")] + ["metrics.jsonl"])
    from lora_tpu_torch.formats.reader import load_file

    (s2, _), (final, _) = (load_file(os.path.join(run, s + ".safetensors"))
                           for s in saves)
    tok = PTI_TOKENS[0]
    ups = [k for k in s2 if k.endswith(":up")]
    if not np.array_equal(s2[tok], final[tok]) or any(
            s2[k].any() for k in ups) or not any(final[k].any()
                                                 for k in ups):
        raise AssertionError("13d: the TI row moved after the unfreeze "
                             "step, or the LoRA before it")
    patched = _patched_unet_check(
        pipe, os.path.join(run, "lora_ti_final.safetensors"), "13d")
    result = {"steps": PTI_TI_STEPS, "launches": got,
              "step_ms_median": statistics.median(_step_ms(rec, 1)),
              "final_loss": res["final_loss"],
              "ti_row_frozen_after_unfreeze": True, "patched": patched}
    log("pti 13d: " + json.dumps(result))
    return result


def _pti_cli(model: str, inst: str, root: str) -> dict:
    """13e: `python -m lora_tpu_torch.cli.lora_pti`, 1 + 1 steps."""
    return _console_entry(
        "pti 13e", "lora_pti",
        ["--pretrained_model_name_or_path", model, "--instance_data_dir",
         inst, "--placeholder_tokens", "<s1>", "--use_template", "object",
         "--max_train_steps_ti", "1", "--max_train_steps_tuning", "1",
         "--gradient_accumulation_steps", "1", "--save_steps", "0"],
        os.path.join(root, "pti_cli"), "final_lora.safetensors")


# the flash rows of the kernels line: (wrapper, route) of each
FLASH_ROW_ROUTES = {
    "flash_fwd": ("flash_fwd", "wgmma"),
    "flash_fwd_tf32x3": ("flash_fwd", "tf32x3"),
    "flash_fwd_mma": ("flash_fwd", "mma"),
    "flash_bwd_dq": ("flash_bwd_dq", "wgmma"),
    "flash_bwd_dq_tf32x3": ("flash_bwd_dq", "tf32x3"),
    "flash_bwd_dq_tf32x3_wide": ("flash_bwd_dq", "tf32x3_wide"),
    "flash_bwd_dq_mma": ("flash_bwd_dq", "mma"),
    "flash_bwd_dkv": ("flash_bwd_dkv", "wgmma"),
    "flash_bwd_dkv_tf32x3": ("flash_bwd_dkv", "tf32x3"),
    "flash_bwd_dkv_tf32x3_wide": ("flash_bwd_dkv", "tf32x3_wide"),
    "flash_bwd_dkv_mma": ("flash_bwd_dkv", "mma"),
}


def add_pti_launches(kernels: list, pti: dict) -> None:
    """Each flash row of the kernels line gains phase 13's launches of its
    kernel: "pti" (13b and 13d, f32) and "pti_bf16" (13c)."""
    paths = {"pti": _added_launches(pti["counted"]["launches"],
                                    pti["ti"]["launches"]),
             "pti_bf16": pti["bf16"]["launches"]}
    for row in kernels:
        if row["name"] not in FLASH_ROW_ROUTES:
            continue
        wrapper, route = FLASH_ROW_ROUTES[row["name"]]
        for path, launches in paths.items():
            n = launches[wrapper][route]
            row["launches"] += n
            row["launches_by_path"][path] = n


def _added_launches(a: dict, b: dict) -> dict:
    return {w: _added(a[w], b[w]) for w in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}


# phase 14: SDXL serving at full width, 1024x1024
# the two self-attention levels of the SDXL UNet at 1024x1024 (128x128
# latents; none at the first level): (heads, T = S, D), 640 channels at
# 64x64 and 1280 at 32x32, head dim 64
SDXL_ATTN_LEVELS = ((10, 4096, 64), (20, 1024, 64))
# routed self-attentions per SDXL UNet call at 1024px by level (T), by
# models/structure.py: at 64x64 down_blocks.1 (2 x 2) and up_blocks.1
# (3 x 2); at 32x32 down_blocks.2 (2 x 10), the mid block (10) and
# up_blocks.0 (3 x 10)
SDXL_LAUNCHES_BY_LEVEL = {4096: 10, 1024: 60}
SDXL_ROUTED_PER_UNET_CALL = sum(SDXL_LAUNCHES_BY_LEVEL.values())  # 70
SDXL_SIZE = 1024
SDXL_PROMPTS = ["a photo of an astronaut riding a horse",
                "a watercolor of a lighthouse at dawn"]
SDXL_STEPS = 20            # 14c: bf16 txt2img, 2 prompts, CFG 5.0
SDXL_F32_STEPS = 4         # 14d: f32 + quantize_base, 1 prompt
SDXL_HTTP_STEPS = 10       # 14e: each HTTP request (image modes: 8 at 0.8)
SDXL_CFG = 5.0
SDXL_RANK = 4              # 14f: the kohya-XL and LyCORIS-XL files
SDXL_ALPHA = 0.7
# the kohya-XL file's up factors (std). At 4x this the random UNet turns
# chaotic: its output moves far between the flash and the plain path, in
# f32 as in bf16, and no collapse check holds
SDXL_UP_STD = 0.05
# the timed int8 shapes (M, K, N, dtype): the GEGLU projection at 64x64
# (2 x 4096 rows of 640 channels to 2 x 2560), f32 x (14d) and bf16 x (14g)
SDXL_INT8_TIMED = ((2 * 4096, 640, 5120, "float32"),
                   (2 * 4096, 640, 5120, "bfloat16"))
# relative L2 of one bf16 SDXL UNet call at batch 2 through the flash kernel
# against the same call through the plain attention path. Both round P to
# bf16 before P.V and store O in bf16 (2^-8 = 3.9e-3 relative), summing in
# other orders; those differences pass through 70 transformer blocks and 23
# resnets to the output. A few parts in 100 bound that (phase 7's limit for
# the gradient, GRAD_REL_L2_TOL); a wrong head, row or tile in any block
# moves the output by O(1).
SDXL_FLASH_REL_L2 = GRAD_REL_L2_TOL
# 14f, bf16: the kohya-XL file at SDXL_ALPHA (W x + a (up down x)) against
# collapse_lora(SDXL_ALPHA) ((W + a up down) x, rounded to bf16 once more):
# the UNet call at batch 2 and each text encoder's part of the encoding, by
# relative L2. The fold moves each weight by up to half a bf16 step (2^-9
# relative), as much as the flash and the plain path differ by (the patched
# call through both is printed beside it); a collapse at the wrong alpha or
# without an encoder moves them by the adapter's whole share, which the
# check requires to be at least twice the limit
SDXL_COLLAPSE_REL_L2 = 3e-2


def sdxl_flash_rows(gen) -> list:
    """14b: the forward kernels against their plain versions at the SDXL
    levels: timed at batch 2 (one prompt under CFG: 14d-14f), bf16 and
    f32; untimed in bf16 at batch 4 (14c's two prompts under CFG)."""
    rows = []
    for B, dtype, timed in ((2, torch.bfloat16, True),
                            (2, torch.float32, True),
                            (4, torch.bfloat16, False)):
        for H, T, D in SDXL_ATTN_LEVELS:
            rows.append(check_kernel(B, H, T, T, D, dtype, gen,
                                     timed=timed))
    return rows


def _sdxl_unet_inputs(pipe, batch: int, gen):
    """Random latents (batch, 128, 128, 4), timesteps, context and text_time
    rows for one SDXL UNet call, in the pipe's dtype."""
    cfg = pipe.unet.cfg
    lat = torch.randn((batch, SDXL_SIZE // 8, SDXL_SIZE // 8,
                       cfg.in_channels), generator=gen, device="cuda")
    ctx = torch.randn((batch, 77, cfg.cross_attention_dim), generator=gen,
                      device="cuda")
    pooled = torch.randn((batch, pipe.text_encoder_2.cfg.projection_dim),
                         generator=gen, device="cuda")
    return (lat.to(pipe.dtype), torch.full((batch,), 501, device="cuda"),
            ctx.to(pipe.dtype),
            {"text_embeds": pooled.to(pipe.dtype),
             "time_ids": pipe._time_ids(batch, SDXL_SIZE, SDXL_SIZE)})


def _sdxl_unet(pipe, inputs, lora=None) -> torch.Tensor:
    lat, t, ctx, cond = inputs
    with torch.inference_mode():
        return pipe.unet(lat, t, ctx, lora=lora, added_cond=cond)


def sdxl_flash_call_sums(rows, calls: collections.Counter) -> dict:
    """The flash launches of one bf16 UNet call at batch 2 by level, which
    must be SDXL_LAUNCHES_BY_LEVEL, and the sums over them of each timed
    column of 14b's batch-2 rows: bf16, and f32 (the same layers)."""
    by_level = collections.Counter()
    for key, n in calls.items():
        by_level[key[2]] += n
    if dict(by_level) != SDXL_LAUNCHES_BY_LEVEL:
        raise AssertionError(f"a UNet call launched flash_fwd {dict(by_level)}"
                             f" times by T, not {SDXL_LAUNCHES_BY_LEVEL}")
    sums = {"launches_by_T": dict(by_level)}
    for dtype, keys in (("bfloat16", FLASH_SUM_KEYS),
                        ("float32", FLASH_F32_SUM_KEYS)):
        level = {r["T"]: r for r in rows
                 if r["dtype"] == dtype and r["B"] == 2 and "ms" in r}
        sums[dtype] = {k: sum(n * level[T][k] for T, n in by_level.items())
                       for k in keys}
    log("sdxl: flash per UNet call (batch 2): " + json.dumps(sums))
    return sums


def phase_sdxl(smi: str) -> dict:
    """Phase 14: SDXL serving at full width and 1024x1024. 14a random SDXL
    weights from the seed (bf16); 14b the flash forward kernels at the
    SDXL levels against their plain versions, one UNet call with flash on
    against off, its launches by level, one profiled; 14c bf16 txt2img;
    14e HTTP (txt2img, img2img, blend inpaint); 14f a LyCORIS-XL (LoHa)
    and a kohya-XL file, the latter collapsed; 14g the bf16 pipe quantized
    over HTTP; 14d f32 with quantize_base. Every flash forward and int8
    call of 14c-14g is recorded and checked against its plain version.
    Returns the launches by path and kernel and the timed rows."""
    from lora_tpu_torch.ops.attention import (
        set_use_memory_efficient_attention,
    )
    from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

    gen = torch.Generator("cuda").manual_seed(SEED + 14)
    # 14a
    t0 = time.perf_counter()
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED), "cuda",
        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    modules = {**{m: pipe._module(m) for m in pipe._MODELS},
               "vae": pipe.vae}
    sizes = {m: {"params": sum(t.numel() for t in mod.parameters()),
                 "bytes": _param_bytes(mod)} for m, mod in modules.items()}
    log("sdxl: 14a: " + json.dumps({
        "init_s": time.perf_counter() - t0, "by_model": sizes,
        "params": sum(s["params"] for s in sizes.values()),
        "weight_bytes": sum(s["bytes"] for s in sizes.values())}))
    out = {"sizes": sizes}

    # 14b
    rows = sdxl_flash_rows(gen)
    inputs = _sdxl_unet_inputs(pipe, 2, gen)
    _sdxl_unet(pipe, inputs)  # first use: cuDNN plans, allocator
    with recording_flash_shapes(collections.Counter()) as calls:
        flash_on = counted_request({}, "sdxl", "14b flash on", 1,
                                   lambda: _sdxl_unet(pipe, inputs),
                                   per_call=SDXL_ROUTED_PER_UNET_CALL)
    out["flash_per_unet_call"] = sdxl_flash_call_sums(rows, calls)
    set_use_memory_efficient_attention(False)
    try:
        _zero_counts()
        flash_off = _sdxl_unet(pipe, inputs)
        torch.cuda.synchronize()
        off_launches = fa.flash_fwd.launches
    finally:
        set_use_memory_efficient_attention(True)
    rel = ((flash_on.float() - flash_off.float()).norm()
           / flash_off.float().norm()).item()
    profile = profile_step(lambda: _sdxl_unet(pipe, inputs))
    out["unet_call"] = {"flash_vs_plain_rel_l2": rel,
                        "limit": SDXL_FLASH_REL_L2,
                        "plain_path_flash_launches": off_launches,
                        **{k: profile[k] for k in ("wall_ms", "device_ms",
                                                   "launches", "busy_share",
                                                   "by_class")}}
    log("sdxl: 14b UNet call (batch 2): " + json.dumps(out["unet_call"]))
    if off_launches or not (np.isfinite(rel) and rel <= SDXL_FLASH_REL_L2):
        raise AssertionError(f"the SDXL UNet call through flash is {rel} "
                             f"(relative L2) from the plain path, limit "
                             f"{SDXL_FLASH_REL_L2} ({off_launches} flash "
                             f"launches with flash off)")
    del flash_on, flash_off

    report = {}
    with recording_flash_shapes(set()) as flash_seen, \
            recording_int8_shapes(set()) as int8_seen:
        # 14c: a bf16 txt2img request, 2 prompts, 1024x1024, CFG 5.0
        size = dict(height=SDXL_SIZE, width=SDXL_SIZE)
        pipe(SDXL_PROMPTS, num_inference_steps=2, guidance_scale=SDXL_CFG,
             generator=torch.Generator("cuda").manual_seed(SEED + 1), **size)
        images = counted_request(
            report, "sdxl", "14c txt2img bf16", SDXL_STEPS,
            lambda: pipe(SDXL_PROMPTS, num_inference_steps=SDXL_STEPS,
                         guidance_scale=SDXL_CFG,
                         generator=torch.Generator("cuda").manual_seed(
                             SEED + 1), **size),
            per_call=SDXL_ROUTED_PER_UNET_CALL)
        _check_images(images, len(SDXL_PROMPTS), "14c", SDXL_SIZE)
        # 14e: the bf16 pipe behind a PipelineServer over HTTP
        out["http"] = _sdxl_http(pipe, report, images[0])
        # 14f: a kohya-XL and a LyCORIS-XL file
        out["adapters"] = _sdxl_adapters(pipe, report, inputs, gen)
        # 14g: the bf16 pipe quantized, as `serve --quantize` builds it
        out["int8_bf16"] = _sdxl_int8_http(pipe, report)
        del pipe, images, inputs
        torch.cuda.empty_cache()
        # 14d: f32 with int8 weights
        out["f32"] = _sdxl_f32(report, gen)
    unchecked = flash_seen - {_row_key(r) for r in rows}
    if unchecked:
        raise AssertionError(f"phase 14 ran flash_fwd at shapes or layouts "
                             f"14b did not check: {sorted(unchecked)}")
    # every int8 shape 14d and 14g ran, against the plain version
    if not set(SDXL_INT8_TIMED) <= int8_seen:
        raise AssertionError(f"14d and 14g ran no int8 call at "
                             f"{set(SDXL_INT8_TIMED) - int8_seen}")
    int8_rows = [check_int8(M, K, N, getattr(torch, dt), gen,
                            timed=(M, K, N, dt) in SDXL_INT8_TIMED)
                 for M, K, N, dt in sorted(int8_seen)]
    log(f"sdxl: flash_fwd ran {len(flash_seen)} shapes and layouts, "
        f"int8_matmul {len(int8_seen)} shapes, each checked against its "
        f"plain version")
    launches = {"sdxl": {"flash_fwd": dict.fromkeys(
        fa.flash_fwd.launches_by_kernel, 0),
        "int8_matmul": dict.fromkeys(i8.int8_matmul.launches_by_kernel, 0)},
        "sdxl_f32": {"flash_fwd": dict.fromkeys(
            fa.flash_fwd.launches_by_kernel, 0),
            "int8_matmul": dict.fromkeys(
                i8.int8_matmul.launches_by_kernel, 0)}}
    for name, r in report.items():
        path = launches["sdxl_f32" if "f32" in name else "sdxl"]
        for wrapper, counts in path.items():
            for k in counts:
                counts[k] += r[wrapper][k]
    out.update(rows=rows, int8_rows=int8_rows, requests=report,
               launches=launches)
    log("sdxl: " + json.dumps({"requests": report, "launches": launches,
                               "card": smi}))
    return out


def _sdxl_http(pipe, report: dict, image) -> dict:
    """14e: one txt2img, one img2img and one blend-inpaint request over HTTP
    to a PipelineServer (max_batch 1: one prompt under CFG, the UNet at
    batch 2), each answered with one 1024x1024 PNG; every flash launch
    wgmma."""
    from lora_tpu_torch import serve

    image_png = serve._png_b64(image)
    mask = np.zeros((SDXL_SIZE, SDXL_SIZE, 3), np.float32)
    mask[SDXL_SIZE // 4:3 * SDXL_SIZE // 4,
         SDXL_SIZE // 4:3 * SDXL_SIZE // 4] = 1.0  # repaint the centre
    base = {"prompt": SDXL_PROMPTS[0], "steps": SDXL_HTTP_STEPS,
            "guidance": SDXL_CFG, "height": SDXL_SIZE, "width": SDXL_SIZE,
            "seed": 3}
    blend_calls = int(SDXL_HTTP_STEPS * MODE_STRENGTH)
    requests = (("txt2img", {}, SDXL_HTTP_STEPS),
                ("img2img", {"image": image_png,
                             "strength": MODE_STRENGTH}, blend_calls),
                ("inpaint", {"image": image_png,
                             "mask": serve._png_b64(mask),
                             "strength": MODE_STRENGTH,
                             "scheduler": "euler_a"}, blend_calls))
    srv = serve.PipelineServer(pipe, port=0, max_batch=1).start()
    out = {}
    try:
        if srv._nine_channel():
            raise AssertionError("an SDXL pipe took the 9-channel route")
        for mode, extra, calls in requests:
            name = f"14e http {mode}"
            body = counted_request(
                report, "sdxl", name, calls,
                lambda: _http(srv.port, "/generate",
                              {**base, "mode": mode, **extra})[1],
                per_call=SDXL_ROUTED_PER_UNET_CALL)
            _check_pngs(body["images"], 1, SDXL_SIZE)
            report[name]["latency_ms"] = body["latency_ms"]
            out[mode] = body["latency_ms"]
        if srv.drain(timeout=60) is not True:
            raise AssertionError("the server did not drain")
    finally:
        srv.stop()
    return out


def _sdxl_adapter_files(pipe, root: str, gen):
    """K, a kohya-XL file (rank SDXL_RANK over the UNet's, te1's and te2's
    default LoRA sites, random up factors of SDXL_UP_STD), and L, a
    LyCORIS-XL file of LoHa modules (rank SDXL_RANK, alpha 1) on the same
    UNet and te2 sites, written from the seed."""
    from lora_tpu_torch.core.lora import init_lora
    from lora_tpu_torch.core.sites import text_encoder_lora_sites
    from lora_tpu_torch.formats.kohya import _xl_index, save_kohya_xl
    from lora_tpu_torch.formats.reader import save_file

    sites = {"unet": pipe.unet_sites(),
             "text_encoder": text_encoder_lora_sites(pipe.text_encoder.cfg),
             "text_encoder_2": text_encoder_lora_sites(
                 pipe.text_encoder_2.cfg)}
    trees = {}
    for model, s in sites.items():
        tree = init_lora(s, r=SDXL_RANK, generator=gen, device="cuda")
        for e in tree["sites"].values():
            e["up"] = SDXL_UP_STD * torch.randn(e["up"].shape, generator=gen,
                                                device="cuda")
        trees[model] = tree
    k_path = os.path.join(root, "kohya_xl.safetensors")
    save_kohya_xl(k_path, unet_cfg=pipe.unet.cfg,
                  lora_unet=trees["unet"], unet_sites=sites["unet"],
                  lora_text=trees["text_encoder"],
                  text_sites=sites["text_encoder"],
                  lora_text2=trees["text_encoder_2"],
                  text2_sites=sites["text_encoder_2"])
    tensors = {}
    for model in ("unet", "text_encoder_2"):
        for key, s in _xl_index(model, sites[model], pipe.unet.cfg).items():
            for side, n in (("w1", s.out_dim), ("w2", s.out_dim)):
                tensors[f"{key}.hada_{side}_a"] = _file_array(
                    0.1 * torch.randn((n, SDXL_RANK), generator=gen,
                                      device="cuda"))
                tensors[f"{key}.hada_{side}_b"] = _file_array(
                    0.1 * torch.randn((SDXL_RANK, s.in_dim), generator=gen,
                                      device="cuda"))
            tensors[f"{key}.alpha"] = np.asarray(1.0, np.float16)
    l_path = os.path.join(root, "lycoris_xl.safetensors")
    save_file(tensors, l_path)
    return k_path, l_path


def _sdxl_adapters(pipe, report: dict, inputs, gen) -> dict:
    """14f: L, then K, each through patch_pipe, tune_lora_scale(SDXL_ALPHA)
    and one UNet call at batch 2 (70 wgmma flash launches) that moves
    against the bare one; te1's and te2's halves of the context move with
    K, te2's alone with L. Then K folded by collapse_lora(SDXL_ALPHA): the
    UNet call, te1's and te2's halves of the context and the pooled
    embedding against the patched ones within SDXL_COLLAPSE_REL_L2, where
    the same at alpha 1.0 is at least twice as far; the patched UNet call
    through the plain attention path within SDXL_FLASH_REL_L2."""
    from lora_tpu_torch.ops.attention import (
        set_use_memory_efficient_attention,
    )

    out = {}
    bare = _sdxl_unet(pipe, inputs)
    d1 = pipe.text_encoder.cfg.hidden_size

    def encode():  # te1's and te2's parts of the context, the pooled row
        ctx, pooled = pipe.encode_prompt_xl(SDXL_PROMPTS[:1])
        return {"te1": ctx[..., :d1], "te2": ctx[..., d1:], "pooled": pooled}

    enc0 = encode()
    with tempfile.TemporaryDirectory(prefix="sdxl_") as root:
        k_path, l_path = _sdxl_adapter_files(pipe, root, gen)
        for name, path in (("lycoris_xl", l_path), ("kohya_xl", k_path)):
            pipe.remove_lora()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.patch_pipe(path)
            pipe.tune_lora_scale(SDXL_ALPHA)
            torch.cuda.synchronize()
            patch_s = time.perf_counter() - t0
            patched = counted_request(
                report, "sdxl", f"14f unet {name}", 1,
                lambda: _sdxl_unet(pipe, inputs, pipe.lora_unet),
                per_call=SDXL_ROUTED_PER_UNET_CALL)
            enc = encode()
            moved = {"unet": (patched.float() - bare.float()).abs().max()
                     .item(),
                     **{k: (enc[k].float() - enc0[k].float()).abs().max()
                        .item() for k in enc}}
            out[name] = {"patch_s": patch_s, "moved": moved,
                         "trees": [t is not None for t in (
                             pipe.lora_unet, pipe.lora_text,
                             pipe.lora_text2)]}
            log(f"sdxl: 14f {name}: " + json.dumps(out[name]))
            want_te1 = name == "kohya_xl"
            if not (moved["unet"] > 0 and moved["te2"] > 0
                    and (moved["te1"] > 0) == want_te1):
                raise AssertionError(f"14f {name} moved {moved}")
    # K through the plain attention path: the bf16 noise floor
    set_use_memory_efficient_attention(False)
    try:
        plain = _sdxl_unet(pipe, inputs, pipe.lora_unet)
    finally:
        set_use_memory_efficient_attention(True)
    # K at alpha 1.0: what a collapse at the wrong alpha would give
    pipe.tune_lora_scale(1.0)
    wrong = {"unet": _sdxl_unet(pipe, inputs, pipe.lora_unet), **encode()}
    pipe.tune_lora_scale(SDXL_ALPHA)
    want = {"unet": patched, **enc}
    pipe.collapse_lora(SDXL_ALPHA)
    if pipe.lora_unet is not None or pipe.lora_text is not None \
            or pipe.lora_text2 is not None:
        raise AssertionError("collapse_lora left an adapter behind")
    folded = {"unet": _sdxl_unet(pipe, inputs), **encode()}
    out["collapse"] = {
        "alpha": SDXL_ALPHA, "limit": SDXL_COLLAPSE_REL_L2,
        "unet_flash_vs_plain_rel_l2": _rel_l2(plain, patched),
        "rel_l2": {k: _rel_l2(folded[k], v) for k, v in want.items()},
        "alpha_1_rel_l2": {k: _rel_l2(wrong[k], v) for k, v in want.items()}}
    log(f"sdxl: 14f collapse_lora({SDXL_ALPHA}) of the kohya-XL file "
        f"against the patched pipe (bf16): " + json.dumps(out["collapse"]))
    if not out["collapse"]["unet_flash_vs_plain_rel_l2"] <= SDXL_FLASH_REL_L2:
        raise AssertionError(f"14f: the patched UNet call through flash is "
                             f"{out['collapse']} from the plain path")
    for k in want:
        got, far = (out["collapse"][w][k] for w in ("rel_l2",
                                                    "alpha_1_rel_l2"))
        if not (got <= SDXL_COLLAPSE_REL_L2 and far >= 2 * SDXL_COLLAPSE_REL_L2):
            raise AssertionError(
                f"14f collapse: {k} is {got} (relative L2) from the patched "
                f"pipe, limit {SDXL_COLLAPSE_REL_L2}; at alpha 1.0 {far}, "
                f"which must be at least twice the limit")
    return out


def _sdxl_int8_weights(pipe) -> tuple:
    """The 2-D int8 weights per call of each model of a quantized SDXL pipe
    (te2 must have none) and the int8 launches of one te1 encode: te1 is
    read at its penultimate layer, so its last layer never runs."""
    per_call = {"unet": _int8_dense(pipe.unet),
                "te1": _int8_dense(pipe.text_encoder),
                "te2": _int8_dense(pipe.text_encoder_2),
                "vae_decode": _int8_dense(pipe.vae, "decoder.")}
    if per_call["te2"] or not per_call["unet"]:
        raise AssertionError(f"int8 weights per call {per_call}")
    layers = pipe.text_encoder.cfg.num_hidden_layers
    return per_call, per_call["te1"] * (layers - 1) // layers


def _sdxl_int8_http(pipe, report: dict) -> dict:
    """14g: the bf16 pipe (14f's adapter folded in) quantize_base()d, as
    `serve --quantize` builds an SDXL directory (UNet, te1 and the VAE
    int8, te2 bf16), behind a PipelineServer (max_batch 1): one txt2img
    request over HTTP, SDXL_HTTP_STEPS steps, answered with a 1024x1024
    PNG: 70 wgmma flash launches per UNet call and exactly the wgmma int8
    launches of its UNet calls, te1 encodes and VAE decode."""
    from lora_tpu_torch import serve

    before = {m: _param_bytes(pipe._module(m)) for m in pipe._MODELS}
    pipe.quantize_base()
    torch.cuda.empty_cache()
    after = {m: _param_bytes(pipe._module(m)) for m in pipe._MODELS}
    per_call, te1_encode = _sdxl_int8_weights(pipe)
    encodes = [0]  # encode_prompt_xl calls: one te1 encode each
    encode_prompt_xl = pipe.encode_prompt_xl

    def counted_encode(prompts):
        encodes[0] += 1
        return encode_prompt_xl(prompts)

    pipe.encode_prompt_xl = counted_encode
    srv = serve.PipelineServer(pipe, port=0, max_batch=1).start()
    try:
        name = "14g http txt2img int8"
        body = counted_request(
            report, "sdxl", name, SDXL_HTTP_STEPS,
            lambda: _http(srv.port, "/generate", {
                "prompt": SDXL_PROMPTS[0], "steps": SDXL_HTTP_STEPS,
                "guidance": SDXL_CFG, "height": SDXL_SIZE,
                "width": SDXL_SIZE, "seed": 3})[1],
            per_call=SDXL_ROUTED_PER_UNET_CALL,
            int8_want=lambda: (per_call["unet"] * SDXL_HTTP_STEPS
                               + te1_encode * encodes[0]
                               + per_call["vae_decode"]))
        _check_pngs(body["images"], 1, SDXL_SIZE)
        report[name].update(latency_ms=body["latency_ms"],
                            te1_encodes=encodes[0])
        if srv.drain(timeout=60) is not True:
            raise AssertionError("the server did not drain")
    finally:
        srv.stop()
        del pipe.encode_prompt_xl
    out = {"param_bytes": before, "param_bytes_int8": after,
           "int8_weights": per_call, "te1_encode": te1_encode,
           "latency_ms": body["latency_ms"]}
    log("sdxl: 14g: " + json.dumps(out))
    return out


def _sdxl_f32(report: dict, gen) -> dict:
    """14d: a random SDXL in f32 with quantize_base() (UNet, te1, VAE int8;
    te2 float): one UNet call's and one te1 encode's int8 launches (every
    2-D int8 weight once, all wgmma_f32), te2's none; then a txt2img
    request, 1 prompt, 1024x1024, SDXL_F32_STEPS steps, CFG 5.0: 70
    tf32x3 flash launches per UNet call and exactly the int8 launches of
    its UNet calls, two te1 encodes and the VAE decode."""
    from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED), "cuda",
        dtype=torch.float32)
    before = {m: _param_bytes(pipe._module(m)) for m in pipe._MODELS}
    pipe.quantize_base()
    torch.cuda.empty_cache()
    after = {m: _param_bytes(pipe._module(m)) for m in pipe._MODELS}
    per_call, te1_encode = _sdxl_int8_weights(pipe)
    inputs = _sdxl_unet_inputs(pipe, 2, gen)
    _sdxl_unet(pipe, inputs)  # first use
    kw = dict(per_call=SDXL_ROUTED_PER_UNET_CALL, route="tf32x3",
              int8_route="wgmma_f32")
    counted_request({}, "sdxl", "14d unet call f32 int8", 1,
                    lambda: _sdxl_unet(pipe, inputs),
                    int8_want=lambda: per_call["unet"], **kw)
    counted_request({}, "sdxl", "14d te1 + te2 encode f32 int8", 0,
                    lambda: pipe.encode_prompt_xl(SDXL_PROMPTS[:1]),
                    int8_want=lambda: te1_encode, **kw)
    out = {"param_bytes": before, "param_bytes_int8": after,
           "int8_weights": per_call, "int8_per_unet_call": per_call["unet"],
           "int8_per_encode": te1_encode}
    log("sdxl: 14d: " + json.dumps(out))
    images = counted_request(
        report, "sdxl", "14d txt2img f32 int8", SDXL_F32_STEPS,
        lambda: pipe(SDXL_PROMPTS[:1], num_inference_steps=SDXL_F32_STEPS,
                     guidance_scale=SDXL_CFG, height=SDXL_SIZE,
                     width=SDXL_SIZE,
                     generator=torch.Generator("cuda").manual_seed(
                         SEED + 1)),
        int8_want=lambda: (per_call["unet"] * SDXL_F32_STEPS
                           + 2 * te1_encode + per_call["vae_decode"]),
        **kw)
    _check_images(images, 1, "14d", SDXL_SIZE)
    del pipe
    torch.cuda.empty_cache()
    return out


def add_sdxl_launches(kernels: list, sdxl: dict) -> None:
    """Each flash forward and int8 row of the kernels line gains phase 14's
    launches of its kernel ("sdxl": 14c, 14e, 14f, 14g in bf16;
    "sdxl_f32": 14d), each flash forward row the SDXL levels' timed rows of
    14b through its kernel (batch 2) and each wgmma int8 row its timed
    GEGLU projection."""
    routes = {**{n: r for n, r in FLASH_ROW_ROUTES.items()
                 if r[0] == "flash_fwd"},
              "int8_matmul": ("int8_matmul", "wgmma"),
              "int8_matmul_wgmma_f32": ("int8_matmul", "wgmma_f32"),
              "int8_matmul_mma": ("int8_matmul", "mma")}
    timed = {"tf32x3": "float32", "wgmma": "bfloat16"}
    for row in kernels:
        if row["name"] not in routes:
            continue
        wrapper, route = routes[row["name"]]
        for path, launches in sdxl["launches"].items():
            n = launches.get(wrapper, {}).get(route, 0)
            row["launches"] += n
            row["launches_by_path"][path] = n
        if wrapper == "flash_fwd" and route in timed:
            row["sdxl_levels_b2"] = [
                {k: r[k] for k in ("H", "T", "D", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "err_o")}
                for r in sdxl["rows"]
                if "ms" in r and r["dtype"] == timed[route]]
        if wrapper == "int8_matmul" and route in WGMMA_ROUTE.values():
            dtype = "float32" if route == "wgmma_f32" else "bfloat16"
            r = next(r for r in sdxl["int8_rows"]
                     if "ms" in r and r["dtype"] == dtype)
            row["sdxl_geglu_64x64"] = {k: r[k] for k in (
                "M", "K", "N", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "rel")}


# phase 15: SDXL training at full width, 1024x1024
SDXL_TRAIN_RANK = 8  # bench.py's xl_train_cached_bs1_1024 (and 15d's)
# 15a / 15b, each mode: warm-up and timed steps; one step of 15a's first
# mode profiled
SDXL_TRAIN_WARMUP, SDXL_TRAIN_STEPS = 1, 3
SDXL_TIME_IDS = (1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0)
SDXL_DB_STEPS = 4  # 15d: lora_db steps
# 15d's instance PNGs (h, w): one at the training size, two that the native
# resize scales down and crops (portrait and landscape)
SDXL_DB_IMAGES = ((1024, 1024), (1280, 1024), (1024, 1536))
FLASH_WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@contextlib.contextmanager
def counting_bwd_levels(counter: collections.Counter):
    """Counts every dQ and dK/dV kernel launch made inside by (wrapper
    name, T) in `counter`, through the launch helpers the wrappers call
    once per launch (`_dq_launch`, `_dkv_launch`); the wrappers and their
    counts are unchanged."""
    real = {"flash_bwd_dq": fa._dq_launch, "flash_bwd_dkv": fa._dkv_launch}

    def counted(name):
        def call(route, q, *a, **kw):
            counter[(name, q.shape[2])] += 1
            return real[name](route, q, *a, **kw)
        return call

    fa._dq_launch = counted("flash_bwd_dq")
    fa._dkv_launch = counted("flash_bwd_dkv")
    try:
        yield counter
    finally:
        fa._dq_launch = real["flash_bwd_dq"]
        fa._dkv_launch = real["flash_bwd_dkv"]


def _sdxl_step_want(dt, remat: bool) -> dict:
    """The flash launches of one SDXL training step by wrapper: by kernel
    (all wgmma in bf16, tf32x3 in f32: D = 64) and by level (T), the
    forward twice under gradient checkpointing."""
    route = "wgmma" if dt == torch.bfloat16 else "tf32x3"
    k = 2 if remat else 1
    return {
        "flash_fwd": _only(route, k * SDXL_ROUTED_PER_UNET_CALL),
        "flash_bwd_dq": _only(route, SDXL_ROUTED_PER_UNET_CALL,
                              fa.flash_bwd_dq),
        "flash_bwd_dkv": _only(route, SDXL_ROUTED_PER_UNET_CALL,
                               fa.flash_bwd_dkv),
        "fwd_by_T": {T: k * n for T, n in SDXL_LAUNCHES_BY_LEVEL.items()},
        "bwd_by_T": {(w, T): n for w in ("flash_bwd_dq", "flash_bwd_dkv")
                     for T, n in SDXL_LAUNCHES_BY_LEVEL.items()},
        "int8": 0}


def _by_T(calls: collections.Counter) -> dict:
    out = collections.Counter()
    for key, n in calls.items():
        out[key[2]] += n
    return dict(out)


def _sdxl_train_batch(pipe, gen):
    """15a's cached batch: (1, 128, 128, 4) latents from the generator, one
    prompt through both text encoders as the trainer's text cache encodes
    it (te2's ids derived from te1's), the training-size time_ids."""
    from lora_tpu_torch.models.clip import dual_encode
    from lora_tpu_torch.training.loss import ids2_from_ids

    eos = int(pipe.tokenizer.eos_token_id)
    ids = torch.tensor(pipe.tokenizer(["a photo of sks dog"])["input_ids"],
                       device="cuda")
    with torch.inference_mode():
        ctx, pooled = dual_encode(
            pipe.text_encoder.flat_params(),
            pipe.text_encoder_2.flat_params(), ids, ids2_from_ids(ids, eos),
            pipe.text_encoder.cfg, pipe.text_encoder_2.cfg, dtype=pipe.dtype,
            eos_id=eos)
    return {"latents": torch.randn((1, SDXL_SIZE // 8, SDXL_SIZE // 8, 4),
                                   generator=gen, device="cuda"
                                   ).to(pipe.dtype),
            "encoder_hidden_states": ctx.clone(),
            "add_text_embeds": pooled.clone(),
            "add_time_ids": torch.tensor([SDXL_TIME_IDS], device="cuda")}


def _sdxl_make_step(optimizer, remat: bool, dtype):
    from lora_tpu_torch.models.config import (
        SDXL_TEXT,
        SDXL_TEXT2,
        SDXL_UNET,
        SDXL_VAE,
    )
    from lora_tpu_torch.models.schedulers import make_schedule
    from lora_tpu_torch.training.loss import LossConfig
    from lora_tpu_torch.training.train_step import make_train_step

    return make_train_step(
        unet_cfg=SDXL_UNET, text_cfg=SDXL_TEXT, vae_cfg=SDXL_VAE,
        sched=make_schedule(),
        loss_cfg=LossConfig(cached_latents=True,
                            gradient_checkpointing=remat),
        optimizer=optimizer, dtype=dtype, text2_cfg=SDXL_TEXT2)


def _sdxl_lora(gen):
    """The rank-8 LoRA on the SDXL UNet's default sites, its up factors
    0.05 std (nonzero: every leaf takes a gradient), f32 leaves that
    require grad."""
    from lora_tpu_torch.core.lora import init_lora
    from lora_tpu_torch.core.sites import unet_lora_sites
    from lora_tpu_torch.models.config import SDXL_UNET
    from lora_tpu_torch.training.train_step import make_trainable

    lora = init_lora(unet_lora_sites(SDXL_UNET), r=SDXL_TRAIN_RANK,
                     generator=gen, device="cuda")
    for entry in lora["sites"].values():
        entry["up"] = 0.05 * torch.randn(entry["up"].shape, generator=gen,
                                         device="cuda")
    return make_trainable({"lora_unet": lora})


def sdxl_grad_check(unet, trainable, batch, dt, gen) -> dict:
    """The LoRA gradient of one SDXL step through the kernels against the
    plain attention path (lr 0: the leaves stay), limits as phase 7's;
    in bf16 also with gradient checkpointing against without."""
    from lora_tpu_torch.ops.attention import set_use_memory_efficient_attention
    from lora_tpu_torch.training.optim import make_optimizer, tree_leaves

    leaves = tree_leaves(trainable)
    base = (unet.flat_params(), {}, {}, {})
    draws = {"noise": torch.randn(tuple(batch["latents"].shape),
                                  generator=gen, device="cuda").to(dt),
             "timesteps": torch.tensor([500], device="cuda")}

    def loss_and_grad(remat):
        opt = make_optimizer(trainable, {"lora_unet": 0.0},
                             weight_decay=0.0, max_grad_norm=None)
        captured = []
        opt.step = lambda: captured.append(torch.cat(
            [x.grad.flatten() for x in leaves]))
        before = _counts()
        loss = _sdxl_make_step(opt, remat, dt)(trainable, base, batch,
                                                **draws)
        torch.cuda.synchronize()
        for x in leaves:
            x.grad = None
        return (loss.float().item(), captured[0],
                tuple(a - b for a, b in zip(_counts(), before)))

    def both(remat):  # through the kernels, then the plain path
        kernels = loss_and_grad(remat)
        set_use_memory_efficient_attention(False)
        try:
            return kernels, loss_and_grad(remat)
        finally:
            set_use_memory_efficient_attention(True)

    bf16 = dt == torch.bfloat16
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = both(False)
    rel = ((g_k - g_p).norm() / g_p.norm()).item()
    tol = GRAD_REL_L2_TOL if bf16 else GRAD_F32_REL_L2_TOL
    row = {"dtype": str(dt).replace("torch.", ""), "remat": False,
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "grad_rel_l2_kernels_vs_plain": rel, "grad_norm": g_k.norm().item(),
           "launches_kernels": n_k, "launches_plain": n_p,
           "limits": {"grad_rel_l2": tol, "remat_loss_rtol": REMAT_LOSS_RTOL}}
    n = SDXL_ROUTED_PER_UNET_CALL
    ok = (n_k == (n, n, n) and n_p == (0, 0, 0)
          and np.isfinite(rel) and rel <= tol)
    if bf16:
        loss_r, g_r, n_r = loss_and_grad(True)
        rel_r = ((g_r - g_k).norm() / g_k.norm()).item()
        row.update(loss_remat=loss_r, grad_rel_l2_remat_vs_kernels=rel_r,
                   launches_remat=n_r)
        ok = ok and n_r == (2 * n, n, n) and abs(loss_r - loss_k) <= \
            REMAT_LOSS_RTOL * abs(loss_k) and np.isfinite(rel_r) and \
            rel_r <= GRAD_REL_L2_TOL
    log("sdxl train: grad: " + json.dumps(row))
    if not ok:
        raise AssertionError(f"the SDXL LoRA gradient through the kernels "
                             f"is off the plain path's, or the launches are "
                             f"not {n} forward, dQ and dK/dV: "
                             f"{row}")
    return row


def sdxl_train_steps(unet, trainable, batch, dt, remat: bool, gen,
                     profiled: bool = False) -> dict:
    """SDXL_TRAIN_WARMUP + SDXL_TRAIN_STEPS steps of the bench.py SDXL step
    (AdamW 1e-4, clip 1.0) in `dt`: the median step by CUDA events, the
    peak memory over the timed steps, and each timed step's flash launches
    by kernel and level (counted from 0 just before it), which must be
    _sdxl_step_want's, with no int8 launch; `profiled`: then one more step
    under torch.profiler."""
    from lora_tpu_torch.training.optim import make_optimizer

    step = _sdxl_make_step(make_optimizer(trainable, {"lora_unet": 1e-4}),
                           remat, dt)
    base = (unet.flat_params(), {}, {}, {})
    want = _sdxl_step_want(dt, remat)
    losses, events = [], []
    what = f"{str(dt).replace('torch.', '')} remat={remat}"
    for _ in range(SDXL_TRAIN_WARMUP):
        losses.append(step(trainable, base, batch, gen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SDXL_TRAIN_STEPS):
        _zero_counts()
        fwd_calls, bwd_calls = collections.Counter(), collections.Counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with recording_flash_shapes(fwd_calls), \
                counting_bwd_levels(bwd_calls):
            start.record()
            losses.append(step(trainable, base, batch, gen))
            end.record()
        events.append((start, end))
        got = {"flash_fwd": dict(fa.flash_fwd.launches_by_kernel),
               "flash_bwd_dq": dict(fa.flash_bwd_dq.launches_by_kernel),
               "flash_bwd_dkv": dict(fa.flash_bwd_dkv.launches_by_kernel),
               "fwd_by_T": _by_T(fwd_calls), "bwd_by_T": dict(bwd_calls),
               "int8": i8.int8_matmul.launches}
        if got != want:
            raise AssertionError(f"an SDXL training step ({what}) "
                                 f"launched {got}, not {want}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite SDXL loss ({what}): "
                             f"{losses.tolist()}")
    out = {"remat": remat, "warmup": SDXL_TRAIN_WARMUP,
           "timed_steps": SDXL_TRAIN_STEPS, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": [round(x, 6) for x in losses.tolist()],
           "launches_per_step": {k: v for k, v in want.items()
                                 if k.startswith("flash")},
           "fwd_by_T_per_step": want["fwd_by_T"]}
    if profiled:
        out["profile"] = {k: v for k, v in profile_step(
            lambda: step(trainable, base, batch, gen)).items() if k != "top"}
    log(f"sdxl train: {what}: " + json.dumps(out))
    return out


def sdxl_kernel_rows(gen) -> tuple:
    """15c: the dQ and dK/dV kernels at the SDXL levels at batch 1 (the
    training step's) against their plain versions, timed (with the mma
    kernels on the same inputs, SDPA's backward and the bounds), bf16 and
    f32; and the forward kernels at batch 1, timed, against theirs."""
    fwd, bwd = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for H, T, D in SDXL_ATTN_LEVELS:
            fwd.append(check_kernel(1, H, T, T, D, dtype, gen))
            bwd.append(check_bwd_kernels(1, H, T, T, D, dtype, gen))
    sums = {}
    for dtype in ("bfloat16", "float32"):
        keys = BWD_SUM_KEYS if dtype == "bfloat16" else BWD_F32_SUM_KEYS
        rows = {r["T"]: r for r in bwd if r["dtype"] == dtype}
        sums[dtype] = {k: sum(n * rows[T][k]
                              for T, n in SDXL_LAUNCHES_BY_LEVEL.items())
                       for k in keys}
    log("sdxl train: 15c backward per training step: " + json.dumps(sums))
    return fwd, bwd, sums


def phase_sdxl_train(smi: str, model_dir=None) -> dict:
    """Phase 15: SDXL training at full width and 1024x1024. 15c the
    backward (and forward) kernels at the SDXL levels at batch 1; 15a the
    bench.py SDXL step in bf16 (a random SDXL pipeline from the seed:
    rank-8 LoRA on the UNet's default sites, cached latents and
    conditioning) with and without gradient checkpointing, its LoRA
    gradient against the plain attention path; 15d lora_db on an SDXL
    directory (bf16, both text encoders, gradient checkpointing, the
    native resize) and its kohya-XL file through patch_pipe; 15b the step
    in f32 (tf32x3). Every flash call of 15a, 15b and 15d is recorded and
    checked against its plain version. Returns the launches by path and
    the rows. 15d's SDXL directory is written to `model_dir` where given
    (phase 16b reads it), else beside its other inputs."""
    from lora_tpu_torch.models.config import SDXL_TEXT2, SDXL_UNET
    from lora_tpu_torch.models.unet import UNet
    from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline
    from lora_tpu_torch.training.optim import tree_leaves

    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 15)
    fwd_rows, bwd_rows, sums = sdxl_kernel_rows(gen)
    out = {"fwd_rows": fwd_rows, "bwd_rows": bwd_rows,
           "bwd_per_training_step": sums}
    seen = set()
    t0 = time.perf_counter()
    pipe = StableDiffusionXLPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED), "cuda",
        dtype=torch.bfloat16)
    batch = _sdxl_train_batch(pipe, gen)
    trainable = _sdxl_lora(gen)
    n_params = sum(x.numel() for x in tree_leaves(trainable))
    log(f"sdxl train: 15a: bf16 pipeline and rank-{SDXL_TRAIN_RANK} LoRA "
        f"({n_params} params) in {time.perf_counter() - t0:.1f} s")
    with recording_flash_shapes(seen):
        out["grad_bf16"] = sdxl_grad_check(pipe.unet, trainable, batch,
                                           torch.bfloat16, gen)
        out["bf16"] = [sdxl_train_steps(pipe.unet, trainable, batch,
                                        torch.bfloat16, remat, gen,
                                        profiled=not remat)
                       for remat in (False, True)]
        out["db"] = _sdxl_lora_db(pipe, gen, model_dir)
    del pipe, batch, trainable
    torch.cuda.empty_cache()
    # 15b: f32, the UNet alone (the conditioning from 15a's encoders is
    # not needed: f32 draws of the same shapes)
    unet = UNet(SDXL_UNET, device="cuda", dtype=torch.float32,
                generator=torch.Generator("cuda").manual_seed(SEED))
    batch = {"latents": torch.randn((1, SDXL_SIZE // 8, SDXL_SIZE // 8, 4),
                                    generator=gen, device="cuda"),
             "encoder_hidden_states": torch.randn(
                 (1, 77, SDXL_UNET.cross_attention_dim), generator=gen,
                 device="cuda"),
             "add_text_embeds": torch.randn((1, SDXL_TEXT2.projection_dim),
                                            generator=gen, device="cuda"),
             "add_time_ids": torch.tensor([SDXL_TIME_IDS], device="cuda")}
    trainable = _sdxl_lora(gen)
    with recording_flash_shapes(seen):
        out["grad_f32"] = sdxl_grad_check(unet, trainable, batch,
                                          torch.float32, gen)
        out["f32"] = [sdxl_train_steps(unet, trainable, batch,
                                       torch.float32, remat, gen)
                      for remat in (False, True)]
    del unet, batch, trainable
    torch.cuda.empty_cache()
    unchecked = seen - {_row_key(r) for r in fwd_rows}
    if unchecked:
        raise AssertionError(f"phase 15 ran flash_fwd at shapes or layouts "
                             f"15c did not check: {sorted(unchecked)}")
    # the launches of the counted main-path runs: 15a's and 15d's (bf16),
    # 15b's (f32) timed steps
    paths = {p: {w: dict.fromkeys(getattr(fa, w).launches_by_kernel, 0)
                 for w in FLASH_WRAPPERS}
             for p in ("sdxl_train", "sdxl_train_f32")}
    for path, runs in (("sdxl_train", out["bf16"]),
                       ("sdxl_train_f32", out["f32"])):
        for r in runs:
            for w, counts in r["launches_per_step"].items():
                for k, n in counts.items():
                    paths[path][w][k] += n * r["timed_steps"]
    for w, counts in out["db"]["launches"].items():
        if w in FLASH_WRAPPERS:
            for k, n in counts.items():
                paths["sdxl_train"][w][k] += n
    out["launches"] = paths
    log("sdxl train: " + json.dumps({
        "phase_s": time.perf_counter() - t_phase,
        "launches": paths, "card": smi,
        "step_ms_median": {f"{r_dt}_remat={r['remat']}": r["step_ms_median"]
                           for r_dt in ("bf16", "f32") for r in out[r_dt]},
        "peak_mem_gib": {f"{r_dt}_remat={r['remat']}": r["peak_mem_gib"]
                         for r_dt in ("bf16", "f32") for r in out[r_dt]}}))
    return out


def _sdxl_db_inputs(pipe, root: str, model=None):
    """15d's inputs: the bf16 pipeline written as an fp16 diffusers
    directory (no CLIP vocabulary: the hashed tokenizer, opted in), to
    `model` where given, else under `root`, and SDXL_DB_IMAGES as PNGs from
    the seed."""
    from lora_tpu_torch.models.hf_import import save_pipeline_params

    t0 = time.perf_counter()
    model = model or os.path.join(root, "model")
    save_pipeline_params(pipe, model, fp16=True)
    inst = _instance_pngs(os.path.join(root, "instance"), SDXL_DB_IMAGES,
                          SEED + 15)
    os.environ["LORA_TPU_ALLOW_HASHED_TOKENIZER"] = "1"
    log(f"sdxl train: 15d: inputs {model} (fp16) and {len(SDXL_DB_IMAGES)} "
        f"PNGs {SDXL_DB_IMAGES} in {time.perf_counter() - t0:.1f} s")
    return model, inst


def _sdxl_lora_db(pipe, gen, model_dir=None) -> dict:
    """15d: lora_db's command line (cli._fire on cli.lora_db.train: what
    `python -m lora_tpu_torch.cli.lora_db` runs, in this process so the
    counts can be read) on an SDXL directory, the recipe's flags
    (recipes/run_lora_db_xl.sh: bf16, both text encoders, gradient
    checkpointing, rank 8), SDXL_DB_STEPS steps at 1024px with
    LORA_TPU_TORCH_NATIVE_IMGOPS=1: each step's launches, every image
    through the native resize (built from native/imgops.c at first use),
    the kohya-XL file through patch_pipe and one 1024px UNet call with
    it."""
    from lora_tpu_torch.cli import _fire, lora_db
    from lora_tpu_torch.data.dataset import NATIVE_IMGOPS_ENV
    from lora_tpu_torch.formats.kohya import is_kohya_xl
    from lora_tpu_torch.formats.reader import SafetensorsFile
    from lora_tpu_torch.native import build as native

    with tempfile.TemporaryDirectory(prefix="lora_db_xl_") as root:
        model, inst = _sdxl_db_inputs(pipe, root, model_dir)
        run = os.path.join(root, "run")
        argv = ["--pretrained_model_name_or_path", model,
                "--instance_data_dir", inst,
                "--instance_prompt", "a photo of sks dog",
                "--output_dir", run, "--resolution", str(SDXL_SIZE),
                "--train_batch_size", "1", "--mixed_precision", "bf16",
                "--train_text_encoder", "--gradient_checkpointing",
                "--lora_rank", str(SDXL_TRAIN_RANK),
                "--learning_rate", "1e-4", "--learning_rate_text", "5e-5",
                "--max_train_steps", str(SDXL_DB_STEPS), "--save_steps", "0",
                "--output_format", "safe", "--seed", str(SEED)]
        resized = []
        real_resize = native.resize_crop_normalize

        def counted_resize(pixels, size):
            resized.append(tuple(pixels.shape))
            return real_resize(pixels, size)

        os.environ[NATIVE_IMGOPS_ENV] = "1"
        native.resize_crop_normalize = counted_resize
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_trainer_counts()
        t0 = time.perf_counter()
        try:
            with timing_trainer_steps({}) as rec:
                res = _fire.fire(lora_db.train, argv)
            torch.cuda.synchronize()
        finally:
            native.resize_crop_normalize = real_resize
            del os.environ[NATIVE_IMGOPS_ENV]
        wall = time.perf_counter() - t0
        got = _launches()
        _check_trainer_result(res, SDXL_DB_STEPS, "15d")
        want = _sdxl_step_want(torch.bfloat16, True)
        want = {w: _scaled(want[w], SDXL_DB_STEPS) for w in FLASH_WRAPPERS}
        if {w: got[w] for w in FLASH_WRAPPERS} != want or \
                got["adam8bit"] or i8.int8_matmul.launches:
            raise AssertionError(f"15d launched {got} (int8 "
                                 f"{i8.int8_matmul.launches}), not {want}")
        lib = native.build()  # the library the run loaded, built above
        if len(resized) < SDXL_DB_STEPS or native._lib is None:
            raise AssertionError(f"15d: {len(resized)} images through the "
                                 f"native resize, library {lib} not loaded")
        files = sorted(os.listdir(run))
        path = os.path.join(run, "lora_weight.safetensors")
        if files != ["lora_weight.safetensors", "metrics.jsonl"]:
            raise AssertionError(f"15d wrote {files}")
        with SafetensorsFile(path) as f:
            keys = list(f.keys())
        prefixes = {p: sum(k.startswith(p) for k in keys)
                    for p in ("lora_unet_", "lora_te1_", "lora_te2_")}
        if not is_kohya_xl(keys) or not all(prefixes.values()):
            raise AssertionError(f"15d's file is not kohya-XL with every "
                                 f"model: {prefixes}")
        step_ms = _step_ms(rec, 1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the file on the 15a pipeline (the directory's weights): one UNet
        # call at 1024px, batch 1, with and without it
        inputs = _sdxl_unet_inputs(pipe, 1, gen)
        bare = _sdxl_unet(pipe, inputs)
        t1 = time.perf_counter()
        pipe.patch_pipe(path)
        patch_s = time.perf_counter() - t1
        with_file = _sdxl_unet(pipe, inputs, pipe.lora_unet)
        pipe.remove_lora()
        moved = (with_file.float() - bare.float()).abs().max().item()
        if not torch.isfinite(with_file).all() or moved == 0.0:
            raise AssertionError(f"15d: the UNet call with the kohya-XL file "
                                 f"is not finite or equals the bare call "
                                 f"(max |diff| {moved})")
        records = _metrics(os.path.join(run, "metrics.jsonl"))
    out = {"steps": res["steps"], "wall_s": wall,
           "steps_per_sec": res["steps_per_sec"],
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "peak_mem_gib": peak, "final_loss": res["final_loss"],
           "losses": {r["step"]: r["loss"] for r in records if "step" in r},
           "launches": got, "native_resizes": len(resized),
           "native_input_shapes": sorted(set(resized)),
           "native_library": os.path.basename(lib),
           "file_modules": prefixes,
           "patch_pipe_s": patch_s, "unet_max_abs_change": moved}
    log("sdxl train: 15d: " + json.dumps(out))
    return out


def add_sdxl_train_launches(kernels: list, st: dict) -> None:
    """Each flash row of the kernels line gains phase 15's launches of its
    kernel ("sdxl_train": 15a's timed bf16 steps and 15d; "sdxl_train_f32":
    15b's), and each row of a kernel that ran at the SDXL levels its timed
    15c rows there (batch 1)."""
    for row in kernels:
        if row["name"] not in FLASH_ROW_ROUTES:
            continue
        wrapper, route = FLASH_ROW_ROUTES[row["name"]]
        for path, launches in st["launches"].items():
            n = launches[wrapper][route]
            row["launches"] += n
            row["launches_by_path"][path] = n
        if wrapper == "flash_fwd":
            rows, keys = st["fwd_rows"], ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "err_o")
            ran = [r for r in rows if r["kernel"] == [route]]
        else:
            p = "dq_" if wrapper == "flash_bwd_dq" else "dkv_"
            rkey = "dq_route" if wrapper == "flash_bwd_dq" else "route"
            keys = tuple(p + k for k in ("ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "prev_ms", "prev_device_ms")) + (
                "library_ms", "library_device_ms", "exp_floor_ms")
            ran = [r for r in st["bwd_rows"] if r[rkey] == route]
            if route == "mma":  # called directly on the routed inputs
                ran, keys = st["bwd_rows"], tuple(
                    p + k for k in ("prev_ms", "prev_device_ms", "plain_ms"))
        if ran:
            row["sdxl_levels_b1"] = [
                {"H": r["H"], "T": r["T"], "D": r["D"], "dtype": r["dtype"],
                 **{k: r[k] for k in keys if k in r}} for r in ran]


# phase 16: the adapter tooling at full width (lora_distill, lora_add,
# LoRAManager, evaluate_pipe)
TOOLS_RANK = 4          # 16a's delta, 16b's and 16c's files
TOOLS_UP_STD = 0.05     # their up factors (down: init_lora's N(0, 1/r))
TOOLS_ALPHA = 0.7       # 16c's upl and upl-ckpt-v2 merging ratio
TOOLS_EVAL = {"n_test": 2, "n_step": 10}  # 16e's evaluate_pipe
# 16a, per site: up @ down of the distilled factors (f32, before the file's
# fp16) against the known rank-4 delta by relative L2. At clamp 1.0 a
# rank-4 residual is recovered to the f32 rounding of W + delta - W
# (~1e-7 of the delta here); the file's fp16 factors round each by up to
# 2^-11, ~4e-4 relative on their product. A wrong site, rank or clamp
# misses by O(1)
DISTILL_REL_L2 = 1e-3
# 16a: the card's products against core/svd.py's on the CPU at the same
# sites: both factor the f32 residual's Gram matrix in f64, summing in
# another order
DISTILL_DEVICE_REL_L2 = 1e-4
# 16a factors every 8th site on the CPU too (24 of 192): the card against
# the CPU on the same residuals
DISTILL_CPU_EVERY = 8
# 16c and 16d, bf16 UNet call at batch 4: (W + a up down) x rounded to bf16
# once more against W x + a (up down x) (the collapsed directory read back
# in bf16 against the patched pipe), and the manager's joined LoRA gated
# to file 1 against file 1 alone. As SDXL_COLLAPSE_REL_L2: the fold moves
# each weight by up to half a bf16 step, which the 16 transformers and 22
# resnets carry to the output; a fold without the adapter misses by the
# adapter's share, which must be at least twice the limit
TOOLS_COLLAPSE_REL_L2 = 3e-2
# 16e: CLIP ViT-L/14's pooled state on the card (f32, TF32 off) against the
# same forward on the CPU: f32 sums in other orders through 24 layers; a
# wrong head, patch or token moves it by O(1)
VISION_DEVICE_REL_L2 = 1e-4
TOOLS_PROMPTS = ("a photo of <1> next to <2>", "<2> in the style of <1>")


def _tools_lora_file(path: str, gen, tokens) -> None:
    """A rank-TOOLS_RANK LoRA over SD-1.5's default UNet and text sites (up
    factors N(0, TOOLS_UP_STD), downs init_lora's) and one TI row per
    token, in fp16 as the trainers save it."""
    from lora_tpu_torch.core.lora import init_lora, lora_to_pairs
    from lora_tpu_torch.core.sites import (
        text_encoder_lora_sites,
        unet_lora_sites,
    )
    from lora_tpu_torch.formats.safetensors_io import (
        TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
        UNET_DEFAULT_TARGET_REPLACE,
        save_safeloras_with_embeds,
    )
    from lora_tpu_torch.models.config import SD15_TEXT, SD15_UNET

    modelmap = {}
    for model, sites, target in (
            ("unet", unet_lora_sites(SD15_UNET), UNET_DEFAULT_TARGET_REPLACE),
            ("text_encoder", text_encoder_lora_sites(SD15_TEXT),
             TEXT_ENCODER_DEFAULT_TARGET_REPLACE)):
        lora = init_lora(sites, r=TOOLS_RANK, generator=gen, device="cuda")
        for e in lora["sites"].values():
            e["up"] = TOOLS_UP_STD * torch.randn(e["up"].shape,
                                                 generator=gen, device="cuda")
        modelmap[model] = (lora_to_pairs(lora, sites), target)
    embeds = {t: torch.randn((SD15_TEXT.hidden_size,), generator=gen,
                             device="cuda").cpu().numpy() for t in tokens}
    save_safeloras_with_embeds(modelmap, embeds, path, cast_fp16=True)


def _products(tree, sites) -> dict:
    """{site: up @ down} of a LoRA tree, f32 on the card (TF32 off)."""
    out = {}
    for s in sites:
        e = tree["sites"][s.name]
        up, down = (e[k].to("cuda", torch.float32) for k in ("up", "down"))
        out[s.name] = up.reshape(up.shape[0], -1) @ down.reshape(
            down.shape[0], -1)
    return out


def _worst_rel(got: dict, want: dict) -> tuple:
    """(largest relative L2 over the sites, its site)."""
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


@contextlib.contextmanager
def _distill_recorded(rec: dict):
    """Records, for each lora_distill call inside, the LoRA trees and sites
    its saver is given (under rec["trees"]) and the seconds of its
    svd_distill calls on the card, synchronized (rec["svd_s"])."""
    from lora_tpu_torch.cli import lora_distill
    from lora_tpu_torch.formats import kohya

    real = {"svd_distill": lora_distill.svd_distill,
            "save_all": lora_distill.save_all,
            "save_kohya_xl": kohya.save_kohya_xl}

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["svd_distill"](*a, **kw)
        torch.cuda.synchronize()
        rec["svd_s"] = rec.get("svd_s", 0.0) + time.perf_counter() - t0
        return out

    def saver(name):
        def save(path, *a, **kw):
            rec["trees"] = {k: v for k, v in kw.items()
                            if k.startswith(("lora_", "unet_sites",
                                             "text_sites", "text2_sites"))}
            return real[name](path, *a, **kw)
        return save

    lora_distill.svd_distill = timed
    lora_distill.save_all = saver("save_all")
    kohya.save_kohya_xl = saver("save_kohya_xl")
    try:
        yield rec
    finally:
        lora_distill.svd_distill = real["svd_distill"]
        lora_distill.save_all = real["save_all"]
        kohya.save_kohya_xl = real["save_kohya_xl"]


def _tools_distill_sd(root: str, gen) -> dict:
    """16a: a random SD-1.5 base and a tuned copy that adds a known rank-4
    delta at every default UNet and text site, both written in f32;
    lora_distill on them at clamp 1.0 on the card, and core/svd.py's
    svd_distill on the CPU at every DISTILL_CPU_EVERY-th site."""
    from lora_tpu_torch.cli import _fire, lora_distill
    from lora_tpu_torch.core.lora import init_lora
    from lora_tpu_torch.core.svd import svd_distill
    from lora_tpu_torch.formats.safetensors_io import load_safeloras
    from lora_tpu_torch.models.hf_import import save_pipeline_params
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.random_init(
        torch.Generator("cuda").manual_seed(SEED), "cuda")
    base, tuned = (os.path.join(root, n) for n in ("base", "tuned"))
    save_pipeline_params(pipe, base)
    sites = pipe.unet_sites() + pipe.text_sites()
    cpu_sites = sites[::DISTILL_CPU_EVERY]
    deltas, cpu_base, cpu_tuned = {}, {}, {}
    for module, model_sites in ((pipe.unet, pipe.unet_sites()),
                                (pipe.text_encoder, pipe.text_sites())):
        lora = init_lora(model_sites, r=TOOLS_RANK, generator=gen,
                         device="cuda")
        params = module.flat_params()
        for s in model_sites:
            e = lora["sites"][s.name]
            e["up"] = TOOLS_UP_STD * torch.randn(e["up"].shape,
                                                 generator=gen, device="cuda")
            deltas[s.name] = e["up"] @ e["down"]
            key = s.name + ".weight"
            w = params[key] + deltas[s.name]
            module.set_param(key, w)
            if s in cpu_sites:
                cpu_base[key], cpu_tuned[key] = params[key].cpu(), w.cpu()
    save_pipeline_params(pipe, tuned)
    del pipe
    torch.cuda.empty_cache()
    out = {"dirs_s": time.perf_counter() - t0, "sites": len(sites),
           "dir_gib": sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(base) for f in fs) / 2**30}
    products = {}
    device = "cuda"
    path = os.path.join(root, f"distilled_{device}.safetensors")
    argv = [tuned, base, "--rank", str(TOOLS_RANK), "--clamp_quantile",
            "1.0", "--save_path", path, "--device", device]
    with _distill_recorded({}) as rec:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _fire.fire(lora_distill.svd_distill_cli, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    trees = rec["trees"]
    products[device] = {
        **_products(trees["lora_unet"], trees["unet_sites"]),
        **_products(trees["lora_text"], trees["text_sites"])}
    out[device] = {"wall_s": wall, "svd_s": rec["svd_s"],
                   "svd_s_per_site": rec["svd_s"] / len(sites)}
    loras = load_safeloras(path)
    file_products = {}
    for model, ss in (("unet", trees["unet_sites"]),
                      ("text_encoder", trees["text_sites"])):
        flat, ranks, _ = loras[model]
        if len(flat) != 2 * len(ss) or set(ranks) != {TOOLS_RANK}:
            raise AssertionError(f"16a: the {device} file holds "
                                 f"{len(flat) // 2} {model} pairs of "
                                 f"ranks {set(ranks)}")
        for s, up, down in zip(ss, flat[::2], flat[1::2]):
            up, down = (torch.from_numpy(np.array(a)).to(
                "cuda", torch.float32) for a in (up, down))
            file_products[s.name] = (up.reshape(up.shape[0], -1)
                                     @ down.reshape(down.shape[0], -1))
    out[device]["rel_l2_vs_delta"], worst = _worst_rel(products[device],
                                                       deltas)
    out[device]["file_rel_l2_vs_delta"], _ = _worst_rel(file_products,
                                                        deltas)
    if not (out[device]["rel_l2_vs_delta"] <= DISTILL_REL_L2
            and out[device]["file_rel_l2_vs_delta"] <= DISTILL_REL_L2):
        raise AssertionError(f"16a: the {device} distillation misses the "
                             f"delta (worst at {worst}): {out[device]}")
    # the CPU: core/svd.py on every DISTILL_CPU_EVERY-th site's weights
    t1 = time.perf_counter()
    tree = svd_distill(cpu_base, cpu_tuned, cpu_sites, TOOLS_RANK, 1.0)
    cpu_s = time.perf_counter() - t1
    products["cpu"] = _products(tree, cpu_sites)
    out["cpu"] = {"sites": len(cpu_sites), "svd_s": cpu_s,
                  "svd_s_per_site": cpu_s / len(cpu_sites)}
    out["cpu"]["rel_l2_vs_delta"], worst = _worst_rel(
        products["cpu"], {k: deltas[k] for k in products["cpu"]})
    if not out["cpu"]["rel_l2_vs_delta"] <= DISTILL_REL_L2:
        raise AssertionError(f"16a: the CPU distillation misses the delta "
                             f"(worst at {worst}): {out['cpu']}")
    out["card_vs_cpu_rel_l2"], worst = _worst_rel(products["cuda"],
                                                  products["cpu"])
    log("tools: 16a: " + json.dumps(out))
    if not out["card_vs_cpu_rel_l2"] <= DISTILL_DEVICE_REL_L2:
        raise AssertionError(f"16a: the card's products differ from the "
                             f"CPU's by {out['card_vs_cpu_rel_l2']} at "
                             f"{worst}")
    shutil.rmtree(tuned)
    return out


def _tools_distill_xl(root: str, xl_dir, gen) -> dict:
    """16b: a random kohya-XL file of rank 4 over the UNet's, te1's and
    te2's default sites, through lora_distill --from_lora against an SDXL
    directory (`xl_dir`, else one written here from the seed as phase 15
    writes its own) on the card: a kohya-XL file whose up @ down, loaded
    back, equals the input's at every site."""
    from lora_tpu_torch.cli import _fire, lora_distill
    from lora_tpu_torch.core.lora import init_lora
    from lora_tpu_torch.core.sites import (
        text_encoder_lora_sites,
        unet_lora_sites,
    )
    from lora_tpu_torch.formats.kohya import (
        is_kohya_xl,
        load_kohya_xl,
        save_kohya_xl,
    )
    from lora_tpu_torch.formats.reader import SafetensorsFile
    from lora_tpu_torch.models.config import SDXL_TEXT, SDXL_TEXT2, SDXL_UNET
    from lora_tpu_torch.models.hf_import import save_pipeline_params
    from lora_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

    t0 = time.perf_counter()
    if xl_dir is None:
        xl_dir = os.path.join(root, "sdxl")
        pipe = StableDiffusionXLPipeline.random_init(
            torch.Generator("cuda").manual_seed(SEED), "cuda",
            dtype=torch.bfloat16)
        save_pipeline_params(pipe, xl_dir, fp16=True)
        del pipe
        torch.cuda.empty_cache()
    ucfg = SDXL_UNET
    sites = {"unet": unet_lora_sites(SDXL_UNET),
             "text_encoder": text_encoder_lora_sites(SDXL_TEXT),
             "text_encoder_2": text_encoder_lora_sites(SDXL_TEXT2)}
    trees = {}
    for model, s in sites.items():
        tree = init_lora(s, r=TOOLS_RANK, generator=gen, device="cuda")
        for e in tree["sites"].values():
            e["up"] = TOOLS_UP_STD * torch.randn(e["up"].shape, generator=gen,
                                                 device="cuda")
        trees[model] = tree
    src = os.path.join(root, "kohya_xl_in.safetensors")
    save_kohya_xl(src, unet_cfg=ucfg, lora_unet=trees["unet"],
                  unet_sites=sites["unet"], lora_text=trees["text_encoder"],
                  text_sites=sites["text_encoder"],
                  lora_text2=trees["text_encoder_2"],
                  text2_sites=sites["text_encoder_2"])
    out = {"inputs_s": time.perf_counter() - t0,
           "sites": {m: len(s) for m, s in sites.items()}}
    dst = os.path.join(root, "kohya_xl_out.safetensors")
    argv = [src, xl_dir, "--rank", str(TOOLS_RANK), "--clamp_quantile", "1.0",
            "--from_lora", "--save_path", dst, "--device", "cuda"]
    with _distill_recorded({}) as rec:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _fire.fire(lora_distill.svd_distill_cli, argv)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t1
    n = sum(out["sites"].values())
    out.update(svd_s=rec["svd_s"], svd_s_per_site=rec["svd_s"] / n)
    with SafetensorsFile(dst) as f:
        keys = list(f.keys())
    prefixes = {p: sum(k.startswith(p) and k.endswith(".lora_up.weight")
                       for k in keys)
                for p in ("lora_unet_", "lora_te1_", "lora_te2_")}
    if not is_kohya_xl(keys) or list(prefixes.values()) != [
            len(sites[m]) for m in sites]:
        raise AssertionError(f"16b wrote {prefixes} modules, not one per "
                             f"site of {out['sites']}")
    kw = dict(unet_cfg=ucfg, unet_sites=sites["unet"],
              text_sites=sites["text_encoder"],
              text2_sites=sites["text_encoder_2"], device="cuda")
    got, want = load_kohya_xl(dst, **kw), load_kohya_xl(src, **kw)
    out["rel_l2"] = {}
    for model, g, w in zip(sites, got, want):
        out["rel_l2"][model], worst = _worst_rel(
            _products(g, sites[model]), _products(w, sites[model]))
        if not out["rel_l2"][model] <= DISTILL_REL_L2:
            raise AssertionError(f"16b: {model}'s distilled up @ down is "
                                 f"{out['rel_l2'][model]} from the input's "
                                 f"at {worst}")
    log("tools: 16b: " + json.dumps(out))
    return out


def _tools_unet_check(a, b, bare, what: str) -> dict:
    """rel L2 of two bf16 UNet outputs with an adapter, which must be within
    TOOLS_COLLAPSE_REL_L2, and of the first against the call without it
    (the adapter's share), which must be at least twice the limit."""
    out = {"rel_l2": _rel_l2(a, b), "rel_l2_to_bare": _rel_l2(a, bare)}
    if not (out["rel_l2"] <= TOOLS_COLLAPSE_REL_L2
            and out["rel_l2_to_bare"] >= 2 * TOOLS_COLLAPSE_REL_L2):
        raise AssertionError(f"{what}: {out} (limit "
                             f"{TOOLS_COLLAPSE_REL_L2})")
    return out


def _tools_lora_add(root: str, base: str, files, gen) -> dict:
    """16c: lora_add's four modes at full SD-1.5 width on the two files."""
    from lora_tpu_torch.cli import _fire, lora_add
    from lora_tpu_torch.formats import ckpt_export
    from lora_tpu_torch.formats.reader import load_file
    from lora_tpu_torch.models.config import SD15_UNET, SD15_VAE
    from lora_tpu_torch.models.hf_import import load_pipeline_params
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    def add(*argv):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _fire.fire(lora_add.add, list(argv))
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    out = {}
    (t1, m1), (t2, m2) = (load_file(f) for f in files)
    lpl = os.path.join(root, "lpl.safetensors")
    out["lpl_s"] = add(*files, lpl, "--alpha_1", "0.5", "--alpha_2", "0.5",
                       "--device", "cuda")
    got, meta = load_file(lpl)
    if set(got) != set(t1) | set(t2) or meta != {**m1, **m2}:
        raise AssertionError(f"16c lpl: keys {sorted(set(got) ^ set(t1))}")
    for k, v in got.items():
        if k.startswith("<"):  # a TI row, passed through
            want = t1[k] if k in t1 else t2[k]
        else:
            want = (0.5 * t1[k].astype(np.float32)
                    + 0.5 * t2[k].astype(np.float32)).astype(np.float16)
        if v.dtype != want.dtype or not np.array_equal(v, want):
            raise AssertionError(f"16c lpl: {k} is not the merge")
    ljl = os.path.join(root, "ljl.safetensors")
    out["ljl_s"] = add(*files, ljl, "--mode", "ljl", "--device", "cuda")
    got, meta = load_file(ljl)
    embeds = sorted(k for k, v in meta.items() if v == "<embed>")
    ranks = {v for k, v in meta.items() if k.endswith(":rank")}
    if embeds != ["<s0-0>", "<s0-1>", "<s1-0>"] or \
            ranks != {str(2 * TOOLS_RANK)} or not np.array_equal(
                got["unet:0:down"], np.concatenate([t1["unet:0:down"],
                                                    t2["unet:0:down"]])):
        raise AssertionError(f"16c ljl: embeds {embeds}, ranks {ranks}")

    upl = os.path.join(root, "upl")
    out["upl_s"] = add(base, files[0], upl, "--alpha_1", str(TOOLS_ALPHA),
                       "--mode", "upl", "--device", "cuda")
    collapsed = StableDiffusionPipeline.from_pretrained(
        upl, dtype=torch.bfloat16, device="cuda",
        require_real_tokenizer=False)
    patched = StableDiffusionPipeline.from_pretrained(
        base, dtype=torch.bfloat16, device="cuda",
        require_real_tokenizer=False)
    patched.patch_pipe(files[0])
    inputs = _unet_inputs(torch.bfloat16, gen)
    _zero_counts()
    folded = _unet_out(collapsed, inputs, None)
    patched.tune_lora_scale(TOOLS_ALPHA)
    at_alpha = _unet_out(patched, inputs, patched.lora_unet)
    patched.tune_lora_scale(1.0)
    file1 = _unet_out(patched, inputs, patched.lora_unet)
    bare = _unet_out(patched, inputs, None)
    torch.cuda.synchronize()
    fwd = dict(fa.flash_fwd.launches_by_kernel)
    if fwd != _only("wgmma", 4 * ROUTED_PER_UNET_CALL):
        raise AssertionError(f"16c: four UNet calls launched {fwd}")
    out["upl_unet"] = _tools_unet_check(folded, at_alpha, bare,
                                        "16c: the collapsed UNet call")
    out["upl_unet"]["flash_fwd"] = fwd
    del collapsed
    torch.cuda.empty_cache()

    ckpt = os.path.join(root, "model.ckpt")
    out["upl_ckpt_v2_s"] = add(base, files[0], ckpt, "--alpha_1",
                               str(TOOLS_ALPHA), "--mode", "upl-ckpt-v2",
                               "--device", "cuda")
    t3 = time.perf_counter()
    got = ckpt_export.params_from_ckpt(ckpt, SD15_UNET, SD15_VAE)
    out["params_from_ckpt_s"] = time.perf_counter() - t3
    want = load_pipeline_params(upl)[:3]
    table = "text_model.embeddings.token_embedding.weight"
    vocab = got[1][table].shape[0]
    for g, w in zip(got, want):
        w = {k: (v[:vocab] if k == table else v) for k, v in w.items()}
        bad = sorted(k for k in w if k not in g or not torch.equal(
            g[k], w[k].half().float()))
        if bad or set(g) != set(w):
            raise AssertionError(f"16c: params_from_ckpt differs from the "
                                 f"collapsed fp16 params at {bad[:5]}")
    a1111 = torch.load(ckpt[:-5] + ".pt", weights_only=True)
    rows = a1111["string_to_param"]["*"]
    if a1111["string_to_token"]["*"].item() != 265 or not np.array_equal(
            rows.numpy(), np.stack([t1["<t1>"], t1["<t2>"]])):
        raise AssertionError(f"16c: the A1111 embedding is {a1111}")
    out["ckpt_gib"] = os.path.getsize(ckpt) / 2**30
    log("tools: 16c: " + json.dumps(out))
    shutil.rmtree(upl)
    os.remove(ckpt)
    return out, patched, inputs, (file1, bare)


def _tools_manager(pipe, files, inputs, calls, report: dict) -> tuple:
    """16d: LoRAManager over the two files on the bf16 pipeline (16c's
    patched one, its LoRA removed): a counted 2-prompt 512px request with
    the manager's prompts, and tune([1, 0]) against file 1 alone (`calls`:
    16c's UNet calls with file 1 at scale 1 and without an adapter)."""
    from lora_tpu_torch.lora_manager import LoRAManager

    pipe.remove_lora()
    t0 = time.perf_counter()
    manager = LoRAManager(list(files), pipe)
    out = {"manager_s": time.perf_counter() - t0,
           "ranklist": manager.ranklist,
           "token_size_list": manager.token_size_list,
           "prompts": [manager.prompt(p) for p in TOOLS_PROMPTS]}
    if manager.ranklist != [TOOLS_RANK] * 2 or \
            manager.token_size_list != [2, 1]:
        raise AssertionError(f"16d: the manager joined {out}")
    images = counted_request(
        report, "tools", "16d_manager_request", STEPS,
        lambda: pipe(out["prompts"], num_inference_steps=STEPS,
                     guidance_scale=7.5, height=512, width=512,
                     generator=torch.Generator("cuda").manual_seed(SEED)))
    _check_images(images, len(TOOLS_PROMPTS), "16d")
    manager.tune([1.0, 0.0])
    out["tune_1_0"] = _tools_unet_check(
        _unet_out(pipe, inputs, pipe.lora_unet), *calls, "16d: tune([1, 0])")
    out.update(wall_s=report["16d_manager_request"]["wall_s"],
               flash_fwd=report["16d_manager_request"]["flash_fwd"])
    log("tools: 16d: " + json.dumps(out))
    return manager, images


def _tools_eval(pipe, manager, images, report: dict, gen) -> dict:
    """16e: evaluate_pipe on the manager's bf16 pipeline with the in-port
    scorer: a random CLIP ViT-L/14 tower and an SD-1.5 CLIP text model with
    a projection, f32 on the card; the targets 16d's images. Then the
    tower's pooled state on the card against the same forward on the
    CPU."""
    from lora_tpu_torch.models.clip import init_clip_text
    from lora_tpu_torch.models.clip_vision import (
        CLIP_VIT_L14_VISION,
        clip_vision_forward,
        init_clip_vision,
        preprocess_images,
    )
    from lora_tpu_torch.models.config import SD15_TEXT
    from lora_tpu_torch.utils.eval import evaluate_pipe, to_uint8

    vis = CLIP_VIT_L14_VISION
    params = {**init_clip_vision(vis, gen, device="cuda"),
              **init_clip_text(SD15_TEXT, gen, device="cuda")}
    params["text_projection.weight"] = 0.02 * torch.randn(
        (vis.projection_dim, SD15_TEXT.hidden_size), generator=gen,
        device="cuda")
    sets = {"params": params, "vision_cfg": vis, "text_cfg": SD15_TEXT,
            "tokenizer": pipe.tokenizer}
    targets = [to_uint8(im) for im in images]
    n = TOOLS_EVAL["n_test"] * TOOLS_EVAL["n_step"]
    scores = counted_request(
        report, "tools", "16e_evaluate_pipe", n,
        lambda: evaluate_pipe(pipe, targets, class_token="dog",
                              learnt_token=manager.prompt("<1>"),
                              clip_model_sets=sets, **TOOLS_EVAL))
    out = {"scores": scores, "wall_s": report["16e_evaluate_pipe"]["wall_s"],
           "flash_fwd": report["16e_evaluate_pipe"]["flash_fwd"]}
    if scores["n_images"] != TOOLS_EVAL["n_test"] or not all(
            np.isfinite(scores[k]) and -1.0 <= scores[k] <= 1.0
            for k in ("text_alignment_avg", "image_alignment_avg")):
        raise AssertionError(f"16e: scores {scores}")
    px = preprocess_images(targets, vis.image_size, "cuda")
    with torch.inference_mode():
        out["vision_ms"] = _time_ms(
            lambda: clip_vision_forward(params, px, vis), iters=5, warmup=1)
        card = clip_vision_forward(params, px, vis)
        cpu = clip_vision_forward({k: v.cpu() for k, v in params.items()},
                                  px.cpu(), vis)
    out["vision_card_vs_cpu_rel_l2"] = _rel_l2(card.cpu(), cpu)
    log("tools: 16e: " + json.dumps(out))
    if not out["vision_card_vs_cpu_rel_l2"] <= VISION_DEVICE_REL_L2:
        raise AssertionError(f"16e: the ViT-L/14 forward on the card is "
                             f"{out['vision_card_vs_cpu_rel_l2']} from the "
                             f"CPU's")
    return out


def phase_tools(smi: str, xl_dir=None) -> dict:
    """Phase 16: the adapter tooling at full width, random weights from the
    seed: 16a lora_distill on SD-1.5 directories (card and CPU), 16b
    lora_distill --from_lora on SDXL (`xl_dir`: phase 15's directory where
    the run has it), 16c lora_add's four modes, 16d LoRAManager on a bf16
    pipeline, 16e evaluate_pipe with a ViT-L/14 tower. Returns each part's
    report, the counted flash launches of 16c-16e, and the flash shapes
    they ran (to be checked against phase 3's)."""
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 16)
    report, out, seen = {}, {}, set()
    with tempfile.TemporaryDirectory(prefix="tools_") as root:
        t0 = time.perf_counter()
        out["16a"] = _tools_distill_sd(root, gen)
        out["16a"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["16b"] = _tools_distill_xl(root, xl_dir, gen)
        out["16b"]["part_s"] = time.perf_counter() - t0
        base = os.path.join(root, "base")
        files = [os.path.join(root, n) for n in ("one.safetensors",
                                                  "two.safetensors")]
        for path, tokens in zip(files, (("<t1>", "<t2>"), ("<t3>",))):
            _tools_lora_file(path, gen, tokens)
        with recording_flash_shapes(seen):
            t0 = time.perf_counter()
            out["16c"], pipe, inputs, calls = _tools_lora_add(
                root, base, files, gen)
            out["16c"]["part_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            manager, images = _tools_manager(pipe, files, inputs, calls,
                                             report)
            out["16d"] = report["16d_manager_request"]
            out["16d"]["part_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["16e"] = _tools_eval(pipe, manager, images, report, gen)
            out["16e"]["part_s"] = time.perf_counter() - t0
    del pipe
    torch.cuda.empty_cache()
    launches = dict.fromkeys(fa.flash_fwd.launches_by_kernel, 0)
    for part in (out["16c"]["upl_unet"]["flash_fwd"],
                 report["16d_manager_request"]["flash_fwd"],
                 report["16e_evaluate_pipe"]["flash_fwd"]):
        for k, n in part.items():
            launches[k] += n
    out.update(launches=launches, seen=seen,
               phase_s=time.perf_counter() - t_phase)
    log("tools: " + json.dumps({
        "phase_s": out["phase_s"], "launches": launches, "card": smi,
        "part_s": {p: out[p]["part_s"] for p in ("16a", "16b", "16c", "16d",
                                                 "16e")}}))
    return out


def add_tools_launches(kernels: list, tools: dict) -> None:
    """Each flash forward row of the kernels line gains phase 16's counted
    launches of its kernel ("tools": 16c's four UNet calls, 16d's request
    and 16e's generation)."""
    for row in kernels:
        wrapper, route = FLASH_ROW_ROUTES.get(row["name"], (None, None))
        if wrapper == "flash_fwd":
            n = tools["launches"][route]
            row["launches"] += n
            row["launches_by_path"]["tools"] = n


def check_tools_shapes(tools: dict, rows) -> None:
    """Every flash forward call phase 16 made was at a shape and layout a
    row of `rows` checked against its plain version."""
    unchecked = tools["seen"] - {_row_key(r) for r in rows}
    if unchecked:
        raise AssertionError(f"phase 16 ran flash_fwd at shapes or layouts "
                             f"no check covered: {sorted(unchecked)}")
    log(f"tools: flash_fwd ran {len(tools['seen'])} shapes and layouts, "
        f"each checked")


# phase 17: training across processes (parallel/mesh.py) through the
# launcher and the lora_db CLI, on random full-width SD-1.5 weights at 512
# px (phase 12's inputs). 17a: one rank over NCCL, DIST_STEPS steps of
# 12c's run; 17b: two ranks sharing the card over gloo, dp = 2 at
# train_batch_size 1, against one process at 2 (cached latents with prior
# preservation: one rank holds only instance rows, the other only class
# rows); 17c: fsdp = 2 on the two ranks against the unsharded run; 17d: a
# SIGTERM to rank 1 alone, then a resume
DIST_STEPS = 3
DIST_FSDP_STEPS = 2
DIST_PREEMPT_STEPS = 5  # the run the SIGTERM cuts short
DIST_LOSS_RTOL = 1e-5
# tensor parallelism (17f, 17e's tp runs): the split GEMMs and the tp
# all-reduce sum in other orders than one process, and under the
# blockwise-int8 Adam (17f) a gradient that differs in its last bits can
# move a moment's code by one step
DIST_TP_LOSS_RTOL = 1e-4
DIST_TREE_TOL = 1e-4  # of the largest entry of the LoRA
DIST_TIMEOUT_S = 600


def _cli_args(flags: dict) -> list:
    """DreamBoothConfig fields (and lora_db.train's) as lora_db flags."""
    out = []
    for k, v in flags.items():
        out += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return out


def dist_rank_worker(spec_path: str) -> int:
    """One rank of phase 17, started by lora_launch_torch: for each run of
    the spec, the lora_db CLI's main with the run's flags, in the
    launcher's group; then RUN.rank{r}.json with the rank's per-step
    losses, step times (CUDA events), gradient all-reduce times, flash and
    adam8bit launches (counts from 0 at the run's start) and the shapes
    of its flash launches, peak memory and steps, and from rank 0 the
    final trainable leaves in RUN.pt. Under tensor parallelism, each
    step's tp all-reduces (the split blocks' activations and gradients,
    then the split gradients' bucket): their count and host time between
    synchronizes. Each step also writes its count to RUN.rank{r}.progress
    (17d's SIGTERM waits for it)."""
    import gc

    from lora_tpu_torch.cli import lora_db
    from lora_tpu_torch.parallel import mesh as mesh_lib
    from lora_tpu_torch.parallel import tensor as tp_lib
    from lora_tpu_torch.training import optim, train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    with open(os.path.join(os.path.dirname(spec_path),
                           f"rank{os.environ['RANK']}.pid"), "w") as f:
        f.write(str(os.getpid()))
    mesh_lib.initialize_distributed_from_env()
    rank = mesh_lib.rank()
    reduce_ms, results = [], {}
    real_mean, real_train = mesh_lib.Mesh.mean_grads, lora_db.train_dreambooth

    def timed_mean(self, params, loss):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_mean(self, params, loss)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def captured(pipe, cfg):
        results["res"] = real_train(pipe, cfg)
        return results["res"]

    tp_steps, tp_acc = [], {"ms": 0.0, "n": 0}
    real_tp_reduce = tp_lib._all_reduce
    real_tp_sum = train_step.sum_split_grads

    def timed_tp_reduce(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_tp_reduce(*a, **kw)
        torch.cuda.synchronize()
        tp_acc["ms"] += 1e3 * (time.perf_counter() - t0)
        tp_acc["n"] += 1
        return out

    def timed_tp_sum(params, mesh):  # the step's last tp all-reduce
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_tp_sum(params, mesh)
        torch.cuda.synchronize()
        tp_steps.append((tp_acc["ms"] + 1e3 * (time.perf_counter() - t0),
                         tp_acc["n"] + 1))
        tp_acc.update(ms=0.0, n=0)

    mesh_lib.Mesh.mean_grads = timed_mean
    tp_lib._all_reduce = timed_tp_reduce
    train_step.sum_split_grads = timed_tp_sum
    lora_db.train_dreambooth = captured
    # the group outlives each run's main(); it is left after the last
    lora_db.finalize_distributed = lambda: None
    for run in spec["runs"]:
        out = run["out"]
        reduce_ms.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tp_steps.clear()
        _zero_trainer_counts()
        shapes = {w: collections.Counter() for w in
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        t0 = time.perf_counter()
        with timing_trainer_steps({}, progress=f"{out}.rank{rank}.progress",
                                  loop_peak=True) as rec, \
                recording_launch_shapes(shapes):
            sys.argv = ["lora_db", *run["args"]]
            lora_db.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        res = results.pop("res")
        record = {"rank": rank, "world": mesh_lib.world_size(),
                  "device": str(torch.cuda.current_device()),
                  "losses": [float(x) for x in rec.get("losses", [])],
                  "step_ms": _step_ms(rec, skip=0),
                  "reduce_ms": list(reduce_ms), "launches": _launches(),
                  "flash_shapes": {w: [[*k, n] for k, n in c.items()]
                                   for w, c in shapes.items()},
                  "tp_reduce_ms": [ms for ms, _ in tp_steps],
                  "tp_reduces": [n for _, n in tp_steps], "run_s": run_s,
                  **_peaks(rec), "steps": res["steps"],
                  "preempted": res["preempted"]}
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump(record, f)
        if rank == 0:
            torch.save([x.detach().cpu() for x in
                        optim.tree_leaves(res["trainable"])], f"{out}.pt")
        del res
    mesh_lib.finalize_distributed()
    return 0


def _peaks(rec: dict) -> dict:
    """The run's peak memory and its training loop's (GiB; see
    timing_trainer_steps's loop_peak)."""
    loop = torch.cuda.max_memory_allocated() / 2 ** 30
    return {"peak_memory_gib": max(rec.get("setup_peak_gib", 0.0), loop),
            "loop_peak_memory_gib": loop}


def _dist_launch(root: str, name: str, nproc: int, runs: list,
                 on_start=None) -> dict:
    """lora_launch_torch --nproc N -- python chip_smoke.py --dist-rank
    SPEC with these runs ([(tag, flags)]), from the repo root; the ranks'
    records by run and rank. on_start(proc, spec_dir) runs while the
    launch does."""
    spec_dir = os.path.join(root, name)
    os.makedirs(spec_dir)
    spec = {"runs": [{"out": os.path.join(spec_dir, tag),
                      "args": _cli_args(flags)} for tag, flags in runs]}
    spec_path = os.path.join(spec_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "lora_tpu_torch.launch", "--nproc",
           str(nproc), "--", sys.executable, os.path.join(here,
                                                          "chip_smoke.py"),
           "--dist-rank", spec_path]
    t0 = time.perf_counter()
    log_path = os.path.join(spec_dir, "launch.log")
    with open(log_path, "w") as logf:
        # a handshake or collective that hangs raises within the phase
        proc = subprocess.Popen(cmd, cwd=here, stdout=logf,
                                stderr=subprocess.STDOUT, text=True,
                                env={**os.environ,
                                     "LORA_TPU_TORCH_DIST_TIMEOUT_S": "300"})
        try:
            if on_start is not None:
                on_start(proc, spec_dir)
            proc.wait(timeout=DIST_TIMEOUT_S)
        finally:
            if proc.poll() is None:  # the ranks run in sessions of their
                # own: each is killed by the pid it wrote
                for r in range(nproc):
                    try:
                        with open(os.path.join(spec_dir,
                                               f"rank{r}.pid")) as f:
                            os.kill(int(f.read()), signal.SIGKILL)
                    except (OSError, ValueError):
                        pass
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in [ln for ln in lines if "joined a process group" in ln
                 or "Preempted" in ln or "Resumed" in ln] + lines[-6:]:
        log(f"dist {name}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"17 {name}: lora_launch_torch exited "
                             f"{proc.returncode}:\n" + "\n".join(lines[-40:]))
    out = {"wall_s": wall, "log": lines}
    for tag, _ in runs:
        out[tag] = []
        for r in range(nproc):
            with open(os.path.join(spec_dir, f"{tag}.rank{r}.json")) as f:
                out[tag].append(json.load(f))
    return out


def _dist_leaves(root: str, name: str, tag: str) -> list:
    return torch.load(os.path.join(root, name, f"{tag}.pt"))


def _ref_run(lora_db, model: str, flags: dict) -> dict:
    """The one-process reference in this process: its per-step losses,
    step times, launches, peak memory and final leaves."""
    from lora_tpu_torch.training import optim

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_trainer_counts()
    with timing_trainer_steps({}, loop_peak=True) as rec:
        res = lora_db.train(model, device="cuda", **flags)
    torch.cuda.synchronize()
    return {"losses": [float(x) for x in rec["losses"]],
            "step_ms": _step_ms(rec, skip=0), "launches": _launches(),
            **_peaks(rec), "steps": res["steps"],
            "leaves": [x.detach().cpu() for x in
                       optim.tree_leaves(res["trainable"])]}


def _same_run(what: str, got_losses, got_leaves, ref: dict,
              loss_rtol: float = DIST_LOSS_RTOL) -> dict:
    """Per-step losses within loss_rtol and leaves within DIST_TREE_TOL of
    the largest entry (where the reference has them); the worst
    differences."""
    if len(got_losses) != len(ref["losses"]):
        raise AssertionError(f"{what}: {len(got_losses)} steps, the "
                             f"reference {len(ref['losses'])}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses,
                                                        ref["losses"]))
    tree = 0.0
    if "leaves" in ref:
        top = max(float(x.abs().max()) for x in ref["leaves"])
        tree = max(float((a - b).abs().max()) for a, b in
                   zip(got_leaves, ref["leaves"])) / top
    if not (np.isfinite(got_losses).all() and loss_rel <= loss_rtol
            and tree <= DIST_TREE_TOL):
        raise AssertionError(f"{what}: losses {got_losses} against "
                             f"{ref['losses']} (worst relative "
                             f"{loss_rel:.3g}), LoRA off by {tree:.3g} of "
                             f"its largest entry")
    return {"loss_rel": loss_rel,
            "lora_rel": tree if "leaves" in ref else None}


def _expect_dist_launches(what: str, got: dict, steps: int,
                          adam: int = 0) -> None:
    """Every flash launch of `steps` f32 steps through the tf32x3 kernels
    (_per_step_want's routes)."""
    dq, dkv, fwd = _per_step_want(torch.float32)
    want = {"flash_fwd": _scaled(fwd, steps),
            "flash_bwd_dq": _scaled(dq, steps),
            "flash_bwd_dkv": _scaled(dkv, steps), "adam8bit": adam}
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want}")


def _check_tp_run(what: str, ranks: list, tp: int, steps: int,
                  adam: int = 0) -> dict:
    """A tensor-parallel run's ranks: every flash launch through the
    tf32x3 kernels (_expect_dist_launches), every rank the same global
    losses, every flash launch at SD-1.5's 8 heads / tp, and the forward,
    dQ and dK/dV kernels against their plain versions at each shape the
    ranks launched (untimed). Returns the shapes and the checks' worst
    errors."""
    for r in ranks:
        _expect_dist_launches(f"{what} rank {r['rank']}", r["launches"],
                              steps, adam=adam)
        if r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"{what}: rank {r['rank']}'s losses "
                                 f"{r['losses']} are not rank 0's "
                                 f"{ranks[0]['losses']}")
    shapes = {w: sorted({tuple(k[:6]) for r in ranks
                         for k in r["flash_shapes"][w]})
              for w in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    wrong = [k for ks in shapes.values() for k in ks if k[1] != 8 // tp]
    if wrong or not shapes["flash_fwd"] or not shapes["flash_bwd_dkv"]:
        raise AssertionError(f"{what}: flash launches at {shapes}, not at "
                             f"{8 // tp} heads a rank")
    gen = torch.Generator("cuda").manual_seed(SEED + 17)
    fwd_err, bwd_err = 0.0, 0.0
    for B, H, T, S, D, dt in shapes["flash_fwd"]:
        row = check_kernel(B, H, T, S, D, getattr(torch, dt), gen,
                           timed=False)
        fwd_err = max(fwd_err, row["err_o"])
    for B, H, T, S, D, dt in sorted(set(shapes["flash_bwd_dq"])
                                    | set(shapes["flash_bwd_dkv"])):
        row = check_bwd_kernels(B, H, T, S, D, getattr(torch, dt), gen,
                                timed=False)
        bwd_err = max(bwd_err, row["err_dq"], row["err_dk"], row["err_dv"])
    return {"shapes": {w: [list(k) for k in ks] for w, ks in
                       shapes.items()},
            "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err}


def _preempt_rank1(proc, spec_dir: str, tag: str) -> None:
    """SIGTERM to rank 1 alone once it has made a step of run `tag`."""
    progress = os.path.join(spec_dir, f"{tag}.rank1.progress")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            with open(progress) as f:
                done = int(f.read() or 0)
        except (OSError, ValueError):
            done = 0
        if done >= 1:
            with open(os.path.join(spec_dir, "rank1.pid")) as f:
                os.kill(int(f.read()), signal.SIGTERM)
            log(f"dist 17d: SIGTERM to rank 1 after its step {done}")
            return
        time.sleep(0.02)
    raise AssertionError("17d: rank 1 made no step to preempt")


def phase_dist(smi: str, trainer_root=None, ref_losses=None) -> dict:
    """Phase 17 (see its note above): the launcher, the CLI and the mesh
    on the card; every number from this run. trainer_root: phase 12's
    directory, whose inputs and class images 17 reuses; ref_losses: 12c's
    per-step losses, which 17a's are held to (without them 17a runs 12c's
    flags in this process first)."""
    from lora_tpu_torch.cli import lora_db

    out = {}
    with tempfile.TemporaryDirectory(prefix="lora_dist_") as root:
        if trainer_root is None:
            pipe, model, inst = _trainer_inputs(root)
            del pipe
            torch.cuda.empty_cache()
        else:
            model = os.path.join(trainer_root, "model")
            inst = os.path.join(trainer_root, "instance")
            root = os.path.join(trainer_root, "dist")
            os.makedirs(root)
        cls = os.path.join(root if trainer_root is None else trainer_root,
                           "class")
        common = dict(instance_data_dir=inst,
                      instance_prompt="a photo of sks dog", resolution=512,
                      lora_rank=TRAINER_RANK, seed=SEED, learning_rate=1e-4)
        prior = dict(with_prior_preservation=True, class_data_dir=cls,
                     class_prompt="a photo of a dog",
                     num_class_images=TRAINER_CLASS_IMAGES,
                     sample_steps=TRAINER_SAMPLE_STEPS)
        # 17a: 12c's run for DIST_STEPS steps as one rank of a group over
        # NCCL, held to 12c's losses (or, alone, to the same run in this
        # process first, which makes the class images)
        flags_a = dict(common, **prior, train_text_encoder=True,
                       use_8bit_adam=True, max_train_steps=DIST_STEPS,
                       save_steps=TRAINER_SAVE_STEPS, save_train_state=True,
                       output_format="both")
        if ref_losses is None:
            ref_a = _ref_run(lora_db, model, dict(
                flags_a, output_dir=os.path.join(root, "ref_a")))
        else:
            ref_a = {"losses": list(ref_losses[:DIST_STEPS]),
                     "step_ms": None}
        a = _dist_launch(root, "17a", 1, [("a", dict(
            flags_a, data_parallel=True, device="cuda",
            pretrained_model_name_or_path=model,
            output_dir=os.path.join(root, "a")))])
        if not any("backend=nccl world_size=1" in ln for ln in a["log"]):
            raise AssertionError("17a: the rank did not join over NCCL")
        (ra,) = a["a"]
        _expect_dist_launches("17a", ra["launches"], DIST_STEPS,
                              adam=2 * DIST_STEPS)
        out["17a"] = {"launch_wall_s": a["wall_s"], **_same_run(
            "17a", ra["losses"], _dist_leaves(root, "17a", "a"), ref_a),
            "losses": ra["losses"], "ref_losses": ref_a["losses"],
            "ref": "12c" if ref_losses is not None else "this process",
            "step_ms": ra["step_ms"], "ref_step_ms": ref_a["step_ms"],
            "launches": ra["launches"],
            "peak_memory_gib": ra["peak_memory_gib"],
            "loop_peak_memory_gib": ra["loop_peak_memory_gib"]}
        log("dist 17a: " + json.dumps(out["17a"]))
        # 17b-17d: two ranks on the one card over gloo, in one launch
        flags_b = dict(common, **prior, cached_latents=True,
                       train_text_encoder=True, max_train_steps=DIST_STEPS,
                       save_steps=0)
        flags_c = dict(common, cached_latents=True,
                       max_train_steps=DIST_FSDP_STEPS, save_steps=0)
        flags_d = dict(common, cached_latents=True, data_parallel=True,
                       max_train_steps=DIST_PREEMPT_STEPS, save_steps=0,
                       preemption_sync_every=1)
        ref_b = _ref_run(lora_db, model, dict(
            flags_b, train_batch_size=2,
            output_dir=os.path.join(root, "ref_b")))
        ref_c = _ref_run(lora_db, model, dict(
            flags_c, output_dir=os.path.join(root, "ref_c")))
        cli = dict(device="cuda", pretrained_model_name_or_path=model)
        pre_dir = os.path.join(root, "d_pre")
        two = _dist_launch(root, "17bcdf", 2, [
            ("b", dict(flags_b, **cli, data_parallel=True,
                       train_batch_size=1,
                       output_dir=os.path.join(root, "b"))),
            ("c", dict(flags_c, **cli, fsdp=2,
                       output_dir=os.path.join(root, "c"))),
            ("d_pre", dict(flags_d, **cli, output_dir=pre_dir)),
            ("d_resume", dict(flags_d, **cli,
                              output_dir=os.path.join(root, "d_resume"),
                              resume_state=os.path.join(
                                  pre_dir, "train_state.safetensors"))),
            # 17f: 17a's run (12c's flags) with tensor_parallel = 2
            ("f", dict(flags_a, **cli, tensor_parallel=2,
                       output_dir=os.path.join(root, "f")))],
            on_start=lambda proc, d: _preempt_rank1(proc, d, "d_pre"))
        if not any("backend=gloo world_size=2 devices=['cuda:0', 'cuda:0']"
                   in ln for ln in two["log"]):
            raise AssertionError("17b: the ranks did not share the card "
                                 "over gloo")
        # 17b
        rb = two["b"]
        for r in rb:
            _expect_dist_launches(f"17b rank {r['rank']}", r["launches"],
                                  DIST_STEPS)
        if rb[0]["losses"] != rb[1]["losses"]:
            raise AssertionError(f"17b: the ranks' global losses differ: "
                                 f"{rb[0]['losses']} {rb[1]['losses']}")
        ref_files = sorted(os.listdir(os.path.join(root, "ref_b")))
        got_files = sorted(os.listdir(os.path.join(root, "b")))
        with open(os.path.join(root, "b", "metrics.jsonl")) as f:
            got_lines = f.read().splitlines()
        with open(os.path.join(root, "ref_b", "metrics.jsonl")) as f:
            ref_lines = f.read().splitlines()
        if got_files != ref_files or len(got_lines) != len(ref_lines):
            raise AssertionError(f"17b: the output directory holds "
                                 f"{got_files} and {len(got_lines)} metrics "
                                 f"lines, one process wrote {ref_files} and "
                                 f"{len(ref_lines)}")
        out["17b"] = {**_same_run("17b", rb[0]["losses"],
                                  _dist_leaves(root, "17bcdf", "b"), ref_b),
                      "losses": rb[0]["losses"],
                      "ref_losses": ref_b["losses"],
                      "step_ms": [r["step_ms"] for r in rb],
                      "ref_step_ms": ref_b["step_ms"],
                      "reduce_ms": [r["reduce_ms"] for r in rb],
                      "peak_memory_gib": [r["peak_memory_gib"] for r in rb],
                      "loop_peak_memory_gib": [r["loop_peak_memory_gib"]
                                               for r in rb],
                      "ref_loop_peak_memory_gib":
                          ref_b["loop_peak_memory_gib"],
                      "files": got_files}
        log("dist 17b: " + json.dumps(out["17b"]))
        # 17c
        rc = two["c"]
        for r in rc:
            _expect_dist_launches(f"17c rank {r['rank']}", r["launches"],
                                  DIST_FSDP_STEPS)
        out["17c"] = {**_same_run("17c", rc[0]["losses"],
                                  _dist_leaves(root, "17bcdf", "c"), ref_c),
                      "losses": rc[0]["losses"],
                      "ref_losses": ref_c["losses"],
                      "step_ms": [r["step_ms"] for r in rc],
                      "ref_step_ms": ref_c["step_ms"],
                      "peak_memory_gib": [r["peak_memory_gib"] for r in rc],
                      "loop_peak_memory_gib": [r["loop_peak_memory_gib"]
                                               for r in rc],
                      "ref_peak_memory_gib": ref_c["peak_memory_gib"],
                      "ref_loop_peak_memory_gib":
                          ref_c["loop_peak_memory_gib"]}
        log("dist 17c: " + json.dumps(out["17c"]))
        # 17d
        pre, resumed = two["d_pre"], two["d_resume"]
        stops = {(r["steps"], r["preempted"]) for r in pre}
        if len(stops) != 1 or not pre[0]["preempted"]:
            raise AssertionError(f"17d: the ranks stopped at (steps, "
                                 f"preempted) {sorted(stops)}")
        stop = pre[0]["steps"]
        made = sorted(os.listdir(pre_dir))
        if "train_state.safetensors" not in made or any(
                f.startswith("lora_weight.") for f in made):
            raise AssertionError(f"17d: the preempted run wrote {made}")
        ran = [len(r["losses"]) for r in resumed]
        if any(r["steps"] != DIST_PREEMPT_STEPS or r["preempted"]
               for r in resumed) or ran != [DIST_PREEMPT_STEPS - stop] * 2:
            raise AssertionError(f"17d: the resume from step {stop} ran "
                                 f"{ran} steps to "
                                 f"{[r['steps'] for r in resumed]}")
        out["17d"] = {"stopped_at": stop, "resumed_steps": ran[0],
                      "files": made, "resumed_losses": resumed[0]["losses"]}
        log("dist 17d: " + json.dumps(out["17d"]))
        # 17f: the two ranks split every attention and FF block of the
        # UNet and the text encoder (4 of SD-1.5's 8 heads a rank), the
        # VAE's one-head attention gathered; held to 12c's losses (or the
        # in-process run's)
        rf = two["f"]
        out["17f"] = {**_check_tp_run("17f", rf, 2, DIST_STEPS,
                                      adam=2 * DIST_STEPS),
                      **_same_run("17f", rf[0]["losses"], None,
                                  {"losses": ref_a["losses"]},
                                  DIST_TP_LOSS_RTOL),
                      "losses": rf[0]["losses"],
                      "ref_losses": ref_a["losses"],
                      "step_ms": [r["step_ms"] for r in rf],
                      "ref_step_ms": ra["step_ms"],
                      "tp_reduce_ms": [r["tp_reduce_ms"] for r in rf],
                      "tp_reduces": [r["tp_reduces"] for r in rf],
                      "run_s": [r["run_s"] for r in rf],
                      "peak_memory_gib": [r["peak_memory_gib"] for r in rf],
                      "loop_peak_memory_gib": [r["loop_peak_memory_gib"]
                                               for r in rf],
                      "ref_peak_memory_gib": ra["peak_memory_gib"],
                      "ref_loop_peak_memory_gib": ra["loop_peak_memory_gib"]}
        log("dist 17f: " + json.dumps(out["17f"]))
        out["launches_wall_s"] = {"17a": a["wall_s"],
                                  "17bcdf": two["wall_s"]}
        log("dist launch walls s: " + json.dumps(out["launches_wall_s"]))
        # the flash and adam8bit launches of every rank of every run
        runs = [ra] + [r for tag in ("b", "c", "d_pre", "d_resume")
                       for r in two[tag]]
        out["launches"] = {w: {k: sum(r["launches"][w][k] for r in runs)
                               for k in ra["launches"][w]}
                           for w in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}
        out["launches"]["adam8bit"] = sum(r["launches"]["adam8bit"]
                                          for r in runs)
        log("dist launches: " + json.dumps(out["launches"]))
        out["launches_tp"] = {w: {k: sum(r["launches"][w][k] for r in rf)
                                  for k in rf[0]["launches"][w]}
                              for w in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")}
        out["launches_tp"]["adam8bit"] = sum(r["launches"]["adam8bit"]
                                             for r in rf)
        log("dist_tp launches: " + json.dumps(out["launches_tp"]))
    log(f"dist: {smi}")
    return out


def phase_dist_cards(smi: str) -> dict:
    """17e, on every card of the host (N >= 2; not part of the full run):
    lora_db over NCCL, one rank a card, dp = N at train_batch_size 1,
    dp = N / 2 x fsdp = 2 at train_batch_size 2 (the NCCL all-gather of
    the sharded base), dp = N / 2 x tp = 2 at 2 and, on four cards, tp = 4
    at 4 (the NCCL all-reduces of the split blocks), each against one
    process at the global batch N."""
    from lora_tpu_torch.cli import lora_db

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        raise RuntimeError(f"17e needs an even number of cards, found {n}")
    out = {"cards": n}
    with tempfile.TemporaryDirectory(prefix="lora_dist_cards_") as root:
        pipe, model, inst = _trainer_inputs(root)
        del pipe
        torch.cuda.empty_cache()
        flags = dict(instance_data_dir=inst,
                     instance_prompt="a photo of sks dog", resolution=512,
                     lora_rank=TRAINER_RANK, seed=SEED, learning_rate=1e-4,
                     cached_latents=True, train_text_encoder=True,
                     max_train_steps=DIST_STEPS, save_steps=0)
        ref = _ref_run(lora_db, model, dict(
            flags, train_batch_size=n, output_dir=os.path.join(root, "ref")))
        cli = dict(flags, device="cuda", pretrained_model_name_or_path=model,
                   data_parallel=True)
        tp_runs = {"dp_tp": 2} if n != 4 else {"dp_tp": 2, "tp4": 4}
        runs = _dist_launch(root, "17e", n, [
            ("dp", dict(cli, train_batch_size=1,
                        output_dir=os.path.join(root, "dp"))),
            ("fsdp", dict(cli, fsdp=2, train_batch_size=2,
                          output_dir=os.path.join(root, "fsdp")))] + [
            (tag, dict(cli, tensor_parallel=tp, train_batch_size=tp,
                       output_dir=os.path.join(root, tag)))
            for tag, tp in tp_runs.items()])
        if not any(f"backend=nccl world_size={n}" in ln
                   for ln in runs["log"]):
            raise AssertionError("17e: the ranks did not join over NCCL")
        for tag in ("dp", "fsdp", *tp_runs):
            tp = tp_runs.get(tag)
            if tp is None:
                for r in runs[tag]:
                    _expect_dist_launches(f"17e {tag} rank {r['rank']}",
                                          r["launches"], DIST_STEPS)
            out[tag] = {
                **(_check_tp_run(f"17e {tag}", runs[tag], tp, DIST_STEPS)
                   if tp else {}),
                **_same_run(f"17e {tag}", runs[tag][0]["losses"],
                            _dist_leaves(root, "17e", tag), ref,
                            DIST_TP_LOSS_RTOL if tp else DIST_LOSS_RTOL),
                "tp_reduce_ms": [r["tp_reduce_ms"] for r in runs[tag]],
                "run_s": [r["run_s"] for r in runs[tag]],
                "losses": runs[tag][0]["losses"],
                "step_ms": [r["step_ms"] for r in runs[tag]],
                "reduce_ms": [r["reduce_ms"] for r in runs[tag]],
                "loop_peak_memory_gib": [r["loop_peak_memory_gib"]
                                         for r in runs[tag]],
                "peak_memory_gib": [r["peak_memory_gib"]
                                    for r in runs[tag]]}
            log(f"dist 17e {tag}: " + json.dumps(out[tag]))
        out["ref"] = {"losses": ref["losses"], "step_ms": ref["step_ms"],
                      "loop_peak_memory_gib": ref["loop_peak_memory_gib"],
                      "peak_memory_gib": ref["peak_memory_gib"]}
        out["wall_s"] = runs["wall_s"]
        log("dist 17e ref: " + json.dumps(out["ref"]))
    log(f"dist 17e: {smi}")
    return out


def add_dist_launches(kernels: list, dist: dict) -> None:
    """Each flash row of the kernels line, and the adam8bit row, gains
    phase 17's launches of its kernel, summed over every rank: 17a-17d's
    ("dist") and 17f's tensor-parallel run ("dist_tp")."""
    for path, counts in (("dist", dist["launches"]),
                         ("dist_tp", dist["launches_tp"])):
        for row in kernels:
            if row["name"] == "adam8bit":
                n = counts["adam8bit"]
            elif row["name"] in FLASH_ROW_ROUTES:
                wrapper, route = FLASH_ROW_ROUTES[row["name"]]
                n = counts[wrapper][route]
            else:
                continue
            row["launches"] += n
            row["launches_by_path"][path] = n


# -- phase 18: the model-backed preprocessing (lora_ppim) ---------------------

# two PNG inputs (w, h): the first wider than the target, the second's
# square crop under it, so Swin2SR runs on it
PPIM_IMAGES = ((640, 480), (400, 300))
PPIM_TARGET = 512
# the input of the card-against-CPU Swin2SR check (w, h): the CPU runs the
# 36 Swin layers of x2-64 in seconds at this size
PPIM_SR_CHECK = (72, 56)
# BLIP-large's logits on the card (TF32 off) against the CPU's, teacher
# forced on the card's greedy ids, over their largest magnitude: f32 on
# both, summed in another order through 24 vision and 12 decoder layers
PPIM_BLIP_DEVICE_REL = 1e-4
# CLIPSeg masks and Swin2SR pixels, card against CPU: the CPU tests'
# tolerance (tests/test_torch_port_preprocess.py PIXEL_TOL and
# PIXEL_OFF_SHARE)
PPIM_PIXEL_TOL = 1
PPIM_PIXEL_OFF_SHARE = 0.01
PPIM_TIMED = 3  # warm calls per timed stage
PPIM_PROFILE_TOKENS = 10  # max_length of the profiled caption

# tiny configurations of the same writers (tests/test_torch_port_
# preprocess.py reads their directories with transformers)
PPIM_TINY_BLIP = blip_cfg.BlipConfig(
    vision=blip_cfg.BlipVisionConfig(hidden_size=48, intermediate_size=64,
                                     num_hidden_layers=2,
                                     num_attention_heads=2, image_size=32,
                                     patch_size=8),
    text=blip_cfg.BlipTextConfig(vocab_size=132, hidden_size=32,
                                 encoder_hidden_size=48,
                                 intermediate_size=64, num_hidden_layers=2,
                                 num_attention_heads=2,
                                 max_position_embeddings=192,
                                 bos_token_id=130))
PPIM_TINY_CLIPSEG = clipseg_cfg.CLIPSegConfig(
    text=clipseg_cfg.CLIPSegTextConfig(
        vocab_size=600, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, bos_token_id=598,
        eos_token_id=599),
    vision=clipseg_cfg.CLIPSegVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, image_size=64, patch_size=16),
    projection_dim=16, extract_layers=(0, 2), reduce_dim=16,
    decoder_num_attention_heads=2, decoder_intermediate_size=32,
    use_complex_transposed_convolution=True)
PPIM_TINY_SWIN2SR = swin2sr_cfg.Swin2SRConfig(
    image_size=32, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
    window_size=4)


def _ppim_bert_vocab(n: int) -> list:
    """A BERT-layout vocab of n tokens: [PAD] 0, [unused*], [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103, then words and made-up pieces."""
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of",
                ",", ".", "##s"])
    i = 0
    while len(vocab) < n:
        vocab.append(f"w{i}" if i % 4 else f"##w{i}")
        i += 1
    return vocab[:n]


def _ppim_clip_vocab(n: int) -> tuple:
    """A CLIP byte-level BPE vocab of n tokens (the 256 byte symbols with
    and without </w>, merges building a few words, filler, then
    <|startoftext|> and <|endoftext|> last) and its merges."""
    from lora_tpu_torch.data.tokenizer import bytes_to_unicode

    syms = list(bytes_to_unicode().values())
    toks = syms + [s + "</w>" for s in syms]
    merges = []
    for w in ("a", "photo", "of", "person", "face"):
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        cur = pieces[0]
        for nxt in pieces[1:]:
            merges.append(f"{cur} {nxt}")
            cur += nxt
            toks.append(cur)
    toks = list(dict.fromkeys(toks))
    merges = list(dict.fromkeys(merges))
    i = 0
    while len(toks) < n - 2:
        toks.append(f"~{i}</w>")
        i += 1
    toks = toks[:n - 2] + ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(toks)}, merges


def _ppim_save(params, model_dir: str, config: dict,
               preprocessor: dict) -> None:
    """A checkpoint directory as transformers' save_pretrained lays it
    out: config.json, model.safetensors (float32) and
    preprocessor_config.json."""
    from lora_tpu_torch.formats.reader import save_file

    os.makedirs(model_dir, exist_ok=True)
    save_file({k: v.detach().float().cpu().contiguous().numpy()
               for k, v in params.items()},
              os.path.join(model_dir, "model.safetensors"),
              metadata={"format": "pt"})
    for name, obj in (("config.json", config),
                      ("preprocessor_config.json", preprocessor)):
        with open(os.path.join(model_dir, name), "w") as f:
            json.dump(obj, f, indent=2)


def ppim_write_checkpoints(root: str, gen, device, blip_c=None,
                           clipseg_c=None, swin2sr_c=None) -> dict:
    """The three checkpoint directories lora_ppim reads, written without
    transformers: random weights from `gen` (the port's init on `device`)
    at the given configurations (default: the published ones), their
    config.json, preprocessor_config.json and tokenizer files as the
    published directories lay them out. {name: directory}."""
    from lora_tpu_torch.models import blip, clipseg, swin2sr

    blip_c = blip_c or blip.BLIP_LARGE
    clipseg_c = clipseg_c or clipseg.CLIPSEG_RD64_REFINED
    swin2sr_c = swin2sr_c or swin2sr.SWIN2SR_X2_64
    dirs = {n: os.path.join(root, n) for n in ("blip", "clipseg", "swin2sr")}

    def dump(d, name, obj):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)

    n = blip_c.text.vocab_size - 2  # [DEC] and [ENC] are added tokens
    if blip_c.text.bos_token_id != n:
        raise ValueError("the BLIP writer puts [DEC] (the bos) at "
                         f"vocab_size - 2 = {n}")
    _ppim_save(
        blip.init_blip(blip_c, gen, device=device), dirs["blip"],
        blip.config_to_json(blip_c),
        {"image_processor_type": "BlipImageProcessor",
         "processor_class": "BlipProcessor", "do_convert_rgb": True,
         "do_resize": True, "resample": 3,
         "size": {"height": blip_c.vision.image_size,
                  "width": blip_c.vision.image_size},
         "do_rescale": True, "rescale_factor": 1 / 255,
         "do_normalize": True, "image_mean": list(blip.BLIP_IMAGE_MEAN),
         "image_std": list(blip.BLIP_IMAGE_STD)})
    with open(os.path.join(dirs["blip"], "vocab.txt"), "w") as f:
        f.write("\n".join(_ppim_bert_vocab(n)) + "\n")
    specials = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                "pad_token": "[PAD]", "cls_token": "[CLS]",
                "mask_token": "[MASK]", "bos_token": "[DEC]"}
    added = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
             103: "[MASK]", n: "[DEC]", n + 1: "[ENC]"}
    dump(dirs["blip"], "tokenizer_config.json", {
        "tokenizer_class": "BertTokenizer", "processor_class": "BlipProcessor",
        "do_lower_case": True, "model_max_length": 512,
        "clean_up_tokenization_spaces": True,
        "additional_special_tokens": ["[ENC]"], **specials,
        "added_tokens_decoder": {str(i): {
            "content": t, "lstrip": False, "normalized": False,
            "rstrip": False, "single_word": False, "special": True}
            for i, t in added.items()}})
    dump(dirs["blip"], "special_tokens_map.json",
         {**specials, "additional_special_tokens": ["[ENC]"]})

    t = clipseg_c.text
    if (t.bos_token_id, t.eos_token_id) != (t.vocab_size - 2,
                                             t.vocab_size - 1):
        raise ValueError("the CLIPSeg writer puts bos and eos last")
    _ppim_save(
        clipseg.init_clipseg(clipseg_c, gen, device=device),
        dirs["clipseg"], clipseg.config_to_json(clipseg_c),
        {"image_processor_type": "ViTImageProcessor",
         "processor_class": "CLIPSegProcessor", "do_resize": True,
         "resample": 2, "size": {"height": 352, "width": 352},
         "do_rescale": True, "rescale_factor": 1 / 255,
         "do_normalize": True, "image_mean": list(clipseg.IMAGENET_MEAN),
         "image_std": list(clipseg.IMAGENET_STD)})
    vocab, merges = _ppim_clip_vocab(t.vocab_size)
    dump(dirs["clipseg"], "vocab.json", vocab)
    with open(os.path.join(dirs["clipseg"], "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    clip_specials = {"bos_token": "<|startoftext|>",
                     "eos_token": "<|endoftext|>",
                     "pad_token": "<|endoftext|>",
                     "unk_token": "<|endoftext|>"}
    dump(dirs["clipseg"], "tokenizer_config.json", {
        "tokenizer_class": "CLIPTokenizer",
        "processor_class": "CLIPSegProcessor", "model_max_length": 77,
        **clip_specials})
    dump(dirs["clipseg"], "special_tokens_map.json", clip_specials)

    _ppim_save(
        swin2sr.init_swin2sr(swin2sr_c, gen, device=device),
        dirs["swin2sr"], swin2sr.config_to_json(swin2sr_c),
        {"image_processor_type": "Swin2SRImageProcessor", "do_pad": True,
         "pad_size": 8, "do_rescale": True, "rescale_factor": 1 / 255})
    return dirs


def _ppim_inputs() -> list:
    """PPIM_IMAGES as smooth random (h, w, 3) uint8 images: seeded noise at
    a sixteenth of the size, BICUBIC up (data/resample.py)."""
    from lora_tpu_torch.data import resample

    rs = np.random.RandomState(SEED)
    return [resample.resize((rs.rand(h // 16, w // 16, 3) * 255).astype(
        np.uint8), (w, h), resample.BICUBIC) for w, h in PPIM_IMAGES]


def _ppim_levels(ref: np.ndarray, got: np.ndarray, what: str) -> dict:
    if ref.shape != got.shape:
        raise AssertionError(f"{what}: card {got.shape} != CPU {ref.shape}")
    diff = np.abs(ref.astype(np.int64) - got)
    out = {"max_levels": int(diff.max()),
           "share_off": float((diff > 0).mean())}
    if out["max_levels"] > PPIM_PIXEL_TOL or \
            out["share_off"] > PPIM_PIXEL_OFF_SHARE:
        raise AssertionError(f"{what}: card against CPU {out}, limits "
                             f"{PPIM_PIXEL_TOL} levels on at most "
                             f"{PPIM_PIXEL_OFF_SHARE} of the pixels")
    return out


def phase_ppim(smi: str) -> dict:
    """Phase 18: lora_ppim's stages on the card at the published widths
    (random weights from SEED), written as lora_ppim writes masks and
    captions, timed, and held against the port's CPU run of the same
    weights; no flash or int8 kernel launches on this path."""
    from lora_tpu_torch.data import png, preprocess as pre
    from lora_tpu_torch.models import blip, clipseg, swin2sr

    t_phase = time.perf_counter()
    before = {f.__name__: f.launches for f in (
        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, i8.int8_matmul)}
    root = tempfile.mkdtemp(prefix="ppim_")
    env = os.environ.get("LORA_TPU_AUX_MODELS")
    out = {}
    try:
        t0 = time.perf_counter()
        dirs = ppim_write_checkpoints(
            root, torch.Generator("cuda").manual_seed(SEED), "cuda")
        out["write_s"] = time.perf_counter() - t0
        sizes = {n: sum(os.path.getsize(os.path.join(d, f))
                        for f in os.listdir(d)) for n, d in dirs.items()}
        log(f"ppim: 18a checkpoints written in {out['write_s']:.1f} s: "
            f"BLIP-large, CLIPSeg rd64-refined, Swin2SR x2-64 at their "
            f"published widths (random weights), bytes {sizes}")
        os.environ["LORA_TPU_AUX_MODELS"] = root
        raw = os.path.join(root, "raw")
        os.makedirs(raw)
        for i, img in enumerate(_ppim_inputs()):
            with open(os.path.join(raw, f"{i}.png"), "wb") as f:
                f.write(png._png_bytes(img))
        images = [pre._read_rgb(os.path.join(raw, f"{i}.png"))
                  for i in range(len(PPIM_IMAGES))]

        # 18b: lora_ppim's stages on the card, then the write
        def sync_time(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, 1e3 * (time.perf_counter() - t)

        (caps, imgs, masks), wall_ms = sync_time(
            lambda: pre.preprocess_images(
                images, target_size=PPIM_TARGET, device="cuda",
                generator=torch.Generator("cuda").manual_seed(SEED)))
        out_dir = os.path.join(root, "out")
        os.makedirs(out_dir)
        with open(os.path.join(out_dir, "caption.txt"), "w") as f:
            f.write("\n".join(caps))
        for i, m in enumerate(masks):
            with open(os.path.join(out_dir, f"{i}.mask.png"), "wb") as f:
                f.write(png._png_bytes(m))
            back = png._png_decode(open(os.path.join(
                out_dir, f"{i}.mask.png"), "rb").read())
            if not np.array_equal(back[..., 0], m):
                raise AssertionError(f"{i}.mask.png does not read back")
        if not (len(caps) == len(images) and all(
                isinstance(c, str) for c in caps)):
            raise AssertionError(f"captions {caps!r}")
        for img, m in zip(imgs, masks):
            if img.shape != (PPIM_TARGET, PPIM_TARGET, 3) or \
                    m.shape != (PPIM_TARGET, PPIM_TARGET) or \
                    img.dtype != np.uint8 or m.dtype != np.uint8:
                raise AssertionError(f"stage output {img.shape} {m.shape}")
        out["stages_ms"] = wall_ms
        out["images_per_s"] = len(images) / (wall_ms / 1e3)
        log(f"ppim: 18b preprocess_images on the card, {len(images)} "
            f"images to {PPIM_TARGET}px (towers loaded from disk in the "
            f"call, as lora_tpu's are): {wall_ms:.1f} ms, "
            f"{out['images_per_s']:.3f} images/s; captions "
            f"{[c[:60] for c in caps]}; masks and caption.txt written; "
            f"{smi}")

        # 18c: each stage on the card with its tower loaded, warm
        cap_g = blip.BlipCaptioner(dirs["blip"], "cuda")
        seg_g = clipseg.CLIPSegMasker(dirs["clipseg"], "cuda")
        sr_g = swin2sr.Swin2SRUpscaler(dirs["swin2sr"], "cuda")
        g = torch.Generator("cuda").manual_seed(SEED)
        coms = [pre._center_of_mass(m) for m in
                [seg_g.mask(img, c) for img, c in zip(images, caps)]]
        crops = [pre._crop_to_square(img, c) for img, c in zip(images, coms)]
        small = [c for c in crops if c.shape[1] < PPIM_TARGET]
        if not small:
            raise AssertionError("no crop under the target: SR never ran")
        stages = {
            "caption": lambda: [cap_g.caption(img, generator=g)
                                for img in images],
            "mask": lambda: [seg_g.mask(img, c)
                             for img, c in zip(images, caps)],
            "crop": lambda: [pre._crop_to_square(img, c)
                             for img, c in zip(images, coms)],
            "super_resolution": lambda: [sr_g.upscale(c) for c in small],
            "resize": lambda: [pre.resample.resize(
                c, (PPIM_TARGET, PPIM_TARGET), pre.resample.LANCZOS)
                for c in crops],
        }
        stage_ms = {}
        for name, fn in stages.items():
            fn()
            stage_ms[name] = statistics.median(
                sync_time(fn)[1] for _ in range(PPIM_TIMED))
        out["stage_ms"] = stage_ms
        tokens = [len(cap_g.generate(img, generator=torch.Generator(
            "cuda").manual_seed(SEED))[0]) for img in images]
        log(f"ppim: 18c stages on the card, towers loaded, median of "
            f"{PPIM_TIMED} (ms, all {len(images)} images; SR on "
            f"{len(small)} crop(s) {[c.shape[:2] for c in small]}): "
            f"{json.dumps({k: round(v, 3) for k, v in stage_ms.items()})}; "
            f"{len(images) / (sum(stage_ms.values()) / 1e3):.3f} images/s "
            f"through the warm stages; sampled caption lengths {tokens} "
            f"tokens; {smi}")
        # one warm caption of image 0 profiled, cut to PPIM_PROFILE_TOKENS
        # to keep the profiler's pass short: kernels a token and the
        # device's busy share
        t_prof = time.perf_counter()
        got = []
        prof = profile_step(lambda: got.append(cap_g.generate(
            images[0], max_length=PPIM_PROFILE_TOKENS,
            generator=torch.Generator("cuda").manual_seed(SEED))))
        n_tok = int(got[0].shape[1])
        out["caption_profile"] = dict(
            {k: prof[k] for k in ("wall_ms", "device_ms", "launches",
                                  "busy_share")}, tokens=n_tok)
        log(f"ppim: 18c one warm caption of image 0 under torch.profiler "
            f"({n_tok} tokens): wall {prof['wall_ms']:.1f} ms, device "
            f"{prof['device_ms']:.1f} ms over {prof['launches']} kernels "
            f"({prof['launches'] / n_tok:.0f} a token), busy share "
            f"{prof['busy_share']:.3f}; by class "
            f"{json.dumps({k: round(v['ms'], 2) for k, v in prof['by_class'].items()})}"
            f"; profiled in {time.perf_counter() - t_prof:.1f} s")

        # 18d: the card against the port's CPU run of the same weights
        cap_c = blip.BlipCaptioner(dirs["blip"], "cpu")
        img = images[1]
        ids_g = cap_g.generate(img, do_sample=False)
        ids_c = cap_c.generate(img, do_sample=False)
        if not torch.equal(ids_g.cpu(), ids_c):
            raise AssertionError(f"greedy captions differ: card "
                                 f"{ids_g.tolist()} CPU {ids_c.tolist()}")
        lg = blip.caption_logits(cap_g.params, cap_g.pixels([img]), ids_g,
                                 cap_g.cfg).cpu()
        lc = blip.caption_logits(cap_c.params, cap_c.pixels([img]), ids_c,
                                 cap_c.cfg)
        rel = float((lg - lc).abs().max() / lc.abs().max())
        if not rel <= PPIM_BLIP_DEVICE_REL:
            raise AssertionError(f"BLIP logits card against CPU {rel}")
        del cap_c
        seg_c = clipseg.CLIPSegMasker(dirs["clipseg"], "cpu")
        mask_err = [_ppim_levels(seg_c.mask(im, c), seg_g.mask(im, c),
                                 f"CLIPSeg mask {i}")
                    for i, (im, c) in enumerate(zip(images, caps))]
        del seg_c
        sr_c = swin2sr.Swin2SRUpscaler(dirs["swin2sr"], "cpu")
        w, h = PPIM_SR_CHECK
        sr_err = _ppim_levels(sr_c.upscale(images[1][:h, :w]),
                              sr_g.upscale(images[1][:h, :w]),
                              "Swin2SR output")
        out.update(blip_logits_rel=rel, greedy_tokens=int(ids_g.shape[1]),
                   mask_err=mask_err, sr_err=sr_err)
        log(f"ppim: 18d card against CPU: BLIP greedy ids equal "
            f"({ids_g.shape[1]} tokens), logits teacher-forced rel {rel:.3e}"
            f" (limit {PPIM_BLIP_DEVICE_REL}); CLIPSeg masks {mask_err}; "
            f"Swin2SR at {w}x{h} {sr_err} (limits {PPIM_PIXEL_TOL} level, "
            f"{PPIM_PIXEL_OFF_SHARE} of the pixels)")
    finally:
        if env is None:
            os.environ.pop("LORA_TPU_AUX_MODELS", None)
        else:
            os.environ["LORA_TPU_AUX_MODELS"] = env
        shutil.rmtree(root, ignore_errors=True)
    after = {f.__name__: f.launches for f in (
        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, i8.int8_matmul)}
    if after != before:
        raise AssertionError(f"phase 18 launched kernels: {before} -> "
                             f"{after}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ppim: phase 18 in {out['phase_s']:.1f} s, no flash or int8 "
        f"launch (none of its attention shapes passes the flash rule)")
    return out


# phase 19: SD-2.1 768-v at full width (models/config.py SD21_UNET,
# SD21_TEXT, SD21_VAE: the published stabilityai/stable-diffusion-2-1
# configs), 768x768, the v-prediction DDIM schedule of its scheduler config
SD21_SIZE = 768
# the routed self-attentions of one SD-2.1 UNet call at 768px (96x96
# latents) by level, (heads, T = S, D): 320 channels in 5 heads at 96x96
# (down_blocks.0: 2, up_blocks.3: 3) and 640 in 10 at 48x48 (down_blocks.1:
# 2, up_blocks.2: 3); the 24x24 (T = 576) and 12x12 (144) levels and every
# cross-attention (S = 77) fail supported() and take the plain path, as in
# lora_tpu
SD21_ATTN_LEVELS = ((5, 9216, 64), (10, 2304, 64))
SD21_LAUNCHES_BY_LEVEL = {9216: 5, 2304: 5}
SD21_ROUTED_PER_UNET_CALL = sum(SD21_LAUNCHES_BY_LEVEL.values())  # 10
SD21_STEPS = 50          # 19b: bf16 txt2img, 2 prompts, CFG 7.5
SD21_SAMPLER_STEPS = 10  # 19c: each other sampler and image mode
SD21_HTTP_STEPS = 20     # 19e: each of the two requests
SD21_DB_STEPS = 4        # 19f: lora_db in f32 (tf32x3)
SD21_DB_BF16_STEPS = 2   # 19f: lora_db in bf16 (wgmma)
SD21_DB_IMAGES = ((768, 768), (640, 960), (1024, 768))
# int8 launches of one call under quantize_base: the UNet's 16 transformers
# x 12 (q/k/v/out of both attentions, the GEGLU projection, ff out, and
# SD-2's linear proj_in and proj_out, which SD-1.5 runs as 1x1 convs,
# dequantized) and its 22 resnets' time_emb_proj; the 23-layer text
# encoder's 6 a layer; the VAE decoder's mid-block attention
SD21_INT8_PER_CALL = {"unet": 16 * 12 + 22, "clip_encode": 23 * 6,
                      "vae_decode": 4}
# one bf16 UNet call at batch 4 through the flash kernels against the plain
# attention path: both round P to bf16 and store O in bf16, as at SDXL's
# levels (SDXL_FLASH_REL_L2)
SD21_FLASH_REL_L2 = GRAD_REL_L2_TOL
# 19a's timed rows, all at the 96x96 level: the forward at the serving
# batch in bf16 and at the training batch in f32, dQ and dK/dV at the
# training batch in bf16 and f32; the int8 kernel at proj_in there, batch 4
SD21_TIMED_FWD = ((4, 5, 9216, 9216, 64, "bfloat16"),
                  (1, 5, 9216, 9216, 64, "float32"))
SD21_TIMED_BWD = ((1, 5, 9216, 9216, 64, "bfloat16"),
                  (1, 5, 9216, 9216, 64, "float32"))
SD21_INT8_TIMED = (4 * 9216, 320, 320, "bfloat16")


def _sd21_unet_inputs(pipe, batch: int, gen):
    """Random latents (batch, 96, 96, 4), timesteps and a 1024-wide context
    for one SD-2.1 UNet call, in the pipe's dtype."""
    cfg = pipe.unet.cfg
    side = SD21_SIZE // 8
    lat = torch.randn((batch, side, side, cfg.in_channels), generator=gen,
                      device="cuda")
    ctx = torch.randn((batch, 77, cfg.cross_attention_dim), generator=gen,
                      device="cuda")
    return (lat.to(pipe.dtype), torch.full((batch,), 501, device="cuda"),
            ctx.to(pipe.dtype))


def _sd21_unet(pipe, inputs) -> torch.Tensor:
    """One UNet call with the pipe's LoRA (none when it has none)."""
    lat, t, ctx = inputs
    with torch.inference_mode():
        return pipe.unet(lat, t, ctx, lora=pipe.lora_unet)


def phase_sd21(smi: str) -> dict:
    """Phase 19: SD-2.1 768-v at full width, random weights from the seed,
    the v-prediction schedule. 19b a bf16 txt2img request with a LoRA and
    TI, one UNet call with flash on against off and one profiled; 19c every
    other sampler, img2img and blend inpaint; 19d quantize_base; 19e two
    requests through a PipelineServer; 19f lora_db on an fp16 SD-2.1
    directory, f32 and bf16. Every flash launch (forward with its layout,
    dQ, dK/dV) and int8 shape is recorded for 19a (sd21_kernel_rows), which
    checks each against its plain version after the build. Returns the
    requests, the launches by path and the recorded shapes."""
    from lora_tpu_torch import serve
    from lora_tpu_torch.cli import lora_db
    from lora_tpu_torch.models import schedulers
    from lora_tpu_torch.models.config import SD21_TEXT, SD21_UNET, SD21_VAE
    from lora_tpu_torch.models.hf_import import save_pipeline_params
    from lora_tpu_torch.ops.attention import (
        set_use_memory_efficient_attention,
    )
    from lora_tpu_torch.pipelines.sd import (
        StableDiffusionPipeline,
        _latent_mask,
    )

    t_phase = time.perf_counter()
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0

    def gen(offset):
        return torch.Generator("cuda").manual_seed(SEED + offset)

    report, out = {}, {}
    totals = {"flash_fwd": dict.fromkeys(fa.flash_fwd.launches_by_kernel, 0),
              "int8_matmul": dict.fromkeys(
                  i8.int8_matmul.launches_by_kernel, 0)}
    counted = functools.partial(counted_request, report, "sd21",
                                per_call=SD21_ROUTED_PER_UNET_CALL,
                                totals=totals)
    flash = {w: collections.Counter() for w in FLASH_WRAPPERS}
    root = tempfile.mkdtemp(prefix="sd21_")
    try:
        with recording_flash_shapes(set()) as layouts, \
                recording_launch_shapes(flash), \
                recording_int8_shapes(set()) as int8_seen:
            # 19b: the bf16 pipeline with a LoRA and TI at 0.8
            t0 = time.perf_counter()
            pipe = StableDiffusionPipeline.random_init(
                gen(0), "cuda", dtype=torch.bfloat16, unet_cfg=SD21_UNET,
                text_cfg=SD21_TEXT, vae_cfg=SD21_VAE)
            # the published scheduler config: DDIM, scaled_linear
            # 0.00085-0.012, steps_offset 1, set_alpha_to_one false; and the
            # UNet config's upcast_attention, which the directory keeps
            pipe.schedule = schedulers.make_schedule(
                prediction_type="v_prediction")
            pipe.unet.upcast_attention = True
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            # the directory 19f trains on: the base as initialised
            t1 = time.perf_counter()
            model = os.path.join(root, "model")
            save_pipeline_params(pipe, model, fp16=True)
            inst = _instance_pngs(os.path.join(root, "instance"),
                                  SD21_DB_IMAGES, SEED + 19)
            part("19f inputs", t1)
            t0 = time.perf_counter() - init_s
            path = os.path.join(root, "lora.safetensors")
            _random_lora_file(pipe, path, gen(1))
            embeds = pipe.patch_pipe(path)
            pipe.tune_lora_scale(0.8)
            if list(embeds) != ["<s1>"] or pipe.lora_unet is None:
                raise AssertionError(f"19b: patch_pipe loaded {list(embeds)}")
            torch.cuda.synchronize()
            out["sizes"] = {m: {"params": sum(t.numel()
                                              for t in mod.parameters()),
                                "bytes": _param_bytes(mod)}
                            for m, mod in (("unet", pipe.unet),
                                           ("text_encoder", pipe.text_encoder),
                                           ("vae", pipe.vae))}
            log("sd21: 19b: " + json.dumps({"init_s": init_s,
                                            "by_model": out["sizes"]}))
            size = dict(height=SD21_SIZE, width=SD21_SIZE)
            pipe(PROMPTS, num_inference_steps=2, generator=gen(2), **size)
            images = counted(
                "19b txt2img", SD21_STEPS,
                lambda: pipe(PROMPTS, num_inference_steps=SD21_STEPS,
                             guidance_scale=7.5, generator=gen(2), **size))
            bwd = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
            if bwd != (0, 0):
                raise AssertionError(f"19b: serving launched backward "
                                     f"kernels {bwd}")
            _check_images(images, len(PROMPTS), "19b", SD21_SIZE)
            inputs = _sd21_unet_inputs(pipe, 2 * len(PROMPTS), gen(3))
            with recording_flash_shapes(collections.Counter()) as calls:
                flash_on = counted("19b unet call", 1,
                                   lambda: _sd21_unet(pipe, inputs))
            if _by_T(calls) != SD21_LAUNCHES_BY_LEVEL:
                raise AssertionError(f"19b: a UNet call launched flash_fwd "
                                     f"{_by_T(calls)} times by T")
            set_use_memory_efficient_attention(False)
            try:
                _zero_counts()
                flash_off = _sd21_unet(pipe, inputs)
                torch.cuda.synchronize()
                off_launches = fa.flash_fwd.launches
            finally:
                set_use_memory_efficient_attention(True)
            rel = _rel_l2(flash_on, flash_off)
            profile = profile_step(lambda: _sd21_unet(pipe, inputs))
            out["txt2img"] = {
                **report["19b txt2img"], "flash_vs_plain_rel_l2": rel,
                "limit": SD21_FLASH_REL_L2,
                "unet_call": {k: profile[k] for k in (
                    "wall_ms", "device_ms", "launches", "busy_share",
                    "by_class")}}
            log("sd21: 19b: " + json.dumps(out["txt2img"]))
            if off_launches or not (np.isfinite(rel)
                                    and rel <= SD21_FLASH_REL_L2):
                raise AssertionError(
                    f"19b: the UNet call through flash is {rel} (relative "
                    f"L2) from the plain path, limit {SD21_FLASH_REL_L2} "
                    f"({off_launches} flash launches with flash off)")
            ref_unet = flash_on
            del flash_off
            part("19b", t0)

            # 19c: every other sampler, img2img and blend inpaint
            t0 = time.perf_counter()
            kw = dict(num_inference_steps=SD21_SAMPLER_STEPS,
                      guidance_scale=7.5)
            for sched in MODE_SAMPLERS:
                images = counted(
                    f"19c txt2img {sched}",
                    SD21_SAMPLER_STEPS + (sched == "pndm"),
                    lambda: pipe(PROMPTS, generator=gen(4), scheduler=sched,
                                 **size, **kw))
                _check_images(images, len(PROMPTS), f"19c {sched}", SD21_SIZE)
            image, mask = _mode_inputs(len(PROMPTS), gen(5), SD21_SIZE)
            calls = int(SD21_SAMPLER_STEPS * MODE_STRENGTH)
            images = counted("19c img2img ddim", calls,
                             lambda: pipe.img2img(PROMPTS, image,
                                                  strength=MODE_STRENGTH,
                                                  generator=gen(6), **kw))
            _check_images(images, len(PROMPTS), "19c img2img", SD21_SIZE)
            images, lat, z0 = counted(
                "19c inpaint_blend euler_a", calls,
                lambda: pipe.inpaint_blend(
                    PROMPTS, image, mask, strength=MODE_STRENGTH,
                    generator=gen(7), scheduler="euler_a",
                    return_latents=True, **kw))
            _check_images(images, len(PROMPTS), "19c inpaint_blend",
                          SD21_SIZE)
            keep = (_latent_mask(mask, SD21_SIZE // 8, SD21_SIZE // 8,
                                 torch.float32) == 0).expand(lat.shape)
            if not torch.equal(lat[keep], z0[keep]) or not (
                    lat[~keep].float() - z0[~keep].float()).abs().max() > 0:
                raise AssertionError("19c: the blend's kept region is not "
                                     "z0, or the repainted region did not "
                                     "move")
            del images, lat, z0, image, mask
            part("19c", t0)

            # 19d: quantize_base: a UNet call and a text encode, counted
            t0 = time.perf_counter()
            pipe.quantize_base()
            torch.cuda.empty_cache()
            per_call = {"unet": _int8_dense(pipe.unet),
                        "clip_encode": _int8_dense(pipe.text_encoder),
                        "vae_decode": _int8_dense(pipe.vae, "decoder.")}
            proj = [_int8_dense(pipe.unet, f"down_blocks.0.attentions.0."
                                           f"{n}") for n in ("proj_in",
                                                             "proj_out")]
            if per_call != SD21_INT8_PER_CALL or proj != [1, 1]:
                raise AssertionError(f"19d: 2-D int8 weights per call "
                                     f"{per_call}, proj_in/out {proj}")
            int8_out = counted(
                "19d unet call int8", 1, lambda: _sd21_unet(pipe, inputs),
                int8_want=lambda: SD21_INT8_PER_CALL["unet"])
            counted("19d text encode int8", 0,
                    lambda: pipe.encode_prompt(PROMPTS),
                    int8_want=lambda: SD21_INT8_PER_CALL["clip_encode"])
            quant_rel = _rel_l2(int8_out, ref_unet)
            out["int8"] = {"per_call": per_call,
                           "unet_call_rel_l2_vs_bf16": quant_rel,
                           "limit": QUANT_UNET_REL_L2_TOL,
                           "param_bytes": {
                               m: _param_bytes(getattr(pipe, m))
                               for m in ("unet", "text_encoder", "vae")}}
            log("sd21: 19d: " + json.dumps(out["int8"]))
            if not (np.isfinite(quant_rel)
                    and quant_rel <= QUANT_UNET_REL_L2_TOL):
                raise AssertionError(f"19d: the int8 UNet call is "
                                     f"{quant_rel} from bf16")
            del int8_out, ref_unet, flash_on
            part("19d", t0)

            # 19e: the quantized pipe behind a PipelineServer, two requests
            t0 = time.perf_counter()
            out["http"] = _sd21_http(serve, pipe, counted)
            part("19e", t0)

            # 19f: lora_db on the SD-2.1 directory at 768px, v target
            t0 = time.perf_counter()
            os.environ["LORA_TPU_ALLOW_HASHED_TOKENIZER"] = "1"
            out["lora_db"] = _sd21_lora_db(lora_db, schedulers, model, inst,
                                           root)
            out["lora_db"]["patched"] = _sd21_patched(
                pipe, out["lora_db"]["file"], inputs)
            log("sd21: 19f: " + json.dumps(out["lora_db"]))
            part("19f", t0)
            del pipe, inputs
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train = out["lora_db"]["launches"]
    out.update(
        requests=report,
        layouts=layouts, int8_shapes=int8_seen,
        launch_shapes={w: dict(c) for w, c in flash.items()},
        launches={"sd21": {"flash_fwd": totals["flash_fwd"],
                           "int8_matmul": totals["int8_matmul"]},
                  "sd21_train": train["f32"],
                  "sd21_train_bf16": train["bf16"]},
        phase_s=time.perf_counter() - t_phase, part_s=parts)
    log("sd21: " + json.dumps({
        "phase_s": out["phase_s"], "part_s": parts,
        "launches": out["launches"], "card": smi}))
    return out


def _sd21_http(serve, pipe, counted) -> dict:
    """19e: two requests of both prompts (SD21_HTTP_STEPS steps, 768px) to
    a PipelineServer on the quantized pipe (max_batch 2: the UNet at batch
    4): each answered with two 768x768 PNGs and exactly the int8 launches
    its weights imply; the second served its embeddings from the cache
    (1024 wide), so it encodes nothing."""
    encodes = [0]
    encode_prompt = pipe.encode_prompt

    def counted_encode(prompts):
        encodes[0] += 1
        return encode_prompt(prompts)

    pipe.encode_prompt = counted_encode
    srv = serve.PipelineServer(pipe, port=0, max_batch=2).start()
    out = {}
    try:
        for i in range(2):
            encodes[0] = 0
            body = counted(
                f"19e http {i + 1}", SD21_HTTP_STEPS,
                lambda: _http(srv.port, "/generate", {
                    "prompt": PROMPTS, "steps": SD21_HTTP_STEPS,
                    "guidance": 7.5, "height": SD21_SIZE,
                    "width": SD21_SIZE, "seed": 5 + i})[1],
                int8_want=lambda: (
                    SD21_INT8_PER_CALL["unet"] * SD21_HTTP_STEPS
                    + SD21_INT8_PER_CALL["clip_encode"] * encodes[0]
                    + SD21_INT8_PER_CALL["vae_decode"]))
            _check_pngs(body["images"], len(PROMPTS), SD21_SIZE)
            out[f"request_{i + 1}"] = {"latency_ms": body["latency_ms"],
                                       "clip_encodes": encodes[0]}
        widths = sorted({tuple(e.shape) for e in srv._embeds.values()})
        out.update(embed_widths=widths, metrics=srv.metrics())
        if out["request_2"]["clip_encodes"] != 0 or widths != [
                (77, pipe.text_encoder.cfg.hidden_size)]:
            raise AssertionError(f"19e: the embed cache: {out}")
        if srv.drain(timeout=60) is not True:
            raise AssertionError("19e: the server did not drain")
    finally:
        srv.stop()
        pipe.encode_prompt = encode_prompt
    log("sd21: 19e: " + json.dumps(out))
    return out


def _sd21_lora_db(lora_db, schedulers, model: str, inst: str,
                  root: str) -> dict:
    """19f: cli.lora_db.train on the fp16 SD-2.1 directory at 768px:
    SD21_DB_STEPS steps in f32 (the trainer's default: the tf32x3 kernels)
    with the text encoder, and SD21_DB_BF16_STEPS in bf16 (wgmma); every
    step's loss against the v target (get_velocity counted) and
    SD21_ROUTED_PER_UNET_CALL forward, dQ and dK/dV launches a step."""
    common = dict(instance_data_dir=inst, instance_prompt="a photo of sks dog",
                  resolution=SD21_SIZE, lora_rank=TRAINER_RANK, seed=SEED,
                  learning_rate=1e-4, output_format="safe", save_steps=0)
    velocity = schedulers.get_velocity
    targets = [0]

    def counted_velocity(*a):
        targets[0] += 1
        return velocity(*a)

    out = {"launches": {}}
    schedulers.get_velocity = counted_velocity
    try:
        for name, steps, extra in (
                ("f32", SD21_DB_STEPS, dict(train_text_encoder=True)),
                ("bf16", SD21_DB_BF16_STEPS, dict(mixed_precision="bf16",
                                                  cached_latents=True))):
            run = os.path.join(root, f"run_{name}")
            targets[0] = 0
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _zero_trainer_counts()
            t0 = time.perf_counter()
            with timing_trainer_steps({}) as rec:
                res = lora_db.train(model, device="cuda", output_dir=run,
                                    max_train_steps=steps,
                                    **dict(common, **extra))
            torch.cuda.synchronize()
            _check_trainer_result(res, steps, f"19f {name}")
            got = _launches()
            route = "tf32x3" if name == "f32" else "wgmma"
            n = SD21_ROUTED_PER_UNET_CALL * steps
            want = {"flash_fwd": _only(route, n),
                    "flash_bwd_dq": _only(route, n, fa.flash_bwd_dq),
                    "flash_bwd_dkv": _only(route, n, fa.flash_bwd_dkv),
                    "adam8bit": 0}
            if got != want or targets[0] != steps:
                raise AssertionError(f"19f {name}: launched {got}, not "
                                     f"{want}; {targets[0]} v targets for "
                                     f"{steps} steps")
            out["launches"][name] = got
            step_ms = _step_ms(rec, 1)
            out[name] = {"steps": res["steps"], "v_targets": targets[0],
                         "wall_s": time.perf_counter() - t0,
                         "step_ms_median": statistics.median(step_ms),
                         "step_ms": step_ms,
                         "peak_mem_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30,
                         "losses": [float(x) for x in rec["losses"]],
                         "final_loss": res["final_loss"]}
            if not all(np.isfinite(out[name]["losses"])):
                raise AssertionError(f"19f {name}: losses "
                                     f"{out[name]['losses']}")
        out["file"] = os.path.join(root, "run_f32", "lora_weight.safetensors")
    finally:
        schedulers.get_velocity = velocity
    return out


def _sd21_patched(pipe, path: str, inputs) -> dict:
    """19f's f32 LoRA file through patch_pipe on the quantized pipe: one
    UNet call at batch 4, finite and apart from the call without it."""
    pipe.remove_lora()
    plain = _sd21_unet(pipe, inputs)
    pipe.patch_pipe(path)
    lora = _sd21_unet(pipe, inputs)
    pipe.remove_lora()
    moved = (lora.float() - plain.float()).abs().max().item()
    if not torch.isfinite(lora).all() or not moved > 0.0:
        raise AssertionError(f"19f: the UNet call with {path} is not finite "
                             f"or equals the call without it ({moved})")
    return {"unet_max_abs_change": moved}


def sd21_kernel_rows(sd21: dict) -> dict:
    """19a: every flash forward layout, dQ and dK/dV shape and int8 shape
    phase 19 ran, against its plain version (after the build: the checks
    call the mma kernels beside the routed ones); the forward timed at the
    serving batch in bf16 and the training batch in f32, the backward at
    the training batch in bf16 and f32, at the 96x96 level (T = 9216), and
    the int8 kernel at proj_in there."""
    gen = torch.Generator("cuda").manual_seed(SEED + 19)
    fwd = [check_kernel(*key[:5], getattr(torch, key[5]), gen,
                        timed=key[:6] in SD21_TIMED_FWD)
           for key in sorted(sd21["layouts"])]
    unchecked = sd21["layouts"] - {_row_key(r) for r in fwd}
    if unchecked:
        raise AssertionError(f"phase 19 ran flash_fwd at layouts 19a did "
                             f"not check: {sorted(unchecked)}")
    shapes = sd21["launch_shapes"]
    bwd_keys = sorted(set(shapes["flash_bwd_dq"])
                      | set(shapes["flash_bwd_dkv"]))
    bwd = [check_bwd_kernels(*key[:5], getattr(torch, key[5]), gen,
                             timed=key in SD21_TIMED_BWD)
           for key in bwd_keys]
    int8 = [check_int8(M, K, N, getattr(torch, dt), gen,
                       timed=(M, K, N, dt) == SD21_INT8_TIMED)
            for M, K, N, dt in sorted(sd21["int8_shapes"])]
    if not set(SD21_TIMED_FWD) <= {k[:6] for k in sd21["layouts"]} or \
            not set(SD21_TIMED_BWD) <= set(bwd_keys) or \
            SD21_INT8_TIMED not in sd21["int8_shapes"]:
        raise AssertionError("phase 19 did not run a timed shape of 19a")
    log(f"sd21: 19a: flash_fwd ran {len(fwd)} layouts, dQ and dK/dV "
        f"{len(bwd)} shapes, int8_matmul {len(int8)} shapes, each checked "
        f"against its plain version")
    return {"fwd_rows": fwd, "bwd_rows": bwd, "int8_rows": int8}


def add_sd21_launches(kernels: list, sd21: dict, rows: dict) -> None:
    """Each flash and int8 row of the kernels line gains phase 19's
    launches of its kernel ("sd21": 19b-19e, bf16 serving; "sd21_train":
    19f in f32; "sd21_train_bf16": 19f in bf16) and the timed 19a row of
    its kernel at the 96x96 level ("sd21_768")."""
    routes = {**FLASH_ROW_ROUTES,
              "int8_matmul": ("int8_matmul", "wgmma"),
              "int8_matmul_wgmma_f32": ("int8_matmul", "wgmma_f32"),
              "int8_matmul_mma": ("int8_matmul", "mma")}
    for row in kernels:
        if row["name"] not in routes:
            continue
        wrapper, route = routes[row["name"]]
        for path, launches in sd21["launches"].items():
            n = launches.get(wrapper, {}).get(route, 0)
            row["launches"] += n
            row["launches_by_path"][path] = n
        if wrapper == "flash_fwd":
            timed = [r for r in rows["fwd_rows"]
                     if "ms" in r and r["kernel"] == [route]]
            keys = ("B", "H", "T", "D", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "err_o")
        elif wrapper == "int8_matmul":
            timed = [r for r in rows["int8_rows"]
                     if "ms" in r and r["kernel"] == [route]]
            keys = ("M", "K", "N", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "rel")
        else:
            p = "dq_" if wrapper == "flash_bwd_dq" else "dkv_"
            rkey = "dq_route" if wrapper == "flash_bwd_dq" else "route"
            timed = [r for r in rows["bwd_rows"]
                     if p + "ms" in r and r[rkey] == route]
            keys = ("B", "H", "T", "D", "dtype") + tuple(
                p + k for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by")) + ("library_ms",) + (
                ("rel_dq",) if p == "dq_" else ("rel_dk", "rel_dv"))
        if timed:
            row["sd21_768"] = [{k: r[k] for k in keys if k in r}
                               for r in timed]


def check_recorded(flash_seen, rows, int8_seen, int8_rows) -> None:
    """Every flash forward call and int8 call recorded on the main paths was
    checked against its plain version: its shapes (and for flash, dtype and
    strides) are those of a row of phase 3 and phase 8."""
    unchecked = int8_seen - {(r["M"], r["K"], r["N"], r["dtype"])
                             for r in int8_rows}
    if unchecked:
        raise AssertionError(f"quantized serving ran int8_matmul at shapes "
                             f"phase 8 did not check: {sorted(unchecked)}")
    unchecked = flash_seen - {_row_key(r) for r in rows}
    if unchecked:
        raise AssertionError(f"the main paths ran flash_fwd at shapes or "
                             f"layouts phase 3 did not check: "
                             f"{sorted(unchecked)}")
    log(f"flash_fwd: the main paths ran {len(flash_seen)} shapes and "
        f"layouts, each checked in phase 3; int8_matmul {len(int8_seen)} "
        f"shapes, each checked in phase 8")


def main_modes() -> int:
    """Phases 1, 2 (the sources the phase runs and flash_fwd.cu, which
    phase 3 calls beside the wgmma kernel) and 10; then phase 3's bf16 UNet
    calls and phase 8's bf16 shapes, untimed, and every shape phase 10
    reached checked against them."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "int8_matmul",
                 "int8_matmul_wgmma"])
    with recording_flash_shapes(set()) as flash_seen, \
            recording_int8_shapes(set()) as int8_seen:
        phase_modes(smi)
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [check_kernel(B, 8, T, T, D, torch.bfloat16, gen, timed=False)
            for B in FLASH_TIMED_BATCHES + FLASH_OTHER_BATCHES
            for T, D in SD15_ATTN_SHAPES]
    int8_rows = [check_int8(M, K, N, torch.bfloat16, gen, timed=False)
                 for M, K, N in int8_path_shapes() + int8_phase_shapes()]
    check_recorded(flash_seen, rows, int8_seen, int8_rows)
    log(smi)
    return 0


def main_adapters() -> int:
    """Phases 1, 2 (the sources phase 11 runs, and flash_fwd.cu, which
    phase 3 calls beside the wgmma and tf32x3 kernels), the tf32x3 forward
    kernel's first calls in a child process, and 11; then phase 3's UNet
    calls (bf16 at every batch, f32 at batch 4) and phase 8's bf16 shapes,
    untimed, and every shape phase 11 reached checked against them."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3",
                 "int8_matmul", "int8_matmul_wgmma"])
    tf32x3_fwd_probe()
    with recording_flash_shapes(set()) as flash_seen, \
            recording_int8_shapes(set()) as int8_seen:
        phase_adapters(smi)
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [check_kernel(B, 8, T, T, D, torch.bfloat16, gen, timed=False)
            for B in FLASH_TIMED_BATCHES + FLASH_OTHER_BATCHES
            for T, D in SD15_ATTN_SHAPES]
    rows += [check_kernel(4, 8, T, T, D, torch.float32, gen, timed=False)
             for T, D in SD15_ATTN_SHAPES]
    int8_rows = [check_int8(M, K, N, torch.bfloat16, gen, timed=False)
                 for M, K, N in int8_path_shapes()]
    check_recorded(flash_seen, rows, int8_seen, int8_rows)
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    """The int8 kernels alone: the device line, their three builds, the f32
    wgmma kernel's first calls in a child process under a timeout, phase 8
    with its per-call sums, and with `tiles` every tile instance of both
    wgmma kernels and their fitted time models."""
    smi = phase_device()
    phase_build(["int8_matmul", "int8_matmul_wgmma", "int8_matmul_wgmma_f32"])
    int8_f32_probe()
    int8_call_sums(phase_int8_kernels())
    if tiles:
        int8_tile_sweep(int8_path_shapes() + int8_phase_shapes())
    log(smi)
    return 0


def main() -> int:
    t0 = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"time: {what} done at {time.perf_counter() - t0:.1f} s")

    smi = phase_device()
    # nvcc builds every source beside the phases that launch none of the
    # mma backward kernels (flash_bwd.cu, the build's longest): 18 (no
    # kernel of the port), 19 (SD-2.1; checked in 19a), 3 and 8 (the
    # forward and int8 kernels against their plain versions) and the
    # serving paths 5 and 9-11; each waits only for the libraries it
    # launches
    with building_in_background():
        phase_ppim(smi)
        stamp("phase 18")
        sd21_run = phase_sd21(smi)
        stamp("phase 19")
        rows = phase_kernels()
        fwd_sums = flash_call_sums(rows)
        int8_rows = phase_int8_kernels()
        int8_sums = int8_call_sums(int8_rows)
        stamp("phases 3, 8")
        with recording_flash_shapes(set()) as flash_seen:
            serve_fwd, bf16_request_s = phase_slice(smi)
            with recording_int8_shapes(set()) as seen:
                f32_launches, f32_fwd = phase_serve_int8_f32(smi)
                int8_launches, serve_int8_fwd = phase_serve_int8(
                    smi, bf16_request_s)
                modes_fwd, modes_int8 = phase_modes(smi)
                adapters_fwd, adapters_f32, adapters_int8 = \
                    phase_adapters(smi)
        stamp("phases 5, 9-11")
    phase_build()  # built by now: ptxas's report and the tiles
    stamp("build")
    with probes_together():
        int8_f32_probe()
        tf32x3_fwd_probe()
        dq_probe()
        dkv_probe()
        tf32x3_dq_probe()
        tf32x3_probe()
        tf32x3_wide_dq_probe()
        tf32x3_wide_probe()
    stamp("probes")
    bwd_rows = phase_bwd_kernels()
    bwd_sums = bwd_step_sums(bwd_rows)
    sd21_rows = sd21_kernel_rows(sd21_run)
    stamp("phases 4, 19a")
    with recording_flash_shapes(flash_seen):
        train_launches, train_fwd, train_dq, train_dkv = phase_train(smi)
        phase_grad()
        _zero_counts()  # the counted f32 training run
        grad_f32 = phase_grad(torch.float32)
    check_recorded(flash_seen, rows, seen, int8_rows)
    stamp("phases 6-7")
    # phase 12's inputs and class images outlive it: phase 17 reuses them
    sd_root = tempfile.mkdtemp(prefix="lora_db_")
    trainer = phase_trainer(smi, rows, bwd_rows, sd_root)
    stamp("phase 12")
    pti = phase_pti(smi, rows, bwd_rows)
    stamp("phase 13")
    sdxl = phase_sdxl(smi)
    stamp("phase 14")
    # phase 15's SDXL directory outlives it: phase 16b distills against it
    xl_root = tempfile.mkdtemp(prefix="sdxl_model_")
    try:
        xl_dir = os.path.join(xl_root, "model")
        sdxl_train = phase_sdxl_train(smi, xl_dir)
        stamp("phase 15")
        tools = phase_tools(smi, xl_dir)
        stamp("phase 16")
    finally:
        shutil.rmtree(xl_root, ignore_errors=True)
    check_tools_shapes(tools, rows)
    try:
        dist = phase_dist(smi, sd_root,
                          trainer["counted"]["step_losses"])
    finally:
        shutil.rmtree(sd_root, ignore_errors=True)
    stamp("phase 17")
    # the trainer's launches by wrapper: f32 (12c and 12d), bf16 (12e)
    trainer_f32 = _added_launches(trainer["counted"]["launches"],
                                  trainer["resumed"]["launches"])
    trainer_bf16 = trainer["bf16"]["launches"]

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
               "serve_int8": serve_int8_fwd, "modes": modes_fwd,
               "adapters": adapters_fwd,
               "trainer_bf16": trainer_bf16["flash_fwd"]}
    fwd_by_kernel = {r: sum(c[r] for c in by_path.values())
                     for r in fa.flash_fwd.launches_by_kernel}
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/flash_fwd_wgmma.cu",
        "replaces": "lora_tpu/ops/flash_attention.py:104",
        # the serving run (50 UNet calls), the timed training steps, the
        # two quantized HTTP requests (50 UNet calls each), phase 10's
        # samplers and image modes and phase 11's HTTP requests: all bf16,
        # all through the wgmma kernel (each phase checks it)
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
    # the f32 forward: the f32 quantized UNet call of phase 9a, the
    # counted f32 training run of phase 7 (f32 attention) and phase 11's
    # f32 UNet call with L
    f32_by_path = {"serve_int8_f32": f32_fwd,
                   "train_f32_grad": grad_f32["fwd_launches_by_kernel"],
                   "adapters_f32": adapters_f32,
                   "trainer": trainer_f32["flash_fwd"]}
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
        "launches": (train_dq["wgmma"]
                     + trainer_bf16["flash_bwd_dq"]["wgmma"]),
        "launches_by_path": {
            "train": train_dq["wgmma"],
            "trainer_bf16": trainer_bf16["flash_bwd_dq"]["wgmma"]},
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
        "launches": (f32_dq["tf32x3"]
                     + trainer_f32["flash_bwd_dq"]["tf32x3"]),
        "launches_by_path": {
            "train_f32_grad": f32_dq["tf32x3"],
            "trainer": trainer_f32["flash_bwd_dq"]["tf32x3"]},
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
        "launches": (f32_dq["tf32x3_wide"]
                     + trainer_f32["flash_bwd_dq"]["tf32x3_wide"]),
        "launches_by_path": {
            "train_f32_grad": f32_dq["tf32x3_wide"],
            "trainer": trainer_f32["flash_bwd_dq"]["tf32x3_wide"]},
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
        "launches": (f32_dq["mma"] + train_dq["mma"]
                     + trainer_f32["flash_bwd_dq"]["mma"]
                     + trainer_bf16["flash_bwd_dq"]["mma"]),
        "launches_by_path": {
            "train_f32_grad": f32_dq["mma"], "train": train_dq["mma"],
            "trainer": trainer_f32["flash_bwd_dq"]["mma"],
            "trainer_bf16": trainer_bf16["flash_bwd_dq"]["mma"]},
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
        "launches": (train_dkv["wgmma"]
                     + trainer_bf16["flash_bwd_dkv"]["wgmma"]),
        "launches_by_path": {
            "train": train_dkv["wgmma"],
            "trainer_bf16": trainer_bf16["flash_bwd_dkv"]["wgmma"]},
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
        "launches": (f32_dkv["tf32x3"]
                     + trainer_f32["flash_bwd_dkv"]["tf32x3"]),
        "launches_by_path": {
            "train_f32_grad": f32_dkv["tf32x3"],
            "trainer": trainer_f32["flash_bwd_dkv"]["tf32x3"]},
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
        "launches": (f32_dkv["tf32x3_wide"]
                     + trainer_f32["flash_bwd_dkv"]["tf32x3_wide"]),
        "launches_by_path": {
            "train_f32_grad": f32_dkv["tf32x3_wide"],
            "trainer": trainer_f32["flash_bwd_dkv"]["tf32x3_wide"]},
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
        "launches": (f32_dkv["mma"] + train_dkv["mma"]
                     + trainer_f32["flash_bwd_dkv"]["mma"]
                     + trainer_bf16["flash_bwd_dkv"]["mma"]),
        "launches_by_path": {
            "train_f32_grad": f32_dkv["mma"], "train": train_dkv["mma"],
            "trainer": trainer_f32["flash_bwd_dkv"]["mma"],
            "trainer_bf16": trainer_bf16["flash_bwd_dkv"]["mma"]},
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
    # the int8 launches of both counted quantized paths, by kernel: bf16
    # serving (all wgmma) and the f32 UNet call and CLIP encode (phase 9a)
    int8_by_path = {"serve_int8": _only("wgmma", int8_launches,
                                        i8.int8_matmul),
                    "serve_int8_f32": f32_launches,
                    "modes_http": modes_int8,
                    "adapters_http": adapters_int8}
    int8_by_kernel = {k: sum(c[k] for c in int8_by_path.values())
                      for k in i8.int8_matmul.launches_by_kernel}

    def routed_err(dtype, kernel):  # worst error of phase 8's calls
        return max(r["err"] for r in int8_rows
                   if r["dtype"] == dtype and r["kernel"] == [kernel])

    kernels.append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/int8_matmul_wgmma.cu",
        "replaces": "lora_tpu/ops/int8_matmul.py:35",
        # quantized serving: request A and request B, phase 10's img2img
        # and inpaint requests and phase 11's quantized request, every
        # bf16 call (all of them wgmma), at shapes phase 8 checked
        "launches": (int8_launches + modes_int8["wgmma"]
                     + adapters_int8["wgmma"]),
        "launches_by_path": {"serve_int8": int8_launches,
                             "modes_http": modes_int8["wgmma"],
                             "adapters_http": adapters_int8["wgmma"]},
        "launches_by_kernel": int8_by_kernel,
        # worst error over the bf16 calls of phase 8 through wgmma
        "max_abs_err": routed_err("bfloat16", "wgmma"),
        # median per launch at the GEGLU projection at 64x64, bf16, through
        # the kernel's C entry point; prev: the mma kernel the same way on
        # the same inputs; library: cuBLAS F.linear on the dequantized bf16
        # weight
        **timed(main_int8["bfloat16"]),
        "device_ms": main_int8["bfloat16"]["device_ms"],
        "prev_ms": main_int8["bfloat16"]["prev_ms"],
        "library_ms": main_int8["bfloat16"]["library_ms"],
        # every column summed over the 182 launches of one UNet call at
        # batch 4 (each launch timed alone, host launch path included)
        "per_unet_call": {k: v for k, v in int8_sums.items()
                          if not k.startswith("f32_")},
    })
    kernels.append({
        "name": "int8_matmul_wgmma_f32",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/int8_matmul_wgmma_f32.cu",
        "replaces": "lora_tpu/ops/int8_matmul.py:35",
        # the f32 quantized UNet call and CLIP encode of phase 9a (f32 x)
        "launches": f32_launches["wgmma_f32"],
        "launches_by_path": {"serve_int8_f32": f32_launches["wgmma_f32"]},
        # worst error over the f32 calls of phase 8 through wgmma_f32
        "max_abs_err": routed_err("float32", "wgmma_f32"),
        # at the GEGLU projection at 64x64, f32 x, through the C entry
        # point; device: CUDA-graph replay; prev: the mma kernel on the same
        # inputs; library: F.linear in f32 (TF32 off)
        **timed(main_int8["float32"]),
        "device_ms": main_int8["float32"]["device_ms"],
        "wrapper_ms": main_int8["float32"]["wrapper_ms"],
        "prev_ms": main_int8["float32"]["prev_ms"],
        "prev_device_ms": main_int8["float32"]["prev_device_ms"],
        "library_ms": main_int8["float32"]["library_ms"],
        "library_device_ms": main_int8["float32"]["library_device_ms"],
        "per_unet_call": {k: v for k, v in int8_sums.items()
                          if k.startswith("f32_")},
    })
    kernels.append({
        "name": "int8_matmul_mma",
        "route": "cuda",
        "source": "lora_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "lora_tpu/ops/int8_matmul.py:35",
        # no call of either quantized path takes it (K % 16, N % 8 and
        # unaligned bases only); phase 8's calls routed to it
        "launches": int8_by_kernel["mma"],
        "launches_by_path": {p: c["mma"] for p, c in int8_by_path.items()},
        "launches_in_checks": sum(r["kernel"] == ["mma"] for r in int8_rows),
        # worst error of the calls routed to it and of it called directly
        # beside the wgmma kernels (both dtypes)
        "max_abs_err": max(routed_err("bfloat16", "mma"),
                           routed_err("float32", "mma"),
                           max(r["err_prev"] for r in int8_rows
                               if "err_prev" in r)),
        # at the GEGLU projection at 64x64, f32 x, called directly on the
        # f32 wgmma kernel's inputs; library: F.linear in f32
        "ms": main_int8["float32"]["prev_ms"],
        "device_ms": main_int8["float32"]["prev_device_ms"],
        "plain_ms": main_int8["float32"]["plain_ms"],
        "bound_ms": main_int8["float32"]["bound_ms"],
        "bound_by": main_int8["float32"]["bound_by"],
        "library_ms": main_int8["float32"]["library_ms"],
    })
    kernels.append(adam8bit_kernel_row(trainer))
    add_pti_launches(kernels, pti)
    add_sdxl_launches(kernels, sdxl)
    add_sdxl_train_launches(kernels, sdxl_train)
    add_tools_launches(kernels, tools)
    add_dist_launches(kernels, dist)
    add_sd21_launches(kernels, sd21_run, sd21_rows)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


SD21_STEMS = ("flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3", "flash_bwd",
              "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
              "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3", "int8_matmul",
              "int8_matmul_wgmma")


def main_sd21() -> int:
    """Phases 1, 19 while nvcc builds the sources it and 19a run (the
    forward, the bf16 and f32 D <= 96 backward and the bf16 int8 kernels,
    and the mma kernels 19a calls beside them), 2 for those sources' ptxas
    reports, then 19a; the kernels line's rows with phase 19's launches
    and its timed rows."""
    smi = phase_device()
    t0 = time.perf_counter()
    with building_in_background(SD21_STEMS):
        sd21 = phase_sd21(smi)
        log(f"time: phase 19 done at {time.perf_counter() - t0:.1f} s")
    phase_build(SD21_STEMS)
    rows = sd21_kernel_rows(sd21)
    log(f"time: 19a done at {time.perf_counter() - t0:.1f} s")
    kernels = [{"name": n, "launches": 0, "launches_by_path": {}}
               for n in (*FLASH_ROW_ROUTES, "int8_matmul")]
    add_sd21_launches(kernels, sd21, rows)
    log("sd21 kernels: " + json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_train() -> int:
    """Phases 1, 2 (the flash sources and adam8bit.cu), the tf32x3 and
    wgmma backward kernels' first calls in child processes, and 12 (its
    flash checks at the trainer's shapes stand in for phases 3 and 4);
    then the kernels line with the adam8bit row."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3",
                 "flash_bwd",
                 "flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3_wide",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3_wide",
                 "adam8bit"])
    tf32x3_fwd_probe()
    dq_probe()
    dkv_probe()
    tf32x3_dq_probe()
    tf32x3_probe()
    tf32x3_wide_dq_probe()
    tf32x3_wide_probe()
    trainer = phase_trainer(smi)
    log(json.dumps({"kernels": [adam8bit_kernel_row(trainer)]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_pti() -> int:
    """Phases 1, 2 (the flash sources), the tf32x3 and wgmma backward
    kernels' and the tf32x3 forward's first calls in child processes, and
    13 (its flash checks at phase 13's shapes stand in for phases 3 and
    4); then phase 13's launches by path and kernel."""
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
    pti = phase_pti(smi)
    log("pti launches: " + json.dumps(
        {p: pti[k]["launches"] for p, k in (("13b", "counted"),
                                            ("13c", "bf16"), ("13d", "ti"))}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_sdxl() -> int:
    """Phases 1, 2 (the three forward sources and the three int8 sources),
    the tf32x3 forward's and the f32 int8 wgmma kernel's first calls in
    child processes, and 14 (with its own flash and int8 checks at phase
    14's shapes); then phase 14's launches by path and kernel."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3",
                 "int8_matmul", "int8_matmul_wgmma",
                 "int8_matmul_wgmma_f32"])
    tf32x3_fwd_probe()
    int8_f32_probe()
    sdxl = phase_sdxl(smi)
    log("sdxl launches: " + json.dumps(sdxl["launches"]))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_sdxl_train() -> int:
    """Phases 1, 2 (the forward and the bf16 and f32 D <= 96 backward
    sources, and flash_bwd.cu for the mma kernels beside them), those
    kernels' first calls in child processes, and 15 (with its own flash
    checks at phase 15's shapes); then the flash rows of phase 15."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3",
                 "flash_bwd", "flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dq_tf32x3"])
    tf32x3_fwd_probe()
    dq_probe()
    dkv_probe()
    tf32x3_dq_probe()
    tf32x3_probe()
    st = phase_sdxl_train(smi)
    rows = [{"name": n, "launches": 0, "launches_by_path": {}}
            for n in FLASH_ROW_ROUTES]
    add_sdxl_train_launches(rows, st)
    log("sdxl train kernels: " + json.dumps(rows))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_dist() -> int:
    """Phases 1, 2 (the flash sources and adam8bit.cu), the tf32x3
    kernels' first calls in child processes, and 17; then phase 17's
    launches by kernel."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_tf32x3", "flash_bwd",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3_wide",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3_wide",
                 "adam8bit"])
    with probes_together():
        tf32x3_fwd_probe()
        tf32x3_dq_probe()
        tf32x3_probe()
        tf32x3_wide_dq_probe()
        tf32x3_wide_probe()
    dist = phase_dist(smi)
    log("dist launches: " + json.dumps(dist["launches"]))
    log("dist_tp launches: " + json.dumps(dist["launches_tp"]))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_dist_cards() -> int:
    """Phases 1, 2 (the f32 flash sources) and 17e on every card of the
    host (four cards of one host, joined by NVLink, in the runs so far)."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_tf32x3", "flash_bwd",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3_wide",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3_wide"])
    phase_dist_cards(smi)
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_ppim() -> int:
    """Phases 1 and 18 (no kernel to build: the path launches none)."""
    smi = phase_device()
    phase_ppim(smi)
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_tools() -> int:
    """Phases 1, 2 (flash_fwd_wgmma.cu, which phase 16 runs, and
    flash_fwd.cu, which phase 3 calls beside it) and 16; then phase 3's
    bf16 UNet calls at batch 4 and 2 (batch 4 at T = 4096 timed), every
    flash shape phase 16 ran checked against them, and the kernels line's
    flash_fwd row with phase 16's launches."""
    smi = phase_device()
    phase_build(["flash_fwd", "flash_fwd_wgmma"])
    tools = phase_tools(smi)
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = [check_kernel(B, 8, T, T, D, torch.bfloat16, gen,
                         timed=(B, T) == (4, SD15_ATTN_SHAPES[0][0]))
            for B in (4, 2) for T, D in SD15_ATTN_SHAPES]
    check_tools_shapes(tools, rows)
    fwd = rows[0]
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "lora_tpu_torch/ops/csrc/flash_fwd_wgmma.cu",
           "replaces": "lora_tpu/ops/flash_attention.py:104",
           "launches": 0, "launches_by_path": {},
           "max_abs_err": max(r["err_o"] for r in rows),
           **{k: fwd[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "exp_floor_ms")}}
    add_tools_launches([row], tools)
    log(json.dumps({"kernels": [row]}))
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
    if sys.argv[1:] == ["--modes"]:
        sys.exit(main_modes())
    if sys.argv[1:] == ["--adapters"]:
        sys.exit(main_adapters())
    if sys.argv[1:] == ["--train"]:
        sys.exit(main_train())
    if sys.argv[1:] == ["--pti"]:
        sys.exit(main_pti())
    if sys.argv[1:] == ["--sdxl"]:
        sys.exit(main_sdxl())
    if sys.argv[1:] == ["--sdxl-train"]:
        sys.exit(main_sdxl_train())
    if sys.argv[1:] == ["--tools"]:
        sys.exit(main_tools())
    if sys.argv[1:] == ["--dist"]:
        sys.exit(main_dist())
    if sys.argv[1:] == ["--ppim"]:
        sys.exit(main_ppim())
    if sys.argv[1:] == ["--dist-cards"]:
        sys.exit(main_dist_cards())
    if sys.argv[1:] == ["--sd21"]:
        sys.exit(main_sd21())
    if sys.argv[1:2] == ["--dist-rank"] and len(sys.argv) == 3:
        sys.exit(dist_rank_worker(sys.argv[2]))
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--int8 | --int8-tiles | --flash | "
                 f"--flash-bwd | --modes | --adapters | --train | --pti | "
                 f"--sdxl | --sdxl-train | --tools | --dist | "
                 f"--dist-cards | --ppim | --sd21]")
    sys.exit(main())
