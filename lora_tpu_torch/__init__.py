"""lora_tpu_torch: the PyTorch / CUDA port of lora_tpu, for NVIDIA Hopper.

The JAX package (lora_tpu) is the reference this port is held against. This
package imports torch and never jax. It mirrors lora_tpu's layout
(models/, core/, ops/, formats/, data/, pipelines/, training/) so each
counterpart sits at the same path. The SD-1.x / SD-2.x txt2img serving path
is ported:

    import torch
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.random_init(
        generator=torch.Generator("cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16)
    pipe.patch_pipe("lora.safetensors")
    images = pipe(["a photo of <s1> dog"], num_inference_steps=50)

and so is the DreamBooth-LoRA training step (training/: loss_step,
make_optimizer, make_train_step, LoRA dropout, gradient checkpointing):

    from lora_tpu_torch.training.optim import make_optimizer
    from lora_tpu_torch.training.train_step import make_train_step, make_trainable

    trainable = make_trainable({"lora_unet": init_lora(sites, r=4, ...)})
    step = make_train_step(..., optimizer=make_optimizer(trainable, {"lora_unet": 1e-4}))
    loss = step(trainable, (unet_params, {}, {}), batch, generator)

Serving also takes diffusers-layout checkpoints
(StableDiffusionPipeline.from_pretrained), an int8 base
(pipe.quantize_base()) and an HTTP server (serve.py, txt2img):

    python -m lora_tpu_torch.serve --model DIR --quantize

The UNet's spatial self-attention runs through hand-written CUDA
flash-attention kernels (ops/csrc/flash_fwd.cu, and flash_bwd.cu for the
dQ and dK/dV of training), and every 2-D int8 weight through a
hand-written CUDA int8-weight matmul (ops/csrc/int8_matmul.cu), all built
with nvcc at first use (ops/build.py).
"""

__version__ = "0.1.0"
