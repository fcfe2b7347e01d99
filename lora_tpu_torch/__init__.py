"""lora_tpu_torch: the PyTorch / CUDA port of lora_tpu, for NVIDIA Hopper.

The JAX package (lora_tpu) is the reference this port is held against. This
package imports torch and never jax. It mirrors lora_tpu's layout
(models/, core/, ops/, formats/, data/, pipelines/) so each counterpart sits
at the same path. The SD-1.x / SD-2.x txt2img serving path is ported:

    import torch
    from lora_tpu_torch.pipelines.sd import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.random_init(
        generator=torch.Generator("cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16)
    pipe.patch_pipe("lora.safetensors")
    images = pipe(["a photo of <s1> dog"], num_inference_steps=50)

The UNet's spatial self-attention runs through a hand-written CUDA
flash-attention forward kernel (ops/csrc/flash_fwd.cu), built with nvcc at
first use.
"""

__version__ = "0.1.0"
