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

patch_pipe also loads kohya-ss / LoCon and LyCORIS files (formats/kohya.py,
formats/lycoris.py; LoHa, LoKr, IA3, DoRA, OFT, BOFT, GLoRA, full and norm
modules), and the LoRA combinators of core/lora.py (merge, add, join,
stack_loras + with_lora_idx for K adapters routed per prompt, collapse,
ranks, inspect) are exported here:

    from lora_tpu_torch import stack_loras
    pipe.lora_unet = stack_loras([lora_a, lora_b])
    images = pipe(["a dog", "a town"], lora_idx=[0, 1], generator=g)

The DreamBooth trainer runs from a diffusers-layout directory and a folder
of images (training/dreambooth.py, cli/lora_db.py; the low-memory Adams
of training/optim.py, the int8 one a hand-written CUDA kernel):

    python -m lora_tpu_torch.cli.lora_db --pretrained_model_name_or_path DIR \
        --instance_data_dir IMAGES --instance_prompt "a photo of sks dog" \
        --output_dir OUT --use_8bit_adam

Serving also takes diffusers-layout checkpoints
(StableDiffusionPipeline.from_pretrained), an int8 base
(pipe.quantize_base()) and an HTTP server (serve.py, txt2img, img2img,
inpainting):

    python -m lora_tpu_torch.serve --model DIR --quantize

and SDXL (pipelines/sdxl.py: two text encoders, the text_time UNet,
kohya-XL and LyCORIS-XL adapters; the server picks it for a directory with
text_encoder_2/):

    from lora_tpu_torch import StableDiffusionXLPipeline

    pipe = StableDiffusionXLPipeline.from_pretrained(DIR, dtype=torch.bfloat16)
    images = pipe(["a photo of a dog"], generator=torch.Generator("cuda"))

The UNet's spatial self-attention runs through hand-written CUDA
flash-attention kernels (ops/csrc/flash_fwd.cu, and flash_bwd.cu for the
dQ and dK/dV of training), and every 2-D int8 weight through a
hand-written CUDA int8-weight matmul (ops/csrc/int8_matmul.cu), all built
with nvcc at first use (ops/build.py).
"""

__version__ = "0.1.0"

from .formats.safetensors_io import (  # noqa: F401
    DEFAULT_TARGET_REPLACE,
    EMBED_FLAG,
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    TEXT_ENCODER_EXTENDED_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    UNET_EXTENDED_TARGET_REPLACE,
    load_safeloras,
    load_safeloras_both,
    load_safeloras_embeds,
    parse_safeloras,
    parse_safeloras_embeds,
    save_safeloras,
    save_safeloras_with_embeds,
)
from .core.lora import (  # noqa: F401
    add_lora,
    collapse_lora,
    init_lora,
    inspect_lora,
    join_loras,
    lora_from_deltas,
    lora_from_flat,
    lora_from_pairs,
    lora_ranks,
    lora_to_pairs,
    merge_loras,
    set_lora_diag,
    stack_loras,
    tune_lora_scale,
    with_lora_idx,
)
from .core.sites import (  # noqa: F401
    Site,
    text_encoder_locon_sites,
    text_encoder_lora_sites,
    unet_locon_sites,
    unet_lora_sites,
)


def __getattr__(name):
    # the pipelines load lazily, as in lora_tpu, so `import lora_tpu_torch`
    # stays cheap
    if name == "StableDiffusionPipeline":
        from .pipelines.sd import StableDiffusionPipeline

        return StableDiffusionPipeline
    if name == "StableDiffusionXLPipeline":
        from .pipelines.sdxl import StableDiffusionXLPipeline

        return StableDiffusionXLPipeline
    raise AttributeError(name)
