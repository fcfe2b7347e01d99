"""DreamBooth-LoRA training from the command line, the counterpart of
lora_tpu/cli/lora_db.py:

    python -m lora_tpu_torch.cli.lora_db --pretrained_model_name_or_path DIR \
        --instance_data_dir IMAGES --instance_prompt "a photo of sks dog" \
        --output_dir OUT [--device cpu] [--any DreamBoothConfig field]

(installed as the console script lora_db_torch). DIR is a diffusers-layout
SD-1.x / SD-2.x directory, or an SDXL one (with text_encoder_2/), which
trains the XL way and writes kohya-XL files (--output_format safe);
training runs on the card unless --device cpu. Under lora_launch_torch it
joins the process group first, and --data_parallel / --fsdp N /
--tensor_parallel N train across the ranks, each on its own device (cuda
means the rank's card), e.g. on two CPU ranks:

    lora_launch_torch --cpu --nproc 2 -- python -m lora_tpu_torch.cli.lora_db \
        ... --tensor_parallel 2 --device cpu
"""

from __future__ import annotations

import os

import torch

from ..pipelines.sd import StableDiffusionPipeline
from ..pipelines.sdxl import StableDiffusionXLPipeline
from ..training.dreambooth import DreamBoothConfig, train_dreambooth
from ..parallel.mesh import (
    finalize_distributed,
    initialize_distributed_from_env,
    rank_device,
)
from ._fire import coerce_kwargs_to_dataclass, fire


def train(pretrained_model_name_or_path: str = "",
          mixed_precision: str = None, device: str = "cuda", **kwargs):
    """Load the pipeline (bf16 with mixed_precision="bf16", else f32) on
    `device` and run train_dreambooth with the other flags as
    DreamBoothConfig fields; returns its result dict. A directory with
    text_encoder_2/ loads as StableDiffusionXLPipeline."""
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    kwargs = coerce_kwargs_to_dataclass(DreamBoothConfig, kwargs)
    cfg = DreamBoothConfig(mixed_precision=mixed_precision, **kwargs)
    pipe_cls = (StableDiffusionXLPipeline if os.path.isdir(os.path.join(
        pretrained_model_name_or_path, "text_encoder_2"))
        else StableDiffusionPipeline)
    pipe = pipe_cls.from_pretrained(pretrained_model_name_or_path,
                                    dtype=dtype, device=rank_device(device))
    return train_dreambooth(pipe, cfg)


def main():
    # join a lora_launch_torch process group, if one is configured, before
    # anything is loaded
    initialize_distributed_from_env()
    try:
        fire(train)
    finally:
        finalize_distributed()


if __name__ == "__main__":
    main()
