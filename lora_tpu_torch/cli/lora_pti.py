"""Pivotal tuning from the command line, the counterpart of
lora_tpu/cli/lora_pti.py:

    python -m lora_tpu_torch.cli.lora_pti --pretrained_model_name_or_path DIR \
        --instance_data_dir IMAGES --placeholder_tokens "<s1>|<s2>" \
        --use_template object --output_dir OUT [--device cpu] \
        [--any PTIConfig field]

(installed as the console script lora_pti_torch). DIR is a diffusers-layout
SD-1.x / SD-2.x directory; training runs on the card unless --device cpu,
in bf16 with --mixed_precision bf16, else in f32. Under lora_launch_torch
it joins the process group first, and --data_parallel / --fsdp N /
--tensor_parallel N train across the ranks.
"""

from __future__ import annotations

import torch

from ..pipelines.sd import StableDiffusionPipeline
from ..training.pti import PTIConfig, train_pti
from ..parallel.mesh import (
    finalize_distributed,
    initialize_distributed_from_env,
    rank_device,
)
from ._fire import coerce_kwargs_to_dataclass, fire


def train(pretrained_model_name_or_path: str = "", device: str = "cuda",
          mixed_precision: str = None, **kwargs):
    """Load the pipeline on `device` and run train_pti with the other flags
    as PTIConfig fields; returns its result dict."""
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    kwargs = coerce_kwargs_to_dataclass(PTIConfig, kwargs)
    cfg = PTIConfig(mixed_precision=mixed_precision, **kwargs)
    pipe = StableDiffusionPipeline.from_pretrained(
        pretrained_model_name_or_path, dtype=dtype,
        device=rank_device(device))
    return train_pti(pipe, cfg)


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
