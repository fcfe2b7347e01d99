"""Pivotal tuning from the command line, the counterpart of
lora_tpu/cli/lora_pti.py:

    python -m lora_tpu_torch.cli.lora_pti --pretrained_model_name_or_path DIR \
        --instance_data_dir IMAGES --placeholder_tokens "<s1>|<s2>" \
        --use_template object --output_dir OUT [--device cpu] \
        [--any PTIConfig field]

(installed as the console script lora_pti_torch). DIR is a diffusers-layout
SD-1.x / SD-2.x directory; training runs on the card unless --device cpu,
in bf16 with --mixed_precision bf16, else in f32.
"""

from __future__ import annotations

import torch

from ..pipelines.sd import StableDiffusionPipeline
from ..training.pti import PTIConfig, train_pti
from ._fire import coerce_kwargs_to_dataclass, fire


def train(pretrained_model_name_or_path: str = "", device: str = "cuda",
          mixed_precision: str = None, **kwargs):
    """Load the pipeline on `device` and run train_pti with the other flags
    as PTIConfig fields; returns its result dict."""
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    kwargs = coerce_kwargs_to_dataclass(PTIConfig, kwargs)
    cfg = PTIConfig(mixed_precision=mixed_precision, **kwargs)
    pipe = StableDiffusionPipeline.from_pretrained(
        pretrained_model_name_or_path, dtype=dtype, device=device)
    return train_pti(pipe, cfg)


def main():
    fire(train)


if __name__ == "__main__":
    main()
