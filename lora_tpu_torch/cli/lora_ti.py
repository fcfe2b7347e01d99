"""The legacy TI+LoRA trainer from the command line, the counterpart of
lora_tpu/cli/lora_ti.py:

    python -m lora_tpu_torch.cli.lora_ti --pretrained_model_name_or_path DIR \
        --instance_data_dir IMAGES --placeholder_token "<s>" \
        --output_dir OUT [--device cpu] [--any LegacyTiConfig field]

(installed as the console script lora_ti_torch). Training runs on the card
unless --device cpu, in bf16 with --mixed_precision bf16, else in f32.
"""

from __future__ import annotations

import torch

from ..pipelines.sd import StableDiffusionPipeline
from ..training.ti_legacy import LegacyTiConfig, train_ti_lora_legacy
from ._fire import coerce_kwargs_to_dataclass, fire


def train(pretrained_model_name_or_path: str = "", device: str = "cuda",
          mixed_precision: str = None, **kwargs):
    """Load the pipeline on `device` and run train_ti_lora_legacy with the
    other flags as LegacyTiConfig fields; returns its result dict."""
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    kwargs = coerce_kwargs_to_dataclass(LegacyTiConfig, kwargs)
    cfg = LegacyTiConfig(mixed_precision=mixed_precision, **kwargs)
    pipe = StableDiffusionPipeline.from_pretrained(
        pretrained_model_name_or_path, dtype=dtype, device=device)
    return train_ti_lora_legacy(pipe, cfg)


def main():
    fire(train)


if __name__ == "__main__":
    main()
