"""save_all: one call that saves the UNet LoRA, the text-encoder LoRA and
the TI embeds, in the safetensors schema or as the legacy three .pt files;
the counterpart of lora_tpu/core/save.py, with the same keys, metadata and
fp16 tensors."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..formats import pt_io
from ..formats.safetensors_io import (
    DEFAULT_TARGET_REPLACE,
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    save_safeloras_with_embeds,
)
from .lora import LoraTree, lora_to_pairs
from .sites import Site


def save_all(
    save_path: str,
    lora_unet: Optional[LoraTree] = None,
    unet_sites: Optional[Sequence[Site]] = None,
    lora_text: Optional[LoraTree] = None,
    text_sites: Optional[Sequence[Site]] = None,
    embeds: Optional[Dict[str, np.ndarray]] = None,
    save_lora: bool = True,
    save_ti: bool = True,
    target_replace_module_unet=DEFAULT_TARGET_REPLACE,
    target_replace_module_text=TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    safe_form: bool = True,
) -> None:
    if not safe_form:
        if save_ti and embeds:
            pt_io.save_ti_pt(embeds, pt_io.ti_lora_path(save_path))
        if save_lora:
            if lora_unet is not None:
                pt_io.save_lora_pt(lora_to_pairs(lora_unet, unet_sites),
                                   save_path)
            if lora_text is not None:
                pt_io.save_lora_pt(lora_to_pairs(lora_text, text_sites),
                                   pt_io.text_lora_path(save_path))
        return

    if not save_path.endswith(".safetensors"):
        raise ValueError(
            f"Save path : {save_path} should end with .safetensors")
    modelmap = {}
    if save_lora:
        if lora_unet is not None:
            modelmap["unet"] = (lora_to_pairs(lora_unet, unet_sites),
                                target_replace_module_unet)
        if lora_text is not None:
            modelmap["text_encoder"] = (lora_to_pairs(lora_text, text_sites),
                                        target_replace_module_text)
    save_safeloras_with_embeds(
        modelmap, embeds if (save_ti and embeds) else {}, save_path,
        cast_fp16=True)
