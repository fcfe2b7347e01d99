"""Int8 base-weight quantization for serving, the counterpart of
lora_tpu/core/quantize.py with the same rules.

The frozen base never receives gradients, so it can live in int8 with
per-output-channel symmetric scales: scale = max(amax / 127, 1e-12) in f32,
q = clip(round_half_even(w / scale), -127, 127). The SD-1.5 UNet's
parameters drop from ~1.72 GB in bf16 to ~0.86 GB. LoRA deltas stay full
precision, so adapters are unaffected.

Layout: "name.weight" -> int8 tensor, companion "name.weight_scale" ->
float32 per-out-channel scale. Norms, biases and any param whose name
contains "embedding" (token/position tables, time_embedding.*) stay float.
models/layers.py dispatches on the dtype: 2-D int8 dense weights go to the
int8 kernel (ops/int8_matmul.py), conv weights are dequantized at use.
"""

from __future__ import annotations

from typing import Dict

import torch

SCALE_SUFFIX = "_scale"


def _quantizable(name: str, w: torch.Tensor) -> bool:
    if not name.endswith(".weight") or w.ndim < 2:
        return False
    if "norm" in name.split(".")[-2] or "embedding" in name:
        return False
    return True


def quantize_params_int8(params: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Per-out-channel symmetric int8 quantization of matmul/conv weights."""
    out: Dict[str, torch.Tensor] = {}
    for name, w in params.items():
        if not _quantizable(name, w):
            out[name] = w
            continue
        wf = w.detach().float()
        amax = wf.reshape(wf.shape[0], -1).abs().amax(dim=1)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        shape = (w.shape[0],) + (1,) * (w.ndim - 1)
        out[name] = torch.clamp(torch.round(wf / scale.reshape(shape)),
                                -127, 127).to(torch.int8)
        out[name + SCALE_SUFFIX] = scale
    return out


def dequantize_weight(p: Dict[str, torch.Tensor], key: str,
                      dtype: torch.dtype) -> torch.Tensor:
    """The weight at `key` in `dtype`, dequantized if int8."""
    w = p[key]
    if w.dtype == torch.int8:
        scale = p[key + SCALE_SUFFIX]
        shape = (w.shape[0],) + (1,) * (w.ndim - 1)
        return (w.float() * scale.reshape(shape)).to(dtype)
    return w.to(dtype)
