"""Scaled dot-product attention.

`attention()` is the single entry point of all models. Non-causal calls on
CUDA tensors whose shapes pass `flash_attention.supported()` (the JAX
package's rule) go to the hand-written flash kernels, in serving and in
training (inputs that require grad take the autograd Function, whose
backward is the dQ and dK/dV kernels); a kernel failure raises. Everything else (CPU tensors, causal attention, the UNet's
cross-attention with S = 77 and its 64-token mid block) takes a plain
matmul path with a float32 softmax, kept plain on purpose so that
measurements can hold both against torch's own fused attention.

Layout: (B, H, T, D) throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, supported


def _plain_attention(q, k, v, scale: float,
                     causal_mask: Optional[torch.Tensor]):
    dt = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal_mask is not None:
        logits = logits.masked_fill(~causal_mask,
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(probs, v)


_FLASH_ENABLED = True


def set_use_memory_efficient_attention(enabled: bool) -> None:
    """Global toggle for the flash-kernel path, the counterpart of the
    reference's xformers switch (xformers_utils.py:42-70)."""
    global _FLASH_ENABLED
    _FLASH_ENABLED = bool(enabled)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if causal:
        Tq, Tk = q.shape[-2], k.shape[-2]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        return _plain_attention(q, k, v, scale, mask)
    if _FLASH_ENABLED and q.is_cuda and supported(q.shape, k.shape):
        return flash_attention(q, k, v, scale)[0]
    return _plain_attention(q, k, v, scale, None)
