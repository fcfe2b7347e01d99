"""Int8-weight matmul: the hand-written CUDA kernel for Hopper
(csrc/int8_matmul.cu), its wrapper and its plain PyTorch version.

    y = round_to_x_dtype((bf16(x) @ bf16(wq).T in f32) * scale)

replacing the Pallas TPU kernel lora_tpu/ops/int8_matmul.py::_kernel. The
quantized serving path (core/quantize.py) stores frozen base weights int8
with per-output-channel scales; models/layers.dense sends every 2-D int8
weight here. The kernel reads the int8 bytes from device memory and widens
them on chip, so the weight's bandwidth stays halved.

`int8_matmul(x, wq, scale)` runs the plain version for CPU tensors, launches
the kernel for CUDA tensors (or raises), and counts its launches in
`int8_matmul.launches`. The first CUDA call builds every csrc/*.cu through
ops/build.py; nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

_lib_lock = threading.Lock()
_fn = None  # the ctypes entry point, once loaded


def _load():
    global _fn
    with _lib_lock:
        if _fn is None:
            fn = build.load_library("int8_matmul").int8_matmul
            P, I = ctypes.c_void_p, ctypes.c_int
            # x, wq, scale, out, M, N, K, is_bf16, stream
            fn.argtypes = [P, P, P, P, I, I, I, I, P]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version: x (..., K) bf16 or f32, wq (N, K) int8, scale (N,)
    f32 -> (..., N) in x's dtype. x is rounded to bf16 as the kernel loads
    it; a bf16 value times an int8 value is exact in f32, so this and the
    kernel differ only in the order of the f32 sums."""
    y = torch.matmul(x.to(torch.bfloat16).float(), wq.float().T)
    return (y * scale.float()).to(x.dtype)


def _check(x, wq, scale):
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul needs CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul takes bf16 or f32 x, got {x.dtype}")
    if wq.dtype != torch.int8 or wq.ndim != 2:
        raise ValueError(f"wq must be a 2-D int8 tensor, got {wq.dtype}"
                         f"{tuple(wq.shape)}")
    N, K = wq.shape
    if x.shape[-1] != K or scale.shape != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} wq{(N, K)} "
                         f"scale {scale.dtype}{tuple(scale.shape)} (f32 (N,))")
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 or f32; wq (N, K) int8; scale (N,) f32 -> (..., N)
    in x's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    _check(x, wq, scale)
    N, K = wq.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():  # the kernel reads rows of K contiguous values
        x2 = x2.contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _load()(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), M, N, K,
                     int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {rc} for "
                           f"x{tuple(x.shape)} {x.dtype} wq{(N, K)}")
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


int8_matmul.launches = 0
