"""Flash-attention forward: the hand-written CUDA kernel for Hopper
(csrc/flash_fwd.cu), its wrapper, and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel
lora_tpu/ops/flash_attention.py::_fwd_kernel. It serves the UNet's spatial
self-attention (ops/attention.py routes the shapes that `supported()`
accepts to it), computing O and the per-row logsumexp L.

Build: the first CUDA call compiles the source with nvcc for sm_90a into a
shared library with a plain C entry point, cached under
lora_tpu_torch/_build/ by a hash of the source and flags, and loads it with
ctypes. Nothing is compiled or imported at module import.

This slice ports the forward only. A CUDA call whose inputs require grad
raises: the backward kernels (ROADMAP Queue B items 2-3) land with the
training slice, together with the torch.autograd.Function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import torch

BQ = 256  # the JAX kernel's q block: the routing rule below keeps its shapes

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "flash_fwd.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _find_nvcc() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    return shutil.which("nvcc")


def build() -> str:
    """Compile csrc/flash_fwd.cu into _build/ (once per source hash) and
    return the library's path. nvcc's ptxas report (registers, shared
    memory, spills per kernel) is kept beside it as build.log."""
    with open(_CSRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"flash_fwd_{key}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the flash-attention "
            "kernel cannot be built, and CUDA tensors have no other path")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, _CSRC],
                             capture_output=True, text=True)
        with open(os.path.join(_BUILD_DIR, "build.log"), "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {_CSRC}:\n"
                f"{res.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.flash_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.flash_fwd.restype = ctypes.c_int
            _lib = lib
        return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: (B, H, T, D) x (B, H, S, D) ->
    (O (B, H, T, D) in the input dtype, L (B, H, T) float32).

    q is pre-scaled in f32 and rounded to the input dtype (the JAX
    _scale_q); the scores, softmax and L are float32."""
    qs = (q.float() * scale).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, H, T, D) tensors")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention takes bf16 or f32, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D % 8 or D > 256 or T < 1 or k.shape[2] < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}: needs D % 8 == 0, D <= 256")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        # 16-byte vector loads: unit last stride, other strides multiples
        # of 8 elements, 16-byte aligned base
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name} must have a unit last stride, strides that are "
                f"multiples of 8 and a 16-byte aligned base; got strides "
                f"{t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, T, D) non-causal attention -> (O, L), O in q's layout and
    dtype, L float32 (B, H, T).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. `flash_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward yet (ROADMAP Queue B items 2-3: "
            "the dQ and dK/dV kernels); call it under torch.no_grad() or "
            "torch.inference_mode()")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention needs CUDA or CPU tensors, got "
                         f"{q.device}")
    _check(q, k, v)
    B, H, T, D = q.shape
    S = k.shape[2]
    # O in q's layout when q is dense (the UNet's transposed views), else
    # contiguous; either way strides the kernel takes (checked for q above)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), strides, B, H, T,
                           S, D, int(q.dtype == torch.bfloat16),
                           float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc} for "
                           f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def supported(q_shape, k_shape) -> bool:
    """The JAX package's routing rule (flash_attention.py:356-359: T a
    multiple of its 256-row q block, S of its 128-row kv block), kept so
    both packages send the same calls to their kernels."""
    return q_shape[2] % BQ == 0 and k_shape[2] % 128 == 0
