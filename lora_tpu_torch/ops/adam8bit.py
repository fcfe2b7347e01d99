"""Blockwise-int8 AdamW update: a hand-written CUDA kernel for Hopper
(csrc/adam8bit.cu), its wrapper and its plain PyTorch version.

The optimizer state of the low-memory Adam (training/optim.py,
make_optimizer(low_memory="int8")) keeps both moments as int8 codes with
one f32 absmax scale per block of BLOCK = 256 elements, over each parameter
group's raveled vector, as lora_tpu's adamw_8bit under _fused_by_group
(lora_tpu/training/optim.py:28-105, 138-181): the blocks run across leaf
boundaries and only the group's last block is zero-padded. The second
moment is carried as its square root (rms = sqrt(nu)), and the step uses
the f32 mu and rms from before they are requantized.

`adam8bit_update` applies one update in place: CPU tensors take the plain
version, CUDA tensors launch the kernel (one launch per call) or raise;
nothing falls back. Launches are counted in `adam8bit_update.launches`. The
first CUDA call builds csrc/adam8bit.cu through ops/build.py; nothing is
compiled at import.

The plain version runs the kernel's sequence of f32 operations one op at a
time, every division between tensors on the device (torch turns a division
by a host scalar into a product with its reciprocal), so on the card the two
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import build

BLOCK = 256

_lock = threading.Lock()
_fn = []  # the ctypes entry point, once loaded
_P, _F = ctypes.c_void_p, ctypes.c_float
# g, clip, p, mu_q, mu_s, nu_q, nu_s, n, lr, wd, b1, 1 - b1, b2, 1 - b2, eps,
# c1, c2, stream
_ARGTYPES = [_P] * 7 + [ctypes.c_longlong] + [_F] * 9 + [_P]


def _entry():
    with _lock:
        if not _fn:
            fn = build.load_library("adam8bit").adam8bit_update
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _fn.append(fn)
        return _fn[0]


def n_blocks(n: int) -> int:
    return -(-n // BLOCK)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (n,) -> (codes int8 (n_blocks * 256,), scales f32 (n_blocks,)):
    lora_tpu's _quantize on the raveled vector, zero-padded to whole
    blocks."""
    n = x.numel()
    nb = n_blocks(n)
    flat = torch.zeros(nb * BLOCK, dtype=torch.float32, device=x.device)
    flat[:n] = x.reshape(-1)
    b = flat.view(nb, BLOCK)
    s = b.abs().amax(dim=1) / _f32(127.0, x.device)
    s = torch.where(s == 0.0, _f32(1.0, x.device), s)
    q = torch.clamp(torch.round(b / s[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), s


def dequantize(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """The first n values of codes q with block scales s, f32 (n,)."""
    return (q.view(-1, BLOCK).float() * s[:, None]).reshape(-1)[:n]


def _f32(x: float, device) -> torch.Tensor:
    """x rounded to f32, as a 0-d tensor on `device`."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def adam8bit_update_reference(g, clip, p, mu_q, mu_s, nu_q, nu_s, *, lr, wd,
                              b1, b2, eps, c1, c2) -> None:
    """The plain version of adam8bit_update (same arguments, same in-place
    result)."""
    n, dev = p.numel(), p.device
    if clip is not None:
        g = g * clip
    m = dequantize(mu_q, mu_s, n) * _f32(b1, dev) + g * _f32(1.0 - b1, dev)
    r = dequantize(nu_q, nu_s, n)
    nu = r * _f32(b2, dev) * r + g * _f32(1.0 - b2, dev) * g
    r = torch.sqrt(nu)
    step = m / (_f32(c1, dev) * (r / torch.sqrt(_f32(c2, dev))
                                 + _f32(eps, dev)))
    p.add_((step + p * _f32(wd, dev)) * _f32(-lr, dev))
    for codes, scales, x in ((mu_q, mu_s, m), (nu_q, nu_s, r)):
        q, s = quantize(x)
        codes.copy_(q)
        scales.copy_(s)


def _check(g, clip, p, mu_q, mu_s, nu_q, nu_s):
    if p.device.type != "cuda":
        raise ValueError(f"adam8bit_update needs CUDA or CPU tensors, got "
                         f"{p.device}")
    n = p.numel()
    nb = n_blocks(n)
    want = {"g": (g, torch.float32, n), "p": (p, torch.float32, n),
            "mu_q": (mu_q, torch.int8, nb * BLOCK),
            "nu_q": (nu_q, torch.int8, nb * BLOCK),
            "mu_s": (mu_s, torch.float32, nb),
            "nu_s": (nu_s, torch.float32, nb)}
    if clip is not None:
        want["clip"] = (clip, torch.float32, 1)
    for name, (t, dtype, numel) in want.items():
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of {numel} "
                f"elements, got {t.dtype}{tuple(t.shape)}")
    if n == 0:
        raise ValueError("adam8bit_update got an empty group")


def adam8bit_update(g: torch.Tensor, clip: Optional[torch.Tensor],
                    p: torch.Tensor, mu_q: torch.Tensor, mu_s: torch.Tensor,
                    nu_q: torch.Tensor, nu_s: torch.Tensor, *, lr: float,
                    wd: float, b1: float, b2: float, eps: float, c1: float,
                    c2: float) -> None:
    """One blockwise-int8 AdamW update of a group's raveled vector, in
    place: g (n,) f32 gradients; clip a 0-d f32 tensor on the device (the
    global-norm clip scale) or None; p (n,) f32 params; mu_q, nu_q
    (n_blocks * 256,) int8 codes and mu_s, nu_s (n_blocks,) f32 scales of
    mu and of rms = sqrt(nu); c1 = 1 - b1**count and c2 = 1 - b2**count
    (f32). See csrc/adam8bit.cu for the arithmetic."""
    if p.device.type == "cpu":
        adam8bit_update_reference(g, clip, p, mu_q, mu_s, nu_q, nu_s, lr=lr,
                                  wd=wd, b1=b1, b2=b2, eps=eps, c1=c1, c2=c2)
        return
    _check(g, clip, p, mu_q, mu_s, nu_q, nu_s)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(g.data_ptr(),
                      clip.data_ptr() if clip is not None else None,
                      p.data_ptr(), mu_q.data_ptr(), mu_s.data_ptr(),
                      nu_q.data_ptr(), nu_s.data_ptr(), p.numel(), lr, wd,
                      b1, 1.0 - b1, b2, 1.0 - b2, eps, c1, c2, stream)
    if rc != 0:
        raise RuntimeError(f"adam8bit_update launch failed: cudaError {rc} "
                           f"for a group of {p.numel()} elements")
    adam8bit_update.launches += 1


adam8bit_update.launches = 0
