"""Int8-weight matmul: three hand-written CUDA kernels for Hopper, their
wrapper and their plain PyTorch version.

    y = round_to_x_dtype((bf16(x) @ bf16(wq).T in f32) * scale)

replacing the Pallas TPU kernel lora_tpu/ops/int8_matmul.py::_kernel. The
quantized serving path (core/quantize.py) stores frozen base weights int8
with per-output-channel scales; models/layers.dense sends every 2-D int8
weight here. Every kernel reads the int8 bytes from device memory and
widens them on chip, so the weight's bandwidth stays halved:

    "wgmma"      csrc/int8_matmul_wgmma.cu      bf16 x: TMA ring,
                 warp-specialised wgmma with the widened W in registers,
                 persistent tiles (every call of bf16 quantized serving)
    "wgmma_f32"  csrc/int8_matmul_wgmma_f32.cu  f32 x: the same pipeline,
                 x landed as f32 and rounded to bf16 in shared memory by
                 the consumer warps under their wgmmas, f32 stored from
                 the accumulators (every call of f32 quantized serving,
                 from_pretrained's default dtype)
    "mma"        csrc/int8_matmul.cu            mma.sync: K % 16 != 0,
                 N % 8 != 0, base pointers that are not 16-byte aligned

`_route` picks one from dtype, shape and pointer alignment alone, and
`_tile` a wgmma kernel's output tile from (M, K, N), the SM count and that
kernel's time model. A CUDA call launches the chosen kernel or raises:
nothing reacts to a failure. CPU tensors take the plain version. Launches
are counted in `int8_matmul.launches_by_kernel` and, summed, in
`int8_matmul.launches`. The first CUDA call of each kernel builds its own
source through ops/build.py; nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from . import build

_lib_lock = threading.Lock()
_fns: Dict[str, object] = {}  # route -> the ctypes entry point, once loaded
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {
    # route: (source stem, C function, argtypes)
    # x, wq, scale, out, M, N, K, is_bf16, stream
    "mma": ("int8_matmul", "int8_matmul", [_P] * 4 + [_I] * 4 + [_P]),
    # x, wq, scale, out, M, N, K, BM, BN, stream
    "wgmma": ("int8_matmul_wgmma", "int8_matmul_wgmma",
              [_P] * 4 + [_I] * 5 + [_P]),
    "wgmma_f32": ("int8_matmul_wgmma_f32", "int8_matmul_wgmma_f32",
                  [_P] * 4 + [_I] * 5 + [_P]),
}
# the (BM, BN) output tiles of both wgmma kernels: BM rows of x (64, 128 or
# 256: the n of wgmma's m64nBMk16), BN rows of W (64 per consumer
# warpgroup)
TILES = tuple((bm, bn) for bn in (64, 128) for bm in (64, 128, 256))
# the wgmma kernel's time per tile, in microseconds per wave of tiles (one
# tile on each SM: pipeline fill, epilogue) and per K step of 64 in a wave,
# fit (least relative error) to every tile instance's time at every bf16
# shape of SD-1.5 quantized serving (chip_smoke.py --int8-tiles, NVIDIA
# H100 80GB HBM3 at 700 W)
_TILE_US = {(64, 64): (0.66, 0.29), (128, 64): (0.92, 0.36),
            (256, 64): (2.25, 0.42), (64, 128): (0.77, 0.39),
            (128, 128): (1.28, 0.50), (256, 128): (3.10, 0.65)}
# the same for the f32 kernel, fit the same way at every f32 shape
# (chip_smoke.py --int8-tiles prints both fits)
_TILE_US_F32 = {(64, 64): (1.00, 0.54), (128, 64): (1.68, 0.82),
                (256, 64): (2.67, 1.79), (64, 128): (1.41, 0.64),
                (128, 128): (2.70, 0.84), (256, 128): (5.22, 1.56)}
_TILE_MODELS = {"wgmma": _TILE_US, "wgmma_f32": _TILE_US_F32}
_sms: Dict[int, int] = {}


def _entry(route: str):
    """The ctypes entry point of one kernel (a key of _ENTRY), building its
    source on first use."""
    with _lib_lock:
        if route not in _fns:
            stem, name, argtypes = _ENTRY[route]
            fn = getattr(build.load_library(stem), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[route] = fn
        return _fns[route]


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version: x (..., K) bf16 or f32, wq (N, K) int8, scale (N,)
    f32 -> (..., N) in x's dtype. x is rounded to bf16 as the kernel loads
    it; a bf16 value times an int8 value is exact in f32, so this and the
    kernel differ only in the order of the f32 sums."""
    y = torch.matmul(x.to(torch.bfloat16).float(), wq.float().T)
    return (y * scale.float()).to(x.dtype)


def _route(x2: torch.Tensor, wq: torch.Tensor) -> str:
    """What TMA can load: 16-byte global row strides (K % 16 == 0 for the
    int8 rows), N % 8 == 0 and 16-byte aligned bases, goes to "wgmma" for
    bf16 x and to "wgmma_f32" for f32 x; everything else to "mma"."""
    N, K = wq.shape
    if (K % 16 == 0 and N % 8 == 0 and x2.data_ptr() % 16 == 0
            and wq.data_ptr() % 16 == 0):
        return "wgmma" if x2.dtype == torch.bfloat16 else "wgmma_f32"
    return "mma"


@functools.lru_cache(maxsize=4096)
def _tile(M: int, K: int, N: int, sms: int = 132,
          route: str = "wgmma") -> Tuple[int, int]:
    """The output tile of the wgmma kernel `route` for an (M, K) x (K, N)
    product on `sms` SMs: the instance its time model (_TILE_MODELS) gives
    the least time, counting whole waves of tiles (a last wave that fills
    few SMs costs as much as a full one)."""
    model = _TILE_MODELS[route]

    def us(tile):
        bm, bn = tile
        tiles = -(-M // bm) * -(-N // bn)
        per_wave, per_step = model[tile]
        return -(-tiles // sms) * (per_wave + per_step * -(-K // 64))

    return min(model, key=us)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


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
    the kernel `_route` picks or raise."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    _check(x, wq, scale)
    N, K = wq.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():  # the kernels read rows of K contiguous values
        x2 = x2.contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    route = _route(x2, wq)
    args = (x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, N, K)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "mma":
            rc = _entry(route)(*args, int(x.dtype == torch.bfloat16), stream)
        else:
            rc = _entry(route)(
                *args, *_tile(M, K, N, _sm_count(x.device), route), stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul ({route}) launch failed: cudaError "
                           f"{rc} for x{tuple(x.shape)} {x.dtype} wq{(N, K)}")
    int8_matmul.launches_by_kernel[route] += 1
    int8_matmul.launches += 1
    return out.reshape(*lead, N)


int8_matmul.launches_by_kernel = {"wgmma": 0, "wgmma_f32": 0, "mma": 0}
int8_matmul.launches = 0  # the sum of launches_by_kernel
