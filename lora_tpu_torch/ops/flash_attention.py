"""Flash attention: the hand-written CUDA kernels for Hopper (csrc/), their
wrappers, their plain PyTorch versions, and the autograd Function over them.

Four kernels, each replacing a Pallas TPU kernel of
lora_tpu/ops/flash_attention.py:

    flash_fwd      _fwd_kernel      O and the f32 logsumexp L, through
        "wgmma"    csrc/flash_fwd_wgmma.cu  bf16: TMA ring, producer warp,
                                            warpgroup wgmma
        "tf32x3"   csrc/flash_fwd_tf32x3.cu f32 with D <= 160: the same
                                            pipeline, every product as
                                            three tf32 wgmmas (hi/lo), the
                                            split made in the kernel
        "mma"      csrc/flash_fwd.cu        mma.sync: D > 160, a stride
                                            of 0
    flash_bwd_dq   _bwd_dq_kernel   dQ, through
        "wgmma"    csrc/flash_bwd_dq_wgmma.cu   bf16: TMA ring of K and V,
                                                producer warp, warpgroup
                                                wgmma, dS as register A
        "tf32x3"   csrc/flash_bwd_dq_tf32x3.cu  f32 with D <= 96: the same
                                                pipeline, every product as
                                                three tf32 wgmmas (hi/lo)
        "tf32x3_wide"  csrc/flash_bwd_dq_tf32x3_wide.cu  f32 with
                                                96 < D <= 160: 3xTF32 on a
                                                cluster of two CTAs (S, P
                                                and dP), P and dP passed
                                                both ways through
                                                distributed shared memory,
                                                dQ's columns shared
        "mma"      csrc/flash_bwd.cu            mma.sync: f32 with D > 160,
                                                bf16 with D > 160, a stride
                                                of 0
    flash_bwd_dkv  _bwd_dkv_kernel  dK and dV, through
        "wgmma"    csrc/flash_bwd_dkv_wgmma.cu  bf16: TMA ring, producer
                                                warp, warpgroup wgmma
        "tf32x3"   csrc/flash_bwd_dkv_tf32x3.cu f32 with D <= 96: the same
                                                pipeline, every product as
                                                three tf32 wgmmas (hi/lo)
        "tf32x3_wide"  csrc/flash_bwd_dkv_tf32x3_wide.cu  f32 with
                                                96 < D <= 160: 3xTF32 on a
                                                cluster of two CTAs (S^T,
                                                P^T, dV and dP^T, dS^T, dK),
                                                P^T passed through
                                                distributed shared memory
        "mma"      csrc/flash_bwd.cu            mma.sync: f32 with D > 160,
                                                bf16 with D > 160, a stride
                                                of 0

`_fwd_route`, `_dq_route` and `_bwd_route` pick the forward, the dQ and
the dK/dV kernel from dtype, D and layout alone; `_fwd_bm` the wgmma
forward's q rows per CTA from T, B * H and the SM count (`_fwd_tf32x3_bm`
the tf32x3 forward's, capped by what its shared memory holds), `_dq_bm` the
wgmma dQ kernel's the same way (`_dq_tf32x3_bm` the tf32x3 dQ kernel's,
capped by what its shared memory holds; the tf32x3_wide dQ kernel always
takes TF32X3_DQ_WIDE_BM q rows per cluster pair), `_dkv_bn` the wgmma dK/dV
kernel's kv rows per CTA from S, B * H and the SM count (`_dkv_tf32x3_bn` the
tf32x3 kernel's, capped the same way; the tf32x3_wide kernel always takes
TF32X3_WIDE_BN kv rows per cluster pair). The wgmma and tf32x3 backward
kernels take Q~ = f32(q) * scale rounded to q's dtype (`_q_tilde`: TMA
cannot scale on load). The four tf32x3 backward kernels also take every
f32 operand split into tf32 hi and lo parts (`_split_tf32`), dK/dV (both of
its kernels) q-innermost copies of Q~ and dO, dQ (both of its kernels) a
kv-innermost copy of K (`_tf32x3_transposed`), all formed by
`_tf32x3_operands` from one split of Q~, dO, K and V. The tf32x3 forward takes q, k and v as they are and makes
Q~, its split and those of K and V (V as its pi-permuted transposed copy)
in shared memory after each tile lands.
`flash_attention_backward` forms Q~ and that split once for both backward
wrappers (each wrapper forms its own part when called alone).

`flash_attention(q, k, v, scale)` is the entry point: a
torch.autograd.Function (the JAX custom_vjp, `scale` not differentiated)
whose forward saves (q, k, v, O, L) and whose backward computes
delta = rowsum(dO * O) in f32 with a torch reduction (the JAX package does
it in XLA, outside its kernels) and runs the two backward kernels. It serves
the UNet's spatial self-attention (ops/attention.py routes the shapes that
`supported()` accepts to it), in serving and in training.

Each wrapper runs its plain version for CPU tensors, launches its kernel for
CUDA tensors (or raises: nothing reacts to a failure), and counts its
launches in `<wrapper>.launches` and per kernel in
`<wrapper>.launches_by_kernel` ({"wgmma", "tf32x3", "mma"}, and
"tf32x3_wide" for the two backward wrappers, summing to `launches`).

Build: the first CUDA call of a kernel compiles its own source (and no
other) through ops/build.py (nvcc for sm_90a, plain C entry points loaded
with ctypes). Nothing is compiled or imported at module import.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import build
from .int8_matmul import _sm_count

BQ = 256  # the JAX kernel's q block: the routing rule below keeps its shapes
# the widest head the wgmma forward kernel instantiates: MAX_DP and the
# instance switch of csrc/flash_fwd_wgmma.cu (a CPU test holds them equal)
WGMMA_MAX_D = 160
# the widest f32 head the tf32x3 forward kernel instantiates, and the
# widest at which it holds 128 q rows a CTA: MAX_DP and BM_MAX of
# csrc/flash_fwd_tf32x3.cu (a CPU test holds them equal)
WGMMA_F32_FWD_MAX_D = 160
TF32X3_FWD_BM128_MAX_D = 128
# the same for the wgmma dQ kernel, csrc/flash_bwd_dq_wgmma.cu
WGMMA_DQ_MAX_D = 160
# the same for the wgmma dK/dV kernel, csrc/flash_bwd_dkv_wgmma.cu
WGMMA_DKV_MAX_D = 160
# the widest f32 head the tf32x3 dK/dV kernel instantiates, and the widest
# at which it holds 128 kv rows a CTA: MAX_DP and BN_MAX of
# csrc/flash_bwd_dkv_tf32x3.cu (a CPU test holds them equal)
WGMMA_F32_DKV_MAX_D = 96
TF32X3_BN128_MAX_D = 64
# the widest f32 head the tf32x3_wide dK/dV kernel instantiates (it takes
# WGMMA_F32_DKV_MAX_D < D <= this), and its kv rows per cluster pair:
# MAX_DP and BN of csrc/flash_bwd_dkv_tf32x3_wide.cu
WGMMA_F32_DKV_WIDE_MAX_D = 160
TF32X3_WIDE_BN = 64
# the same for the tf32x3 dQ kernel, csrc/flash_bwd_dq_tf32x3.cu: MAX_DP,
# and the widest head at which BM_MAX is 128 q rows a CTA
WGMMA_F32_DQ_MAX_D = 96
TF32X3_DQ_BM128_MAX_D = 64
# the widest f32 head the tf32x3_wide dQ kernel instantiates (it takes
# WGMMA_F32_DQ_MAX_D < D <= this), and its q rows per cluster pair: MAX_DP
# and BM of csrc/flash_bwd_dq_tf32x3_wide.cu
WGMMA_F32_DQ_WIDE_MAX_D = 160
TF32X3_DQ_WIDE_BM = 64
# the tf32x3 kernels' transposed copies, rounded up with zeros so no TMA
# box lies wholly past them: the q columns of Q~ and dO to T_ALIGN of the
# two dK/dV sources (their largest q tile), the kv columns of K to S_ALIGN
# of the two dQ sources (their largest kv tile)
TF32X3_T_ALIGN = 32
TF32X3_S_ALIGN = 64
# the backward routes whose kernels read the split operands of
# _tf32x3_operands
TF32X3_ROUTES = ("tf32x3", "tf32x3_wide")

_lib_lock = threading.Lock()
_fns: Dict[str, object] = {}  # entry -> the ctypes function, once loaded

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# pointers..., strides, B, H, T, S, D, is_bf16 (bm for "wgmma", "tf32x3",
# "dq_wgmma", "dq_tf32x3" and "dq_tf32x3_wide", bn for "dkv_wgmma",
# "dkv_tf32x3" and "dkv_tf32x3_wide"), scale, stream
_TAIL = [_STRIDES, _INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_float, _PTR]
_ENTRY = {
    # entry: (source stem, C function, pointer arguments)
    "wgmma": ("flash_fwd_wgmma", "flash_fwd_wgmma", 5),
    "tf32x3": ("flash_fwd_tf32x3", "flash_fwd_tf32x3", 5),
    "mma": ("flash_fwd", "flash_fwd", 5),
    # flash_bwd_dq's four routes, "dq_" + route
    "dq_wgmma": ("flash_bwd_dq_wgmma", "flash_bwd_dq_wgmma", 7),
    "dq_tf32x3": ("flash_bwd_dq_tf32x3", "flash_bwd_dq_tf32x3", 13),
    "dq_tf32x3_wide": ("flash_bwd_dq_tf32x3_wide",
                       "flash_bwd_dq_tf32x3_wide", 13),
    "dq_mma": ("flash_bwd", "flash_bwd_dq", 7),
    # flash_bwd_dkv's four routes, "dkv_" + route
    "dkv_wgmma": ("flash_bwd_dkv_wgmma", "flash_bwd_dkv_wgmma", 8),
    "dkv_tf32x3": ("flash_bwd_dkv_tf32x3", "flash_bwd_dkv_tf32x3", 16),
    "dkv_tf32x3_wide": ("flash_bwd_dkv_tf32x3_wide",
                        "flash_bwd_dkv_tf32x3_wide", 16),
    "dkv_mma": ("flash_bwd", "flash_bwd_dkv", 8),
}


def _entry(name: str):
    """The ctypes function of one kernel ("wgmma", "tf32x3" or "mma" forward,
    "dq_" or "dkv_" + a backward route), building its source on first
    use."""
    with _lib_lock:
        if name not in _fns:
            stem, fn_name, n_ptrs = _ENTRY[name]
            fn = getattr(build.load_library(stem), fn_name)
            fn.argtypes = [_PTR] * n_ptrs + _TAIL
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _q_tilde(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q~: q pre-scaled in f32 and rounded once to the input dtype (the JAX
    _scale_q), in q's dtype and, where q is dense, its layout."""
    return (q.float() * scale).to(q.dtype)


def _scale_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Q~ as f32."""
    return _q_tilde(q, scale).float()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of flash_fwd: (B, H, T, D) x (B, H, S, D) ->
    (O (B, H, T, D) in the input dtype, L (B, H, T) float32).

    q is pre-scaled in f32 and rounded to the input dtype (the JAX
    _scale_q); the scores, softmax and L are float32."""
    s = torch.matmul(_scale_q(q, scale), k.float().transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _probs(q, k, lse, scale):
    """(Q~ as f32, P = exp(Q~ K^T - L) in f32)."""
    qs = _scale_q(q, scale)
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    return qs, torch.exp(s - lse[..., None])


def _ds(p, do, v, delta, dt):
    """dS = P * (dO V^T - delta) in f32, rounded to the input dtype."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - delta[..., None])).to(dt).float()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale: float
                           ) -> torch.Tensor:
    """The plain version of flash_bwd_dq (the JAX _bwd_dq_kernel and the
    scale _bwd applies after it): dQ = scale * dS K, rounded to the input
    dtype before and after the scale."""
    _, p = _probs(q, k, lse, scale)
    ds = _ds(p, do, v, delta, q.dtype)
    dq = torch.matmul(ds, k.float()).to(q.dtype)
    return (dq.float() * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of flash_bwd_dkv (the JAX _bwd_dkv_kernel):
    dV = P^T dO with P rounded to the input dtype; dK = dS^T Q~ with no
    further scale."""
    qs, p = _probs(q, k, lse, scale)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    ds = _ds(p, do, v, delta, q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, T) contiguous."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_attention_backward_reference(q, k, v, o, lse, do, scale: float
                                       ) -> Tuple[torch.Tensor, ...]:
    """The plain version of the whole backward (the JAX _bwd): (dq, dk, dv)
    in the input dtype, from the forward's residuals (q, k, v, O, L) and
    dO."""
    delta = _delta(o, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale), dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _layout_ok(t: torch.Tensor) -> bool:
    """What the kernels' 16-byte vector loads take: a unit last stride,
    other strides multiples of 8 elements, a 16-byte aligned base."""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q, k, v, do=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention needs CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, H, T, D) tensors")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        if do.shape != q.shape:
            raise ValueError(f"dO{tuple(do.shape)} is not q's shape "
                             f"{tuple(q.shape)}")
        named.append(("dO", do))
    if any(t.dtype != q.dtype for _, t in named) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention takes bf16 or f32, got "
                         f"{[str(t.dtype) for _, t in named]}")
    if D % 8 or D > 256 or T < 1 or k.shape[2] < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}: needs D % 8 == 0, D <= 256")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not _layout_ok(t):
            raise ValueError(
                f"{name} must have a unit last stride, strides that are "
                f"multiples of 8 and a 16-byte aligned base; got strides "
                f"{t.stride()}")


def _check_stats(q, *stats):
    B, H, T, _ = q.shape
    for t in stats:
        if (t.shape != (B, H, T) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"L and delta must be contiguous float32 "
                             f"({B}, {H}, {T}) on {q.device}, got "
                             f"{t.dtype}{tuple(t.shape)}")


def _tma_ok(*tensors: torch.Tensor) -> bool:
    """Every tensor has a layout TMA's tensor maps take: _layout_ok, and no
    stride of 0."""
    return all(_layout_ok(t) and min(t.stride()[:3]) > 0 for t in tensors)


def _route(max_d: int, q: torch.Tensor, *others: torch.Tensor) -> str:
    """"wgmma" for bf16 with D <= max_d where every tensor has a layout
    TMA's tensor maps take (_tma_ok), else "mma"."""
    if (q.dtype == torch.bfloat16 and q.shape[3] <= max_d
            and _tma_ok(q, *others)):
        return "wgmma"
    return "mma"


def _fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward kernel of a call: "wgmma" (csrc/flash_fwd_wgmma.cu) for
    bf16 with D <= WGMMA_MAX_D, "tf32x3" (csrc/flash_fwd_tf32x3.cu) for
    f32 with D <= WGMMA_F32_FWD_MAX_D, each where the layouts are ones
    TMA's tensor maps take (_layout_ok: 16-byte strides and bases; and no
    stride of 0); "mma" (csrc/flash_fwd.cu) for the rest: wider D, a
    broadcast. A layout _layout_ok refuses never launches: _check raises
    first."""
    return _kernel_route(WGMMA_MAX_D, WGMMA_F32_FWD_MAX_D, q, k, v)


def _fwd_bm(T: int, bh: int, sms: int = 132) -> int:
    """q rows per CTA of the wgmma kernel for T q rows and bh = B * H heads
    on `sms` SMs: 128 (two consumer warpgroups) unless that gives fewer
    CTAs than SMs, then 64."""
    return 128 if -(-T // 128) * bh >= sms else 64


def _fwd_tf32x3_bm(T: int, bh: int, D: int, sms: int = 132) -> int:
    """q rows per CTA of the tf32x3 forward kernel: _fwd_bm's rule where
    the instance holds 128 rows (D <= TF32X3_FWD_BM128_MAX_D), else 64."""
    return _fwd_bm(T, bh, sms) if D <= TF32X3_FWD_BM128_MAX_D else 64


def _kernel_route(max_d: int, f32_max_d: int, q: torch.Tensor,
                  *others: torch.Tensor) -> str:
    """"tf32x3" for f32 with D <= f32_max_d where every tensor has a
    layout TMA's tensor maps take (_tma_ok), else _route's rule."""
    if (q.dtype == torch.float32 and q.shape[3] <= f32_max_d
            and _tma_ok(q, *others)):
        return "tf32x3"
    return _route(max_d, q, *others)


def _bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor) -> str:
    """The dK/dV kernel of a call: "wgmma" (csrc/flash_bwd_dkv_wgmma.cu)
    for bf16 with D <= WGMMA_DKV_MAX_D, "tf32x3"
    (csrc/flash_bwd_dkv_tf32x3.cu) for f32 with D <= WGMMA_F32_DKV_MAX_D,
    "tf32x3_wide" (csrc/flash_bwd_dkv_tf32x3_wide.cu) for f32 with
    WGMMA_F32_DKV_MAX_D < D <= WGMMA_F32_DKV_WIDE_MAX_D, each where the
    layouts are ones TMA's tensor maps take (_tma_ok); "mma"
    (csrc/flash_bwd.cu) for the rest: wider D, a broadcast. A layout
    _layout_ok refuses never launches: _check raises first."""
    return _wide_route(WGMMA_DKV_MAX_D, WGMMA_F32_DKV_MAX_D,
                       WGMMA_F32_DKV_WIDE_MAX_D, q, k, v, do)


def _dq_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor) -> str:
    """The dQ kernel of a call: _bwd_route's rule with WGMMA_DQ_MAX_D,
    WGMMA_F32_DQ_MAX_D and WGMMA_F32_DQ_WIDE_MAX_D, "wgmma"
    (csrc/flash_bwd_dq_wgmma.cu), "tf32x3" (csrc/flash_bwd_dq_tf32x3.cu),
    "tf32x3_wide" (csrc/flash_bwd_dq_tf32x3_wide.cu) or "mma"
    (csrc/flash_bwd.cu)."""
    return _wide_route(WGMMA_DQ_MAX_D, WGMMA_F32_DQ_MAX_D,
                       WGMMA_F32_DQ_WIDE_MAX_D, q, k, v, do)


def _wide_route(max_d: int, f32_max_d: int, f32_wide_max_d: int,
                q: torch.Tensor, *others: torch.Tensor) -> str:
    """"tf32x3_wide" for f32 with f32_max_d < D <= f32_wide_max_d where
    every tensor has a layout TMA's tensor maps take (_tma_ok), else
    _kernel_route's rule."""
    if (q.dtype == torch.float32
            and f32_max_d < q.shape[3] <= f32_wide_max_d
            and _tma_ok(q, *others)):
        return "tf32x3_wide"
    return _kernel_route(max_d, f32_max_d, q, *others)


def _dq_bm(T: int, bh: int, sms: int = 132) -> int:
    """q rows per CTA of the wgmma dQ kernel for T q rows and bh = B * H
    heads on `sms` SMs: _fwd_bm's rule (128, two consumer warpgroups,
    unless that gives fewer CTAs than SMs)."""
    return _fwd_bm(T, bh, sms)


def _dq_tf32x3_bm(T: int, bh: int, D: int, sms: int = 132) -> int:
    """q rows per CTA of the tf32x3 dQ kernel: _dq_bm's rule where the
    instance holds 128 rows (D <= TF32X3_DQ_BM128_MAX_D), else 64."""
    return _dq_bm(T, bh, sms) if D <= TF32X3_DQ_BM128_MAX_D else 64


def _dkv_bn(S: int, bh: int, sms: int = 132) -> int:
    """kv rows per CTA of the wgmma dK/dV kernel for S kv rows and
    bh = B * H heads on `sms` SMs: _fwd_bm's rule over the kv rows (128,
    two consumer warpgroups, unless that gives fewer CTAs than SMs)."""
    return _fwd_bm(S, bh, sms)


def _dkv_tf32x3_bn(S: int, bh: int, D: int, sms: int = 132) -> int:
    """kv rows per CTA of the tf32x3 dK/dV kernel: _dkv_bn's rule where
    the instance holds 128 rows (D <= TF32X3_BN128_MAX_D), else 64."""
    return _dkv_bn(S, bh, sms) if D <= TF32X3_BN128_MAX_D else 64


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero: cvt.rna.tf32.f32) as f32 whose low 13 bits are zero, in x's
    layout. |x| must stay below (2 - 2^-11) * 2^127, which rounds to inf."""
    return ((x.view(torch.int32) + 0x1000).bitwise_and_(-0x2000)
            ).view(torch.float32)


def _split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both tf32 in f32 bit patterns: hi = tf32(x),
    lo = tf32(x - hi), so that x = hi + lo to within 2^-22 |x| (while the
    remainder is a normal number). The operands of 3xTF32."""
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _tf32x3_transposed(x: torch.Tensor,
                       align: int = TF32X3_T_ALIGN) -> torch.Tensor:
    """(B, H, T, D) -> (B, H, D, T') contiguous, T' = T rounded up to
    `align` with zeros past T, rows permuted within each group of 8 by
    pi = [0, 2, 4, 6, 1, 3, 5, 7] (column 8j + p holds row 8j + pi(p)):
    the K-major B operand of a tf32x3 kernel's products over the row axis
    (dV and dK over q, dQ over kv), whose register-A fragments are then the
    score accumulators as they are. pi is a (4, 2) -> (2, 4) transpose of
    each group of 8."""
    B, H, T, D = x.shape
    tp = -(-T // align) * align
    y = torch.nn.functional.pad(x, (0, 0, 0, tp - T))
    return y.view(B, H, tp // 8, 4, 2, D).permute(0, 1, 5, 2, 4, 3).reshape(
        B, H, D, tp)


def _tf32x3_operands(q_tilde, do, k, v, kernels=("dq", "dkv")
                     ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """{kernel: operands} of the tf32x3 kernels named in `kernels` ("dq",
    "dkv"), from one split of each f32 tensor into hi and lo. Both read Q~,
    dO, K, V hi and lo (in their layouts); then "dkv" the transposed copies
    of Q~ and dO (twelve tensors), "dq" that of K (ten)."""
    qh, ql = _split_tf32(q_tilde)
    oh, ol = _split_tf32(do)
    kh, kl = _split_tf32(k)
    split = (qh, ql, oh, ol, kh, kl, *_split_tf32(v))
    ops = {}
    if "dkv" in kernels:
        ops["dkv"] = split + tuple(_tf32x3_transposed(x)
                                   for x in (qh, ql, oh, ol))
    if "dq" in kernels:
        ops["dq"] = split + tuple(_tf32x3_transposed(x, TF32X3_S_ALIGN)
                                  for x in (kh, kl))
    return ops


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn, name, ptrs, strides, q, k, arg, scale):
    """One C entry point on the current stream; `arg` is is_bf16 (bm for
    the wgmma and tf32x3 forward and the wgmma and tf32x3 dQ kernels, bn
    for the
    wgmma and tf32x3 dK/dV kernels)."""
    B, H, T, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, strides, B, H, T, k.shape[2], D, arg, float(scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} for "
                           f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")


def _fwd_launch(route, q, k, v, scale, bm=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward kernel through its C entry point (no routing, no count):
    the wgmma and tf32x3 kernels at `bm` q rows per CTA (by default
    _fwd_bm's, or _fwd_tf32x3_bm's), the mma kernel at its own tile."""
    B, H, T, D = q.shape
    # O in q's layout when q is dense (the UNet's transposed views), else
    # contiguous; either way strides the kernels take (checked for q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if route == "tf32x3":
        arg = bm or _fwd_tf32x3_bm(T, B * H, D, _sm_count(q.device))
    elif route == "wgmma":
        arg = bm or _fwd_bm(T, B * H, _sm_count(q.device))
    else:
        arg = int(q.dtype == torch.bfloat16)
    _launch(_entry(route), f"flash_fwd ({route})",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), _strides(q, k, v, out), q, k, arg, scale)
    return out, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, T, D) non-causal attention forward -> (O, L), O in q's layout
    and dtype, L float32 (B, H, T). No autograd: see flash_attention. CUDA
    tensors launch the kernel `_fwd_route` picks."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check(q, k, v)
    route = _fwd_route(q, k, v)
    out, lse = _fwd_launch(route, q, k, v, scale)
    flash_fwd.launches_by_kernel[route] += 1
    flash_fwd.launches += 1
    return out, lse


def _dq_launch(route, q, k, v, do, lse, delta, scale, bm=None,
               operands=None) -> torch.Tensor:
    """One dQ kernel through its C entry point (no routing, no count). The
    wgmma and tf32x3 kernels take q as Q~ (_q_tilde: TMA cannot scale on
    load) and `bm` q rows per CTA (by default _dq_bm's, or
    _dq_tf32x3_bm's; tf32x3_wide: TF32X3_DQ_WIDE_BM per cluster pair, the
    only height it takes); the tf32x3 and tf32x3_wide kernels read
    _tf32x3_operands(q, do, k, v)["dq"], formed here unless given as
    `operands`; the mma kernel takes q and scales it itself. dQ comes back
    in the layout of the q given."""
    dq = torch.empty_like(q)
    B, H, T, D = q.shape
    tensors = (q, k, v, do)
    if route in TF32X3_ROUTES:
        tensors = operands or _tf32x3_operands(q, do, k, v, ("dq",))["dq"]
        arg = bm or (TF32X3_DQ_WIDE_BM if route == "tf32x3_wide" else
                     _dq_tf32x3_bm(T, B * H, D, _sm_count(q.device)))
    elif route == "wgmma":
        arg = bm or _dq_bm(T, B * H, _sm_count(q.device))
    else:
        arg = int(q.dtype == torch.bfloat16)
    _launch(_entry(f"dq_{route}"), f"flash_bwd_dq ({route})",
            [t.data_ptr() for t in (*tensors, lse, delta, dq)],
            _strides(*tensors, dq), q, k, arg, scale)
    return dq


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, q_tilde=None,
                 operands=None) -> torch.Tensor:
    """dQ in q's layout (where q is dense) and dtype, from the forward's q,
    k, v, L, the incoming dO and delta = rowsum(dO * O). CUDA tensors
    launch the kernel `_dq_route` picks; the wgmma and tf32x3 kernels read
    `q_tilde` (_q_tilde(q, scale)) and the tf32x3 kernel `operands`
    (_tf32x3_operands(q_tilde, do, k, v)["dq"]) where the caller has
    formed them, else the wrapper forms them."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    route = _dq_route(q, k, v, do)
    if route != "mma":
        q = _q_tilde(q, scale) if q_tilde is None else q_tilde
    dq = _dq_launch(route, q, k, v, do, lse, delta, scale,
                    operands=operands)
    flash_bwd_dq.launches_by_kernel[route] += 1
    flash_bwd_dq.launches += 1
    return dq


def _dkv_launch(route, q, k, v, do, lse, delta, scale, bn=None,
                operands=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dK/dV kernel through its C entry point (no routing, no count).
    The wgmma and tf32x3 kernels take q as Q~ (_q_tilde: TMA cannot scale
    on load) and `bn` kv rows per CTA (by default _dkv_bn's, or
    _dkv_tf32x3_bn's; tf32x3_wide: TF32X3_WIDE_BN per cluster pair, the
    only height it takes); the tf32x3 and tf32x3_wide kernels read
    _tf32x3_operands(q, do, k, v)["dkv"], formed here unless given as
    `operands`; the mma kernel takes q and scales it itself."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, H, _, D = q.shape
    tensors = (q, k, v, do)
    if route in TF32X3_ROUTES:
        tensors = operands or _tf32x3_operands(q, do, k, v, ("dkv",))["dkv"]
        arg = bn or (TF32X3_WIDE_BN if route == "tf32x3_wide" else
                     _dkv_tf32x3_bn(k.shape[2], B * H, D, _sm_count(q.device)))
    elif route == "wgmma":
        arg = bn or _dkv_bn(k.shape[2], B * H, _sm_count(q.device))
    else:
        arg = int(q.dtype == torch.bfloat16)
    _launch(_entry(f"dkv_{route}"), f"flash_bwd_dkv ({route})",
            [t.data_ptr() for t in (*tensors, lse, delta, dk, dv)],
            _strides(*tensors, dk, dv), q, k, arg, scale)
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, q_tilde=None,
                  operands=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) in k's and v's layouts and dtype; inputs as flash_bwd_dq
    (`operands`: _tf32x3_operands(q_tilde, do, k, v)["dkv"]). CUDA tensors
    launch the kernel `_bwd_route` picks."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    route = _bwd_route(q, k, v, do)
    if route != "mma":
        q = _q_tilde(q, scale) if q_tilde is None else q_tilde
    dk, dv = _dkv_launch(route, q, k, v, do, lse, delta, scale,
                         operands=operands)
    flash_bwd_dkv.launches_by_kernel[route] += 1
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches_by_kernel = {"wgmma": 0, "tf32x3": 0, "mma": 0}
flash_fwd.launches = 0  # the sum of launches_by_kernel
flash_bwd_dq.launches_by_kernel = {"wgmma": 0, "tf32x3": 0,
                                   "tf32x3_wide": 0, "mma": 0}
flash_bwd_dq.launches = 0  # the sum of launches_by_kernel
flash_bwd_dkv.launches_by_kernel = {"wgmma": 0, "tf32x3": 0,
                                    "tf32x3_wide": 0, "mma": 0}
flash_bwd_dkv.launches = 0  # the sum of launches_by_kernel


def flash_attention_backward(q, k, v, o, lse, do, scale: float
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) through the two backward kernels (their plain versions
    on the CPU). Where either routes to a kernel that reads Q~ (wgmma,
    tf32x3, tf32x3_wide), Q~ is formed once here and handed to both, and
    where either routes to a kernel of TF32X3_ROUTES, so is the split of
    Q~, dO, K and V (_tf32x3_operands, each kernel's part)."""
    qt, ops = None, {}
    if do.device.type == "cuda":
        if not _layout_ok(do):
            # dO comes with whatever strides autograd gives it (the UNet's
            # is a transposed view the kernels take as it is); one copy
            # otherwise
            do = do.contiguous()
        routes = {"dq": _dq_route(q, k, v, do),
                  "dkv": _bwd_route(q, k, v, do)}
        if set(routes.values()) != {"mma"}:
            qt = _q_tilde(q, scale)
        tf32x3 = [n for n, r in routes.items() if r in TF32X3_ROUTES]
        if tf32x3:
            ops = _tf32x3_operands(qt, do, k, v, tf32x3)
    delta = _delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, qt,
                           ops.get("dkv"))
    return flash_bwd_dq(q, k, v, do, lse, delta, scale, qt,
                        ops.get("dq")), dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX custom_vjp (flash_attention.py:340-353): the forward saves
    (q, k, v, O, L); `scale` takes no gradient; L is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do,
                                              ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, T, D) non-causal attention -> (O, L), O in q's layout and
    dtype, L float32 (B, H, T), differentiable in q, k and v.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    return _FlashAttention.apply(q, k, v, scale)


def supported(q_shape, k_shape) -> bool:
    """The JAX package's routing rule (flash_attention.py:356-359: T a
    multiple of its 256-row q block, S of its 128-row kv block), kept so
    both packages send the same calls to their kernels."""
    return q_shape[2] % BQ == 0 and k_shape[2] % 128 == 0
