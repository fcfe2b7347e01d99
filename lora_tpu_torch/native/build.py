"""Build and load the native image preprocessing (native/imgops.c).

The C source is compiled with $CC (default cc) into a shared library with a
plain C entry point and loaded with ctypes, as ops/build.py builds the CUDA
kernels: no Python headers are needed. It is built at first use into
ops/build.py's build_dir(), cached by a key over the source and the flags,
under that directory's build lock (ops/build.py build_lock: one process
compiles, the others wait and load), and nothing is compiled at import. A
failed build or load raises with the compiler's message: the caller asked
for the native path, and there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "imgops.c")
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def _key(cc: str) -> str:
    h = hashlib.sha256(" ".join((cc,) + CC_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """The library's path, compiling native/imgops.c first if needed."""
    from ..ops.build import build_dir, build_lock

    cc = os.environ.get("CC", "cc")
    out_dir = build_dir()
    path = os.path.join(out_dir, f"imgops_{_key(cc)}.so")
    if os.path.exists(path):
        return path
    with build_lock(out_dir):  # another process may have built it
        if not os.path.exists(path):
            _compile(cc, out_dir, path)
    return path


def _compile(cc: str, out_dir: str, path: str) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cc, *CC_FLAGS, _SRC, "-o", tmp, "-lm"],
                                  capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building {_SRC} with {cc!r} failed: {e}"
                               ) from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SRC} with {cc!r} failed ({proc.returncode}):\n"
                f"{(proc.stderr or proc.stdout)[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.lora_resize_crop_normalize
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
            _lib = lib
        return _lib


def resize_crop_normalize(pixels: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) float32 in [-1, 1]: bilinear
    resize of the short side to `size`, center crop, normalization, in one
    pass of the native code."""
    src = np.ascontiguousarray(pixels, np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected (H, W, C) pixels, got {src.shape}")
    h, w, c = src.shape
    out = np.empty((size, size, c), np.float32)
    rc = load().lora_resize_crop_normalize(src.ctypes.data, h, w, c, size,
                                           out.ctypes.data)
    if rc != 0:
        raise ValueError(f"native resize of {src.shape} to {size}: bad "
                         f"dimensions")
    return out
