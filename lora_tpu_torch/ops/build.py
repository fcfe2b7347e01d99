"""Build and load the hand-written CUDA kernels of ops/csrc/.

Every csrc/*.cu is compiled with nvcc for sm_90a into a shared library with
plain C entry points, one nvcc process per source, all started together,
and loaded with ctypes. The libraries are cached under lora_tpu_torch/_build/
by a key over every file under csrc/ (headers included) and the flags, so
editing any source rebuilds all of them. The first CUDA call of any kernel
wrapper builds every library; nothing is compiled at import, and a failed
or impossible build raises (CUDA tensors have no other path).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Tuple

_CSRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    return shutil.which("nvcc")


def _sources() -> Tuple[list, str]:
    """The csrc/*.cu sources and a key over every file under csrc/ (headers
    included) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu"))), h.hexdigest()[:16]


def build() -> Dict[str, str]:
    """Compile each csrc/*.cu into _build/ (once per key), one nvcc process
    per source, all started together; return {source stem: library path}.
    nvcc's ptxas report (registers, shared memory, spills per kernel) is
    kept beside them as build.log."""
    sources, key = _sources()
    libs = {os.path.splitext(os.path.basename(s))[0]: s for s in sources}
    paths = {stem: os.path.join(_BUILD_DIR, f"{stem}_{key}.so")
             for stem in libs}
    todo = [stem for stem, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA kernels "
            "cannot be built, and CUDA tensors have no other path")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmps, procs = {}, {}
    try:
        for stem in todo:
            fd, tmps[stem] = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            procs[stem] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmps[stem], libs[stem]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outs = {stem: proc.communicate() for stem, proc in procs.items()}
        with open(os.path.join(_BUILD_DIR, "build.log"), "w") as f:
            for stem, (out, err) in outs.items():
                f.write(f"==== {libs[stem]}\n{out}{err}")
        for stem, proc in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {libs[stem]}:\n"
                    f"{outs[stem][1][-4000:]}")
        for stem in todo:
            os.replace(tmps[stem], paths[stem])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load_library(stem: str) -> ctypes.CDLL:
    """The library built from csrc/<stem>.cu, building every source first
    if needed; loaded once per process."""
    with _lock:
        if stem not in _libs:
            paths = build()
            if stem not in paths:
                raise RuntimeError(f"no csrc/{stem}.cu among {sorted(paths)}")
            _libs[stem] = ctypes.CDLL(paths[stem])
        return _libs[stem]
