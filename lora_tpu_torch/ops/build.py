"""Build and load the hand-written CUDA kernels of ops/csrc/.

Every csrc/*.cu is compiled with nvcc for sm_90a into a shared library with
plain C entry points and loaded with ctypes. Each library is cached in the
build directory by a key over its own source, every csrc/*.cuh and the
flags: editing a source rebuilds only its library, editing a header
rebuilds them all. The build directory is $LORA_TPU_TORCH_BUILD_DIR when
that is set, else lora_tpu_torch/_build/ beside the sources (a checkout),
else, where the package directory cannot be written (an installed wheel),
lora_tpu_torch/build under the user's cache directory. The first CUDA call
of a kernel wrapper builds only the library it needs; build() with no
arguments compiles them all, one nvcc process per source, all started
together. Processes that share the build directory (the ranks of a
process group at their first call) build under an flock on
<build dir>/.build.lock: one compiles, the others wait and load its
libraries. Nothing is compiled at import, and a failed or impossible build
raises (CUDA tensors have no other path).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional

_CSRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
BUILD_DIR_ENV = "LORA_TPU_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    """Where the libraries are built and cached (see the module note)."""
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return override
    existing = _BUILD_DIR if os.path.isdir(_BUILD_DIR) else os.path.dirname(
        _BUILD_DIR)
    if os.access(existing, os.W_OK):
        return _BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "lora_tpu_torch", "build")


@contextlib.contextmanager
def build_lock(out_dir: str):
    """An exclusive flock on out_dir/.build.lock for the block: builds into
    one directory from several processes run one at a time."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".build.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _find_nvcc() -> Optional[str]:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    return shutil.which("nvcc")


def _sources() -> Dict[str, str]:
    """{stem: path} of every csrc/*.cu."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu")))}


def _key(source: str) -> str:
    """A key over one source, every csrc/*.cuh (a source may include any
    of them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cuh")))
    for path in [source, *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(stems: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile csrc/<stem>.cu for each stem (every source when None) into
    build_dir() (once per key), one nvcc process per source, all started
    together; return {stem: library path}. nvcc's ptxas report (registers,
    shared memory, spills per kernel) is kept beside each library as
    <stem>_<key>.log."""
    sources = _sources()
    if stems is not None:
        missing = sorted(set(stems) - set(sources))
        if missing:
            raise RuntimeError(f"no csrc/<stem>.cu for {missing} among "
                               f"{sorted(sources)}")
        sources = {s: sources[s] for s in stems}
    out_dir = build_dir()
    paths = {stem: os.path.join(out_dir, f"{stem}_{_key(src)}.so")
             for stem, src in sources.items()}
    if all(os.path.exists(path) for path in paths.values()):
        return paths
    with build_lock(out_dir):  # another process may have built them
        _build_missing(sources, paths, out_dir)
    return paths


def _build_missing(sources: Dict[str, str], paths: Dict[str, str],
                   out_dir: str) -> None:
    todo = [stem for stem, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA kernels "
            "cannot be built, and CUDA tensors have no other path")
    tmps, procs = {}, {}
    try:
        for stem in todo:
            fd, tmps[stem] = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            procs[stem] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmps[stem], sources[stem]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outs = {stem: proc.communicate() for stem, proc in procs.items()}
        for stem, (out, err) in outs.items():
            with open(paths[stem][:-3] + ".log", "w") as f:
                f.write(f"==== {sources[stem]}\n{out}{err}")
        for stem, proc in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{sources[stem]}:\n{outs[stem][1][-4000:]}")
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


def load_library(stem: str) -> ctypes.CDLL:
    """The library built from csrc/<stem>.cu, building only that source
    first if needed; loaded once per process."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(build([stem])[stem])
        return _libs[stem]
