"""Profiling on torch.profiler, the counterpart of
lora_tpu/utils/profiling.py: a device trace written as a Chrome trace
(Perfetto, chrome://tracing), named regions inside it, host wall timing
with an optional device sync, and the device's memory statistics."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "lora_tpu_torch_trace") -> Iterator[
        torch.profiler.profile]:
    """Capture a CPU + CUDA trace of the block into
    log_dir/trace.json: `with trace("t"): run_steps()`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(label: str, sync=None) -> Iterator[None]:
    """Host wall timing of the block. sync: a CUDA device (or True for the
    current one) to synchronise before the clock stops, so the time covers
    the device work the block queued."""
    t0 = time.perf_counter()
    yield
    if sync is not None and sync is not False:
        torch.cuda.synchronize(None if sync is True else sync)
    print(f"[timing] {label}: {(time.perf_counter() - t0) * 1000:.2f} ms")


def memory_stats(device: Optional[torch.device] = None) -> dict:
    """torch.cuda.memory_stats of `device` (the current CUDA device by
    default); {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return torch.cuda.memory_stats(device)
