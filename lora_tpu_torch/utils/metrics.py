"""Lightweight metrics: JSONL logging with an optional wandb passthrough,
and step timing; the counterpart of lora_tpu/utils/metrics.py."""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 echo: bool = True):
        self.path = path
        self.echo = echo
        self.t0 = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
            except ImportError:
                print("wandb not available; falling back to JSONL only")

    def log(self, **kv):
        rec = {"t": round(time.time() - self.t0, 3), **kv}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.wandb is not None and getattr(self.wandb, "run", None):
            self.wandb.log(kv)
        if self.echo:
            print(" ".join(f"{k}={v:.5g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in rec.items()))


class StepTimer:
    """Rolling steps/sec over host-clock ticks (tick after a device sync to
    time device work)."""

    def __init__(self):
        self.start = None
        self.count = 0

    def tick(self):
        if self.start is None:
            self.start = time.perf_counter()
        self.count += 1

    @property
    def steps_per_sec(self) -> float:
        if not self.start or self.count < 2:
            return 0.0
        return (self.count - 1) / (time.perf_counter() - self.start)
