"""The full training state in one file, the counterpart of
lora_tpu/training/checkpoint.py: the trainable leaves, the optimizer's
state, the step and the trainer's random generator, so a resumed run goes
on exactly where the saved one stopped. And PreemptionGuard, which turns
SIGTERM into a flag the training loop polls.

The container is lora_tpu's: one safetensors file with the tensors
"leaf:{i}" (the trainable leaves in tree_leaves order, then the optimizer's
state_tensors(): see training/optim.py), "__rng__" (the torch.Generator's
state) and the "step" and "n_leaves" metadata. Restoring needs a trainable
tree and an optimizer built from the same config; a count or shape that
differs raises. The files are not interchangeable with lora_tpu's:
jax.random keys and optax states have no torch counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.reader import SafetensorsFile, save_file
from .optim import GroupedAdamW, tree_leaves


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 widens to f32 (exact), as the reader gives it back."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_train_state(path: str, trainable: dict, optimizer: GroupedAdamW,
                     step: int, generator: torch.Generator) -> None:
    leaves = tree_leaves(trainable) + optimizer.state_tensors()
    tensors = {f"leaf:{i}": _numpy(t) for i, t in enumerate(leaves)}
    tensors["__rng__"] = generator.get_state().numpy()
    save_file(tensors, path, {"step": str(step),
                              "n_leaves": str(len(leaves))})


@torch.no_grad()
def load_train_state(path: str, trainable: dict, optimizer: GroupedAdamW,
                     generator: Optional[torch.Generator] = None) -> int:
    """Restore the file into `trainable` (in place), `optimizer` and
    `generator` (when given); return the step."""
    params = tree_leaves(trainable)
    like = params + optimizer.state_tensors()
    with SafetensorsFile(path) as f:
        meta = f.metadata()
        n = int(meta["n_leaves"])
        if n != len(like):
            raise ValueError(
                f"checkpoint has {n} leaves, expected {len(like)} — was the "
                "optimizer/trainable config changed?")
        arrays = [torch.from_numpy(np.array(f.get_tensor(f"leaf:{i}")))
                  for i in range(n)]
        rng = torch.from_numpy(np.array(f.get_tensor("__rng__")))
        step = int(meta["step"])
    for i, (arr, ref) in enumerate(zip(arrays, like)):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} shape {tuple(arr.shape)} != expected "
                             f"{tuple(ref.shape)}")
    for leaf, arr in zip(params, arrays):
        leaf.copy_(arr.to(device=leaf.device, dtype=leaf.dtype))
    optimizer.load_state_tensors(arrays[len(params):])
    if generator is not None:
        generator.set_state(rng)
    return step


class PreemptionGuard:
    """SIGTERM (what cluster schedulers and host maintenance deliver) sets
    `should_stop`; the training loop polls it once per micro-step, saves
    the full train state and returns cleanly. A context manager: the
    previous handlers come back on exit. Off the main thread, where CPython
    forbids signal(), nothing is installed and should_stop stays False."""

    def __init__(self, signals=None):
        import signal as _signal

        self._signal = _signal
        self.signals = (signals if signals is not None
                        else (_signal.SIGTERM,))
        self.should_stop = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        try:
            for s in self.signals:
                self._prev[s] = self._signal.signal(s, self._handler)
        except ValueError:  # not the main thread
            self._prev = {}
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            self._signal.signal(s, h)
        return False
