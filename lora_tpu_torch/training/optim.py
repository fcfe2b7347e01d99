"""AdamW over the trainable tree's groups with per-group learning rates, the
counterpart of lora_tpu/training/optim.py (optax).

`make_optimizer(trainable, lrs)` binds the optimizer to the trainable
leaves (tensors that require grad) and reads their `.grad`; `step()`
applies one update in place, as the JAX step's `optax.apply_updates` does
functionally. What optax does, step() does in the same order:

- grad_accum = k (optax.MultiSteps): the gradients of k micro-steps are
  averaged; every k-th call applies the inner update, the others change
  nothing.
- the global-norm clip over all groups with the JAX formula,
  scale = min(1, max_norm / max(||g||, 1e-16)) (optim.py:165-168;
  torch.nn.utils.clip_grad_norm_ divides by ||g|| + 1e-6 instead);
- AdamW per group (torch.optim.AdamW, fused on CUDA): decoupled weight
  decay times lr, eps added after the bias-corrected square root, exactly
  optax.adamw; weight decay 0 for the "ti" group;
- the learning rate of each group is its schedule at the count of applied
  updates before this one, so the first update uses lr(0).

A leaf that got no gradient is updated with a zero gradient (its weight
decay still applies), as jax.grad returns zeros for it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


def make_lr_schedule(name: str, lr: float, total_steps: int,
                     warmup_steps: int = 0) -> Schedule:
    """constant / linear / cosine (+ optional linear warmup from 0), the
    optax schedules of the JAX package: count -> lr."""
    decay_steps = max(total_steps - warmup_steps, 1)
    if name == "constant":
        def base(count):
            return lr
    elif name == "linear":
        def base(count):
            return lr * (1.0 - min(max(count, 0), decay_steps) / decay_steps)
    elif name == "cosine":
        def base(count):
            frac = min(max(count, 0), decay_steps) / decay_steps
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    else:
        raise ValueError(f"unknown lr schedule {name}")
    if warmup_steps <= 0:
        return base

    def schedule(count):
        if count < warmup_steps:
            return lr * max(count, 0) / warmup_steps
        return base(count - warmup_steps)

    return schedule


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in jax.tree_util's order (sorted
    keys)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if tree is None:
        return []
    raise TypeError(f"unexpected leaf {type(tree)} in a trainable tree")


class GroupedAdamW:
    """The optimizer make_optimizer returns; see the module docstring."""

    def __init__(self, trainable: Dict, lrs: Dict[str, Union[Schedule, float]],
                 *, weight_decay: float, betas: Sequence[float], eps: float,
                 max_grad_norm: Optional[float], grad_accum: int):
        self.groups: Dict[str, List[torch.Tensor]] = {
            name: tree_leaves(sub) for name, sub in trainable.items()
            if sub is not None}
        self.params = [p for leaves in self.groups.values() for p in leaves]
        if not self.params:
            raise ValueError("make_optimizer got no trainable leaves")
        for p in self.params:
            if not (p.requires_grad and p.is_leaf):
                raise ValueError("trainable leaves must be leaf tensors that "
                                 "require grad (convert.trainable_from_jax)")
        self.schedules = {
            name: lrs[name] if callable(lrs[name])
            else (lambda count, lr=float(lrs[name]): lr)
            for name in self.groups}
        self.max_grad_norm = max_grad_norm
        self.grad_accum = int(grad_accum)
        self.count = 0       # applied updates (optax's inner count)
        self.mini_step = 0   # micro-steps since the last update
        self._acc: Optional[List[torch.Tensor]] = None
        self.adamw = torch.optim.AdamW(
            [{"params": leaves, "name": name,
              "weight_decay": 0.0 if name == "ti" else weight_decay}
             for name, leaves in self.groups.items()],
            lr=0.0, betas=tuple(betas), eps=eps,
            fused=True if self.params[0].is_cuda else None)

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """Apply the gradients now in the leaves' .grad (then clear them)."""
        grads = self._grads()
        self.zero_grad()
        if self.grad_accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # the running mean of optax.MultiSteps
            n = self.mini_step
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                return
            grads, self._acc, self.mini_step = self._acc, None, 0
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.clamp(self.max_grad_norm / norm.clamp_min(1e-16),
                                max=1.0)
            torch._foreach_mul_(grads, scale)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = float(self.schedules[group["name"]](self.count))
        self.adamw.step()
        self.count += 1
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(
    trainable: Dict,
    lrs: Dict[str, Union[Schedule, float]],
    *,
    weight_decay: float = 1e-2,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    grad_accum: int = 1,
    low_memory: Union[bool, str] = False,
) -> GroupedAdamW:
    """lrs: {"lora_unet": lr, "lora_text": lr, "ti": lr}, floats or
    schedules (count -> lr), for the groups of `trainable`. On CUDA the
    update is torch's fused AdamW, the counterpart of the JAX package's
    default fused=True (one update over each group's raveled vector)."""
    if low_memory:
        raise NotImplementedError(
            f"low_memory={low_memory!r} (the bf16 first moment and the "
            "blockwise-int8 Adam) is not ported yet (ROADMAP Slice 4)")
    return GroupedAdamW(trainable, lrs, weight_decay=weight_decay,
                        betas=betas, eps=eps, max_grad_norm=max_grad_norm,
                        grad_accum=grad_accum)
