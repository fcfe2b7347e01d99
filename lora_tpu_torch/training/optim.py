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

low_memory replaces torch's AdamW with the JAX package's two low-memory
Adams, each run on every group's raveled vector (the leaves in
tree_leaves order, one vector per group), as lora_tpu's default
fused=True runs them:

- "bf16" (or True): optax.adamw(mu_dtype=bf16). The update uses the f32
  first moment, which is then stored in bf16 (optax casts last). Plain
  torch ops: lora_tpu runs this as optax, with no Pallas kernel.
- "int8": adamw_8bit, both moments blockwise-int8 (256-element blocks that
  run across leaf boundaries, one code array and one scale array per
  group; the second moment carried as its square root): one launch per
  group of the hand-written update kernel (ops/adam8bit.py,
  csrc/adam8bit.cu).

The clip scale stays a device tensor and nothing in step() waits for the
device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import adam8bit

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


def _low_memory_mode(low_memory) -> Optional[str]:
    if low_memory is False or low_memory is None:
        return None
    if low_memory is True or low_memory == "bf16":
        return "bf16"
    if low_memory == "int8":
        return "int8"
    raise ValueError(f"low_memory must be False, True, 'bf16' or 'int8', got "
                     f"{low_memory!r}")


def _bias_corrections(betas: Sequence[float], count: int):
    """(1 - b1**count, 1 - b2**count) in f32 arithmetic, as optax computes
    them, returned as Python floats (exact f32 values)."""
    one, n = np.float32(1.0), np.float32(count)
    return tuple(float(one - np.float32(b) ** n) for b in betas)


class GroupedAdamW:
    """The optimizer make_optimizer returns; see the module docstring."""

    def __init__(self, trainable: Dict, lrs: Dict[str, Union[Schedule, float]],
                 *, weight_decay: float, betas: Sequence[float], eps: float,
                 max_grad_norm: Optional[float], grad_accum: int,
                 low_memory: Union[bool, str] = False):
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
        self.weight_decay = {name: 0.0 if name == "ti" else weight_decay
                             for name in self.groups}
        self.betas = tuple(float(b) for b in betas)
        self.eps = float(eps)
        self.max_grad_norm = max_grad_norm
        self.grad_accum = int(grad_accum)
        self.low_memory = _low_memory_mode(low_memory)
        self.count = 0       # applied updates (optax's inner count)
        self.mini_step = 0   # micro-steps since the last update
        self._acc: Optional[List[torch.Tensor]] = None
        self.adamw = None
        self.moments: Dict[str, Dict[str, torch.Tensor]] = {}
        if self.low_memory is None:
            self.adamw = torch.optim.AdamW(
                [{"params": leaves, "name": name,
                  "weight_decay": self.weight_decay[name]}
                 for name, leaves in self.groups.items()],
                lr=0.0, betas=self.betas, eps=eps,
                fused=True if self.params[0].is_cuda else None)
        for name, leaves in self.groups.items():
            n = sum(p.numel() for p in leaves)
            dev = leaves[0].device
            if self.low_memory == "bf16":
                self.moments[name] = {
                    "mu": torch.zeros(n, dtype=torch.bfloat16, device=dev),
                    "nu": torch.zeros(n, dtype=torch.float32, device=dev)}
            elif self.low_memory == "int8":
                zero_q, one_s = adam8bit.quantize(
                    torch.zeros(n, dtype=torch.float32, device=dev))
                self.moments[name] = {
                    "mu_q": zero_q, "mu_s": one_s,
                    "nu_q": zero_q.clone(), "nu_s": one_s.clone()}

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
        scale = None
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.clamp(self.max_grad_norm / norm.clamp_min(1e-16),
                                max=1.0)
        if self.low_memory is None:
            if scale is not None:
                torch._foreach_mul_(grads, scale)
            for p, g in zip(self.params, grads):
                p.grad = g
            for group in self.adamw.param_groups:
                group["lr"] = float(self.schedules[group["name"]](self.count))
            self.adamw.step()
        else:
            self._low_memory_step(grads, scale)
        self.count += 1
        self.zero_grad()

    def _low_memory_step(self, grads: List[torch.Tensor],
                         scale: Optional[torch.Tensor]) -> None:
        """One update of every group on its raveled vector, as lora_tpu's
        _fused_by_group runs adamw(mu_dtype=bf16) or adamw_8bit."""
        b1, b2 = self.betas
        c1, c2 = _bias_corrections(self.betas, self.count + 1)
        first = 0
        for name, leaves in self.groups.items():
            g = torch.cat([x.reshape(-1) for x in
                           grads[first:first + len(leaves)]])
            first += len(leaves)
            p = torch.cat([x.reshape(-1) for x in leaves])
            lr = float(self.schedules[name](self.count))
            wd = self.weight_decay[name]
            st = self.moments[name]
            if self.low_memory == "int8":
                adam8bit.adam8bit_update(
                    g, scale, p, st["mu_q"], st["mu_s"], st["nu_q"],
                    st["nu_s"], lr=lr, wd=wd, b1=b1, b2=b2, eps=self.eps,
                    c1=c1, c2=c2)
            else:
                _adamw_bf16_mu(g, scale, p, st, lr=lr, wd=wd, b1=b1, b2=b2,
                               eps=self.eps, c1=c1, c2=c2)
            torch._foreach_copy_(
                leaves, [v.view_as(x) for v, x in
                         zip(p.split([x.numel() for x in leaves]), leaves)])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    # -- the state, as a flat list of tensors (training/checkpoint.py) ----
    def _adamw_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """torch AdamW's state of one param; zeros (what its first step
        would create) before that step."""
        st = self.adamw.state.get(p)
        if st:
            return st
        fused = self.adamw.param_groups[0].get("fused")
        return {"step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if fused else "cpu"),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def state_tensors(self) -> List[torch.Tensor]:
        """The whole optimizer state in a fixed order: the applied-update
        count (0-d int64); then torch AdamW's step, exp_avg and exp_avg_sq
        per param, or per group the bf16 mu and f32 nu, or the int8 codes
        and scales (mu_q, mu_s, nu_q, nu_s); then, with grad_accum > 1, the
        running-mean accumulator per param (zeros between updates) and
        mini_step (0-d int64)."""
        out = [torch.tensor(self.count, dtype=torch.int64)]
        if self.low_memory is None:
            for p in self.params:
                st = self._adamw_state(p)
                out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
        else:
            for st in self.moments.values():
                out += list(st.values())
        if self.grad_accum > 1:
            out += (self._acc if self._acc is not None
                    else [torch.zeros_like(p) for p in self.params])
            out.append(torch.tensor(self.mini_step, dtype=torch.int64))
        return out

    @torch.no_grad()
    def load_state_tensors(self, tensors: Sequence[torch.Tensor]) -> None:
        """Restore what state_tensors() gave (same count, shapes and order;
        values are cast to this optimizer's dtypes and devices)."""
        like = self.state_tensors()
        if len(tensors) != len(like):
            raise ValueError(f"optimizer state has {len(tensors)} tensors, "
                             f"expected {len(like)}")
        vals = []
        for i, (t, ref) in enumerate(zip(tensors, like)):
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"optimizer state tensor {i} shape "
                                 f"{tuple(t.shape)} != expected "
                                 f"{tuple(ref.shape)}")
            vals.append(t.to(device=ref.device, dtype=ref.dtype))
        it = iter(vals)
        self.count = int(next(it))
        if self.low_memory is None:
            for p in self.params:
                self.adamw.state[p] = {"step": next(it),
                                       "exp_avg": next(it),
                                       "exp_avg_sq": next(it)}
        else:
            for st in self.moments.values():
                for k in st:
                    st[k] = next(it)
        if self.grad_accum > 1:
            acc = [next(it) for _ in self.params]
            self.mini_step = int(next(it))
            self._acc = acc if self.mini_step else None


def _adamw_bf16_mu(g, scale, p, st, *, lr, wd, b1, b2, eps, c1, c2) -> None:
    """optax.adamw(mu_dtype=bf16) on a raveled group, in place: the f32
    first moment feeds the update and is stored in bf16 afterwards. The
    stored moment decays by b1 rounded to bf16 (JAX's weakly typed scalar
    takes the bf16 array's type), in an f32 product: under jit XLA drops the
    product's round trip through bf16."""
    dev = p.device

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    if scale is not None:
        g = g * scale
    decayed = st["mu"].float() * torch.tensor(
        b1, dtype=torch.bfloat16, device=dev).float()
    mu = g * f32(1.0 - b1) + decayed
    nu = (g * g) * f32(1.0 - b2) + st["nu"] * f32(b2)
    step = (mu / f32(c1)) / (torch.sqrt(nu / f32(c2)) + f32(eps))
    p.add_((step + p * f32(wd)) * f32(-lr))
    st["mu"].copy_(mu)
    st["nu"].copy_(nu)


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
    default update is torch's fused AdamW, the counterpart of the JAX
    package's default fused=True (one update over each group's raveled
    vector). low_memory: "bf16" (or True) keeps Adam's first moment in
    bf16, "int8" both moments blockwise-int8 (see the module docstring)."""
    return GroupedAdamW(trainable, lrs, weight_decay=weight_decay,
                        betas=betas, eps=eps, max_grad_norm=max_grad_norm,
                        grad_accum=grad_accum, low_memory=low_memory)
