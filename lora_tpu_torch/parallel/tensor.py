"""Tensor parallelism's autograd pieces (Megatron-style), over a mesh's tp
sub-group (parallel/mesh.py).

lora_tpu shards the attention and MLP weights with PartitionSpecs
(_TP_RULES) and XLA inserts the collectives. Here each split block does it
itself:

  - a column site (q/k/v, the GEGLU projection, fc1) reads its input
    through copy_to_tp (the identity forward, an all-reduce of the
    gradient backward) and computes its block of output features;
  - a row site (the attention output, ff.net.2, fc2) reads its block of
    input features, and its partial output goes through reduce_from_tp
    (an all-reduce forward, the identity backward) before the bias.

A block runs split when split_block says so: every weight of it sharded on
tp and, for attention, the heads divisible by tp. Else it reads its weights
whole (ShardedParams all-gathers them over tp) and runs as one process
does; the base is frozen, so that gather needs no backward.

The trainable leaves a split site reads (LoRA down, up, diag, scale) get
only this rank's part of their gradient there. partial_grad routes that
part aside (onto the leaf, as `_tp_part`) rather than into .grad, which
keeps the whole gradients of replicated reads (conv LoRAs, proj_in /
proj_out, TI rows, a gathered block, and the scale's reads elsewhere);
sum_split_grads then sums the parts over tp in one flat bucket and adds
them to .grad. Gloo groups on CUDA tensors stage through host memory
(mesh._all_reduce).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from .mesh import Mesh, ShardedParams, _all_reduce


class _CopyToTP(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient over tp backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """g: all-reduce over tp forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PartialGrad(torch.autograd.Function):
    """Identity forward on a trainable leaf; backward adds the gradient
    that reaches it to leaf._tp_part instead of .grad."""

    @staticmethod
    def forward(ctx, leaf):
        ctx.leaf = leaf
        return leaf.view_as(leaf)

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        part = getattr(leaf, "_tp_part", None)
        leaf._tp_part = g if part is None else part + g
        return None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh.group("tp"))


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh.group("tp"))


def partial_grad(t: torch.Tensor) -> torch.Tensor:
    """t as read at a split site: a leaf that requires grad gets its
    gradient there as a part to be summed over tp."""
    if t.requires_grad and t.is_leaf and torch.is_grad_enabled():
        return _PartialGrad.apply(t)
    return t


def split_block(p, names: Sequence[str],
                heads: Optional[int] = None) -> Optional[Mesh]:
    """The mesh whose tp axis splits the block of these weights, or None
    when it runs whole: params that are not sharded on tp, a weight of the
    block that param_pspec leaves whole, or heads that tp does not
    divide."""
    if not isinstance(p, ShardedParams) or p.mesh.shape["tp"] == 1:
        return None
    if (heads is not None and heads % p.mesh.shape["tp"]) or not \
            p.tp_split(names):
        return None
    return p.mesh


@torch.no_grad()
def sum_split_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Add each leaf's parts from split sites, summed over tp in one flat
    f32 bucket, to its .grad (every rank then holds one process's
    gradient); the parts are cleared."""
    params = list(params)
    parts = [p.__dict__.pop("_tp_part", None) for p in params]
    if mesh.shape["tp"] == 1 or all(x is None for x in parts):
        return
    bucket = torch.cat([(torch.zeros_like(p) if x is None else x)
                        .reshape(-1).float() for p, x in zip(params, parts)])
    mesh.all_reduce(bucket, "tp")
    for p, s in zip(params, bucket.split([p.numel() for p in params])):
        s = s.view_as(p).to(p.dtype)
        p.grad = s if p.grad is None else p.grad + s
