"""The train step factory, the counterpart of
lora_tpu/training/train_step.py.

One step is the loss and its gradients over the trainable leaves only (the
frozen base params never require grad), then the optimizer's update. The
JAX step is a pure function returning (trainable, opt_state, loss); here
the optimizer (training/optim.py) owns its state and updates the trainable
leaves in place, so the step returns the loss alone: a 0-d f32 tensor on
the device, not synchronised.

Under a mesh (parallel/mesh.py) the batch is the rank's block of the global
batch, and the trainable leaves' gradients and the loss are averaged over
dp in one flat bucket before the optimizer (so before its global-norm clip
and either low-memory Adam): lora_tpu's psum of the LoRA / TI gradients.
Under tensor parallelism the parts of the gradients that split blocks gave
(parallel/tensor.py) are first summed over tp in one flat bucket; a
leaf's reads outside split blocks already gave its whole gradient on every
tp rank, which a sum would count tp times. The returned loss is the global
batch's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import schedulers
from ..parallel.mesh import Mesh
from ..parallel.tensor import sum_split_grads
from .loss import LossConfig, loss_step
from .optim import GroupedAdamW, tree_leaves


def make_train_step(
    *,
    unet_cfg,
    text_cfg,
    vae_cfg,
    sched: schedulers.NoiseSchedule,
    loss_cfg: LossConfig,
    optimizer: GroupedAdamW,
    ti_ids: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    mesh=None,
    text2_cfg=None,
    eos_id: Optional[int] = None,
) -> Callable:
    """Returns step(trainable, base, batch, generator=None, **draws) ->
    loss, with base = (unet_params, text_params, vae_params) flat dicts
    ({} for a model the batch does not need), or (unet_params, text_params,
    text2_params, vae_params) when text2_cfg is given (SDXL, with the
    tokenizer's eos_id), and draws the explicit random draws loss_step
    takes (noise=, timesteps=, ...; under a mesh the global batch's). The
    base may be sharded over the mesh's fsdp and tp axes
    (mesh.shard_params)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    dp = 1 if mesh is None else mesh.shape["dp"]
    tp = 1 if mesh is None else mesh.shape["tp"]

    def step(trainable, base, batch, generator=None, **draws):
        if text2_cfg is not None:
            unet_p, text_p, text2_p, vae_p = base
        else:
            (unet_p, text_p, vae_p), text2_p = base, None
        loss = loss_step(
            trainable, batch, generator,
            unet_params=unet_p, text_params=text_p, vae_params=vae_p,
            unet_cfg=unet_cfg, text_cfg=text_cfg, vae_cfg=vae_cfg,
            sched=sched, cfg=loss_cfg, ti_ids=ti_ids, dtype=dtype,
            text2_params=text2_p, text2_cfg=text2_cfg, eos_id=eos_id,
            mesh=mesh, **draws)
        loss.backward()
        if tp > 1:
            sum_split_grads(optimizer.params, mesh)
        if dp > 1:
            loss = mesh.mean_grads(optimizer.params, loss)
        optimizer.step()
        return loss.detach()

    return step


def make_trainable(tree: dict) -> dict:
    """Make every leaf of a trainable tree (e.g. {"lora_unet":
    core.lora.init_lora(...)}) a float32 leaf tensor that requires grad, in
    place, and return the tree."""
    for leaf in tree_leaves(tree):
        if leaf.dtype != torch.float32:
            raise ValueError(f"trainable leaves are float32, got {leaf.dtype}")
        leaf.requires_grad_(True)
    return tree


def ti_norm_prior(ti_embeds: torch.Tensor, lr: float,
                  target_norm: float = 0.4) -> torch.Tensor:
    """The TI norm decay applied after each optimizer step during inversion:
    renormalise each row toward `target_norm` with strength
    lambda = min(1, 100 * lr)."""
    lam = min(1.0, 100.0 * lr)
    x = ti_embeds.float()
    pre = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    unit = x / pre.clamp_min(1e-12)
    return (unit * (pre + lam * (target_norm - pre))).to(ti_embeds.dtype)
