"""DreamBooth-LoRA training in plain float32: the sample stream, the
prior-preservation loss and its LoRA gradients, the global-norm clip and
AdamW.

The sample stream is a frozen copy of the rules the program's trainer
applies to the same image files: random.Random(seed) shuffles the indices
of max(instances, class images) each epoch, batches of `batch` indices in
order (the last partial batch dropped; a list shorter than a batch
repeated until it is not); index i takes instance i mod n
and class image i mod m; a second random.Random(seed) draws each instance
image's colour jitter as it is loaded (brightness, then contrast, each
1 + U(-0.1, 0.1): x * b, then (x - mean) * c + mean, clipped to [0, 1]);
pixels are x * 2 - 1. A batch is [instances | class images].

The loss: each row's image is VAE-encoded (the posterior sampled with the
given noise), noised to its timestep, and the UNet's prediction compared
with the target by the mean square over the row; the instance rows' mean
plus prior_loss_weight times the class rows' mean. Gradients are taken
one row at a time (the loss is a weighted sum over rows), so a row's
activations are all that is held.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import sd
from .sampler import Schedule


def sample_stream(n_instance: int, n_class: int, batch: int,
                  seed: int) -> Iterator[Tuple[list, list]]:
    """Per step: ([(instance index, brightness, contrast)], [class index])."""
    idx_rng, aug_rng = random.Random(seed), random.Random(seed)
    n = max(n_instance, n_class)
    while True:
        idxs = list(range(n))
        idx_rng.shuffle(idxs)
        while len(idxs) < batch:  # fewer images than a batch: repeat
            idxs = idxs + idxs
        for s in range(0, len(idxs) - (batch - 1), batch):
            inst, cls = [], []
            for i in idxs[s:s + batch]:
                b = 1.0 + aug_rng.uniform(-0.1, 0.1)
                c = 1.0 + aug_rng.uniform(-0.1, 0.1)
                inst.append((i % n_instance, b, c))
                cls.append(i % n_class)
            yield inst, cls


def pixels(u8: np.ndarray, jitter=None) -> np.ndarray:
    """(H, W, 3) uint8 -> float32 in [-1, 1], with (brightness, contrast)."""
    x = u8.astype(np.float32) / 255.0
    if jitter is not None:
        b, c = jitter
        x = x * b
        mean = x.mean()
        x = np.clip((x - mean) * c + mean, 0.0, 1.0)
    return x * 2.0 - 1.0


def leaves(lora: Dict[str, dict]) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every trainable leaf: per model its scale and each
    site's down and up factors."""
    out = []
    for model in sorted(lora):
        out.append((f"{model}.scale", lora[model]["scale"]))
        for site in sorted(lora[model]["sites"]):
            up, down = lora[model]["sites"][site]
            out += [(f"{model}.{site}.down", down), (f"{model}.{site}.up", up)]
    return out


def train_steps(params: Dict[str, dict], cfg: dict, lora: Dict[str, dict],
                batches: List[dict], opt: dict) -> dict:
    """Run len(batches) steps from `lora` ({model: {"scale": 0-d tensor,
    "sites": {site: (up, down)}}}, float32 leaves, updated in place).
    A batch: "pixels" (B, 3, H, W), "ids" (B, 77), "is_instance" (B,),
    "vae_noise" and "noise" (B, 4, h, w), "timesteps" (B,). opt: "lr"
    ({model: lr}), "weight_decay", "betas", "eps", "max_grad_norm",
    "prior_loss_weight". Returns the losses, the first step's clipped
    gradient by leaf, and the leaves after each step."""
    sched = Schedule(cfg["scheduler"], batches[0]["pixels"].device)
    named = leaves(lora)
    for _, t in named:
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in named}
    v = {n: torch.zeros_like(t) for n, t in named}
    b1, b2 = opt["betas"]
    out = {"losses": [], "grad1": None, "after": []}
    for step, batch in enumerate(batches, 1):
        inst = batch["is_instance"]
        n_i, n_c = float(inst.sum()), float((1 - inst).sum())
        total = 0.0
        for r in range(batch["pixels"].shape[0]):
            w = (1.0 / n_i) if inst[r] > 0 else (opt["prior_loss_weight"]
                                                 / n_c)
            with torch.no_grad():
                lat = sd.vae_encode(params["vae"], cfg["vae"],
                                    batch["pixels"][r:r + 1],
                                    batch["vae_noise"][r:r + 1])
            t = batch["timesteps"][r:r + 1]
            noise = batch["noise"][r:r + 1]
            noisy = sched.add_noise(lat, noise, t)
            ctx = sd.clip_text(params["text_encoder"], cfg["text_encoder"],
                               batch["ids"][r:r + 1],
                               _tree(lora, "text_encoder"))
            pred = sd.unet(params["unet"], cfg["unet"], noisy, t, ctx,
                           _tree(lora, "unet"))
            loss = ((pred - sched.target(lat, noise, t)) ** 2).mean()
            (w * loss).backward()
            total += w * float(loss.detach())
        out["losses"].append(total)
        with torch.no_grad():
            grads = {n: (t.grad if t.grad is not None
                         else torch.zeros_like(t)) for n, t in named}
            norm = math.sqrt(sum(float((g.double() ** 2).sum())
                                 for g in grads.values()))
            clip = min(1.0, opt["max_grad_norm"] / max(norm, 1e-16))
            grads = {n: g * clip for n, g in grads.items()}
            if step == 1:
                out["grad1"] = {n: g.clone() for n, g in grads.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for n, t in named:
                lr = opt["lr"][n.split(".", 1)[0]]
                g = grads[n]
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                t.mul_(1 - lr * opt["weight_decay"])
                t.sub_(lr * (m[n] / c1) / ((v[n] / c2).sqrt() + opt["eps"]))
                t.grad = None
            out["after"].append({n: t.detach().clone() for n, t in named})
    return out


def _tree(lora: Dict[str, dict], model: str):
    return {"sites": lora[model]["sites"], "scale": lora[model]["scale"]}
