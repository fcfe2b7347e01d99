"""The comparison that decides `correct`: the program's outputs against the
plain reference, each number beside its limit.

Serving: every request of one group the window served (the group drawn
from the seed), so every row of a device batch is checked; each served
PNG against the reference's image for the same prompt, seed and guidance.
The number is the worst image's RMS pixel difference, in units of the
full [0, 1] range.

Training: the three steps set-up ran through the window's own call,
against the reference's three steps on the same rows and draws. The
numbers are each step's loss (relative gap), the first step's clipped
gradient (the optimizer's first moment over 1 - beta1) and the change of
the leaves after three steps, both by the worst leaf: the gap between the
program's norm and the reference's, over the larger of the reference
leaf's norm and the median leaf's. Leaves whose reference gradient is under
a thousandth of the median leaf's move under Adam by round-off alone and
are left out of the change.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from . import inputs
from .reference import sd
from .reference.txt2img import txt2img, with_adapter

ROOT = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> Dict[str, float]:
    """{number: limit} of a cell (benchmark/limits/<cell>.json)."""
    with open(os.path.join(ROOT, "limits", cell + ".json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()
                if k != "readings"}


def reference_params(cfg: dict, seed: int, device):
    """The run's weights as float32 (the values served in the
    configuration's dtype, widened)."""
    w16 = inputs.make_weights(cfg, seed, device, getattr(torch, cfg["dtype"]))
    return w16, {m: {k: t.float() for k, t in p.items()}
                 for m, p in w16.items()}


def precision(control: bool):
    """The reference's arithmetic: float32, or the control's fp8 operands."""
    return sd.operand_precision(torch.float8_e4m3fn if control else None)


@torch.no_grad()
def reference_images(cfg: dict, mix: dict, seed: int, device, requests,
                     control: bool = False) -> List[np.ndarray]:
    with sd.plain_float32(), precision(control):
        w16, params = reference_params(cfg, seed, device)
        lora, ti = inputs.make_lora(cfg, w16, seed, mix["lora_rank"], device)
        del w16
        params, added, loras = with_adapter(
            params, cfg["text_encoder"], lora, torch.as_tensor(ti,
                                                               device=device),
            inputs.TI_TOKEN, mix["lora_scale"])
        return [txt2img(params, cfg, loras, added, r.prompt,
                        mix["negative_prompt"], r.seed, mix["steps"],
                        r.guidance, mix["height"], mix["width"], device)
                for r in requests]


def image_numbers(served: List[np.ndarray], ref: List[np.ndarray],
                  any_requests: bool) -> Dict[str, Optional[float]]:
    """Worst RMS, mean absolute and largest pixel difference over the
    sample ([0, 1] units). No sample at all reads as failed (None)."""
    if not served or not any_requests:
        return {"image_rms": None}
    out = {"image_rms": [], "image_mean_abs": [], "image_max_abs": []}
    for a, b in zip(served, ref):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64)) / 255
        out["image_rms"].append(float(np.sqrt((d ** 2).mean())))
        out["image_mean_abs"].append(float(d.mean()))
        out["image_max_abs"].append(float(d.max()))
    return {**{k: max(v) for k, v in out.items()},
            "images_checked": len(served)}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep=None) -> float:
    """max over leaves of | ||prog|| - ||ref|| | / max(||ref||, median)."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    return max(abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: "losses" (3), "grad1" {leaf: tensor}, "p0" and "p3"
    {leaf: tensor} (the reference's p3 is its after[2])."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g_ref = ref["grad1"]
    gn = {n: float(g.double().norm()) for n, g in g_ref.items()}
    med = statistics.median(gn.values())
    moved = {n for n in g_ref if gn[n] >= 1e-3 * med}
    d_prog = {n: prog["p3"][n] - prog["p0"][n] for n in g_ref}
    d_ref = {n: ref["p3"][n] - ref["p0"][n] for n in g_ref}
    return {"loss_gap": loss,
            "grad1_gap": leaf_gap(prog["grad1"], g_ref),
            "change_gap": leaf_gap(d_prog, d_ref, moved)}


def verdict(numbers: Dict[str, Optional[float]],
            lim: Dict[str, float]) -> bool:
    """Every limited number present, finite and at or under its limit."""
    for k, limit in lim.items():
        v = numbers.get(k)
        if v is None or not np.isfinite(v) or v > limit:
            return False
    return True
