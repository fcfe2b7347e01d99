"""The yardstick's arithmetic: the card's published peaks, the least work of
the flash-attention launches, and a model's FLOPs counted on the meta
device from the plain reference at a cell's shapes.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s in bf16 on the
tensor cores, 3.35 TB/s of HBM. A bound is the larger of FLOPs over the
FLOP rate and bytes over the memory rate (each input read once, each
output written once), so a share of it cannot pass 100% unless the count
is too high.

Attention work is counted from shapes, whatever implements it: the
forward computes Q K^T and P V (4 B H T S D FLOPs), reads q, k, v and
writes o; the backward needs five products (Q K^T again, dO V^T, dS K,
P^T dO, dS^T Q: 10 B H T S D FLOPs), reads q, k, v, dO, the f32 row
statistics and the f32 row sums of dO * O, and writes dq, dk, dv. Which
attention calls the flash kernels serve is the routing rule copied from
the program (T a multiple of 256 query rows, S of 128 key rows), checked
against the program's launch counter by the readers.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


def flash_fwd_bound_s(B, H, T, S, D, elem: int = 2) -> float:
    return bound_s(4.0 * B * H * T * S * D, elem * B * H * (2 * T + 2 * S) * D)


def flash_bwd_bound_s(B, H, T, S, D, elem: int = 2) -> float:
    reads = elem * B * H * (2 * T + 2 * S) * D + 8 * B * H * T
    writes = elem * B * H * (T + 2 * S) * D
    return bound_s(10.0 * B * H * T * S * D, reads + writes)


def flash_routed(T: int, S: int) -> bool:
    """The program's routing rule for its flash kernels."""
    return T % 256 == 0 and S % 128 == 0


def self_attention_levels(unet_cfg: dict, height: int,
                          width: int) -> List[Tuple[int, int, int]]:
    """(T, heads, head dim) of every self-attention call of one UNet
    forward at a height x width image, in call order."""
    from .reference.sd import unet_blocks

    out = []
    h, w = height // 8, width // 8
    for kind, i, res, attn, heads, resample in unet_blocks(unet_cfg):
        ch = res[-1][1]
        n = (1 if kind == "mid" else len(res)) if attn else 0
        out += [(h * w, heads, ch // heads)] * n
        if resample:
            h, w = (h // 2, w // 2) if kind == "down" else (h * 2, w * 2)
    return out


def flash_levels(unet_cfg: dict, height: int, width: int):
    """The self-attention calls of one UNet forward the flash kernels
    serve, as (T, heads, head dim)."""
    return [(T, H, D) for T, H, D in
            self_attention_levels(unet_cfg, height, width)
            if flash_routed(T, T)]


def count_flops(fn: Callable[[], torch.Tensor]) -> int:
    """The FLOPs torch's counter reads off the aten calls of fn (matrix
    products and convolutions, forward and whatever backward fn runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def meta_params(shapes, device="meta") -> dict:
    return {name: torch.empty(shape, device=device)
            for name, shape, _ in shapes}


def _meta_lora(cfg: dict, model: str, rank: int, scale):
    from .reference.tokens import text_sites, unet_sites

    shapes = {n: s for n, s, _ in _shapes(cfg)[model]}
    sites = unet_sites(cfg["unet"]) if model == "unet" else \
        text_sites(cfg["text_encoder"])
    out = {}
    for site in sites:
        o, i = shapes[site + ".weight"]
        out[site] = (torch.empty((o, rank), device="meta"),
                     torch.empty((rank, i), device="meta"))
    return {"sites": out, "scale": scale}


def _shapes(cfg: dict):
    from .reference import sd

    return {"unet": sd.unet_param_shapes(cfg["unet"]),
            "text_encoder": sd.clip_param_shapes(cfg["text_encoder"]),
            "vae": sd.vae_param_shapes(cfg["vae"])}


def image_flops(cfg: dict, height: int, width: int, steps: int,
                rank: int = 4) -> int:
    """One served image: `steps` UNet calls on the uncond and cond rows
    with the LoRA, and the VAE decode. The text encoder (under 0.1% of
    this) is left out."""
    from .reference import sd

    shapes = _shapes(cfg)
    pu, pv = meta_params(shapes["unet"]), meta_params(shapes["vae"])
    uc = cfg["unet"]
    x = torch.empty((2, uc["in_channels"], height // 8, width // 8),
                    device="meta")
    t = torch.empty((2,), device="meta")
    ctx = torch.empty((2, 77, uc["cross_attention_dim"]), device="meta")
    lora = _meta_lora(cfg, "unet", rank, 1.0)
    unet = count_flops(lambda: sd.unet(pu, uc, x, t, ctx, lora))
    z = torch.empty((1, 4, height // 8, width // 8), device="meta")
    vae = count_flops(lambda: sd.vae_decode(pv, cfg["vae"], z))
    return steps * unet + vae


def train_step_flops(cfg: dict, resolution: int, rows: int,
                     rank: int = 4) -> int:
    """One DreamBooth step at `rows` rows: the VAE encode, the text encoder
    and the UNet forward with their LoRAs, and the backward that the LoRA
    gradients need (the frozen base's input gradients and the LoRA's
    weight gradients; nothing recomputed)."""
    from .reference import sd

    shapes = _shapes(cfg)
    p = {m: meta_params(s) for m, s in shapes.items()}
    lu = _meta_lora(cfg, "unet", rank, torch.empty((), device="meta"))
    lt = _meta_lora(cfg, "text_encoder", rank,
                    torch.empty((), device="meta"))
    for tree in (lu, lt):
        tree["scale"].requires_grad_(True)
        for up, down in tree["sites"].values():
            up.requires_grad_(True)
            down.requires_grad_(True)
    uc, tc = cfg["unet"], cfg["text_encoder"]
    h = resolution // 8

    def step():
        px = torch.empty((rows, 3, resolution, resolution), device="meta")
        with torch.no_grad():
            lat = sd.vae_encode(p["vae"], cfg["vae"], px,
                                torch.empty((rows, 4, h, h), device="meta"))
        ids = torch.zeros((rows, tc["max_position_embeddings"]),
                          dtype=torch.long, device="meta")
        ctx = sd.clip_text(p["text_encoder"], tc, ids, lt)
        t = torch.empty((rows,), device="meta")
        pred = sd.unet(p["unet"], uc, lat, t, ctx, lu)
        (pred ** 2).mean().backward()

    return count_flops(step)
