"""One txt2img request in plain float32: the prompt and the negative prompt
through the text encoder with its LoRA and the TI row, DPM-Solver++(2M)
through the UNet with its LoRA under classifier-free guidance, the VAE
decode, and the served image's quantization (clip to [0, 1], times 255,
truncated to uint8)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import sd
from .sampler import Schedule, dpmpp_sample
from .tokens import token_ids


def with_adapter(params: Dict[str, dict], text_cfg: dict, lora: dict,
                 ti_row: torch.Tensor, ti_token: str, scale: float):
    """(params with the TI row appended to the token table, the added
    tokens, {model: LoRA at `scale`})."""
    table = "text_model.embeddings.token_embedding.weight"
    text = dict(params["text_encoder"])
    text[table] = torch.cat([text[table], ti_row[None].to(text[table])])
    added = {ti_token: text_cfg["vocab_size"]}
    loras = {m: {"sites": lora[m], "scale": scale} for m in lora}
    return {**params, "text_encoder": text}, added, loras


@torch.no_grad()
def txt2img(params: Dict[str, dict], cfg: dict, loras: dict, added: dict,
            prompt: str, negative: str, seed: int, steps: int,
            guidance: float, height: int, width: int,
            device) -> np.ndarray:
    """(height, width, 3) uint8. The initial latents are the request's:
    a standard normal (1, height / 8, width / 8, 4) in bfloat16 from a
    torch.Generator on `device` seeded with the request's seed."""
    tc, uc = cfg["text_encoder"], cfg["unet"]
    ids = torch.tensor([token_ids(negative, tc["vocab_size"], added),
                        token_ids(prompt, tc["vocab_size"], added)],
                       device=device)
    ctx = sd.clip_text(params["text_encoder"], tc, ids,
                       loras.get("text_encoder"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    lat = torch.randn((1, height // 8, width // 8, uc["out_channels"]),
                      generator=g, device=device, dtype=torch.bfloat16)
    x = lat.float().permute(0, 3, 1, 2).contiguous()
    sched = Schedule(cfg["scheduler"], device)

    def model(x, t):
        tt = torch.full((2,), t, device=device)
        out = sd.unet(params["unet"], uc, torch.cat([x, x]), tt, ctx,
                      loras.get("unet"))
        u, c = out[:1], out[1:]
        return u + guidance * (c - u)

    z = dpmpp_sample(model, x, sched, steps)
    img = sd.vae_decode(params["vae"], cfg["vae"], z)
    img = (img / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)[0]
    return (img.cpu().numpy() * 255).astype(np.uint8)
