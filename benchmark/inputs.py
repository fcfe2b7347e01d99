"""Everything a run feeds both sides, made from --seed: the weights, the
LoRA + textual-inversion file, the prompts, the training images and the
random draws. The same seed gives the same inputs.

Weights are drawn on the device in one call per model into one buffer,
then cut into tensors in the type they are served in: UNet and VAE
weights normal with the variance of the program's own random init
(1 / (3 fan-in)), CLIP's N(0, 0.02) (positions N(0, 0.01)), biases 0,
norms 1. Normal rather than the init's uniform draws: a trained network's
weights are bell-shaped with tails, and a per-channel int8 rounding of
uniform weights (whose largest value is only 1.7 standard deviations out)
is nearly as fine as bfloat16's, which would hide what a precision below
the configuration's costs.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .fileio import png_encode, safetensors_bytes
from .reference import sd as ref
from .reference.tokens import text_sites, unet_sites

ROOT = os.path.dirname(os.path.abspath(__file__))
TI_TOKEN = "<s1>"


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def model_shapes(cfg: dict):
    return {"unet": ref.unet_param_shapes(cfg["unet"]),
            "text_encoder": ref.clip_param_shapes(cfg["text_encoder"]),
            "vae": ref.vae_param_shapes(cfg["vae"])}


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device, dtype) -> Dict[str, dict]:
    """{model: {name: tensor}} in `dtype` on `device`."""
    out = {}
    for model, shapes in model_shapes(cfg).items():
        g = generator(seed, "weights." + model, device)
        n = sum(int(np.prod(s)) for _, s, k in shapes if k in ("w", "emb", "pos"))
        buf = torch.empty(n, device=device, dtype=torch.float32)
        buf.normal_(0.0, 1.0, generator=g)
        params, off = {}, 0
        for name, shape, kind in shapes:
            if kind == "b" or kind == "beta":
                params[name] = torch.zeros(shape, device=device, dtype=dtype)
            elif kind == "g":
                params[name] = torch.ones(shape, device=device, dtype=dtype)
            else:
                size = int(np.prod(shape))
                if model == "text_encoder":
                    scale = 0.01 if kind == "pos" else 0.02
                else:
                    scale = (3.0 * float(np.prod(shape[1:]))) ** -0.5
                params[name] = (buf[off:off + size] * scale).to(dtype).view(
                    shape)
                off += size
        del buf
        out[model] = params
    return out


@torch.no_grad()
def make_lora(cfg: dict, weights: Dict[str, dict], seed: int, rank: int,
              device) -> Tuple[dict, np.ndarray]:
    """A rank-`rank` LoRA over the default UNet and text sites ({model:
    {site: (up, down)}} in float32) and one TI row, as a trained adapter
    file holds them: down N(0, 1) / rank, up N(0, 0.05)."""
    g = generator(seed, "lora", device)
    lora = {}
    for model, sites in (("unet", unet_sites(cfg["unet"])),
                         ("text_encoder", text_sites(cfg["text_encoder"]))):
        lora[model] = {}
        for site in sites:
            o, i = weights[model][site + ".weight"].shape
            down = torch.randn((rank, i), generator=g, device=device) / rank
            up = 0.05 * torch.randn((o, rank), generator=g, device=device)
            lora[model][site] = (up, down)
    d = cfg["text_encoder"]["hidden_size"]
    ti = 0.02 * torch.randn((d,), generator=g, device=device)
    return lora, ti.cpu().numpy()


def lora_file_bytes(cfg: dict, lora: dict, ti: np.ndarray) -> bytes:
    """The indexed "{model}:{idx}:up|down" safetensors schema with the TI
    row under its token."""
    tensors, meta = {}, {}
    for model, sites, target in (
            ("unet", unet_sites(cfg["unet"]),
             ["CrossAttention", "Attention", "GEGLU"]),
            ("text_encoder", text_sites(cfg["text_encoder"]),
             ["CLIPAttention"])):
        meta[model] = json.dumps(target)
        for idx, site in enumerate(sites):
            up, down = lora[model][site]
            meta[f"{model}:{idx}:rank"] = str(down.shape[0])
            tensors[f"{model}:{idx}:up"] = up.cpu().numpy()
            tensors[f"{model}:{idx}:down"] = down.cpu().numpy()
    tensors[TI_TOKEN] = np.asarray(ti, np.float32)
    meta[TI_TOKEN] = "<embed>"
    return safetensors_bytes(tensors, meta)


def prompt_templates(mix: dict) -> List[str]:
    """The mix's prompt set: every subject x setting, in a fixed order."""
    return [mix["prompt_form"].format(token=TI_TOKEN, subject=s, setting=t)
            for s in mix["subjects"] for t in mix["settings"]]


def zipf_choices(rng: np.random.Generator, n_items: int, s: float,
                 size: int) -> np.ndarray:
    """Indices into n_items drawn with P(k) proportional to 1 / (k+1)^s."""
    p = 1.0 / np.arange(1, n_items + 1) ** s
    return rng.choice(n_items, size=size, p=p / p.sum())


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Open-loop arrival times in [0, seconds): a fixed set of Poisson gaps
    at the mix's rate (drawn once from the mix's own seed, so every run
    offers the same load), put in the run seed's order."""
    rate = float(mix["rate_per_s"])
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(mix["arrival_seed"]).exponential(
        1.0 / rate, n)
    gaps *= (seconds * (n - 0.5) / n) / gaps.sum()
    order = np.random.default_rng(sub_seed(seed, "arrivals")).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order][0]


def smooth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A (size, size, 3) uint8 image of a few random low-frequency waves
    per channel (photo-like statistics, compresses as photos do)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy, ph = rng.uniform(0.5, 6.0), rng.uniform(0.5, 6.0), \
                rng.uniform(0, 2 * np.pi)
            img[..., c] += np.sin(2 * np.pi * (fx * x + fy * y) + ph)
    img = 0.5 + 0.12 * img + 0.02 * rng.standard_normal(img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_training_images(directory: str, n_instance: int, n_class: int,
                          size: int, seed: int) -> Tuple[str, str]:
    """instance/ and class/ PNG folders under `directory`."""
    rng = np.random.default_rng(sub_seed(seed, "images"))
    dirs = []
    for kind, n in (("instance", n_instance), ("class", n_class)):
        d = os.path.join(directory, kind)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            with open(os.path.join(d, f"{i:03d}.png"), "wb") as f:
                f.write(png_encode(smooth_image(rng, size), level=1))
        dirs.append(d)
    return dirs[0], dirs[1]


def step_draws(seed: int, step: int, rows: int, latent_hw: Tuple[int, int],
               device, T: int, dtype):
    """A training step's draws: the VAE posterior noise, the diffusion
    noise (both (rows, h, w, 4) in the step's dtype, as the trainer draws
    them) and the timesteps (rows,)."""
    g = generator(seed, f"step.{step}", device)
    shape = (rows,) + tuple(latent_hw) + (4,)
    vae_noise = torch.randn(shape, generator=g, device=device, dtype=dtype)
    noise = torch.randn(shape, generator=g, device=device, dtype=dtype)
    t = torch.randint(0, T, (rows,), generator=g, device=device)
    return vae_noise, noise, t
