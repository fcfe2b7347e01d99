"""The noise schedule, DPM-Solver++(2M) sampling and the training target,
in plain float32 torch, from the published scheduler configs.

The schedule is diffusers' "scaled_linear" betas over num_train_timesteps,
alphas_cumprod in float64 stored as float32; a prev timestep below 0 is the
final alpha (alphas_cumprod[0] with set_alpha_to_one false). The sampler
is the 2M multistep solver on data predictions (first order on the first
step), on the timesteps linspace(0, T - 1, S + 1) reversed, rounded, the
last dropped; a v- or sample-prediction model's output is turned into eps
after classifier-free guidance.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class Schedule:
    def __init__(self, cfg: dict, device):
        T = cfg["num_train_timesteps"]
        if cfg["beta_schedule"] != "scaled_linear":
            raise ValueError(f"unsupported beta_schedule "
                             f"{cfg['beta_schedule']!r}")
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                            T, dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        self.T = T
        self.acp = torch.tensor(acp, dtype=torch.float32, device=device)
        self.final = float(1.0 if cfg.get("set_alpha_to_one") else acp[0])
        self.prediction_type = cfg.get("prediction_type", "epsilon")

    def alpha_bar(self, t: int) -> torch.Tensor:
        if t < 0:
            return torch.tensor(self.final, dtype=torch.float32,
                                device=self.acp.device)
        return self.acp[t]

    def add_noise(self, x0, noise, t: torch.Tensor):
        a = self.acp[t].reshape(-1, 1, 1, 1)
        return a.sqrt() * x0 + (1 - a).sqrt() * noise

    def target(self, x0, noise, t: torch.Tensor):
        """What the model is trained to predict."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            a = self.acp[t].reshape(-1, 1, 1, 1)
            return a.sqrt() * noise - (1 - a).sqrt() * x0
        raise ValueError(f"unknown prediction_type {self.prediction_type!r}")

    def to_eps(self, out, x, t: int):
        """A model output at timestep t as eps."""
        if self.prediction_type == "epsilon":
            return out
        a = self.alpha_bar(t)
        sa, sb = a.sqrt(), (1 - a).sqrt()
        if self.prediction_type == "v_prediction":
            return sa * out + sb * x
        return (x - sa * out) / sb


def dpmpp_timesteps(T: int, steps: int) -> np.ndarray:
    return np.linspace(0, T - 1, steps + 1)[::-1][:-1].round().astype(
        np.int64)


def dpmpp_sample(model: Callable, latents: torch.Tensor, sched: Schedule,
                 steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) from latents at the first timestep; model(x, t) is
    the guided model output at integer timestep t."""
    ts = [int(t) for t in dpmpp_timesteps(sched.T, steps)]
    x = latents.float()
    d_prev, lam_prev = None, None

    def coeffs(t):
        a = sched.alpha_bar(t)
        alpha, sigma = a.sqrt(), (1 - a).sqrt()
        return alpha, sigma, alpha.log() - sigma.clamp(min=1e-10).log()

    for i, t in enumerate(ts):
        t_next = ts[i + 1] if i + 1 < len(ts) else -1
        eps = sched.to_eps(model(x, t).float(), x, t)
        alpha_s, sigma_s, lam_s = coeffs(t)
        alpha_t, sigma_t, lam_t = coeffs(t_next)
        d = (x - sigma_s * eps) / alpha_s
        h = lam_t - lam_s
        if d_prev is None:
            d_multi = d
        else:
            r = ((lam_s - lam_prev) / h).clamp(min=1e-8)
            d_multi = (1.0 + 1.0 / (2.0 * r)) * d - (1.0 / (2.0 * r)) * d_prev
        x = (sigma_t / sigma_s) * x - alpha_t * (torch.exp(-h) - 1.0) * d_multi
        d_prev, lam_prev = d, lam_s
    return x
