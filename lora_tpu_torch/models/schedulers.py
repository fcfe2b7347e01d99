"""Diffusion noise schedules: the DDPM forward process (add_noise, and
get_velocity for v-prediction training) and the DDIM sampler.

The counterpart of lora_tpu/models/schedulers.py (SD-1.5 schedule:
scaled_linear betas 0.00085..0.012 over 1000 train steps). The scheduler
arithmetic is float32 whatever the model's dtype. PNDM, DPM-Solver++,
Euler and DDPM sampling land with the other samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int
    alphas_cumprod: torch.Tensor  # (T,) float32
    final_alpha_cumprod: float
    steps_offset: int = 1
    prediction_type: str = "epsilon"

    def to(self, device) -> "NoiseSchedule":
        """The same schedule with alphas_cumprod on `device` (move it once
        per sampling loop, not once per step)."""
        return dataclasses.replace(
            self, alphas_cumprod=self.alphas_cumprod.to(device))


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    set_alpha_to_one: bool = False,
    steps_offset: int = 1,
    prediction_type: str = "epsilon",
) -> NoiseSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return NoiseSchedule(
        num_train_timesteps=num_train_timesteps,
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
        final_alpha_cumprod=final,
        steps_offset=steps_offset,
        prediction_type=prediction_type,
    )


def _gather(sched: NoiseSchedule, t: torch.Tensor,
            like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt(abar_t), sqrt(1 - abar_t) broadcast to `like`'s rank."""
    a = sched.alphas_cumprod.to(like.device)[t]
    shape = (-1,) + (1,) * (like.ndim - 1)
    return (a.sqrt().reshape(shape).to(like.dtype),
            (1.0 - a).sqrt().reshape(shape).to(like.dtype))


def add_noise(sched: NoiseSchedule, sample: torch.Tensor,
              noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    sa, sb = _gather(sched, t, sample)
    return sa * sample + sb * noise


def get_velocity(sched: NoiseSchedule, sample: torch.Tensor,
                 noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The v-prediction target sqrt(abar_t) * noise - sqrt(1 - abar_t) *
    sample."""
    sa, sb = _gather(sched, t, sample)
    return sa * noise - sb * sample


def pred_to_x0_eps(sched: NoiseSchedule, model_out: torch.Tensor,
                   sample: torch.Tensor,
                   t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A model prediction as (x0, eps), per prediction_type."""
    sa, sb = _gather(sched, t, sample)
    if sched.prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - sb * eps) / sa
    elif sched.prediction_type == "v_prediction":
        x0 = sa * sample - sb * model_out
        eps = sa * model_out + sb * sample
    else:  # "sample"
        x0 = model_out
        eps = (sample - sa * x0) / sb
    return x0, eps


def ddim_timesteps(sched: NoiseSchedule,
                   num_inference_steps: int) -> np.ndarray:
    ratio = sched.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(
        np.int64)
    return ts + sched.steps_offset


def ddim_step(
    sched: NoiseSchedule,
    model_out: torch.Tensor,
    t: torch.Tensor,
    sample: torch.Tensor,
    prev_t: torch.Tensor,
) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM step from timestep t to prev_t ((B,)
    tensors; prev_t < 0 steps to the final alpha). Returns the sample in its
    own dtype."""
    x0, eps = pred_to_x0_eps(sched, model_out.float(), sample.float(), t)
    alphas = sched.alphas_cumprod.to(sample.device)
    a_prev = torch.where(prev_t >= 0, alphas[prev_t.clamp(min=0)],
                         torch.full_like(alphas[t], sched.final_alpha_cumprod))
    a_prev = a_prev.reshape((-1,) + (1,) * (sample.ndim - 1))
    prev = a_prev.sqrt() * x0 + (1.0 - a_prev).sqrt() * eps
    return prev.to(sample.dtype)
