"""Diffusion noise schedules: the DDPM forward process (add_noise, and
get_velocity for v-prediction training) and the samplers: DDIM, PNDM
(PLMS), DPM-Solver++(2M), Euler and Euler-ancestral (with linear or Karras
sigmas) and DDPM. The samplers but DDIM and DDPM step on eps; a v- or
sample-prediction model's output reaches them through pred_to_x0_eps
(timestep space) or sigma_pred_to_eps (sigma space).

The counterpart of lora_tpu/models/schedulers.py (SD-1.5 schedule:
scaled_linear betas 0.00085..0.012 over 1000 train steps). Timestep and
sigma tables are numpy, as there (float64 interpolation, then float32), so
they match it bit for bit. The step arithmetic is float32 whatever the
model's dtype, cast back to the sample's. Sampler state (PNDM's eps ring,
DPM-Solver++'s previous data prediction) stays in tensors, and no step
reads a value back to the host, so a loop of steps can be captured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
    a = torch.take(sched.alphas_cumprod.to(like.device), t)
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


def _alpha_at(sched: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
    """abar_t for a timestep tensor of any shape (gathered on its device:
    no host sync); t < 0 means the final alpha."""
    a = torch.take(sched.alphas_cumprod.to(t.device), t.clamp(min=0))
    return torch.where(t >= 0, a,
                       torch.full_like(a, sched.final_alpha_cumprod))


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
    a_prev = _alpha_at(sched, prev_t).reshape(
        (-1,) + (1,) * (sample.ndim - 1))
    prev = a_prev.sqrt() * x0 + (1.0 - a_prev).sqrt() * eps
    return prev.to(sample.dtype)


# ---------------------------------------------------------------------------
# PNDM (PLMS with the PRK warm-up skipped): SD-1.x's default sampler
# ---------------------------------------------------------------------------

def pndm_timesteps(sched: NoiseSchedule,
                   num_inference_steps: int) -> np.ndarray:
    """Descending PLMS timesteps, S + 1 of them: the second-highest is
    visited twice for the pseudo-improved-Euler warm-up (skip_prk_steps)."""
    ratio = sched.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round().astype(np.int64)
    ts = ts + sched.steps_offset
    plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    return plms.copy()


def pndm_init_state(latent_shape, device=None,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The eps ring (newest first), its fill count, the step counter and
    the sample saved at the first step, all on `device`."""
    zeros = dict(device=device, dtype=dtype)
    ints = dict(device=device, dtype=torch.int64)
    return {
        "ets": torch.zeros((4,) + tuple(latent_shape), **zeros),
        "n_ets": torch.zeros((), **ints),
        "counter": torch.zeros((), **ints),
        "cur_sample": torch.zeros(tuple(latent_shape), **zeros),
    }


def _pndm_prev_sample(sched, sample, t, prev_t, eps):
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, prev_t)
    b_t = 1.0 - a_t
    b_prev = 1.0 - a_prev
    sample_coeff = (a_prev / a_t).sqrt()
    denom = a_t * b_prev.sqrt() + (a_t * b_t * a_prev).sqrt()
    return (sample_coeff * sample
            - (a_prev - a_t) * eps / denom).to(sample.dtype)


def pndm_step(sched: NoiseSchedule, state: Dict[str, torch.Tensor],
              model_out: torch.Tensor, t: torch.Tensor,
              sample: torch.Tensor, ratio: int):
    """One PLMS step at timestep t (a 0-d tensor from pndm_timesteps);
    returns (the sample in its own dtype, the new state). The state's
    counter selects each branch on the device, as lora_tpu's does."""
    eps = model_out.float()
    x = sample.float()
    counter = state["counter"]
    is_warm2 = counter == 1  # the second visit of the duplicated timestep

    # push eps into the ring, except on the warm-up's averaging call
    ets = torch.where(is_warm2, state["ets"],
                      torch.cat([eps[None], state["ets"][:-1]]))
    n_ets = torch.where(is_warm2, state["n_ets"],
                        (state["n_ets"] + 1).clamp(max=4))

    e1, e2, e3, e4 = ets[0], ets[1], ets[2], ets[3]
    combos = torch.stack([
        e1,                                               # 1 point
        (3 * e1 - e2) / 2,                                # 2 points
        (23 * e1 - 16 * e2 + 5 * e3) / 12,                # 3 points
        (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24,      # AB4
    ])
    eps_ms = combos.index_select(0, (n_ets.clamp(1, 4) - 1).reshape(1))[0]
    # the warm-up's second call: the mean of the fresh and the stored eps,
    # applied from the saved sample at the original (higher) timestep
    eps_use = torch.where(is_warm2, (eps + e1) / 2.0, eps_ms)
    x_use = torch.where(is_warm2, state["cur_sample"], x)
    t_use = torch.where(is_warm2, t + ratio, t)

    prev = _pndm_prev_sample(sched, x_use, t_use, t_use - ratio, eps_use)
    new_state = {
        "ets": ets,
        "n_ets": n_ets,
        "counter": counter + 1,
        "cur_sample": torch.where(counter == 0, x, state["cur_sample"]),
    }
    return prev.to(sample.dtype), new_state


# ---------------------------------------------------------------------------
# DPM-Solver++ (2M, multistep, data prediction): strong at few steps
# ---------------------------------------------------------------------------

def dpmpp_timesteps(sched: NoiseSchedule,
                    num_inference_steps: int) -> np.ndarray:
    return np.linspace(0, sched.num_train_timesteps - 1,
                       num_inference_steps + 1)[::-1][:-1].round().astype(
                           np.int64).copy()


def dpmpp_init_state(latent_shape, device=None,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {
        "d_prev": torch.zeros(tuple(latent_shape), device=device,
                              dtype=dtype),
        "lambda_prev": torch.zeros((), device=device, dtype=torch.float32),
        "count": torch.zeros((), device=device, dtype=torch.int64),
    }


def _alpha_sigma_lambda(sched, t):
    a = _alpha_at(sched, t)
    alpha = a.sqrt()
    sigma = (1.0 - a).sqrt()
    lam = alpha.log() - sigma.clamp(min=1e-10).log()
    return alpha, sigma, lam


def dpmpp_step(sched: NoiseSchedule, state: Dict[str, torch.Tensor],
               model_out: torch.Tensor, t: torch.Tensor,
               sample: torch.Tensor, prev_t: torch.Tensor):
    """One DPM-Solver++(2M) step from t to prev_t (0-d tensors; prev_t < 0
    is the final alpha) for an epsilon-prediction model: first order on the
    first step, the 2M multistep combination after it."""
    x = sample.float()
    eps = model_out.float()
    alpha_s, sigma_s, lam_s = _alpha_sigma_lambda(sched, t)
    alpha_t, sigma_t, lam_t = _alpha_sigma_lambda(sched, prev_t)
    d = (x - sigma_s * eps) / alpha_s  # the data (x0) prediction
    h = lam_t - lam_s
    h_prev = lam_s - state["lambda_prev"]
    r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
    r = r.clamp(min=1e-8)
    d_multi = torch.where(
        state["count"] > 0,
        (1.0 + 1.0 / (2.0 * r)) * d - (1.0 / (2.0 * r)) * state["d_prev"],
        d)
    x_next = (sigma_t / sigma_s) * x - alpha_t * (torch.exp(-h) - 1.0) \
        * d_multi
    new_state = {"d_prev": d, "lambda_prev": lam_s,
                 "count": state["count"] + 1}
    return x_next.to(sample.dtype), new_state


# ---------------------------------------------------------------------------
# Euler discrete (k-diffusion style)
# ---------------------------------------------------------------------------

def _training_sigmas(sched: NoiseSchedule) -> np.ndarray:
    a = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
    return ((1 - a) / a) ** 0.5


def euler_sigmas(sched: NoiseSchedule,
                 num_inference_steps: int) -> np.ndarray:
    """(S + 1,) descending float32 sigmas ending in 0, linearly
    interpolated over the training sigmas."""
    sig_all = _training_sigmas(sched)
    ts = np.linspace(0, sched.num_train_timesteps - 1, num_inference_steps,
                     dtype=np.float64)[::-1]
    sig = np.interp(ts, np.arange(len(sig_all)), sig_all)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def euler_timesteps(sched: NoiseSchedule,
                    num_inference_steps: int) -> np.ndarray:
    return np.linspace(0, sched.num_train_timesteps - 1, num_inference_steps
                       )[::-1].round().astype(np.int64).copy()


def karras_sigmas(sched: NoiseSchedule, num_inference_steps: int,
                  rho: float = 7.0) -> Tuple[np.ndarray, np.ndarray]:
    """Karras et al. (2022) sigma spacing for the Euler samplers: (sigmas
    (S + 1,) float32 ending in 0, the nearest training timesteps (S,) for
    the model's conditioning input)."""
    sig_all = _training_sigmas(sched)
    sig_min, sig_max = sig_all[0], sig_all[-1]
    ramp = np.linspace(0, 1, num_inference_steps)
    inv_rho = 1.0 / rho
    sig = (sig_max**inv_rho + ramp * (sig_min**inv_rho - sig_max**inv_rho)
           ) ** rho
    ts = np.interp(sig, sig_all, np.arange(len(sig_all))).round().astype(
        np.int64)
    return np.concatenate([sig, [0.0]]).astype(np.float32), ts


def euler_scale_model_input(sample: torch.Tensor,
                            sigma: torch.Tensor) -> torch.Tensor:
    """The model's input at sigma: sample / sqrt(sigma^2 + 1), the divisor
    in the sample's dtype (sigma a float32 0-d tensor)."""
    return sample / (sigma**2 + 1.0).sqrt().to(sample.dtype)


def sigma_pred_to_eps(sched: NoiseSchedule, model_out: torch.Tensor,
                      sample: torch.Tensor,
                      sigma: torch.Tensor) -> torch.Tensor:
    """A model prediction as the eps the Euler steps take, in float32
    (epsilon prediction: the output as it is). `sample` is the unscaled
    latent at `sigma` (a float32 0-d tensor); x0 follows diffusers'
    EulerDiscreteScheduler, x / (sigma^2 + 1) - v * sigma /
    sqrt(sigma^2 + 1) for v-prediction and the output itself for sample
    prediction, and eps = (x - x0) / sigma."""
    if sched.prediction_type == "epsilon":
        return model_out
    x = sample.float()
    if sched.prediction_type == "v_prediction":
        x0 = (x / (sigma**2 + 1.0)
              - model_out.float() * sigma / (sigma**2 + 1.0).sqrt())
    else:  # "sample"
        x0 = model_out.float()
    return (x - x0) / sigma


def euler_step(sample: torch.Tensor, eps: torch.Tensor, sigma: torch.Tensor,
               sigma_next: torch.Tensor) -> torch.Tensor:
    """Deterministic Euler step in sigma space (epsilon prediction)."""
    x = sample.float()
    denoised = x - sigma * eps.float()
    d = (x - denoised) / sigma
    return (x + d * (sigma_next - sigma)).to(sample.dtype)


def euler_ancestral_step(sample: torch.Tensor, eps: torch.Tensor,
                         sigma: torch.Tensor, sigma_next: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
    """Stochastic (ancestral) Euler step in sigma space; `noise` is one
    standard normal draw of the sample's shape."""
    x = sample.float()
    sigma_up = (sigma_next**2 * (sigma**2 - sigma_next**2)
                / (sigma**2).clamp(min=1e-20)).clamp(min=0.0).sqrt()
    sigma_down = (sigma_next**2 - sigma_up**2).clamp(min=0.0).sqrt()
    denoised = x - sigma * eps.float()
    d = (x - denoised) / sigma
    x = x + d * (sigma_down - sigma)
    return (x + noise.float() * sigma_up).to(sample.dtype)


# ---------------------------------------------------------------------------
# DDPM ancestral sampler (sampling on the training schedule)
# ---------------------------------------------------------------------------

def ddpm_step(
    sched: NoiseSchedule,
    model_out: torch.Tensor,
    t: torch.Tensor,
    sample: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """One DDPM posterior step from timestep t ((B,) tensor) to t - 1; the
    noise is added where t > 0."""
    x0, eps = pred_to_x0_eps(sched, model_out.float(), sample.float(), t)
    shape = (-1,) + (1,) * (sample.ndim - 1)
    a_t = _alpha_at(sched, t).reshape(shape)
    a_prev = torch.where(t > 0, _alpha_at(sched, t - 1),
                         torch.ones_like(t, dtype=a_t.dtype)).reshape(shape)
    beta_t = 1.0 - a_t / a_prev
    # the posterior mean's coefficients (DDPM eq. 7)
    coef_x0 = a_prev.sqrt() * beta_t / (1.0 - a_t)
    coef_xt = (a_t / a_prev).sqrt() * (1.0 - a_prev) / (1.0 - a_t)
    mean = coef_x0 * x0 + coef_xt * sample
    var = (beta_t * (1.0 - a_prev) / (1.0 - a_t)).clamp(min=1e-20)
    sigma = torch.where(t.reshape(shape) > 0, var.sqrt(),
                        torch.zeros_like(var))
    return (mean + sigma * noise).to(sample.dtype)
