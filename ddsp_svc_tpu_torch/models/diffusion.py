"""Gaussian mel diffusion with shallow start and DPM-Solver++ 2M (mirrors
ddsp_svc_tpu/models/diffusion.py: ``linear_schedule``,
``_DiscreteVPSchedule``, ``norm_spec``/``denorm_spec``, ``q_sample``,
``_sample_dpmpp_2m``).

Every per-step scalar is computed in numpy float64 on the host, as in the
JAX package; only the denoiser calls and the elementwise updates touch
tensors. Mel layout is (B, T, M).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np
import torch


@lru_cache(maxsize=8)
def linear_schedule(timesteps: int = 1000, max_beta: float = 0.02) -> dict:
    betas = np.linspace(1e-4, max_beta, timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    return dict(
        betas=betas,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
    )


@dataclass(frozen=True)
class _DiscreteVPSchedule:
    """Continuous-time view of the discrete schedule (NoiseScheduleVP
    'discrete': piecewise-linear log-alpha interpolation)."""

    log_alpha_array: np.ndarray
    t_array: np.ndarray

    @classmethod
    def from_betas(cls, betas: np.ndarray) -> "_DiscreteVPSchedule":
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(np.flip(lambs), -5.1))
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        n = len(log_alphas)
        return cls(log_alphas, np.linspace(0.0, 1.0, n + 1)[1:])

    @property
    def total_n(self) -> int:
        return len(self.t_array)

    def log_alpha(self, t):
        return np.interp(t, self.t_array, self.log_alpha_array)

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def sigma(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def model_input_time(self, t):
        """Continuous t in [1/N, 1] -> discrete step label in [0, N-1]."""
        return (t - 1.0 / self.total_n) * self.total_n


EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sample_dpmpp_2m(x: torch.Tensor, eps_fn: EpsFn, schedule_betas: np.ndarray,
                    k_step: int, steps: int) -> torch.Tensor:
    """Multistep DPM-Solver++ order 2, time_uniform, lower_order_final:
    ``steps`` denoiser calls from the shallow start ``k_step``."""
    ns = _DiscreteVPSchedule.from_betas(schedule_betas[:k_step])
    n = ns.total_n
    b = x.shape[0]
    timesteps = np.linspace(1.0, 1.0 / n, steps + 1)

    def x0_fn(x, t_cont):
        tin = torch.full((b,), float(ns.model_input_time(t_cont)),
                         dtype=x.dtype, device=x.device)
        eps = eps_fn(x, tin)
        return (x - float(ns.sigma(t_cont)) * eps) / float(ns.alpha(t_cont))

    def first_update(x, s, t, model_s):
        phi_1 = np.expm1(-(ns.lam(t) - ns.lam(s)))
        return (float(ns.sigma(t) / ns.sigma(s)) * x
                - float(ns.alpha(t) * phi_1) * model_s)

    def second_update(x, t_prev_1, t_prev_0, t, m1, m0):
        lam_p1, lam_p0, lam_t = ns.lam(t_prev_1), ns.lam(t_prev_0), ns.lam(t)
        h = lam_t - lam_p0
        r0 = (lam_p0 - lam_p1) / h
        phi_1 = np.expm1(-h)
        d1_0 = float(1.0 / r0) * (m0 - m1)
        return (float(ns.sigma(t) / ns.sigma(t_prev_0)) * x
                - float(ns.alpha(t) * phi_1) * m0
                - 0.5 * float(ns.alpha(t) * phi_1) * d1_0)

    t_prev = [timesteps[0]]
    m_prev = [x0_fn(x, timesteps[0])]
    if steps >= 2:
        t = timesteps[1]
        x = first_update(x, t_prev[-1], t, m_prev[-1])
        t_prev.append(t)
        m_prev.append(x0_fn(x, t))
    lower_order_final = steps < 10
    for step in range(2, steps + 1):
        t = timesteps[step]
        order = min(2, steps + 1 - step) if lower_order_final else 2
        if order == 2:
            x = second_update(x, t_prev[-2], t_prev[-1], t, m_prev[-2], m_prev[-1])
        else:
            x = first_update(x, t_prev[-1], t, m_prev[-1])
        t_prev = [t_prev[-1], t]
        if step < steps:
            m_prev = [m_prev[-1], x0_fn(x, t)]
    if steps == 1:
        x = first_update(x, t_prev[0], timesteps[1], m_prev[0])
    return x


class GaussianDiffusion:
    """DDPM schedule (1000 linear steps, max beta 0.02, the values every
    config uses) on normalised mel, shallow-diffusion inference with
    DPM-Solver++ 2M. Holds no parameters: the denoiser is passed in."""

    spec_min, spec_max = -12.0, 2.0

    def schedule(self) -> dict:
        return linear_schedule()

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2.0 - 1.0

    def denorm_spec(self, x):
        return (x + 1.0) / 2.0 * (self.spec_max - self.spec_min) + self.spec_min

    def q_sample(self, x_start: torch.Tensor, t: int, noise: torch.Tensor):
        """Diffuse to step ``t`` (one step for the whole batch)."""
        s = self.schedule()
        c0 = float(np.float32(s["sqrt_alphas_cumprod"][t]))
        c1 = float(np.float32(s["sqrt_one_minus_alphas_cumprod"][t]))
        return c0 * x_start + c1 * noise

    def infer(self, eps_fn: EpsFn, gt_spec: torch.Tensor, k_step: int,
              infer_speedup: int = 10, sampler: str = "dpm-solver",
              init_noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Shallow diffusion from ``gt_spec`` (B, T, M, un-normalised mel):
        q_sample to step k_step - 1, then DPM-Solver++ 2M with
        k_step // infer_speedup denoiser calls; returns the mel."""
        if sampler != "dpm-solver":
            raise NotImplementedError(
                f"sampler {sampler!r}: only 'dpm-solver' is ported")
        if infer_speedup <= 1:
            raise NotImplementedError("the full DDPM chain is not ported")
        norm = self.norm_spec(gt_spec)
        noise = init_noise if init_noise is not None else torch.randn(
            norm.shape, generator=generator, device=norm.device,
            dtype=norm.dtype)
        x = self.q_sample(norm, int(k_step) - 1, noise)
        x = sample_dpmpp_2m(x, eps_fn, self.schedule()["betas"], int(k_step),
                            int(k_step) // infer_speedup)
        return self.denorm_spec(x)
