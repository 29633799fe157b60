"""Gaussian mel diffusion, shallow or from noise, and its samplers (mirrors
ddsp_svc_tpu/models/diffusion.py: ``linear_schedule``,
``_DiscreteVPSchedule``, ``norm_spec``/``denorm_spec``, ``q_sample``, the
full DDPM ancestral chain, DDIM, PLMS/PNDM, DPM-Solver++ 2M and UniPC bh2).

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
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
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


def _data_prediction(ns: _DiscreteVPSchedule, eps_fn: EpsFn):
    """x0(x, t) = (x - sigma(t) eps(x, t)) / alpha(t) at continuous t."""
    def x0_fn(x, t_cont):
        tin = torch.full((x.shape[0],), float(ns.model_input_time(t_cont)),
                         dtype=x.dtype, device=x.device)
        eps = eps_fn(x, tin)
        return (x - float(ns.sigma(t_cont)) * eps) / float(ns.alpha(t_cont))
    return x0_fn


def _step_labels(x: torch.Tensor, i: int) -> torch.Tensor:
    return torch.full((x.shape[0],), float(i), dtype=x.dtype, device=x.device)


def sample_ddpm_chain(x: torch.Tensor, eps_fn: EpsFn, t_start: int,
                      noise=None, generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """The full ancestral chain from step ``t_start - 1`` down to 0, one
    denoiser call per step. ``noise`` (t_start, *x.shape): the draw of
    each step in the order the steps run; drawn from ``generator`` when
    not given."""
    s = linear_schedule()
    f32 = {k: s[k].astype(np.float32) for k in (
        "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
        "posterior_mean_coef1", "posterior_mean_coef2",
        "posterior_log_variance_clipped")}
    for i, t in enumerate(range(t_start - 1, -1, -1)):
        eps = eps_fn(x, _step_labels(x, t))
        x_recon = (float(f32["sqrt_recip_alphas_cumprod"][t]) * x
                   - float(f32["sqrt_recipm1_alphas_cumprod"][t]) * eps)
        x_new = (float(f32["posterior_mean_coef1"][t]) * x_recon
                 + float(f32["posterior_mean_coef2"][t]) * x)
        if t > 0:
            z = noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
            std = np.exp(np.float32(0.5) * f32["posterior_log_variance_clipped"][t])
            x_new = x_new + float(std) * torch.as_tensor(z, dtype=x.dtype,
                                                           device=x.device)
        x = x_new
    return x


def sample_ddim(x: torch.Tensor, eps_fn: EpsFn, t_start: int, speedup: int
                ) -> torch.Tensor:
    """DDIM with per-step coefficients from the host schedule."""
    ac = linear_schedule()["alphas_cumprod"]
    for i in reversed(range(0, t_start, speedup)):
        a_t = float(ac[i])
        a_prev = float(ac[max(i - speedup, 0)])
        eps = eps_fn(x, _step_labels(x, i))
        x = float(np.sqrt(a_prev)) * (
            x / float(np.sqrt(a_t))
            + float(np.sqrt((1 - a_prev) / a_prev) - np.sqrt((1 - a_t) / a_t)) * eps)
    return x


def plms_coefficients(a_t, a_prev, sqrt=np.sqrt) -> tuple:
    """PLMS's transfer from step t to t_prev is x + (a_prev - a_t) * (c_x x
    - c_eps eps), with a the cumulative alpha: -> (c_x, c_eps), from host
    floats (the sampler, in float64) or tensors (the ONNX ``pred`` graph,
    ``sqrt=torch.sqrt``)."""
    a_t_sq, a_prev_sq = sqrt(a_t), sqrt(a_prev)
    return (1.0 / (a_t_sq * (a_t_sq + a_prev_sq)),
            1.0 / (a_t_sq * (sqrt((1 - a_prev) * a_t) + sqrt((1 - a_t) * a_prev))))


def sample_plms(x: torch.Tensor, eps_fn: EpsFn, t_start: int, speedup: int
                ) -> torch.Tensor:
    """PLMS/PNDM: Adams-Bashforth on eps, a Heun start (two denoiser calls
    on the first step, one on every other)."""
    ac = linear_schedule()["alphas_cumprod"]

    def x_pred(x, eps, i):
        a_t, a_prev = float(ac[i]), float(ac[max(i - speedup, 0)])
        c_x, c_eps = plms_coefficients(a_t, a_prev)
        return x + (a_prev - a_t) * (float(c_x) * x - float(c_eps) * eps)

    noise_list = []
    for i in reversed(range(0, t_start, speedup)):
        eps = eps_fn(x, _step_labels(x, i))
        if len(noise_list) == 0:
            x_p = x_pred(x, eps, i)
            eps_prev = eps_fn(x_p, _step_labels(x, max(i - speedup, 0)))
            eps_prime = (eps + eps_prev) / 2.0
        elif len(noise_list) == 1:
            eps_prime = (3.0 * eps - noise_list[-1]) / 2.0
        elif len(noise_list) == 2:
            eps_prime = (23.0 * eps - 16.0 * noise_list[-1]
                         + 5.0 * noise_list[-2]) / 12.0
        else:
            eps_prime = (55.0 * eps - 59.0 * noise_list[-1]
                         + 37.0 * noise_list[-2] - 9.0 * noise_list[-3]) / 24.0
        x = x_pred(x, eps_prime, i)
        noise_list = (noise_list + [eps])[-3:]
    return x


def sample_dpmpp_2m(x: torch.Tensor, eps_fn: EpsFn, schedule_betas: np.ndarray,
                    k_step: int, steps: int) -> torch.Tensor:
    """Multistep DPM-Solver++ order 2, time_uniform, lower_order_final:
    ``steps`` denoiser calls from the shallow start ``k_step``."""
    ns = _DiscreteVPSchedule.from_betas(schedule_betas[:k_step])
    n = ns.total_n
    timesteps = np.linspace(1.0, 1.0 / n, steps + 1)
    x0_fn = _data_prediction(ns, eps_fn)

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



def _bh2_coeffs(h: float, r0: float | None = None) -> dict:
    """Host scalars of one UniPC bh2 update (data prediction)."""
    hh = -h
    h_phi_1 = np.expm1(hh)
    b_h = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    b0 = h_phi_k * 1.0 / b_h
    h_phi_k = h_phi_k / hh - 1.0 / 2.0
    b1 = h_phi_k * 2.0 / b_h
    coeffs = {"h_phi_1": h_phi_1, "b_h": b_h, "b0": b0, "b1": b1}
    if r0 is not None:
        # solve [[1, 1], [r0, 1]] rho = [b0, b1]
        a = (b1 - b0) / (r0 - 1.0)
        coeffs["rhos_c"] = (a, b0 - a)
    return coeffs


def sample_unipc_bh2(x: torch.Tensor, eps_fn: EpsFn, schedule_betas: np.ndarray,
                     k_step: int, steps: int) -> torch.Tensor:
    """Multistep UniPC (bh2) order 2 with data prediction: the predictor
    with rho_p = 0.5, the corrector from the 2 x 2 B(h) system, and an
    order-1 final step without corrector; ``steps`` denoiser calls."""
    ns = _DiscreteVPSchedule.from_betas(schedule_betas[:k_step])
    n = ns.total_n
    timesteps = np.linspace(1.0, 1.0 / n, steps + 1)
    x0_fn = _data_prediction(ns, eps_fn)

    def update(x, t_prev_list, m_prev_list, t, order, use_corrector):
        t_prev_0, m0 = t_prev_list[-1], m_prev_list[-1]
        lam_t, lam_p0 = ns.lam(t), ns.lam(t_prev_0)
        h = lam_t - lam_p0
        sig_ratio = float(ns.sigma(t) / ns.sigma(t_prev_0))
        alpha_t = float(ns.alpha(t))
        if order == 2:
            m1 = m_prev_list[-2]
            r0 = (ns.lam(t_prev_list[-2]) - lam_p0) / h
            c = _bh2_coeffs(h, r0)
            d1_0 = (m1 - m0) / float(r0)
            x_t_ = sig_ratio * x - float(alpha_t * c["h_phi_1"]) * m0
            x_t = x_t_ - float(alpha_t * c["b_h"]) * (0.5 * d1_0)
            if not use_corrector:
                return x_t, None
            m_t = x0_fn(x_t, t)
            rc0, rc1 = c["rhos_c"]
            x_t = x_t_ - float(alpha_t * c["b_h"]) * (
                float(rc0) * d1_0 + float(rc1) * (m_t - m0))
            return x_t, m_t
        c = _bh2_coeffs(h)
        x_t_ = sig_ratio * x - float(alpha_t * c["h_phi_1"]) * m0
        if not use_corrector:
            return x_t_, None
        m_t = x0_fn(x_t_, t)
        return x_t_ - float(alpha_t * c["b_h"]) * (0.5 * (m_t - m0)), m_t

    t_prev = [timesteps[0]]
    m_prev = [x0_fn(x, timesteps[0])]
    if steps >= 2:
        t = timesteps[1]
        x, m_t = update(x, t_prev, m_prev, t, order=1, use_corrector=True)
        t_prev.append(t)
        m_prev.append(m_t)
    for step in range(2, steps + 1):
        t = timesteps[step]
        x, m_t = update(x, t_prev, m_prev, t, min(2, steps + 1 - step),
                        use_corrector=step != steps)
        t_prev = [t_prev[-1], t]
        if step < steps:
            m_prev = [m_prev[-1], m_t if m_t is not None else x0_fn(x, t)]
    if steps == 1:
        x, _ = update(x, t_prev, m_prev, timesteps[1], order=1, use_corrector=False)
    return x

class GaussianDiffusion:
    """DDPM schedule (1000 linear steps, max beta 0.02, the values every
    config uses) on normalised mel, inference with the samplers above:
    shallow from a given mel, or from noise at ``k_step`` (the model's
    k_step_max) when there is none; and the training loss (``loss``). Holds
    no parameters: the denoiser is passed in."""

    spec_min, spec_max = -12.0, 2.0

    def __init__(self, out_dims: int = 128, k_step: int = 1000):
        self.out_dims, self.k_step = out_dims, k_step

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

    def loss(self, eps_fn: EpsFn, gt_spec: torch.Tensor,
             k_step: int | None = None, t: torch.Tensor | None = None,
             noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The training loss (JAX ``infer=False``, diffusion.py:151-159):
        t ~ U{0 .. k_step - 1} per row (``k_step`` defaults to the model's
        k_step_max), the mel diffused to t with a normal draw, and the MSE
        of the denoiser's noise prediction. ``t`` (B,) int and ``noise``
        (B, T, M) are drawn from ``generator`` when not given."""
        spec = self.norm_spec(gt_spec)
        b = spec.shape[0]
        t_max = self.k_step if k_step is None else int(k_step)
        if t is None:
            t = torch.randint(0, t_max, (b,), generator=generator,
                              device=spec.device)
        if noise is None:
            noise = torch.randn(spec.shape, generator=generator,
                                device=spec.device, dtype=spec.dtype)
        s = self.schedule()
        t = torch.as_tensor(t, device=spec.device).long()
        coef = [torch.as_tensor(s[k].astype(np.float32), device=spec.device)[t]
                [:, None, None] for k in ("sqrt_alphas_cumprod",
                                          "sqrt_one_minus_alphas_cumprod")]
        x_noisy = coef[0] * spec + coef[1] * noise
        eps = eps_fn(x_noisy, t.to(spec.dtype))
        return torch.mean((noise - eps) ** 2)

    def infer(self, eps_fn: EpsFn, gt_spec: torch.Tensor | None,
              k_step: int | None, infer_speedup: int = 10,
              sampler: str = "dpm-solver",
              init_noise: torch.Tensor | None = None,
              chain_noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              condition: torch.Tensor | None = None) -> torch.Tensor:
        """Shallow diffusion from ``gt_spec`` (B, T, M, un-normalised mel):
        q_sample to step k_step - 1, then ``sampler`` ('dpm-solver',
        'unipc', 'pndm' or 'ddim') with speedup ``infer_speedup``, or the
        full ancestral chain when ``infer_speedup`` is 1 (its per-step
        draws ``chain_noise`` (k_step, B, T, M) or from ``generator``);
        returns the mel. Without ``gt_spec`` (or ``k_step``) the sampler
        starts from the noise itself at ``self.k_step``, on the
        ``condition``'s (B, T) grid."""
        if gt_spec is None or k_step is None:
            k_step = self.k_step
            shape = (condition.shape[0], condition.shape[1], self.out_dims)
            x = init_noise if init_noise is not None else torch.randn(
                shape, generator=generator, device=condition.device,
                dtype=condition.dtype)
        else:
            k_step = int(k_step)
            norm = self.norm_spec(gt_spec)
            noise = init_noise if init_noise is not None else torch.randn(
                norm.shape, generator=generator, device=norm.device,
                dtype=norm.dtype)
            x = self.q_sample(norm, k_step - 1, noise)
        betas = self.schedule()["betas"]
        if sampler is None or infer_speedup <= 1:
            x = sample_ddpm_chain(x, eps_fn, k_step, chain_noise, generator)
        elif sampler == "dpm-solver":
            x = sample_dpmpp_2m(x, eps_fn, betas, k_step, k_step // infer_speedup)
        elif sampler == "unipc":
            x = sample_unipc_bh2(x, eps_fn, betas, k_step, k_step // infer_speedup)
        elif sampler == "pndm":
            x = sample_plms(x, eps_fn, k_step, infer_speedup)
        elif sampler == "ddim":
            x = sample_ddim(x, eps_fn, k_step, infer_speedup)
        else:
            raise NotImplementedError(f"sampler {sampler!r}")
        return self.denorm_spec(x)
