"""Rectified flow on mel (mirrors ddsp_svc_tpu/models/reflow.py
``RectifiedFlow``): at inference the Euler or RK4 ODE of the velocity net
from the shallow start x = t_start * norm_spec(mel) + (1 - t_start) *
noise, or from the noise itself at t = 0 when there is no mel; in training
the velocity loss (``loss``). Mel layout is (B, T, M).

The time arithmetic is the JAX package's: t accumulates as a Python float,
is filled as f32 per step and scaled by 1000 in f32 inside the velocity
call; RK4's final division by 6 is correctly rounded on every device
(``ops/source.exact_div``), since PyTorch's CUDA division by a Python
scalar multiplies by its rounded reciprocal.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.source import exact_div

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class RectifiedFlow:
    """Holds no parameters: the velocity net is passed in, as
    ``v_fn(x, 1000 t)``."""

    spec_min, spec_max = -12.0, 2.0

    def __init__(self, out_dims: int = 128):
        self.out_dims = out_dims

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2.0 - 1.0

    def denorm_spec(self, x):
        return (x + 1.0) / 2.0 * (self.spec_max - self.spec_min) + self.spec_min

    def loss(self, velocity_fn: VelocityFn, gt_spec: torch.Tensor,
             t_start: float = 0.0, t: torch.Tensor | None = None,
             x_0: torch.Tensor | None = None, loss_type: str = "l2_lognorm",
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The training loss (JAX ``infer=False``, reflow.py:58-80): t =
        t_start + (1 - t_start) U, clipped to [1e-7, 1 - 1e-7], x_t = x_0 +
        t (x_1 - x_0) with x_1 the normalised mel and x_0 a normal draw, and
        the velocity's error against x_1 - x_0 by ``loss_type`` ('l1',
        'l2', or 'l2_lognorm': l2 weighted by the log-normal density of t).
        ``t`` (B,) and ``x_0`` (B, T, M) are drawn from ``generator`` when
        not given."""
        x_1 = self.norm_spec(gt_spec)
        b = x_1.shape[0]
        t_start = max(float(t_start), 0.0)
        if t is None:
            u = torch.rand((b,), generator=generator, device=x_1.device,
                           dtype=x_1.dtype)
            t = torch.clamp(t_start + (1.0 - t_start) * u, 1e-7, 1.0 - 1e-7)
        t = torch.as_tensor(t, dtype=x_1.dtype).to(x_1.device)
        if x_0 is None:
            x_0 = torch.randn(x_1.shape, generator=generator,
                              device=x_1.device, dtype=x_1.dtype)
        x_t = x_0 + t[:, None, None] * (x_1 - x_0)
        err = (x_1 - x_0) - velocity_fn(x_t, 1000.0 * t)
        if loss_type == "l1":
            return torch.mean(torch.abs(err))
        if loss_type == "l2":
            return torch.mean(err ** 2)
        if loss_type == "l2_lognorm":
            w = 0.398942 / t / (1.0 - t) * torch.exp(
                -0.5 * torch.log(t / (1.0 - t)) ** 2)
            return torch.mean(w[:, None, None] * err ** 2)
        raise NotImplementedError(f"loss_type {loss_type!r}")

    def infer(self, velocity_fn: VelocityFn, gt_spec: torch.Tensor | None,
              infer_step: int = 10, sampler: str = "euler",
              t_start: float = 0.0, init_noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              condition: torch.Tensor | None = None) -> torch.Tensor:
        """``infer_step`` steps of ``sampler`` ('euler': one velocity call
        per step, 'rk4': four) from ``t_start`` to 1 -> the mel. ``gt_spec``
        (B, T, M) un-normalised; without it the ODE starts from the noise
        at t = 0 on the ``condition``'s (B, T) grid. ``init_noise`` (B, T,
        M) is drawn from ``generator`` when not given."""
        t_start = max(float(t_start), 0.0)
        like = gt_spec if gt_spec is not None else condition
        shape = (like.shape[0], like.shape[1], self.out_dims)
        noise = init_noise if init_noise is not None else torch.randn(
            shape, generator=generator, device=like.device, dtype=like.dtype)
        if gt_spec is None:
            x = noise
            t, dt = 0.0, 1.0 / infer_step
        else:
            x = t_start * self.norm_spec(gt_spec) + (1.0 - t_start) * noise
            t, dt = t_start, (1.0 - t_start) / infer_step

        def v_fn(x, tv):
            tb = torch.full((x.shape[0],), tv, dtype=x.dtype, device=x.device)
            return velocity_fn(x, 1000.0 * tb)

        if sampler == "euler":
            for _ in range(infer_step):
                x = x + v_fn(x, t) * dt
                t += dt
        elif sampler == "rk4":
            for _ in range(infer_step):
                k1 = v_fn(x, t)
                k2 = v_fn(x + 0.5 * k1 * dt, t + 0.5 * dt)
                k3 = v_fn(x + 0.5 * k2 * dt, t + 0.5 * dt)
                k4 = v_fn(x + k3 * dt, t + dt)
                x = x + exact_div((k1 + 2.0 * k2 + 2.0 * k3 + k4) * dt, 6.0)
                t += dt
        else:
            raise NotImplementedError(f"sampler {sampler!r}: 'euler' or 'rk4'")
        return self.denorm_spec(x)
