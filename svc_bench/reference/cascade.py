"""The mel cascades of diffusion-fast and reflow: CombSubSuperFast (the
combtooth exciter and a noise branch filtered by STFT-domain filters from
Unit2Control) whose log-mel conditions the NaiveV2Diff conformer, run as a
shallow diffusion under DPM-Solver++ (2M, time-uniform) or as a rectified
flow under Euler."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (carry_cycles, conv, exact_div, gelu, group_norm,
                     layer_norm, linear, log_mel, quantise, sinusoidal_pos_emb,
                     stft, istft, wn_linear)


def combtooth(f0: torch.Tensor, sr: int, block: int):
    """f0 (B, T, 1) -> (combtooth (B, T block), phase at each frame start
    (B, T, 1) in radians): a linear f0 ramp within each frame, the frames'
    phase carried as integers of 2^-22 cycles."""
    n = torch.arange(block, dtype=f0.dtype, device=f0.device)
    s0 = exact_div(f0, sr)
    ds0 = F.pad(s0[:, 1:] - s0[:, :-1], (0, 0, 0, 1))
    rad = s0 * (n + 1.0) + exact_div(0.5 * ds0 * n * (n + 1.0), block)
    s0_eff = s0 + exact_div(ds0 * n, block)
    last = float(block - 1)
    rad_last = s0 * (last + 1.0) + exact_div(0.5 * ds0 * last * (last + 1.0), block)
    rad = rad + carry_cycles(quantise(rad_last))
    rad = rad - torch.round(rad)
    comb = torch.sinc(rad / (s0_eff + 1e-5)).reshape(f0.shape[0], -1)
    return comb, 2.0 * math.pi * rad[:, :, :1]


def conformer_module(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv -> GLU -> depthwise conv -> SiLU -> 1x1 conv."""
    u = F.glu(conv(w, f"{p}.conv1", x), dim=-1)
    k = w[f"{p}.depthwise.weight"].shape[-1]
    v = conv(w, f"{p}.depthwise", u, padding=k // 2, groups=u.shape[-1])
    return conv(w, f"{p}.conv2", F.silu(v))


def unit2control(w: dict, p: str, units, f0, phase, volume):
    """-> the control vector (B, T, 4 (win / 2 + 1))."""
    x = conv(w, f"{p}.stack_conv0", units, padding=1)
    x = F.leaky_relu(group_norm(w, f"{p}.stack_norm", x, 4), 0.01)
    x = conv(w, f"{p}.stack_conv1", x, padding=1)
    x = (x + linear(w, f"{p}.f0_embed", torch.log1p(f0 / 700.0))
         + linear(w, f"{p}.phase_embed", phase / math.pi)
         + linear(w, f"{p}.volume_embed", volume))
    i = 0
    while f"{p}.decoder.layers.{i}.conformer.conv1.weight" in w:
        x = x + conformer_module(w, f"{p}.decoder.layers.{i}.conformer", x)
        i += 1
    return wn_linear(w, f"{p}.dense_out", layer_norm(w, f"{p}.norm", x))


def combsub_superfast(w: dict, cfg: dict, units, f0, volume, noise):
    """units (B, T, n_unit), f0 and volume (B, T, 1), noise (B, T block) ->
    audio (B, T block)."""
    sr, block = cfg["data"]["sampling_rate"], cfg["data"]["block_size"]
    win = cfg["model"]["win_length"]
    comb, phase = combtooth(f0, sr, block)
    ctrl = unit2control(w, "ddsp_model.unit2ctrl", units, f0, phase, volume)
    hm, hp, nm, npz = ctrl.split(win // 2 + 1, dim=-1)
    src = torch.polar(torch.exp(hm), math.pi * hp)
    nse = torch.polar(torch.exp(nm), math.pi * npz) / 128.0
    src = torch.cat([src, src[:, -1:]], dim=1)
    nse = torch.cat([nse, nse[:, -1:]], dim=1)
    pad_mode = "reflect" if comb.shape[-1] > win // 2 else "constant"
    spec = (stft(comb, win, block, pad_mode) * src
            + stft(noise, win, block, pad_mode) * nse)
    return istft(spec, win, block)


def naive_v2_diff(w: dict, p: str, x, steps, cond, n_layers: int):
    """The conformer denoiser: x (B, T, M), steps (B,), cond (B, T, M)."""
    h = gelu(conv(w, f"{p}.input_projection", x))
    dim = h.shape[-1]
    emb = sinusoidal_pos_emb(steps, dim)
    emb = linear(w, f"{p}.diff_emb_1", gelu(linear(w, f"{p}.diff_emb_0", emb)))[:, None]
    for i in range(n_layers):
        q = f"{p}.layers.{i}"
        step_vec = conv(w, f"{q}.diffusion_step_projection", emb)
        g = (h + step_vec + conv(w, f"{q}.condition_projection", cond))
        h = h + conformer_module(w, f"{q}.conformer", g)
    return conv(w, f"{p}.output_projection", h)


SPEC_MIN, SPEC_MAX = -12.0, 2.0


def norm_spec(x):
    return (x - SPEC_MIN) / (SPEC_MAX - SPEC_MIN) * 2.0 - 1.0


def denorm_spec(x):
    return (x + 1.0) / 2.0 * (SPEC_MAX - SPEC_MIN) + SPEC_MIN


def _betas(timesteps: int = 1000, max_beta: float = 0.02) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


class _VP:
    """The discrete VP schedule in continuous time (float64 on the host):
    log alpha interpolated piecewise linearly over t = (1 .. N) / N."""

    def __init__(self, betas: np.ndarray):
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
        lambs = log_alphas - 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        idx = int(np.searchsorted(np.flip(lambs), -5.1))
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        self.la = log_alphas
        self.n = len(log_alphas)
        self.t = np.linspace(0.0, 1.0, self.n + 1)[1:]

    def log_alpha(self, t):
        return np.interp(t, self.t, self.la)

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def sigma(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))


def dpm_solver_pp(x, eps_fn, k_step: int, steps: int):
    """Multistep DPM-Solver++ order 2 (data prediction, time-uniform,
    lower order on the final steps when steps < 10) from the shallow start
    ``k_step``: ``steps`` denoiser calls."""
    ns = _VP(_betas()[:k_step])
    ts = np.linspace(1.0, 1.0 / ns.n, steps + 1)

    def x0(x, tc):
        tin = torch.full((x.shape[0],), float((tc - 1.0 / ns.n) * ns.n),
                         dtype=x.dtype, device=x.device)
        return (x - float(ns.sigma(tc)) * eps_fn(x, tin)) / float(ns.alpha(tc))

    def first(x, s, t, m):
        phi = np.expm1(-(ns.lam(t) - ns.lam(s)))
        return float(ns.sigma(t) / ns.sigma(s)) * x - float(ns.alpha(t) * phi) * m

    def second(x, t1, t0, t, m1, m0):
        h = ns.lam(t) - ns.lam(t0)
        r0 = (ns.lam(t0) - ns.lam(t1)) / h
        phi = np.expm1(-h)
        d1 = float(1.0 / r0) * (m0 - m1)
        return (float(ns.sigma(t) / ns.sigma(t0)) * x - float(ns.alpha(t) * phi) * m0
                - 0.5 * float(ns.alpha(t) * phi) * d1)

    t_prev, m_prev = [ts[0]], [x0(x, ts[0])]
    if steps >= 2:
        x = first(x, t_prev[-1], ts[1], m_prev[-1])
        t_prev.append(ts[1])
        m_prev.append(x0(x, ts[1]))
    for step in range(2, steps + 1):
        order = min(2, steps + 1 - step) if steps < 10 else 2
        if order == 2:
            x = second(x, t_prev[-2], t_prev[-1], ts[step], m_prev[-2], m_prev[-1])
        else:
            x = first(x, t_prev[-1], ts[step], m_prev[-1])
        t_prev = [t_prev[-1], ts[step]]
        if step < steps:
            m_prev = [m_prev[-1], x0(x, ts[step])]
    if steps == 1:
        x = first(x, t_prev[0], ts[1], m_prev[0])
    return x


def mel_cascade(w: dict, cfg: dict, units, f0, volume, noise: dict, extract):
    """-> the mel (B, T, M) of DiffusionFast or RectifiedFlow at the
    config's sampler settings; ``extract`` maps audio to its log-mel."""
    model, infer = cfg["model"], cfg["infer"]
    ddsp = combsub_superfast(w, cfg, units, f0, volume, noise["ddsp"])
    cond = extract(ddsp)
    if model["type"] == "DiffusionFast":
        k_step = int(model["k_step_max"])
        b = _betas()
        c0 = float(np.float32(np.sqrt(np.cumprod(1.0 - b))[k_step - 1]))
        c1 = float(np.float32(np.sqrt(1.0 - np.cumprod(1.0 - b))[k_step - 1]))
        x = c0 * norm_spec(cond) + c1 * noise["diffusion"]

        def eps(x, t):
            return naive_v2_diff(w, "denoise_fn", x, t, cond, model["n_layers"])

        x = dpm_solver_pp(x, eps, k_step, k_step // int(infer["speedup"]))
        return denorm_spec(x)
    if model["type"] == "RectifiedFlow":
        t, steps = float(model["t_start"]), int(infer["infer_step"])
        x = t * norm_spec(cond) + (1.0 - t) * noise["diffusion"]
        dt = (1.0 - t) / steps
        for _ in range(steps):
            tb = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
            v = naive_v2_diff(w, "velocity_fn", x, 1000.0 * tb, cond, model["n_layers"])
            x = x + v * dt
            t += dt
        return denorm_spec(x)
    raise ValueError(f"no reference for model type {model['type']!r}")


def extract_fn(voc: dict):
    return lambda audio: log_mel(audio, voc)
