"""End-to-end validation of exported ONNX artifacts, wheel-free (mirrors
ddsp_svc_tpu/onnx/validate.py).

Drives the four exported graphs through the external app's PNDM loop (the
host loop of diffusion/diffusion_onnx.py:566-608, which MoeVoiceStudio-style
hosts implement) with the numpy runtime, and compares the mel it produces
with the port's eager Unit2Mel sampling the same chain from the same
initial noise: the proof that the .onnx files reproduce the checkpoint they
were exported from.
"""
from __future__ import annotations

import numpy as np
import torch

from .reader import load_model_file
from .runtime import run_model


def pndm_infer_onnx(graph_paths: dict, hubert: np.ndarray, mel2ph: np.ndarray,
                    f0: np.ndarray, volume: np.ndarray,
                    spk_mix: np.ndarray | None, init_noise: np.ndarray,
                    k_step: int, speedup: int) -> np.ndarray:
    """The whole exported chain: hubert (1, T, U), mel2ph (1, T) int64, f0
    and volume (1, T), spk_mix (T, n_spk) or None, init_noise (1, 1, M, T)
    -> the denormalised mel (1, M, T)."""
    models = {k: load_model_file(p) for k, p in graph_paths.items()}
    enc_feeds = {"hubert": hubert.astype(np.float32),
                 "mel2ph": mel2ph.astype(np.int64),
                 "f0": f0.astype(np.float32),
                 "volume": volume.astype(np.float32)}
    if "spk_mix" in {vi.name for vi in models["encoder"].graph.inputs}:
        enc_feeds["spk_mix"] = spk_mix.astype(np.float32)
    cond = run_model(models["encoder"], enc_feeds)["mel_pred"]

    def denoise(x, t):
        return run_model(models["denoise"], {"noise": x, "time": t,
                                             "condition": cond})["noise_pred"]

    def pred(x, eps, t, t_prev):
        return run_model(models["pred"], {"noise": x, "noise_pred": eps, "time": t,
                                          "time_prev": t_prev})["noise_pred_o"]

    x = init_noise.astype(np.float32)
    noise_list: list[np.ndarray] = []
    for i in reversed(range(0, k_step, speedup)):
        t = np.array([i], np.int64)
        t_prev = np.array([max(i - speedup, 0)], np.int64)
        eps = denoise(x, t)
        if len(noise_list) == 0:
            eps_prev = denoise(pred(x, eps, t, t_prev), t_prev)
            eps_prime = (eps + eps_prev) / 2.0
        elif len(noise_list) == 1:
            eps_prime = (3.0 * eps - noise_list[-1]) / 2.0
        elif len(noise_list) == 2:
            eps_prime = (23.0 * eps - 16.0 * noise_list[-1] + 5.0 * noise_list[-2]) / 12.0
        else:
            eps_prime = (55.0 * eps - 59.0 * noise_list[-1] + 37.0 * noise_list[-2]
                         - 9.0 * noise_list[-3]) / 24.0
        x = pred(x, eps_prime, t, t_prev)
        noise_list = (noise_list + [eps])[-3:]
    return run_model(models["after"], {"x": x})["mel_out"]


def validate_export(model_path: str, graph_paths: dict, n_frames: int = 24,
                    speedup: int | None = None, seed: int = 0,
                    device: str | torch.device | None = None) -> dict:
    """The exported chain against the port's eager Unit2Mel (sampler
    'pndm', loaded on ``device``, the CUDA card by default) from the same
    inputs and initial noise -> {"snr_db", "max_abs", "ref_rms", "steps"}."""
    from ..models.registry import load_model
    from ..models.vocoder import LOG10_E

    model, args = load_model(model_path, device)
    model.eval()
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    t = n_frames
    u = args.data.encoder_out_channels
    n_spk = max(int(args.model.n_spk or 1), 1)
    mel_bins = model.decoder.out_dims
    k_step = model.decoder.k_step
    if speedup is None:
        # > 1: the sampler takes speedup <= 1 as the ancestral chain, not PNDM
        speedup = max(k_step // 10, 2)

    hubert = rng.standard_normal((1, t, u)).astype(np.float32)
    mel2ph = np.arange(1, t + 1, dtype=np.int64)[None]  # identity alignment
    f0 = (rng.random((1, t)) * 300.0 + 80.0).astype(np.float32)
    volume = rng.random((1, t)).astype(np.float32)
    init_noise = rng.standard_normal((1, 1, mel_bins, t)).astype(np.float32)
    if n_spk > 1:
        mix = rng.random(n_spk).astype(np.float32)
        mix /= mix.sum()
        spk_mix = np.tile(mix[None], (t, 1))
        spk_mix_dict = {k + 1: float(mix[k]) for k in range(n_spk)}
    else:
        spk_mix = spk_mix_dict = None

    onnx_mel = pndm_infer_onnx(graph_paths, hubert, mel2ph, f0, volume, spk_mix,
                               init_noise, k_step, speedup)  # (1, M, T)

    def on(a):
        return torch.from_numpy(a).to(dev)

    with torch.no_grad():
        mel = model(on(hubert), on(f0)[..., None], on(volume)[..., None],
                    spk_id=torch.ones((1, 1), dtype=torch.long, device=dev),
                    spk_mix_dict=spk_mix_dict, infer_speedup=speedup,
                    sampler="pndm", k_step=None,
                    init_noise=on(init_noise[:, 0].transpose(0, 2, 1).copy()))
    scale = LOG10_E if (args.vocoder and args.vocoder.type) == "nsf-hifigan-log10" else 1.0
    ref = mel[0].T.cpu().numpy().astype(np.float64) * scale  # (M, T)
    err = onnx_mel[0] - ref
    ref_rms = float(np.sqrt(np.mean(ref ** 2)) + 1e-12)
    err_rms = float(np.sqrt(np.mean(err ** 2)) + 1e-20)
    return {"snr_db": 20.0 * float(np.log10(ref_rms / err_rms)),
            "max_abs": float(np.abs(err).max()), "ref_rms": ref_rms,
            "steps": int(np.ceil(k_step / speedup))}
