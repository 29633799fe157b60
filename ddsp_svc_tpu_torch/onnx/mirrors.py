"""The four ONNX graphs of the external apps' contract over a loaded port
``Unit2Mel`` (the counterpart of ddsp_svc_tpu/onnx/mirrors.py).

Graph surface (names, shapes, dynamic axes) as the reference export:
- encoder: diffusion/onnx_export.py:75-158 (hubert, mel2ph, f0, volume,
  spk_mix) -> mel_pred, the (1, H, T) condition;
- denoise: diffusion/diffusion_onnx.py:128-168, 492-504 (noise, time,
  condition) -> noise_pred;
- pred: diffusion/diffusion_onnx.py:186-199, 512-524, the PLMS x_pred step;
- after: diffusion/diffusion_onnx.py:171-183, 549-560, the denormalised mel.

The JAX package needs mirror modules and a weight converter because its
model is not torch. The port's is, so each graph is a thin module over the
loaded model's own submodules (no weight is copied) that adapts the layout:
the port runs (B, T, C), the contract is NCW. The encoder runs
``Unit2Mel.hidden`` on the graph's embeds, the denoiser is the model's
``WaveNet``, and ``pred`` and ``after`` are ``models/diffusion.py``'s PLMS
coefficients and ``denorm_spec``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.cascade import Unit2Mel
from ..models.diffusion import plms_coefficients
from ..models.vocoder import LOG10_E


class EncoderGraph(nn.Module):
    """Unit2Mel's embeds with the app-side alignment and speaker mix.

    Inputs: hubert (1, T_u, U); mel2ph (1, T) int64, 1-based frame -> unit
    (0 selects a zero row, i.e. silence); f0, volume (1, T); spk_mix
    (T, n_spk), per-frame mix weights over the 0-based speaker rows.
    Output: (1, H, T), named ``mel_pred`` for the apps."""

    def __init__(self, model: Unit2Mel):
        super().__init__()
        self.model = model

    def forward(self, hubert, mel2ph, f0, volume, spk_mix):
        padded = F.pad(hubert, (0, 0, 1, 0))
        index = mel2ph.unsqueeze(-1).repeat(1, 1, hubert.shape[-1])
        aligned = torch.gather(padded, 1, index)
        # an empty mix adds no speaker: the per-frame mix is added below;
        # the contract has no formant-shift input
        x = self.model.hidden(aligned, f0.unsqueeze(-1), volume.unsqueeze(-1),
                              spk_mix_dict={})
        spk_embed = self.model.spk_embed
        if spk_embed is not None:
            x = x + torch.matmul(spk_mix, spk_embed.weight).unsqueeze(0)
        return x.transpose(1, 2)


class DenoiseGraph(nn.Module):
    """The model's WaveNet: noise (1, 1, M, T), time (1,) int64, condition
    (1, H, T) -> the predicted noise (1, 1, M, T)."""

    def __init__(self, model: Unit2Mel):
        super().__init__()
        self.denoise_fn = model.denoise_fn

    def forward(self, noise, time, condition):
        eps = self.denoise_fn(noise.squeeze(1).transpose(1, 2), time,
                              condition.transpose(1, 2))
        return eps.transpose(1, 2).unsqueeze(1)


class PredGraph(nn.Module):
    """The PLMS transfer step of ``models/diffusion.sample_plms``: noise
    (1, 1, M, T) the current x, noise_pred its eps', time and time_prev
    (1,) int64 -> the next x."""

    def __init__(self, model: Unit2Mel):
        super().__init__()
        device = next(model.parameters()).device
        self.register_buffer("alphas_cumprod", torch.tensor(
            model.decoder.schedule()["alphas_cumprod"], dtype=torch.float32,
            device=device), persistent=False)

    def forward(self, noise, noise_pred, time, time_prev):
        a_t = self.alphas_cumprod.index_select(0, time).reshape(1, 1, 1, 1)
        a_prev = self.alphas_cumprod.index_select(0, time_prev).reshape(1, 1, 1, 1)
        c_x, c_eps = plms_coefficients(a_t, a_prev, torch.sqrt)
        return noise + (a_prev - a_t) * (c_x * noise - c_eps * noise_pred)


class AfterGraph(nn.Module):
    """``denorm_spec`` of the sampled (1, 1, M, T) -> the mel (1, M, T), in
    log10 for an 'nsf-hifigan-log10' vocoder (``models/vocoder.py``)."""

    def __init__(self, model: Unit2Mel, scale: float = 1.0):
        super().__init__()
        self.decoder, self.scale = model.decoder, float(scale)

    def forward(self, x):
        m = self.decoder.denorm_spec(x.squeeze(1))
        return m * self.scale if self.scale != 1.0 else m


def build_graphs(model: Unit2Mel, vocoder_type: str | None) -> dict:
    """The four graph modules over ``model`` (in eval mode)."""
    scale = LOG10_E if vocoder_type == "nsf-hifigan-log10" else 1.0
    graphs = {"encoder": EncoderGraph(model), "denoise": DenoiseGraph(model),
              "pred": PredGraph(model), "after": AfterGraph(model, scale)}
    for g in graphs.values():
        g.eval()
    return graphs
