"""One served request end to end, as the batched serving path defines it
(the port's ``SvcPipeline.infer`` with ``enable_batching(batch_encoder=
True)`` and ``device_f0=True``):

- the request has T = L // block + 1 frames and rides the smallest bucket
  b >= T; its units are its own (solo) encoding, zero past T; its f0 is the
  YIN of its audio zero-padded to b blocks, 220 Hz past T; its volume is
  zero past T;
- its draws come from a generator on the device seeded with the request's
  seed, in this order: the DDSP noise U(-1, 1) (1, b block), the initial
  mel noise N(0, 1) (1, b, M), the sine source's initial phases U(0, 1)
  (1, 1, 9) with the first set to 0, its noise N(0, 1) (1, b hop, 9);
- the cascade runs at b frames; the mel and the f0 past T are zeroed
  before the vocoder; the audio is cut to T hop samples and multiplied by
  the volume gate (-60 dB, dilated over 9 frames) upsampled to samples.

The volume and its gate are computed on the host in float64 as upstream's
``Volume_Extractor`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cascade, encoder, f0 as f0_mod, vocoder
from .layers import upsample

MASK_DB = -60.0


def volume(audio: np.ndarray, hop: int) -> np.ndarray:
    n_frames = len(audio) // hop + 1
    a2 = np.pad(audio.astype(np.float64) ** 2, (hop // 2, (hop + 1) // 2),
                mode="reflect")
    return np.sqrt(a2[: n_frames * hop].reshape(n_frames, hop).mean(axis=1)
                   ).astype(np.float32)


def gate(vol: np.ndarray, threshold_db: float = MASK_DB, win: int = 9) -> np.ndarray:
    mask = (vol > 10 ** (threshold_db / 20.0)).astype(np.float32)
    mp = np.pad(mask, (win // 2, win // 2), constant_values=(mask[0], mask[-1]))
    return np.lib.stride_tricks.sliding_window_view(mp, win).max(axis=-1)


def bucket_for(t: int, buckets) -> int:
    for b in sorted(buckets):
        if t <= b:
            return b
    raise ValueError(f"{t} frames exceed the largest bucket {max(buckets)}")


def draws(seed: int, frames: int, cfg: dict, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    block, voc = cfg["data"]["block_size"], cfg["vocoder"]
    out = {"ddsp": torch.rand((1, frames * block), generator=gen, device=device) * 2 - 1,
           "diffusion": torch.randn((1, frames, voc["num_mels"]), generator=gen,
                                    device=device)}
    rand_ini = torch.rand((1, 1, 9), generator=gen, device=device)
    rand_ini[..., 0] = 0.0
    out["rand_ini"] = rand_ini
    out["sine"] = torch.randn((1, frames * voc["hop_size"], 9), generator=gen,
                              device=device)
    return out


@torch.no_grad()
def front_end(weights: dict, cfg: dict, serve: dict, audio: np.ndarray, device):
    """The request's units (1, b, C) and f0 (1, b, 1) as the synthesis
    batcher receives them: padded to the bucket (units 0, f0 220 Hz)."""
    data = cfg["data"]
    sr, block = data["sampling_rate"], data["block_size"]
    audio = np.asarray(audio, np.float32)
    t = len(audio) // block + 1
    b = bucket_for(t, serve["buckets"])
    live = torch.arange(b, device=device) < t
    x = torch.from_numpy(audio).to(device)
    units = encoder.units(weights["encoder"], cfg["encoder"], x, sr, block)
    units = torch.where(live[None, :, None],
                        torch.nn.functional.pad(units, (0, 0, 0, b - t)), 0.0)
    padded = torch.nn.functional.pad(x, (0, b * block - len(audio)))[None]
    f0 = f0_mod.track(padded, sr, block, serve["f0_min"], serve["f0_max"])[:, :b]
    return units, torch.where(live[None], f0, 220.0)[..., None]


@torch.no_grad()
def synthesize_rows(weights: dict, cfg: dict, units: torch.Tensor, f0: torch.Tensor,
                    vol: torch.Tensor, seeds, frames, device) -> torch.Tensor:
    """A batch as the synthesis batcher runs it: rows of units (n, b, C),
    f0 and volume (n, b, 1) padded to the bucket, each row's draws from its
    seed, each row's real frame count -> audio (n, b hop), unmasked."""
    voc = cfg["vocoder"]
    b = units.shape[1]
    rows = [draws(s, b, cfg, device) for s in seeds]
    noise = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    live = (torch.arange(b, device=device)[None]
            < torch.as_tensor(frames, device=device)[:, None])
    mel = cascade.mel_cascade(weights["model"], cfg, units, f0, vol, noise,
                              cascade.extract_fn(voc))
    return vocoder.nsf_hifigan(weights["vocoder"], voc, mel * live[..., None],
                               f0[..., 0] * live, noise["rand_ini"], noise["sine"])


def synthesize(weights: dict, cfg: dict, serve: dict, audio: np.ndarray, seed: int,
               units: torch.Tensor, f0: torch.Tensor, device) -> np.ndarray:
    """The served output (T hop,) from the request's padded units and f0."""
    block, voc = cfg["data"]["block_size"], cfg["vocoder"]
    audio = np.asarray(audio, np.float32)
    t = len(audio) // block + 1
    vol = volume(audio, block)
    vol_b = torch.zeros((1, units.shape[1], 1), device=device)
    vol_b[0, :t, 0] = torch.from_numpy(vol).to(device)
    out = synthesize_rows(weights, cfg, units, f0, vol_b, [seed], [t], device)
    out = out[0, : t * voc["hop_size"]].cpu().numpy()
    mask = lerp_mask(gate(vol), block)
    return (out * mask[: out.shape[-1]]).astype(np.float32)


def lerp_mask(mask: np.ndarray, block: int) -> np.ndarray:
    """The frame gate upsampled to samples, each frame lerped towards the
    next (the last held), in float32."""
    m = torch.from_numpy(mask.astype(np.float32))[None, :, None]
    return upsample(m, block)[0, :, 0].numpy()
