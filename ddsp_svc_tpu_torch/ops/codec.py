"""Wire codecs of the serving engines (the port's own copy of
ddsp_svc_tpu/ops/codec.py): G.711-style mu-law companding (mu = 255), one
definition for the synthesis batcher's output encode on the device and
decode on the host, and the encoder batcher's input encode on the host and
decode on the device. Each function takes a numpy array (host) or a torch
tensor (any device) and returns the same kind; both compute in float32.
"""
from __future__ import annotations

import numpy as np
import torch

_LOG256 = float(np.log(256.0))


def mulaw_encode_u8(x):
    """float audio in [-1, 1] -> uint8 companded code (128 = zero)."""
    if isinstance(x, torch.Tensor):
        x = x.float()
        y = torch.sign(x) * (torch.log1p(255.0 * torch.clamp(x.abs(), max=1.0))
                             / _LOG256)
        return torch.clamp(torch.round((y + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)
    y = np.sign(x) * (np.log1p(255.0 * np.minimum(np.abs(x), 1.0)) / _LOG256)
    return np.clip(np.rint((y + 1.0) * 127.5), 0.0, 255.0).astype(np.uint8)


def mulaw_decode(code):
    """uint8 companded code -> float32 audio."""
    if isinstance(code, torch.Tensor):
        y = code.float() / 127.5 - 1.0
        return torch.sign(y) * ((torch.pow(256.0, y.abs()) - 1.0) / 255.0)
    y = code.astype(np.float32) / 127.5 - 1.0
    return np.sign(y) * ((256.0 ** np.abs(y) - 1.0) / 255.0)


def mulaw_step(ref):
    """One companding step at each sample's level: the tolerance a mu-law
    round trip is allowed."""
    if isinstance(ref, torch.Tensor):
        return _LOG256 / 255.0 * (1.0 / 255.0 + ref.abs())
    return _LOG256 / 255.0 * (1.0 / 255.0 + np.abs(ref))


def i16_encode(x):
    """float audio -> int16 (x 32767, rounded, clipped)."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.round(x.float() * 32767.0), -32768.0,
                           32767.0).to(torch.int16)
    return np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)


def i16_decode(code):
    """int16 -> float32 audio (/ 32767)."""
    if isinstance(code, torch.Tensor):
        return code.float() * (1.0 / 32767.0)
    return code.astype(np.float32) / 32767.0
