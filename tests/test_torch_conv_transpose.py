"""The transposed convolutions' CUDA route (models/nn.py
``polyphase_conv_transpose``: one forward convolution over the stride's
phases, which cuDNN computes deterministically; ROADMAP C(kk)) on the CPU
against ``F.conv_transpose1d`` / ``conv_transpose2d``: the NSF-HiFiGAN's
upsamplers (configs/nsf-hifigan.yaml: k 16 s 8, k 4 s 2), the RMVPE
decoder's (k 3 s 2, output padding 1) and odd strides, paddings and
output paddings; float64 to 1e-12 and float32 to 1e-6 of the peak (only
the order of the sums differs), and the ``ConvTranspose1d`` /
``ConvTranspose2d`` modules' weights through it against their own
forward."""
import pytest
import torch
import torch.nn.functional as F

from ddsp_svc_tpu_torch.models import nn as pnn
from ddsp_svc_tpu_torch.models.nn import polyphase_conv_transpose

CASES_1D = [  # (in, out, k, stride, padding, output padding, length)
    (64, 32, 16, 8, 4, 0, 23),   # the vocoder's first upsampler, narrowed
    (16, 8, 4, 2, 1, 0, 40),     # its stride-2 stages
    (5, 7, 3, 2, 1, 1, 9),
    (4, 4, 5, 3, 0, 2, 7),
    (3, 2, 2, 4, 0, 3, 5),       # output padding past the last tap
    (3, 3, 1, 1, 0, 0, 6),
]
CASES_2D = [  # (in, out, k, stride, padding, output padding, h, w)
    (8, 4, (3, 3), (2, 2), (1, 1), (1, 1), 6, 16),  # RMVPE's decoder
    (3, 5, (4, 3), (2, 3), (1, 0), (0, 2), 5, 4),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("case", CASES_1D)
def test_polyphase_1d(case, dtype, tol):
    cin, cout, k, s, p, op, t = case
    g = torch.Generator().manual_seed(k * 31 + s)
    x = torch.randn(2, cin, t, generator=g, dtype=dtype)
    w = torch.randn(cin, cout, k, generator=g, dtype=dtype)
    b = torch.randn(cout, generator=g, dtype=dtype)
    want = F.conv_transpose1d(x, w, b, s, p, op)
    got = polyphase_conv_transpose(x, w, b, s, p, op)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize("case", CASES_2D)
def test_polyphase_2d(case, dtype, tol):
    cin, cout, k, s, p, op, h, w_ = case
    g = torch.Generator().manual_seed(sum(k))
    x = torch.randn(1, cin, h, w_, generator=g, dtype=dtype)
    w = torch.randn(cin, cout, *k, generator=g, dtype=dtype)
    want = F.conv_transpose2d(x, w, None, s, p, op)
    got = polyphase_conv_transpose(x, w, None, s, p, op)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= tol * want.abs().max()


def test_modules_through_the_polyphase_route():
    g = torch.Generator().manual_seed(0)
    m1 = pnn.ConvTranspose1d(16, 8, 16, stride=8, padding=4)
    m2 = pnn.ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1, bias=False)
    for m in (m1, m2):
        with torch.no_grad():
            for prm in m.parameters():
                prm.copy_(torch.randn(prm.shape, generator=g))
    x1 = torch.randn(2, 30, 16, generator=g)  # (B, T, C), as the vocoder feeds it
    with torch.no_grad():
        want = m1(x1)
        got = polyphase_conv_transpose(x1.transpose(1, 2), m1.folded_weight(), m1.bias,
                                       8, 4).transpose(1, 2)
    assert got.shape == want.shape == (2, 30 * 8, 8)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    x2 = torch.randn(1, 8, 6, 16, generator=g)
    with torch.no_grad():
        want = m2(x2)
        got = polyphase_conv_transpose(x2, m2.weight, None, 2, 1, 1)
    assert got.shape == want.shape == (1, 4, 12, 32)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
