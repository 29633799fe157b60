"""The work counts (``svc_bench/work.py``) against hand counts and against
torch's own FLOP counter run over the plain reference at small widths: the
counts the rooflines and mfu.infer divide by are the work the model does."""
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from svc_bench import weights as W, work
from svc_bench.reference import cascade, encoder, f0, request, vocoder
from svc_bench.tests.tiny import tiny_cell


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_hand_counts():
    assert work.conv_flops(10, 4, 3, 5) == 2 * 10 * 4 * 3 * 5
    assert work.conv_flops(10, 8, 8, 3, groups=8) == 2 * 10 * 1 * 8 * 3
    # dim 4, cond 2, inner 8, k 3: cond proj 8, GLU conv 64, out conv 32 a
    # frame (x2 for a multiply-add), depthwise 8 x 3
    assert work.conformer_layer_flops(4, 2, 3, k=3) == 2 * 3 * (8 + 64 + 32) + 2 * 3 * 8 * 3
    voc = {"upsample_rates": [2], "upsample_initial_channel": 8,
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]]}
    # one stage of 4 channels over 2 t samples, two k = 3 convs
    assert work.resblock_flops(voc, 5) == 2 * 10 * 4 * 4 * 6
    assert work.resblock_bytes(voc, 5) == 2 * 4 * 10 * 4
    assert work.fft_flops(1024) == 2.5 * 1024 * 10
    assert work.least_seconds(1e12, 0.0, 1e12) == 1.0
    assert work.least_seconds(0.0, 3.35e12, 1e12) == 1.0


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell()
    cfg = cell["config"]
    return cfg, cell["mix"]["serve"], W.make(cfg, 7, torch.device("cpu"))


def test_encoder_count(tiny):
    cfg, _, w = tiny
    n = 20000
    audio = torch.randn(n)
    got = counted(lambda: encoder.units(w["encoder"], cfg["encoder"], audio, 44100, 512))
    assert got == pytest.approx(work.encoder_flops(cfg["encoder"], n, 44100), rel=1e-9)


def test_denoiser_and_ddsp_count(tiny):
    cfg, _, w = tiny
    t = 40
    units = torch.randn(1, t, cfg["data"]["encoder_out_channels"])
    f0_ = torch.full((1, t, 1), 200.0)
    vol = torch.rand(1, t, 1)
    noise = request.draws(3, t, cfg, torch.device("cpu"))
    win = cfg["model"]["win_length"]
    ddsp = counted(lambda: cascade.combsub_superfast(w["model"], cfg, units, f0_, vol,
                                                     noise["ddsp"]))
    assert ddsp + 3 * (t + 1) * work.fft_flops(win) == pytest.approx(
        work.ddsp_flops(cfg, t), rel=1e-9)
    voc = cfg["vocoder"]
    mel = counted(lambda: cascade.extract_fn(voc)(torch.randn(1, t * 512)))
    assert mel + t * work.fft_flops(voc["n_fft"]) == pytest.approx(
        work.mel_flops(voc, t), rel=1e-9)
    cond = torch.randn(1, t, voc["num_mels"])
    calls = work.sampler_calls(cfg)
    one = counted(lambda: cascade.naive_v2_diff(w["model"], "denoise_fn", cond,
                                                torch.zeros(1), cond,
                                                cfg["model"]["n_layers"]))
    assert calls * one == pytest.approx(work.denoiser_flops(cfg, t), rel=1e-9)


def test_vocoder_and_yin_count(tiny):
    cfg, serve, w = tiny
    voc, t = cfg["vocoder"], 20
    mel = torch.randn(1, t, voc["num_mels"])
    f0_ = torch.full((1, t), 220.0)
    noise = request.draws(5, t, cfg, torch.device("cpu"))
    got = counted(lambda: vocoder.nsf_hifigan(w["vocoder"], voc, mel, f0_,
                                              noise["rand_ini"], noise["sine"]))
    assert got == pytest.approx(work.vocoder_flops(voc, t), rel=1e-9)
    n = t * 512
    yin = counted(lambda: f0.track(torch.randn(1, n), 44100, 512, serve["f0_min"],
                                   serve["f0_max"]))
    tau_max = int(44100 / 2 / serve["f0_min"]) + 1
    n_fft = 1 << math.ceil(math.log2(4 * tau_max))
    ffts = work.frames(n, 512) * 3 * work.fft_flops(n_fft)
    assert yin + ffts == pytest.approx(
        work.yin_flops(n, 44100, 512, serve["f0_min"], serve["f0_max"]), rel=1e-9)


def test_whole_request_count_matches_the_published_widths():
    """~89 GFLOP a second of audio for diffusion-fast, ~106 for reflow."""
    from svc_bench import registry

    serve = registry.mix("open.r60")["serve"]
    for name, lo, hi in (("diffusion-fast", 85e9, 95e9), ("reflow", 100e9, 112e9)):
        cfg = registry.cell(registry.benchmark(),
                            {"diffusion-fast": "dfast.serve.r60",
                             "reflow": "reflow.serve.r60"}[name])["config"]
        per_s = sum(work.request_flops(cfg, serve, 441000).values()) / 10.0
        assert lo < per_s < hi, (name, per_s)
    assert np.isclose(work.PEAK_F32_TC_FLOP_PER_S, 164.9e12)
