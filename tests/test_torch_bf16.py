"""The bf16 vocoder (``--voc_bf16``) against the JAX package on the CPU.

A bf16 chain rounds every conv input (and, in the stock chain, every conv
output and sum) to 8 significant bits. Two correct implementations that
sum in another f32 order flip some of those roundings, and a flipped
activation moves by a bf16 ulp and carries on through the next convs. So
the tolerances are:

- K2's bf16 class: ``resblock_group_bf16_plain`` against the Pallas kernel
  run on bf16 x in interpret mode, by ``cuda_resblock.bf16_agreement``
  (per element 1 bf16 ulp of the reference plus 2^-7 x max|out|, at most
  2 % of the elements beyond 1 ulp and 10 % differing at all: the flipped
  intermediate roundings), the tolerance the card holds the kernel to; the
  share of elements that differ at all is held below 5 % here. The same
  tolerance passes two other f32 sum orders against exact sums and fails
  three planted extra bf16 roundings;
- ``Conv1d`` called with ``dtype=bf16`` and the stock ResBlock1 chain in
  bf16 against JAX: within 1 ulp (the same rounding points, one conv each);
- whole generators: the port's bf16 output must be closer to JAX's bf16
  output than JAX's bf16 output is to JAX's f32 output (a weight set with
  a larger gain has a larger bf16 error on both sides; measured with four
  seeds: 33-50 dB against 31-47 dB), and at least 30 dB (the JAX
  package's own bf16 gate is 25 dB, tpu_checks.py:100-133);
- ``cli.infer --voc_bf16 --device cpu`` on a JAX checkpoint against the
  JAX CLI with ``--voc_bf16``, whose CPU path is the stock bf16 chain
  (other rounding points than K2-bf16): no further apart than two
  independent bf16 roundings of one signal (3 dB below JAX's bf16-vs-f32
  SNR), and >= 25 dB.

Every whole-chain test also holds the port's bf16 output below
``BF16_FROM_F32_MAX_DB`` from the port's own f32 output, so that a bf16
setting the code dropped (an f32 run reads its own f32 output, an infinite
SNR) fails.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.models.vocoder as jvoc
import ddsp_svc_tpu_torch.cli.infer as pcli
from ddsp_svc_tpu.models.nn import Conv1d as JConv1d
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu.ops.pallas_resblock import fused_resblock_group
from ddsp_svc_tpu_torch.io.jax_params import generator_state_dict, load_state
from ddsp_svc_tpu_torch.models.nn import Conv1d
from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
from ddsp_svc_tpu_torch.models.vocoder import Enhancer, Vocoder
from ddsp_svc_tpu_torch.ops.cuda_resblock import (bf16_agreement,
                                                  pack_conv_weight_bf16,
                                                  resblock_group,
                                                  resblock_group_bf16,
                                                  resblock_group_bf16_plain,
                                                  unpack_conv_weight_bf16)
from scipy.io import wavfile
from test_torch_cli import N_UNIT, _write_wav
from test_torch_cli_families import (_both, _checkpoint, _vocoder_payload,
                                     noisy_sides)  # noqa: F401
from torch_helpers import conv_w, f0_contour, randomize_tree, snr_db, tt

KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
SR = 44100
BF16 = torch.bfloat16
# a bf16 chain's output sits 30-50 dB from the f32 chain's (measured here);
# one above this ran in f32
BF16_FROM_F32_MAX_DB = 60.0


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    mag = np.abs(v.astype(np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


def within_bf16_ulp(got, want) -> tuple[bool, float]:
    """(|got - want| <= 1 bf16 ulp of want + 1e-6 max|want| everywhere, the
    share of elements that differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    tol = bf16_ulp(want) + 1e-6 * np.abs(want).max()
    return bool((diff <= tol).all()), float((diff > 0).mean())


def _rb_weights(rng, c):
    jax_w, torch_w = [], []
    for k, dils in zip(KS, DS):
        jw, tw = [], []
        bound = 1.0 / np.sqrt(c * k)
        for _ in range(2 * len(dils)):
            w = rng.uniform(-bound, bound, (k, c, c)).astype(np.float32)
            b = rng.uniform(-bound, bound, (c,)).astype(np.float32)
            jw.append((jnp.asarray(w), jnp.asarray(b)))
            tw.append((conv_w(w), tt(b)))
        jax_w.append(jw)
        torch_w.append(tw)
    return jax_w, torch_w


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_resblock_group_bf16_plain_matches_jax_kernel(c):
    """B = 2 at a length no multiple of the Pallas tile. Measured on the
    CPU: 0.04-3 % of the elements differ, 0.006-0.4 % by more than 1 ulp,
    by at most 5e-5 x max|out| beyond it."""
    rng = np.random.default_rng(100 + c)
    length = 8 * 70
    x = rng.standard_normal((2, length, c)).astype(np.float32)
    jax_w, torch_w = _rb_weights(rng, c)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(lambda x_, w_: fused_resblock_group(
        x_, w_, KS, DS, interpret=True))(xb, jax_w)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
    got = resblock_group_bf16_plain(xt, torch_w, KS, DS)
    assert got.dtype == BF16 and got.shape == xt.shape
    agree = bf16_agreement(got, torch.from_numpy(
        np.array(want.astype(jnp.float32))))
    assert agree["ok"] and agree["differ"] < 0.05, agree
    # the wrapper dispatches a bf16 CPU x to the plain version, launching
    # nothing
    n0 = resblock_group_bf16.launches
    assert torch.equal(resblock_group(xt, torch_w, KS, DS), got)
    assert resblock_group_bf16.launches == n0


def _bf16_chain(x, rb_weights, sums="exact", fault=None):
    """``resblock_group_bf16_plain``'s function with its convs' sums taken
    another way (``sums``: "exact", in float64; "taps", one tap at a time in
    f32) or with a planted fault: "z" (each chain's residual sum rounded to
    bf16), "total" (the running sum over the chains rounded to bf16), "t"
    (every conv output rounded to bf16, as intermediates stored in bf16
    would be)."""
    def r(t):
        return t.to(BF16).float()

    xc = x.float().transpose(1, 2)
    total = None
    for k, dils, rbw in zip(KS, DS, rb_weights):
        z, ci = xc, 0
        for d in dils:
            t = z
            for dd in (d, 1):
                w, b = rbw[ci]
                ci += 1
                t = r(torch.nn.functional.leaky_relu(t, 0.1))
                pad = (k - 1) * dd // 2
                # one tap at a time: in float64 for the exact sums (as
                # products of bf16 values, each exact in float64), in f32
                # for the "taps" order
                dt = torch.float64 if sums == "exact" else torch.float32
                tp = torch.nn.functional.pad(t, (pad, pad)).to(dt)
                n = t.shape[-1]
                t = (b.to(dt)[None, :, None] + sum(
                    torch.einsum("oc,bcl->bol", r(w)[:, :, tau].to(dt),
                                 tp[:, :, tau * dd:tau * dd + n])
                    for tau in range(k))).float()
                if fault == "t":
                    t = r(t)
            z = t + z
            if fault == "z":
                z = r(z)
        total = z if total is None else total + z
        if fault == "total":
            total = r(total)
    return (total / len(rb_weights)).transpose(1, 2).to(BF16)


@functools.lru_cache(maxsize=None)
def _exact_case(c):
    """(x, weights, the exact-sum output) of width ``c``, computed once for
    the five variants."""
    rng = np.random.default_rng(300 + c)
    x = torch.from_numpy(rng.standard_normal((2, 8 * 70, c)).astype(
        np.float32)).to(BF16)
    _, torch_w = _rb_weights(rng, c)
    return x, torch_w, _bf16_chain(x, torch_w)


@pytest.mark.parametrize("variant", ["plain", "taps", "fault_z",
                                     "fault_total", "fault_t"])
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_bf16_agreement_sum_orders_and_faults(c, variant):
    """The tolerance's two sides, against the exact-sum reference: the
    plain version (torch's conv sum order) and a tap-at-a-time f32 sum
    order pass it (measured: 0.14-2.5 % of the elements differ); an extra
    bf16 rounding of the chains' residual sums, of the running sum over
    chains or of every conv output fails it (17-34 % differ)."""
    x, torch_w, exact = _exact_case(c)
    if variant == "plain":
        got = resblock_group_bf16_plain(x, torch_w, KS, DS)
    elif variant == "taps":
        got = _bf16_chain(x, torch_w, sums="taps")
    else:
        got = _bf16_chain(x, torch_w, fault=variant.split("_")[1])
    agree = bf16_agreement(got, exact)
    assert agree["ok"] == (not variant.startswith("fault")), agree


def test_bf16_weight_packing_round_trip():
    """The bf16 kernel's B tiles hold every weight, rounded to bf16, where
    ``unpack_conv_weight_bf16`` reads it back (k16 core matrices)."""
    w = torch.randn((32, 48, 7), generator=torch.Generator().manual_seed(5))
    packed = pack_conv_weight_bf16(w)
    assert packed.shape == (7, 3, 4, 2, 8, 8) and packed.dtype == BF16
    assert torch.equal(unpack_conv_weight_bf16(packed), w.to(BF16))


def test_resblock_group_refuses_other_dtypes():
    x = torch.zeros((1, 8, 16), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        resblock_group(x, [], KS, DS)
    with pytest.raises(ValueError, match="bfloat16 x"):
        resblock_group_bf16(x.float(), [], KS, DS)


@pytest.mark.parametrize("k,stride,pad,dil", [(7, 1, 3, 1), (3, 1, 5, 5),
                                              (16, 8, 4, 1)])
def test_conv1d_bf16_matches_jax(k, stride, pad, dil):
    """x and the weight cast to bf16, the conv, then the bf16 bias add:
    within 1 bf16 ulp of JAX (the conv's f32 sum order may flip a
    rounding)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 40, 24)).astype(np.float32)
    jc = JConv1d(32, k, stride=stride, padding=pad, dilation=dil,
                 dtype=jnp.bfloat16)
    params = randomize_tree(jc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], k)
    want = jc.apply({"params": params}, jnp.asarray(x))
    port = Conv1d(24, 32, k, stride=stride, padding=pad, dilation=dil)
    load_state(port, {"weight": conv_w(params["kernel"]), "bias": tt(params["bias"])})
    with torch.no_grad():
        got = port(tt(x), BF16)
    assert got.dtype == BF16
    ok, share = within_bf16_ulp(got.float().numpy(),
                                np.asarray(want.astype(jnp.float32)))
    assert ok, f"{share:.4%} of elements differ, some by more than 1 ulp"


def _generator_case(t=4, c0=512, seed=21):
    cfg = dict(sampling_rate=SR, num_mels=128, upsample_initial_channel=c0)
    rng = np.random.default_rng(seed)
    mel = rng.normal(-4.0, 1.5, (1, t, 128)).astype(np.float32)
    f0 = f0_contour(t)[..., 0]
    noise = dict(rand_ini=np.concatenate([[0.0], rng.random(8)]).astype(
        np.float32)[None, None],
        noise=rng.standard_normal((1, t * 512, 9)).astype(np.float32))
    jg = JGenerator(**cfg, weight_norm=False)
    params = randomize_tree(jax.eval_shape(lambda: jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(mel), jnp.asarray(f0))["params"]), seed=seed)
    return cfg, mel, f0, noise, params


@pytest.fixture(scope="module")
def generator_case():
    return _generator_case()


_JAX_GENERATORS = {}  # dtype -> jitted apply (one compile per dtype)


def _jax_generator(cfg, params, mel, f0, noise, dtype, scale=1.0):
    fn = _JAX_GENERATORS.get(dtype)
    if fn is None:
        jg = JGenerator(**cfg, weight_norm=False, dtype=dtype,
                        use_pallas_resblock=dtype is not None,
                        pallas_interpret=True)
        fn = _JAX_GENERATORS[dtype] = jax.jit(lambda p, m, f, r, n: jg.apply(
            {"params": p}, m, f, sine_kwargs=dict(rand_ini=r, noise=n)))
    out = fn(params, *map(jnp.asarray, (mel * np.float32(scale), f0,
                                        noise["rand_ini"], noise["noise"])))
    return np.asarray(out.astype(jnp.float32))


def test_generator_bf16_matches_jax(generator_case):
    """At the default widths (C = 256 ... 16; four frames): K2-bf16 on the
    four stages with C <= 128 and the stock bf16 chain at C = 256, as the
    JAX dispatch. Measured: 39.9 dB against JAX bf16, where JAX's bf16 is
    37.3 dB from its f32 and the port's f32 117 dB from JAX's."""
    cfg, mel, f0, noise, params = generator_case
    want = _jax_generator(cfg, params, mel, f0, noise, jnp.bfloat16)
    want_f32 = _jax_generator(cfg, params, mel, f0, noise, None)
    port = Generator(**cfg)
    load_state(port, generator_state_dict(params))
    kwargs = {k: tt(v) for k, v in noise.items()}
    with torch.no_grad():
        got = port(tt(mel), tt(f0), kwargs, dtype=BF16)
        f32 = port(tt(mel), tt(f0), kwargs)
    assert got.dtype == BF16 and got.shape == (1, 4 * 512)
    got = got.float().numpy()
    assert snr_db(want_f32, f32.numpy()) >= 100.0
    assert snr_db(want, got) >= max(30.0, snr_db(want_f32, want))
    assert 25.0 <= snr_db(f32.numpy(), got) < BF16_FROM_F32_MAX_DB  # 25: tpu_checks.py's gate


def test_resblock1_stock_chain_bf16_matches_jax():
    """The stock ResBlock1 chain a bf16 generator runs at C = 256 (leaky
    with the slope rounded to bf16, the conv, the bf16 bias add, the bf16
    residual), against the JAX ResBlock1(dtype=bf16): within 1 ulp, and
    < 1 % of the elements differ (measured 0.01 %)."""
    from ddsp_svc_tpu.models.nsf_hifigan import ResBlock1 as JResBlock1
    from ddsp_svc_tpu_torch.models.nsf_hifigan import ResBlock1

    rng = np.random.default_rng(41)
    x = jnp.asarray(rng.standard_normal((1, 32, 256)), jnp.bfloat16)
    jb = JResBlock1(256, 3, (1, 3, 5), weight_norm=False, dtype=jnp.bfloat16)
    params = randomize_tree(jb.init(jax.random.PRNGKey(0), x)["params"], 42)
    want = jax.jit(lambda v: jb.apply({"params": params}, v))(x)
    port = ResBlock1(256, 3, (1, 3, 5))
    sd = {}
    for name, leaf in params.items():
        kind, i = name.split("_")
        sd[f"{kind}.{i}.weight"] = conv_w(leaf["kernel"])
        sd[f"{kind}.{i}.bias"] = tt(leaf["bias"])
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16),
                   BF16)
    ok, share = within_bf16_ulp(got.float().numpy(),
                                np.asarray(want.astype(jnp.float32)))
    assert ok and share < 0.01, share


def test_vocoder_bf16_log10(generator_case):
    """The Vocoder wrapper in bf16 (the log10 type, so the mel is scaled
    back before the generator): f32 audio out, by the whole-generator rule
    against the JAX bf16 generator on the same mel (the f32 reference is
    the port's, which test_generator_bf16_matches_jax holds >= 100 dB from
    JAX's)."""
    cfg, mel, f0, noise, params = generator_case
    want = _jax_generator(cfg, params, mel, f0, noise, jnp.bfloat16,
                          1 / 0.434294)
    voc = Vocoder("nsf-hifigan-log10")
    load_state(voc.model, generator_state_dict(params))
    kwargs = {k: tt(v) for k, v in noise.items()}
    with torch.no_grad():
        got = voc.infer(tt(mel), tt(f0)[..., None], kwargs, dtype=BF16)
        f32 = voc.infer(tt(mel), tt(f0)[..., None], kwargs)
    assert got.dtype == torch.float32
    assert snr_db(want, got.numpy()) >= max(30.0, snr_db(f32.numpy(), want))
    assert snr_db(f32.numpy(), got.numpy()) < BF16_FROM_F32_MAX_DB


def test_enhancer_bf16_matches_jax(monkeypatch, generator_case):
    """The JAX Enhancer(dtype=bf16) against the port's on the same audio,
    f0, generator params and sine noise (the mel extraction, the f0 grid and
    the generator; the frame count of the generator case, so the JAX
    generator's compile is shared), by the whole-generator rule (the f32
    reference is the port's Enhancer in f32)."""
    cfg, _, _, noise, params = generator_case
    # the JAX wrapper's own generator is replaced below: skip its init
    monkeypatch.setattr(jvoc, "load_vocoder_params",
                        lambda ckpt: ({}, dict(jvoc.DEFAULT_NSF_CONFIG)))
    jenh = jvoc.Enhancer("nsf-hifigan", dtype=jnp.bfloat16)

    def infer(mel, f0, key=None):
        return jnp.asarray(_jax_generator(cfg, params, np.asarray(mel),
                                          np.asarray(f0), noise, jnp.bfloat16))

    monkeypatch.setattr(jenh.vocoder, "infer", infer)
    t = 4
    audio = (0.3 * np.sin(2 * np.pi * 330 * np.arange(t * 512) / SR)
             + 0.01 * np.random.default_rng(33).standard_normal(t * 512)
             ).astype(np.float32)[None]
    f0 = f0_contour(t, base=330.0)
    want, _ = jenh.enhance(jnp.asarray(audio), SR, jnp.asarray(f0), 512)
    want = np.asarray(want.astype(jnp.float32))
    vocoder = Vocoder()
    load_state(vocoder.model, generator_state_dict(params))
    port_noise = {"rand_ini": noise["rand_ini"], "sine": noise["noise"]}
    outs = {}
    for dtype in (BF16, torch.float32):
        enh = Enhancer(device="cpu", vocoder=vocoder, dtype=dtype)
        outs[dtype], sr = enh.enhance(tt(audio), SR, tt(f0), 512,
                                      noise=port_noise)
    got = outs[BF16]
    assert sr == SR and got.dtype == torch.float32
    assert got.shape == want.shape
    f32 = outs[torch.float32].numpy()
    assert snr_db(want, got.numpy()) >= max(30.0, snr_db(f32, want))
    assert snr_db(f32, got.numpy()) < BF16_FROM_F32_MAX_DB


def test_cli_voc_bf16_matches_jax(tmp_path, noisy_sides):
    """``cli.infer --voc_bf16`` on a rectified-flow checkpoint with a
    weight-normed NSF-HiFiGAN payload both CLIs read, the draws injected
    (tests/test_torch_cli_families.py). The JAX CLI on the CPU runs its
    stock bf16 chain (its Pallas path is for a TPU), which rounds every
    conv output to bf16 where the port's K2-bf16 keeps f32, so: the port's
    output against the JAX CLI's no further apart than two independent
    bf16 roundings of one signal would be (3 dB below JAX's bf16-vs-f32
    SNR), with the port's CLI without the flag as the f32 reference, and
    >= 25 dB (measured: 34.8 dB, JAX's bf16 33.6 dB from f32)."""
    from ddsp_svc_tpu.models.cascade import ReflowUnit2Wav

    voc = _vocoder_payload(tmp_path / "voc.msgpack")
    module = ReflowUnit2Wav(SR, 512, 2048, N_UNIT, 2, True, 128, 2, 16)
    ckpt = _checkpoint(tmp_path / "reflow", module, {
        "type": "RectifiedFlow", "win_length": 2048, "n_layers": 2,
        "n_chans": 16, "use_pitch_aug": True, "n_spk": 2, "t_start": 0.7},
        82, 3, voc, aug_shift=jnp.zeros((1, 1, 1)),
        mel_extract_fn=JLogMel().extract, gt_spec=jnp.zeros((1, 8, 128)),
        infer=False, key=jax.random.PRNGKey(2))
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, SR, 0.5)
    argv = ["-m", ckpt, "-i", str(in_wav), "-id", "2", "-step", "4"]
    snr = _both(tmp_path, argv + ["--voc_bf16"])
    pcli.main(argv + ["-o", str(tmp_path / "port_f32.wav"), "--device", "cpu"])
    f32 = wavfile.read(tmp_path / "port_f32.wav")[1].astype(np.float64)
    bf16 = wavfile.read(tmp_path / "jax" / "out.wav")[1].astype(np.float64)
    ref = snr_db(f32, bf16)
    port_bf16 = wavfile.read(tmp_path / "port" / "out.wav")[1].astype(np.float64)
    own = snr_db(f32, port_bf16)
    print(f"--voc_bf16 CLI: port vs JAX {snr:.1f} dB; JAX bf16 vs f32 {ref:.1f} "
          f"dB; port bf16 vs f32 {own:.1f} dB")
    assert snr >= max(25.0, ref - 3.0)
    assert own < BF16_FROM_F32_MAX_DB
