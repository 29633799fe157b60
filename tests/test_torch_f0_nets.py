"""The f0 nets against the JAX package on the CPU, on the same parameters
drawn from a seed in the JAX format (``torch_f0_helpers``).

  - Each net's salience against ``jax.jit`` of the JAX net: E2E0 with one
    block a stage and CFNaiveMelPE at hidden 64 with 2 layers on random
    mels, and every net at its full width through the extractors' own
    front ends (RMVPE on a 0.4 s clip, FCPE on 0.4 s, CREPE full on the
    25 frames of a 0.12 s clip). Tolerance 2e-6 absolute on saliences in
    (0, 1) (measured: 6e-8 for E2E0 and CREPE, 3e-7 for the conformer).
  - The decoders (local average, Viterbi, CREPE's weighted argmax with and
    without its fmin / fmax mask, FCPE's local argmax) fed JAX's own
    salience: bit for bit.
  - ``F0Extractor(kind).extract`` against the JAX package's, with
    ``uv_interp`` and ``silence_front`` both ways (and RMVPE's Viterbi), on
    parameters whose output layer carries a clear peak at 220 Hz: the
    decoded f0 within 1e-5 relative (measured: 5e-7).
  - The state-dict mappings both ways, leaf for leaf.
  - The entry points on a weights file of those RMVPE parameters, written
    by the port's own msgpack writer in the JAX package's converted format
    where both packages look for it (``DDSP_SVC_TPU_RMVPE_CKPT``, or
    ``pretrain/rmvpe/model.msgpack`` from the working directory for the
    config-driven ``build_f0_extractor``): ``cli.infer -pe rmvpe`` (its f0
    cache) and ``cli.preprocess`` with ``f0_extractor: rmvpe`` (its f0
    files) against the f0 of the JAX package's extractor as its CLIs build
    it, to the same 1e-5; and a batched ``SvcPipeline`` row with the RMVPE
    front end within 1e-5 x max|out| of the direct path
    (tests/test_torch_batcher.py's bound). The port's checkpoint there is a
    tiny CombSubSuperFast written by the port in the JAX format.

The JAX nets are compiled once a module: the narrow ones by the tests that
hold them, the full ones by the extractors (one JAX extractor a net, its
RMVPE shared by the entry points' reference).
"""
import os
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.cli.common import build_f0_extractor as jax_build_f0
from ddsp_svc_tpu.features import crepe as jcrepe
from ddsp_svc_tpu.features import fcpe as jfcpe
from ddsp_svc_tpu.features import rmvpe as jrmvpe
from ddsp_svc_tpu.features.f0 import F0Extractor as JF0
from ddsp_svc_tpu.features.audio import load_wav as jax_load_wav
from ddsp_svc_tpu.ops.resample import resample as jresample
from ddsp_svc_tpu.utils.params import load_params as jax_load_params
from ddsp_svc_tpu_torch.cli import infer as pcli
from ddsp_svc_tpu_torch.cli import preprocess as pprep
from ddsp_svc_tpu_torch.features import crepe as pcrepe
from ddsp_svc_tpu_torch.features import fcpe as pfcpe
from ddsp_svc_tpu_torch.features import rmvpe as prmvpe
from ddsp_svc_tpu_torch.features.f0 import F0Extractor as PF0
from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io import jax_params as jp
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict, save_config
from torch_f0_helpers import jax_net, net_variables, voice

SR, HOP = 44100, 512
SALIENCE_TOL = 2e-6
F0_RTOL = 1e-5
CLIP_SECONDS = {"rmvpe": 0.4, "fcpe": 0.4, "crepe": 0.12}
NARROW = {"rmvpe": dict(n_blocks=1), "fcpe": dict(hidden=64, n_layers=2)}


@pytest.fixture(scope="module")
def narrow():
    return {kind: net_variables(kind, seed=1, **cfg) for kind, cfg in NARROW.items()}


@pytest.mark.parametrize("kind,t", [("rmvpe", 32), ("fcpe", 45)])
def test_narrow_net_matches_jax(kind, t, narrow):
    cfg, variables = NARROW[kind], narrow[kind]
    net, _ = jax_net(kind, **cfg)
    mel = np.random.default_rng(t).standard_normal((2, t, 128)).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(mel)))
    port_cfg = {k: v for k, v in cfg.items() if k != "hidden"}
    port = (prmvpe.E2E0(**cfg) if kind == "rmvpe" else pfcpe.CFNaiveMelPE(**cfg))
    jp.load_state(port.eval(), jp.f0_net_state_dict(kind, variables, **port_cfg))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, t, 360)
    assert np.abs(got - want).max() <= SALIENCE_TOL


@pytest.fixture(scope="module")
def extractors():
    """Per net: (the JAX extractor, the port's on the CPU, the clip, the
    variables), full width, the output layer's peak at 220 Hz."""
    out = {}
    for kind, seconds in CLIP_SECONDS.items():
        variables = net_variables(kind, seed=3, peak=True)
        out[kind] = (JF0(kind, SR, HOP, 50.0, 1100.0, model_params=variables),
                     PF0(kind, SR, HOP, 50.0, 1100.0, model_params=variables,
                         device="cpu"),
                     voice(seconds, SR, seed=1), variables)
    return out


def _jax_salience(kind, ext, audio):
    """JAX's salience of ``audio`` through its extractor's own front end
    and jitted net (the steps of its ``infer_from_audio`` before the
    decoder)."""
    x = jresample(jnp.asarray(audio, jnp.float32)[None], SR, 16000)
    if kind == "rmvpe":
        mel = ext.rmvpe.mel_from_audio16k(x)
        n = mel.shape[1]
        mel = jnp.pad(mel, ((0, 0), (0, 32 * ((n - 1) // 32 + 1) - n), (0, 0)))
        return np.asarray(ext.rmvpe._apply(ext.rmvpe.variables, mel)[0, :n])
    if kind == "fcpe":
        n = x.shape[1] // jfcpe.HOP + 1
        mel = jnp.swapaxes(ext.fcpe.mel(x), 1, 2)
        mel = jnp.pad(mel, ((0, 0), (0, max(0, n - mel.shape[1])), (0, 0)),
                      mode="edge")[:, :n]
        return np.asarray(ext.fcpe._apply(mel)[0])
    a = np.asarray(x)[0]
    n = len(a) // 80 + 1
    padded = np.pad(a, (512, 512))
    idx = np.minimum(np.arange(n)[:, None] * 80 + np.arange(1024)[None, :],
                     len(padded) - 1)
    frames = padded[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    frames = frames / np.maximum(frames.std(axis=1, keepdims=True), 1e-10)
    return np.asarray(ext.crepe._apply(ext.crepe.variables, jnp.asarray(frames)))


@pytest.mark.parametrize("kind", ["rmvpe", "fcpe", "crepe"])
def test_full_net_and_decoders_match_jax(kind, extractors):
    """The full net's salience through the front end; then the decoders on
    JAX's salience, bit for bit."""
    jext, pext, audio, _ = extractors[kind]
    want = _jax_salience(kind, jext, audio)
    got = pext.net.salience(audio, SR).numpy()
    assert got.shape == want.shape and want.shape[0] > 20
    assert np.abs(got - want).max() <= SALIENCE_TOL
    if kind == "rmvpe":
        for thred in (0.03, 0.9):
            np.testing.assert_array_equal(
                prmvpe.to_local_average_f0(want, thred),
                jrmvpe.to_local_average_f0(want, thred))
        np.testing.assert_array_equal(prmvpe.to_viterbi_f0(want),
                                      jrmvpe.to_viterbi_f0(want))
        prob = want.T.astype(np.float64)
        trans = jrmvpe._viterbi_transition()
        np.testing.assert_array_equal(prmvpe.viterbi_path(prob, trans),
                                      jrmvpe.viterbi_path(prob, trans))
    elif kind == "crepe":
        for lim in ((None, None), (50.0, 1100.0), (300.0, None)):
            for g, w in zip(pcrepe.weighted_argmax_f0(want, *lim),
                            jcrepe.weighted_argmax_f0(want, *lim)):
                np.testing.assert_array_equal(g, w)
    else:
        for thr in (0.006, 0.5):
            np.testing.assert_array_equal(pfcpe.local_argmax_f0(want, thr),
                                          jfcpe.local_argmax_f0(want, thr))


@pytest.mark.parametrize("kind", ["rmvpe", "fcpe", "crepe"])
def test_extractor_matches_jax(kind, extractors):
    """``extract`` with ``uv_interp`` and ``silence_front`` each off and on
    (and RMVPE with its Viterbi decoder): the same voicing, f0 within 1e-5
    relative, on the synth hop grid."""
    jext, pext, audio, _ = extractors[kind]
    cases = [(False, 0.0), (True, 0.03)]
    for uv, sf in cases + ([("viterbi", 0.0)] if kind == "rmvpe" else []):
        viterbi = uv == "viterbi"
        jext.use_viterbi = pext.use_viterbi = viterbi
        want = jext.extract(audio, uv_interp=bool(uv) and not viterbi,
                            silence_front=sf)
        got = pext.extract(audio, uv_interp=bool(uv) and not viterbi,
                           silence_front=sf)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (len(audio) // HOP + 1,)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=F0_RTOL, atol=0,
                                   err_msg=f"{kind} {uv} {sf}")
        tail = want[int(sf * SR / HOP):]
        assert np.all(np.abs(tail - 220.0) < 15.0), tail
    jext.use_viterbi = pext.use_viterbi = False


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("kind,gru", [("rmvpe", 1), ("rmvpe", 0), ("fcpe", 1),
                                      ("crepe", 1)])
def test_state_dict_round_trip(kind, gru, narrow, extractors):
    """JAX variables -> the port's state dict -> JAX variables: the same
    leaves and values, the port net loaded strictly in between (the narrow
    nets, E2E0 without its BiGRU too, CREPE full). A flax GRU has no r / z
    hidden biases, so a port GRU with one is refused."""
    if kind == "crepe":
        variables, cfg = extractors["crepe"][3], {}
    else:
        variables, cfg = narrow[kind], dict(NARROW[kind])
    if not gru:  # E2E0(n_gru=0): no BiGRU, the Dense on the 384 features
        variables = {c: dict(t) for c, t in variables.items()}
        del variables["params"]["gru"]
        fc = variables["params"]["fc"]
        variables["params"]["fc"] = dict(fc, kernel=fc["kernel"][:384])
        cfg["n_gru"] = 0
    port_cfg = {k: v for k, v in cfg.items() if k != "hidden"}
    net = {"rmvpe": lambda: prmvpe.E2E0(**cfg), "crepe": pcrepe.Crepe,
           "fcpe": lambda: pfcpe.CFNaiveMelPE(**cfg)}[kind]()
    jp.load_state(net, jp.f0_net_state_dict(kind, variables, **port_cfg))
    back = jp.f0_net_variables(kind, net.state_dict(), **port_cfg)
    want, got = dict(_flat(variables)), dict(_flat(back))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    if kind == "rmvpe" and gru:
        state = net.state_dict()
        state["gru.bias_hh_l0"] = state["gru.bias_hh_l0"] + 1.0
        with pytest.raises(ValueError, match="no r and z hidden biases"):
            jp.f0_net_variables(kind, state, **port_cfg)


# ---------------------------------------------------------- entry points

CLI_SR, CLI_HOP = 16000, 64


def _args(tmp, f0_extractor="yin"):
    return DotDict({
        "data": {"sampling_rate": CLI_SR, "block_size": CLI_HOP, "duration": 0.5,
                 "encoder": "tiny", "encoder_ckpt": str(tmp / "absent.npz"),
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "encoder_out_channels": 256, "f0_extractor": f0_extractor,
                 "f0_min": 50.0, "f0_max": 1100.0, "extensions": ["wav"],
                 "train_path": str(tmp / "data" / "train"),
                 "valid_path": str(tmp / "data" / "val")},
        "model": {"type": "CombSubSuperFast", "win_length": 256, "n_spk": 2},
        "infer": {}, "env": {"expdir": str(tmp / "exp")}})


@pytest.fixture(scope="module")
def weights(tmp_path_factory, extractors):
    """(root with pretrain/rmvpe/model.msgpack, the JAX extractor its
    ``cli.common.build_f0_extractor`` builds from a config there, a 0.4 s
    wav, its audio). The JAX extractor's RMVPE is the module's, on the
    same parameters, so its net compiles once."""
    root = tmp_path_factory.mktemp("f0cli")
    path = root / "pretrain" / "rmvpe" / "model.msgpack"
    jp.write_msgpack(str(path), extractors["rmvpe"][3])
    assert set(jax_load_params(str(path))) == {"params", "batch_stats"}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        jext = jax_build_f0(_args(root, "rmvpe"))
    finally:
        os.chdir(cwd)
    assert jext.f0_extractor == "rmvpe"
    jext.rmvpe = extractors["rmvpe"][0].rmvpe
    wav = root / "in.wav"
    wavfile.write(wav, CLI_SR, (voice(0.4, CLI_SR, seed=4) * 32767).astype(np.int16))
    audio, sr = jax_load_wav(str(wav))
    assert sr == CLI_SR
    return root, jext, wav, audio


def _same_f0(got, want):
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=F0_RTOL, atol=0)
    assert np.all(np.abs(want[want > 0] - 220.0) < 15.0)


def test_cli_infer_rmvpe(weights, tmp_path, monkeypatch):
    """``cli.infer -pe rmvpe`` caches the JAX CLI's f0 (the JAX CLI builds
    ``F0Extractor(pe, sr, hop, f0_min, f0_max)``, reading the weights file
    as the port does)."""
    root, jext, wav, audio = weights
    args = _args(tmp_path)
    model = random_init_(build_model(args), torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path / "exp"), 3, model, args.model)
    save_config(str(tmp_path / "exp" / "config.yaml"), dict(args))
    monkeypatch.setenv("DDSP_SVC_TPU_RMVPE_CKPT",
                       str(root / "pretrain" / "rmvpe" / "model.msgpack"))
    out = tmp_path / "out" / "out.wav"
    pcli.main(["-m", ckpt, "-i", str(wav), "-o", str(out), "-pe", "rmvpe",
               "--device", "cpu"])
    cache = list((tmp_path / "out" / "cache").glob("rmvpe_*.npy"))
    assert len(cache) == 1 and out.exists()
    _same_f0(np.load(cache[0]), jext.extract(audio, uv_interp=True))


def test_cli_preprocess_rmvpe(weights, tmp_path, monkeypatch):
    """``cli.preprocess`` with ``f0_extractor: rmvpe`` reads
    ``pretrain/rmvpe/model.msgpack`` from the working directory, as the JAX
    package's, and writes its f0."""
    root, jext, wav, audio = weights
    args = _args(tmp_path, "rmvpe")
    for split in ("train", "val"):
        os.makedirs(tmp_path / "data" / split / "audio")
        os.link(wav, tmp_path / "data" / split / "audio" / "a.wav")
    cfg = str(tmp_path / "config.yaml")
    save_config(cfg, dict(args))
    monkeypatch.chdir(root)
    pprep.main(["-c", cfg, "--device", "cpu", "--seed", "1"])
    want = jext.extract(audio, uv_interp=False)
    assert np.all(want > 0)
    for split in ("train", "val"):
        _same_f0(np.load(tmp_path / "data" / split / "f0" / "a.wav.npy"), want)


def test_batched_rmvpe_row_matches_direct(weights, monkeypatch):
    """A batched ``infer`` row with the RMVPE front end (the net's f0 on the
    request's own path, where the JAX server takes a net's f0) against the
    direct path with the row's draws injected."""
    root, *_ = weights
    monkeypatch.setenv("DDSP_SVC_TPU_RMVPE_CKPT",
                       str(root / "pretrain" / "rmvpe" / "model.msgpack"))
    gen = torch.Generator().manual_seed(11)
    args = _args(root)
    model = random_init_(build_model(args), gen)
    vocoder = random_init_(Vocoder(config=dict(upsample_initial_channel=32)), gen)
    pipe = SvcPipeline.from_parts(
        model, None, args, vocoder, device="cpu", enhance=True,
        units_encoder=UnitsEncoder("tiny", device="cpu", seed=3),
        pitch_extractor="rmvpe")
    assert pipe.f0_extractor(CLI_SR).net is not None
    bucket = 16
    audio = voice((bucket - 1) * CLI_HOP / CLI_SR, CLI_SR, seed=7)
    noise = pipe.request_noise(5, bucket)
    direct, _ = pipe.infer(audio, CLI_SR, noise=noise, spk_id=2)
    pipe.enable_batching(buckets=(8, bucket), max_batch=2, max_wait_ms=200.0)
    try:
        other = {}
        th = threading.Thread(target=lambda: other.setdefault(
            "out", pipe.infer(audio[:CLI_HOP * 10], CLI_SR, seed=9, spk_id=2)))
        th.start()
        batched, _ = pipe.infer(audio, CLI_SR, seed=5, spk_id=2)
        th.join()
        stats = pipe.batcher.stats()
    finally:
        pipe.disable_batching()
    assert batched.shape == direct.shape
    assert np.abs(batched - direct).max() <= 1e-5 * np.abs(direct).max()
    assert other["out"][0].shape[0] > 0 and stats["requests"] == 2
