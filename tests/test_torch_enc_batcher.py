"""The masked batched HuBERT forward and the encoder batcher
(features/hubert.py ``encode_batched``, infer/enc_batcher.py) on the CPU
with the tiny encoder and the same randomised weights on both sides:

- zero-padded rows of different lengths, at the encoder's rate and at
  44.1 kHz (resampled): each row's valid frames against JAX's
  ``make_batched_encode_fn`` and against the port's own solo encode of the
  unpadded row, within the encoder's tolerance, 1e-5 x max|out|
  (tests/test_torch_hubert.py); ``valid_frames`` and ``align_index`` equal
  to JAX's;
- ``BatchedEncoder`` under concurrency against the solo ``encode``, with
  the device YIN in the batch (``encode_with_f0``: the bucket padding
  convention, f0 against the solo device YIN within 1e-4, 1e-3 on the
  last two frames) and with the
  i16 and mu-law upload codecs (against the solo encode of the decoded
  audio).
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.features import hubert as jh
from ddsp_svc_tpu_torch.features import hubert as ph
from ddsp_svc_tpu_torch.features.yin_device import make_pipeline_f0_fn
from ddsp_svc_tpu_torch.infer.enc_batcher import BatchedEncoder
from ddsp_svc_tpu_torch.ops import codec
from torch_helpers import randomize_tree, rel_err

HOP44 = 512


@pytest.fixture(scope="module")
def encoders():
    variables = {"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=61)}
    return (jh.UnitsEncoder("tiny", params=variables),
            ph.UnitsEncoder("tiny", params=variables, device="cpu"))


def _rows(rng, lengths, l_pad):
    audio = np.zeros((len(lengths), l_pad), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = 0.3 * rng.standard_normal(n)
    return audio


@pytest.mark.parametrize("sr,lengths,l_pad", [
    (16000, (6400, 3300, 390), 6400),
    (44100, (17640, 9000, 4410), 17640)])
def test_masked_batch_rows_match_jax_and_solo(encoders, sr, lengths, l_pad):
    jenc, penc = encoders
    audio = _rows(np.random.default_rng(sr), lengths, l_pad)
    want = np.asarray(jax.jit(jenc.make_batched_encode_fn(sr, l_pad))(
        jenc.variables, jnp.asarray(audio), jnp.asarray(lengths, jnp.int32)))
    got = penc.encode_batched(torch.from_numpy(audio), sr,
                              torch.tensor(lengths)).numpy()
    for i, n in enumerate(lengths):
        v = penc.valid_frames(n, sr)
        assert v == jenc.valid_frames(n, sr)
        assert rel_err(got[i, :v], want[i, :v]) <= 1e-5, i
        # the port's own solo encode of the unpadded row, on the synth grid
        solo = penc.encode(torch.from_numpy(audio[i:i + 1, :n]), sr, HOP44)
        idx = penc.align_index(n, sr, HOP44)
        assert np.array_equal(idx, jenc.align_index(n, sr, HOP44))
        assert rel_err(got[i, idx], solo[0].numpy()) <= 1e-5, i


def _voice(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f = 200.0 * (1 + 0.05 * np.sin(2 * np.pi * 4 * t)) * (1 + 0.1 * seed)
    a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.01 * rng.standard_normal(n)
    return a.astype(np.float32)


@pytest.mark.parametrize("with_f0", [False, True])
def test_batched_encoder_matches_solo(encoders, with_f0):
    """Four concurrent requests of different lengths in one bucket (one
    batched forward) and one past the largest bucket (the solo path)."""
    _, penc = encoders
    sr, buckets = 44100, (16, 32)
    eng = BatchedEncoder(penc, frame_buckets=buckets, max_batch=4,
                         max_wait_ms=200.0, with_f0=with_f0)
    lengths = (31 * HOP44, 20 * HOP44 + 77, 17 * HOP44, 25 * HOP44 + 3, 40 * HOP44)
    audios = [_voice(n, sr, i) for i, n in enumerate(lengths)]
    results = [None] * len(audios)

    def worker(i):
        if with_f0:
            results[i] = eng.encode_with_f0(audios[i], sr, HOP44, shift=2.0)
        else:
            results[i] = eng.encode(audios[i], sr, HOP44)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(audios))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = eng.stats()
    finally:
        eng.close()
    # the request past the largest bucket takes the solo path, uncounted
    assert stats["requests"] == 4 and stats["batches"] == 1
    for i, a in enumerate(audios):
        t = len(a) // HOP44 + 1
        solo = penc.encode(torch.from_numpy(a)[None], sr, HOP44)[0].numpy()
        if not with_f0:
            assert rel_err(results[i][0].numpy(), solo) <= 1e-5, i
            continue
        units, f0 = (r[0].numpy() for r in results[i])
        want_f0 = (make_pipeline_f0_fn(len(a), sr, HOP44, 50.0, 1100.0)(
            torch.from_numpy(a)).numpy() * 2.0 ** (2.0 / 12.0))
        assert rel_err(units[:t], solo) <= 1e-5, i
        # the batch's YIN runs over the bucket-long signal: its FFT sums
        # move the parabolic refinement by ~2.5e-5 (0.04 cents), and the
        # last frames' windows reach the decimation filter's ringing past
        # the request's end, which the solo YIN cuts (measured 1.2e-4)
        np.testing.assert_allclose(f0[:t - 2, 0], want_f0[:-2], rtol=1e-4)
        np.testing.assert_allclose(f0[t - 2:t, 0], want_f0[-2:], rtol=1e-3)
        if len(a) < 40 * HOP44:  # batched: padded to the bucket
            assert units.shape[0] == 32
            assert np.all(units[t:] == 0.0) and np.all(f0[t:] == 220.0)


@pytest.mark.parametrize("wire", ["i16", "mulaw"])
def test_batched_encoder_audio_codecs(encoders, wire):
    """The upload codec: each row equals the solo encode of the audio as
    decoded on the device (the same function of the same input: decoded
    as the batch matrix is, since a vectorised pow and its scalar tail may
    round apart)."""
    _, penc = encoders
    sr = 16000
    eng = BatchedEncoder(penc, frame_buckets=(32,), max_batch=2, transfer_in=wire)
    a = _voice(320 * 25, sr, 3)
    try:
        got = eng.encode(a, sr, 320)[0].numpy()
    finally:
        eng.close()
    enc, dec = ((codec.i16_encode, codec.i16_decode) if wire == "i16"
                else (codec.mulaw_encode_u8, codec.mulaw_decode))
    code = enc(a)
    batch = np.full((1, 32 * 320), 128 if wire == "mulaw" else 0, code.dtype)
    batch[0, :len(a)] = code
    decoded = dec(torch.from_numpy(batch))[0, :len(a)]
    want = penc.encode(decoded[None], sr, 320)[0].numpy()
    assert rel_err(got, want) <= 1e-5
    plain = penc.encode(torch.from_numpy(a)[None], sr, 320)[0].numpy()
    assert rel_err(got, plain) <= (1e-3 if wire == "i16" else 0.2)
