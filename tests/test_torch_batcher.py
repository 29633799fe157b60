"""The port's dynamic batching (infer/batcher.py, ops/codec.py and
``SvcPipeline.enable_batching``) on the CPU, at small widths.

Against the JAX package: ``right_sized_slots`` and ``deadline_chunks`` for
every batch size up to 16, and the wire codecs (the host's numpy paths bit
for bit; the device encode bit for bit against the jnp one, the device
decode within one f32 ulp of full scale). Against the port's own direct path, with the
row's draws handed to it (``SvcPipeline.request_noise``): a BatchedSynth
row within 1e-5 x max|out|, and ``SvcPipeline.infer`` batched for
CombSubSuperFast, Sins with the enhancer in the batch and DiffusionFast
with the cascade builder, each within 1e-5 x max|out|. The engine's
contract: rows independent of their batch-mates under concurrency, bucket
overflow, error delivery, close() failing queued requests, the pipelined
delivery equal to the serial one, the i16 / mu-law / f16-in codecs against
f32, no starvation across buckets, warmup kept out of the stats, and no
autograd in the worker.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddsp_svc_tpu.infer import batcher as jbatcher
from ddsp_svc_tpu.ops import codec as jcodec
from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
from ddsp_svc_tpu_torch.infer import batcher as pbatcher
from ddsp_svc_tpu_torch.infer.batcher import BatchedSynth
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.models.vocoder import Vocoder
from ddsp_svc_tpu_torch.ops import codec as pcodec
from ddsp_svc_tpu_torch.utils.config import DotDict
import torch_helpers  # noqa: F401,E402  (torch's threads under xdist)

SR, HOP, N_UNIT = 16000, 64, 16


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def synth():
    args = DotDict({"data": {"sampling_rate": SR, "block_size": HOP,
                             "encoder_out_channels": N_UNIT},
                    "model": {"type": "CombSubSuperFast", "win_length": 256,
                              "n_spk": 4}})
    model = random_init_(build_model(args), torch.Generator().manual_seed(1)).eval()
    eng = BatchedSynth(model, buckets=(32, 64), max_batch=4, max_wait_ms=20.0,
                       device="cpu")
    yield eng, model
    eng.close()


def _req(rng, t):
    return (rng.standard_normal((t, N_UNIT)).astype(np.float32),
            (220.0 * np.exp(0.1 * rng.standard_normal((t, 1)))).astype(np.float32),
            (0.5 * np.ones((t, 1))).astype(np.float32))


@pytest.mark.parametrize("max_batch", [4, 8, 16])
def test_slot_policy_matches_jax(max_batch):
    for n in range(1, 17):
        assert (pbatcher.right_sized_slots(n, max_batch)
                == jbatcher.right_sized_slots(n, max_batch)), n
        batch = list(range(n))
        assert (pbatcher.deadline_chunks(batch, lambda k: pbatcher.right_sized_slots(k, max_batch))
                == jbatcher.deadline_chunks(batch, lambda k: jbatcher.right_sized_slots(k, max_batch))), n


def test_codecs_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 50000),
                        np.linspace(-1, 1, 20001)]).astype(np.float32)
    codes = np.arange(256, dtype=np.uint8)
    assert np.array_equal(pcodec.mulaw_encode_u8(x), jcodec.mulaw_encode_u8(x))
    assert np.array_equal(pcodec.mulaw_decode(codes), jcodec.mulaw_decode(codes))
    assert np.array_equal(pcodec.mulaw_step(x), jcodec.mulaw_step(x))
    assert np.array_equal(
        pcodec.mulaw_encode_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jcodec.mulaw_encode_u8(jnp.asarray(x), xp=jnp)))
    want = np.asarray(jcodec.mulaw_decode(jnp.asarray(codes), xp=jnp))
    got = pcodec.mulaw_decode(torch.from_numpy(codes)).numpy()
    assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))
    # int16: the same rounding on the host and the device
    assert np.array_equal(pcodec.i16_encode(torch.from_numpy(x)).numpy(),
                          pcodec.i16_encode(x))


def test_row_matches_direct_padded_forward(synth):
    """A request padded to bucket 32 against the model run alone on the
    same padded inputs with the row's own draw (U(-1, 1) at the bucket
    length from a generator seeded with the request's seed)."""
    eng, model = synth
    rng = np.random.default_rng(0)
    t, bucket = 20, 32
    units, f0, vol = _req(rng, t)
    got = eng.infer(units, f0, vol, spk_id=2, seed=7)
    assert got.shape == (t * HOP,) and got.dtype == np.float32
    pad = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full((bucket - t, 1 if a.shape[1] == 1 else a.shape[1]), fill,
                    np.float32)])[None]
    noise = torch.rand((1, bucket * HOP), generator=torch.Generator().manual_seed(7)) * 2 - 1
    with torch.no_grad():
        want, _ = model(torch.from_numpy(pad(units, 0.0)),
                        torch.from_numpy(pad(f0, 220.0)),
                        torch.from_numpy(pad(vol, 0.0)),
                        spk_id=torch.tensor([[2]]), noise=noise)
    assert _rel(got, want[0, :t * HOP]) <= 1e-5


def test_concurrent_requests_batch_independent(synth):
    eng, _ = synth
    rng = np.random.default_rng(1)
    reqs = [(_req(rng, 24), 100 + i, 1 + i % 4) for i in range(8)]
    serial = [eng.infer(u, f, v, spk_id=s, seed=k) for (u, f, v), k, s in reqs]
    results = [None] * 8

    def worker(i):
        (u, f, v), k, s = reqs[i]
        results[i] = eng.infer(u, f, v, spk_id=s, seed=k)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for i in range(8):
        assert _rel(results[i], serial[i]) <= 1e-5, i
    assert eng.stats()["batches"] >= 2


def test_bucket_selection_and_overflow(synth):
    eng, _ = synth
    rng = np.random.default_rng(2)
    out = eng.infer(*_req(rng, 50), spk_id=1, seed=0)  # -> bucket 64
    assert out.shape == (50 * HOP,)
    with pytest.raises(ValueError, match="largest bucket"):
        eng.infer(*_req(rng, 80), spk_id=1, seed=0)


def test_error_delivery(synth):
    """A forward that raises fails its callers; the engine keeps serving."""
    eng, _ = synth
    rng = np.random.default_rng(3)
    with pytest.raises(Exception):
        eng.infer(*_req(rng, 16), spk_id=99, seed=0)  # no speaker 99
    assert eng.infer(*_req(rng, 16), spk_id=1, seed=0).shape == (16 * HOP,)


def test_close_fails_queued_requests():
    """close() fails every queued request; no caller hangs."""
    started = threading.Event()

    def builder(bucket, sig):
        def fwd(units, f0, volume, spk, gens, tframes):
            started.set()
            time.sleep(0.5)
            return torch.zeros((units.shape[0], bucket * HOP))
        return fwd

    class Model:
        block_size = HOP

    eng = BatchedSynth(Model(), buckets=(8,), max_batch=1, max_wait_ms=1.0,
                       forward_builder=builder, device="cpu")
    rng = np.random.default_rng(4)
    outcomes, threads = [], []

    def call():
        try:
            outcomes.append(eng.infer(*_req(rng, 8), spk_id=1, seed=0))
        except RuntimeError as e:
            outcomes.append(e)

    for _ in range(4):
        threads.append(threading.Thread(target=call))
        threads[-1].start()
    started.wait(5)
    eng.close()
    for th in threads:
        th.join(10)
    assert all(not th.is_alive() for th in threads), "caller hung after close"
    assert len(outcomes) == 4
    assert any(isinstance(o, RuntimeError) for o in outcomes)


def test_pipelined_matches_serial(synth):
    _, model = synth
    rng = np.random.default_rng(5)
    reqs = [_req(rng, 30) for _ in range(6)]
    outs = {}
    for depth in (1, 3):
        eng = BatchedSynth(model, buckets=(32,), max_batch=2, max_wait_ms=5.0,
                           pipeline_depth=depth, device="cpu")
        res = [None] * 6

        def worker(i, eng=eng, res=res):
            res[i] = eng.infer(*reqs[i], spk_id=1, seed=i)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        eng.close()
        outs[depth] = res
    for a, b in zip(outs[1], outs[3]):
        assert _rel(b, a) <= 1e-5


@pytest.mark.parametrize("transfer", ["i16", "mulaw", "f16_in"])
def test_transfer_codecs_against_f32(synth, transfer):
    """i16 within one LSB; mu-law within one companding step on >= 99.9 %
    of the samples and > 30 dB SNR; f16 units within 1e-2 x max|out|."""
    _, model = synth
    kw = ({"transfer_in": "f16"} if transfer == "f16_in"
          else {"transfer": transfer})
    eng = BatchedSynth(model, buckets=(32,), max_batch=2, device="cpu", **kw)
    ref_eng = BatchedSynth(model, buckets=(32,), max_batch=2, device="cpu")
    try:
        rng = np.random.default_rng(6)
        req = _req(rng, 30)
        ref = ref_eng.infer(*req, spk_id=1, seed=3)
        got = eng.infer(*req, spk_id=1, seed=3)
    finally:
        eng.close()
        ref_eng.close()
    assert got.shape == ref.shape and got.dtype == np.float32
    if transfer == "i16":
        assert np.abs(got - np.clip(ref, -1, 1)).max() <= 1.01 / 32767.0
    elif transfer == "mulaw":
        step = pcodec.mulaw_step(ref)
        assert (np.abs(got - ref) <= step * 1.01).mean() >= 0.999
        snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
        assert snr > 30.0, snr
    else:
        assert _rel(got, ref) <= 1e-2


def test_rejects_unknown_codecs_and_mesh(synth):
    """An unknown codec, and a mesh whose size does not divide max_batch
    (JAX's ValueError; the sharded engines are tests/test_torch_mesh_serving.py)."""
    _, model = synth
    with pytest.raises(ValueError, match="transfer codec"):
        BatchedSynth(model, transfer="bogus", device="cpu")
    with pytest.raises(ValueError, match="max_batch 8 not divisible by mesh size 3"):
        BatchedSynth(model, max_batch=8, mesh=["cpu"] * 3)


def test_no_cross_bucket_starvation(synth):
    """A big-bucket request arriving behind a stream of small-bucket ones
    is served within the stream."""
    eng, _ = synth
    rng = np.random.default_rng(7)
    results, stop = {}, threading.Event()

    def small_stream():
        while not stop.is_set():
            eng.infer(*_req(rng, 10), spk_id=1, seed=0)

    streams = [threading.Thread(target=small_stream) for _ in range(3)]
    for th in streams:
        th.start()
    time.sleep(0.1)
    tb = threading.Thread(target=lambda: results.setdefault(
        "big", eng.infer(*_req(np.random.default_rng(8), 50), spk_id=1, seed=0)))
    tb.start()
    tb.join(30)
    stop.set()
    for th in streams:
        th.join(30)
    assert not tb.is_alive(), "big-bucket request starved"
    assert results["big"].shape == (50 * HOP,)


def test_warmup_excluded_from_stats(synth):
    eng, _ = synth
    before = eng.stats()
    eng.warmup(N_UNIT)
    after = eng.stats()
    assert after["requests"] == before["requests"]
    assert after["latency_ms_p99"] == before["latency_ms_p99"]
    assert after["compiled_signatures"] >= len(eng.buckets)


def test_worker_runs_without_autograd(synth):
    """Grad mode is per thread: the worker's forward records no graph,
    though the model's parameters require grad."""
    _, model = synth
    seen = {}

    def builder(bucket, sig):
        def fwd(units, f0, volume, spk, gens, tframes):
            audio, _ = model(units, f0, volume, spk_id=spk)
            seen["grad_fn"], seen["enabled"] = audio.grad_fn, torch.is_grad_enabled()
            return audio
        return fwd

    assert any(p.requires_grad for p in model.parameters())
    eng = BatchedSynth(model, buckets=(32,), max_batch=2, forward_builder=builder,
                       device="cpu")
    try:
        eng.infer(*_req(np.random.default_rng(9), 20), spk_id=1, seed=0)
    finally:
        eng.close()
    assert seen == {"grad_fn": None, "enabled": False}


# ------------------------------------------------------ SvcPipeline batching


def _pipeline(mtype: str):
    """A small pipeline of ``mtype`` on the CPU with the tiny encoder: 16 kHz
    / 64 for CombSubSuperFast, 44.1 kHz / 512 (the NSF-HiFiGAN's grid) for
    Sins with the enhancer and DiffusionFast, whose NSF-HiFiGAN has 32
    channels."""
    gen = torch.Generator().manual_seed(11)
    sr, hop = (SR, HOP) if mtype == "CombSubSuperFast" else (44100, 512)
    model_cfg = {"CombSubSuperFast": dict(win_length=256),
                 "Sins": dict(n_harmonics=24, n_mag_allpass=16, n_mag_noise=12),
                 "DiffusionFast": dict(win_length=2048, n_layers=2, n_chans=16,
                                       k_step_max=40)}[mtype]
    args = DotDict({"data": {"sampling_rate": sr, "block_size": hop,
                             "encoder_out_channels": 256},
                    "model": dict(type=mtype, n_spk=2, **model_cfg),
                    "enhancer": ({"type": "nsf-hifigan", "ckpt": None}
                                 if mtype == "Sins" else None)})
    model = random_init_(build_model(args), gen)
    vocoder = random_init_(Vocoder(config=dict(upsample_initial_channel=32)), gen)
    return SvcPipeline.from_parts(
        model, None, args, vocoder, device="cpu", enhance=True,
        units_encoder=UnitsEncoder("tiny", device="cpu", seed=3))


@pytest.mark.parametrize("mtype", ["CombSubSuperFast", "Sins", "DiffusionFast"])
def test_pipeline_batched_matches_direct(mtype):
    """A recording exactly one bucket long through ``infer`` batched (the
    plain synth; synth, gate and enhancer in one forward; the cascade
    builder) against the direct path with the row's draws injected: within
    1e-5 x max|out|. A second request of another length in the same batch
    does not change it."""
    pipe = _pipeline(mtype)
    sr, hop = int(pipe.args.data.sampling_rate), int(pipe.args.data.block_size)
    bucket = 16
    n = np.arange((bucket - 1) * hop)
    audio = (0.3 * np.sin(2 * np.pi * 220.0 * n / sr)
             * (1 + 0.3 * np.sin(2 * np.pi * 3.0 * n / sr))).astype(np.float32)
    audio[len(n) // 3:len(n) // 2] = 0.0
    kw = dict(spk_id=2, k_step=20, speedup=10) if mtype == "DiffusionFast" else dict(spk_id=2)
    noise = pipe.request_noise(5, bucket)
    direct, sr_d = pipe.infer(audio, sr, noise=noise, **kw)
    pipe.enable_batching(buckets=(8, bucket), max_batch=2, max_wait_ms=200.0,
                         **({"k_step": 20, "speedup": 10}
                            if mtype == "DiffusionFast" else {}))
    try:
        other = {}
        th = threading.Thread(target=lambda: other.setdefault(
            "out", pipe.infer(audio[:hop * 10], sr, seed=9, **kw)))
        th.start()
        batched, sr_b = pipe.infer(audio, sr, seed=5, **kw)
        th.join()
        stats = pipe.batcher.stats()
    finally:
        pipe.disable_batching()
    assert sr_b == sr_d and batched.shape == direct.shape
    assert _rel(batched, direct) <= 1e-5
    assert other["out"][0].shape[0] > 0 and stats["requests"] == 2
