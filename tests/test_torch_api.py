"""The port's HTTP endpoint (ddsp_svc_tpu_torch/cli/api.py) over real HTTP
on 127.0.0.1, port 0, on the CPU: the cases of tests/test_api.py that
apply -- the multipart round trip, the flask_api voice-change contract,
concurrent requests batched, /health, /stats, 404, a request past the
largest bucket (the direct path), a malformed body (a one-line 500), the
diffusion sampler fields (each setting its own signature), stream=1 as a
chunked response and its rate-mismatch fallback -- the refusal of
``--batch_devices`` above the cards there are, and ``main`` serving a
checkpoint written by the JAX package, on one device and sharded over two
CPU entries. The supervisor's tests are tests/test_torch_supervisor.py."""
import io
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from ddsp_svc_tpu_torch.cli import api
from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.utils.config import DotDict
from test_torch_batcher import _pipeline
from test_torch_cli import ddsp_ckpt  # noqa: F401

SR, HOP = 16000, 64


def _ddsp_pipeline():
    args = DotDict({"data": {"sampling_rate": SR, "block_size": HOP,
                             "encoder_out_channels": 256},
                    "model": {"type": "CombSubSuperFast", "win_length": 256,
                              "n_spk": 4},
                    "enhancer": None})
    model = random_init_(build_model(args), torch.Generator().manual_seed(2))
    return SvcPipeline.from_parts(model, None, args, None, device="cpu",
                                  units_encoder=UnitsEncoder("tiny", device="cpu"))


def _serve(pipeline):
    srv = api.Server(("127.0.0.1", 0), api.make_handler(pipeline, {}))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    pipeline = _ddsp_pipeline()
    pipeline.enable_batching(buckets=(64, 128), max_batch=4, max_wait_ms=30.0)
    srv, base = _serve(pipeline)
    yield base, pipeline
    srv.shutdown()
    pipeline.disable_batching()


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
        out.write(value if isinstance(value, bytes) else str(value).encode())
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def _wav_bytes(seconds=0.25, freq=220.0, sr=SR):
    n = np.arange(int(sr * seconds))
    audio = (0.3 * np.sin(2 * np.pi * freq * n / sr)).astype(np.float32)
    buf = io.BytesIO()
    wavfile.write(buf, sr, (audio * 32767).astype(np.int16))
    return buf.getvalue()


def _post(base, **fields):
    body, ctype = _multipart({"fPitchChange": 0.0, "sSpeakId": 1,
                              "sampleRate": SR, **fields})
    req = urllib.request.Request(base + "/voiceChangeModel", data=body,
                                 method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), dict(r.headers)


def test_multipart_parser_roundtrip():
    body, ctype = _multipart({"a": b"\x00\x01bin", "b": "text"})
    fields = api.parse_multipart(body, ctype)
    assert fields["a"] == b"\x00\x01bin" and fields["b"] == b"text"


def test_voice_change_contract(server):
    base, _ = server
    status, payload, headers = _post(base, sample=_wav_bytes(), fPitchChange=2.0,
                                     sSpeakId=2)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    out_sr, data = wavfile.read(io.BytesIO(payload))
    assert out_sr == SR and data.dtype == np.int16
    assert len(data) == int(0.25 * SR) // HOP * HOP + HOP
    assert np.abs(data).max() > 0


def test_concurrent_requests_batched(server):
    base, pipeline = server
    before = pipeline.batcher.stats()
    results = [None] * 4

    def worker(i):
        results[i] = _post(base, sample=_wav_bytes(freq=200.0 + 20 * i),
                           sSpeakId=1 + i % 4)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for status, payload, _ in results:
        assert status == 200
        assert len(wavfile.read(io.BytesIO(payload))[1]) > 0
    after = pipeline.batcher.stats()
    assert after["requests"] - before["requests"] == 4
    assert after["batches"] - before["batches"] < 4  # some shared a batch


def test_health_stats_and_404(server):
    import json

    base, _ = server
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
    _post(base, sample=_wav_bytes())
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        body = json.loads(r.read())
    b = body["batching"]
    assert b["requests"] >= 1 and b["batches"] >= 1 and b["max_batch"] == 4
    assert 0 < b["mean_batch_occupancy"] <= 1 and b["latency_ms_p50"] > 0
    assert body["encoder_batching"] is None
    for req in (base + "/nope-get",
                urllib.request.Request(base + "/nope", data=b"x", method="POST")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404


def test_oversized_request_runs_direct(server):
    """0.8 s is 201 frames, past the largest bucket (128): the direct
    path serves it."""
    base, pipeline = server
    before = pipeline.batcher.stats()["requests"]
    status, payload, _ = _post(base, sample=_wav_bytes(seconds=0.8))
    assert status == 200
    assert len(wavfile.read(io.BytesIO(payload))[1]) == 201 * HOP
    assert pipeline.batcher.stats()["requests"] == before


def test_malformed_body_returns_500(server):
    base, _ = server
    req = urllib.request.Request(
        base + "/voiceChangeModel", data=b"not-multipart", method="POST",
        headers={"Content-Type": "multipart/form-data; boundary=x"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 500
    assert "\n" not in e.value.reason


def test_stream_mode_chunked_response(server):
    base, _ = server
    status, payload, headers = _post(base, sample=_wav_bytes(seconds=1.0), stream=1)
    assert status == 200 and headers.get("Transfer-Encoding") == "chunked"
    assert "Content-Length" not in headers
    out_sr, data = wavfile.read(io.BytesIO(payload))
    assert out_sr == SR and len(data) == SR and np.abs(data).max() > 0


def test_stream_mode_rate_mismatch_falls_back(server):
    base, _ = server
    status, payload, headers = _post(base, sample=_wav_bytes(), stream=1,
                                     sampleRate=2 * SR)
    assert status == 200 and "Content-Length" in headers
    assert wavfile.read(io.BytesIO(payload))[0] == 2 * SR


def test_diffusion_per_request_sampler_fields():
    """sample_method / sample_interval / skip_steps per request: k_step 10
    twice (one signature) and 4 (its own); each answers a wav."""
    pipeline = _pipeline("DiffusionFast")
    pipeline.enable_batching(buckets=(64,), max_batch=2, max_wait_ms=30.0,
                             k_step=10, method="dpm-solver", speedup=2)
    srv, base = _serve(pipeline)
    try:
        results = [None] * 3
        skips = [990, 990, 996]

        def worker(i):
            results[i] = _post(base, sample=_wav_bytes(sr=44100), sampleRate=44100,
                               sample_method="dpm-solver", sample_interval=2,
                               skip_steps=skips[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for status, payload, _ in results:
            assert status == 200
            assert len(wavfile.read(io.BytesIO(payload))[1]) > 0
        assert len(pipeline._batch_sigs) == 2
    finally:
        srv.shutdown()
        pipeline.disable_batching()


@pytest.mark.parametrize("devices,cards", [(2, 0), (2, 1), (3, 2)])
def test_refused_options(monkeypatch, devices, cards):
    """``--batch_devices`` above the cards this machine has is refused,
    naming both numbers, before a model loads (JAX would serve on fewer
    devices than asked)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    flag = ["--batch_devices", str(devices), "--batch", "4"]
    msg = f"--batch_devices {devices}: this machine has {cards} CUDA card"
    with pytest.raises(ValueError, match=msg):
        api.batch_mesh(api.parse_args(["-m", "m"] + flag).batch_devices)
    with pytest.raises(ValueError, match=msg):
        api.main(["-m", "absent/model_1.ckpt"] + flag)
    assert api.batch_mesh(1) is None
    assert api.batch_mesh(devices, "cpu") == [torch.device("cpu")] * devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    assert api.batch_mesh(devices) == [torch.device("cuda", i) for i in range(devices)]


def test_main_shards_batches_over_cpu_entries(ddsp_ckpt):  # noqa: F811
    """``main`` with ``--batch_devices 2 --device cpu``: the batchers shard
    over two CPU entries, and concurrent POSTs are answered."""
    ready, holder = threading.Event(), {}
    import ddsp_svc_tpu_torch.infer.pipeline as pipeline

    made = []
    enable = pipeline.SvcPipeline.enable_batching

    def spy(self, *a, **k):
        made.append(k.get("mesh"))
        return enable(self, *a, **k)

    pipeline.SvcPipeline.enable_batching = spy
    th = threading.Thread(target=api.main, daemon=True, kwargs=dict(
        argv=["-m", str(ddsp_ckpt), "-p", "0", "--host", "127.0.0.1",
              "--device", "cpu", "--batch", "2", "--batch_buckets", "32,64",
              "--batch_devices", "2", "--batch_encoder", "--batch_wait_ms", "200"],
        ready_cb=lambda srv: (holder.setdefault("srv", srv), ready.set())))
    try:
        th.start()
        assert ready.wait(300)
    finally:
        pipeline.SvcPipeline.enable_batching = enable
    srv = holder["srv"]
    try:
        assert made == [[torch.device("cpu")] * 2]
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results = [None] * 2

        def worker(i):
            results[i] = _post(base, sample=_wav_bytes(seconds=0.1, freq=200.0 + 50 * i))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for status, payload, _ in results:
            assert status == 200
            out_sr, data = wavfile.read(io.BytesIO(payload))
            assert out_sr == SR and len(data) == int(0.1 * SR) // HOP * HOP + HOP
    finally:
        srv.shutdown()
        th.join(60)
    assert not th.is_alive()


def test_main_serves_a_jax_checkpoint(ddsp_ckpt):  # noqa: F811
    """``main`` with every batching option a CPU run takes, on a
    CombSubSuperFast checkpoint written by the JAX package."""
    ready = threading.Event()
    holder = {}

    def ready_cb(srv):
        holder["srv"] = srv
        ready.set()

    th = threading.Thread(target=api.main, daemon=True, kwargs=dict(
        argv=["-m", str(ddsp_ckpt), "-p", "0", "--host", "127.0.0.1",
              "--device", "cpu", "--batch", "2", "--batch_buckets", "32,64",
              "--batch_i16", "--batch_encoder", "--device_f0", "--audio_i16",
              "--batch_pipeline", "2", "--voc_bf16", "--warmup"],
        ready_cb=ready_cb))
    th.start()
    assert ready.wait(300)
    srv = holder["srv"]
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        status, payload, _ = _post(base, sample=_wav_bytes(seconds=0.1))
        assert status == 200
        out_sr, data = wavfile.read(io.BytesIO(payload))
        assert out_sr == SR and len(data) == int(0.1 * SR) // HOP * HOP + HOP
    finally:
        srv.shutdown()
        th.join(60)
    assert not th.is_alive()
