"""The port's web GUI (``ddsp_svc_tpu_torch/gui/``, ``cli/gui.py``) over
real HTTP on 127.0.0.1:0, against the JAX package's ``gui``:

  - the page, /api/status and /api/locales; the locale tables equal JAX's;
  - /api/config's round trip and coercion (JAX's tests/test_gui.py);
  - /api/convert on a stand-in pipeline (length, headers, block count), and
    on a 2-layer DiffusionFast ``SvcPipeline`` on the CPU (the fixtures of
    tests/test_torch_infer.py, the same noise injected into every block)
    against JAX's ``GuiApp.convert`` on the same weights, from a 16 kHz
    wav that both resample to the engine's 44.1 kHz: >= 40 dB, the
    tolerance of tests/test_torch_realtime.py;
  - 409 without a model and 501 for the live stream (no sounddevice);
  - ``derive_config`` writes what JAX's writes; ``job_argv`` names the
    port's CLIs (with the GUI's --device), and the real preprocess CLI
    starts from a foreign working directory; ``JobRunner`` starts, polls,
    refuses a second job and stops, on stub commands, directly and through
    /api/workflow/*;
  - ``cli.gui`` serves on the port it is given and preloads --model.
"""
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from scipy.io import wavfile

import jax.numpy as jnp

import ddsp_svc_tpu.gui.web as jweb
import torch_helpers  # noqa: F401 (torch's threads under xdist)
from ddsp_svc_tpu.gui import workflow as jwf
from ddsp_svc_tpu.gui.i18n import LOCALES as JAX_LOCALES
from ddsp_svc_tpu.utils.config import load_config as jax_load_config
from ddsp_svc_tpu_torch.cli import gui as cli_gui
from ddsp_svc_tpu_torch.features.audio import load_wav
from ddsp_svc_tpu_torch.gui import DEFAULTS, LOCALES, GuiApp, get_locale, serve
from ddsp_svc_tpu_torch.gui import workflow as wf
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.utils.config import DotDict, load_config, save_config
from test_torch_infer import (BLOCK, SR, Noisy, _diffusion_args,  # noqa: F401
                              _jax_pipeline, _noise, cascade, encoders, nsf,
                              voice)
from torch_helpers import snr_db

RT = {"block_time": 0.1, "crossfade_time": 0.02, "extra_time": 0.4}


class PassthroughPipeline:
    def infer(self, audio, sample_rate, **kwargs):
        return audio.copy(), sample_rate


def _serve(app):
    srv = serve(app, port=0, background=True)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def server():
    app = GuiApp(pipeline=PassthroughPipeline(), device="cpu")
    srv, base = _serve(app)
    yield base, app
    app.jobs.stop()
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read(), dict(r.headers)


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), dict(r.headers)


def _post_json(url, obj):
    code, body, _ = _post(url, json.dumps(obj).encode())
    return code, json.loads(body)


def _wav_bytes(audio, sr) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, (audio * 32767).astype(np.int16))
    return buf.getvalue()


def test_page_status_and_locales(server):
    base, _ = server
    code, body, _ = _get(base + "/")
    assert code == 200 and b"/api/status" in body and b"/api/workflow/start" in body
    st = json.loads(_get(base + "/api/status")[1])
    assert st["model_loaded"] and st["config"] == DEFAULTS == jweb.DEFAULTS
    assert st["f0_modes"] == jweb.F0_MODES
    assert json.loads(_get(base + "/api/locales")[1]) == {
        k: get_locale(k) for k in LOCALES}


def test_locales_equal_jax():
    assert LOCALES == JAX_LOCALES
    keys = set(LOCALES["en_US"])
    assert all(set(table) == keys for table in LOCALES.values())
    assert get_locale("nope") == LOCALES["en_US"]


def test_config_roundtrip_and_coercion(server):
    base, app = server
    _post_json(base + "/api/config", {
        "pitch": "5", "use_phase_vocoder": "true", "spk_id": 3,
        "block_time": 0.1, "crossfade_time": 0.02, "extra_time": 0.4,
        "samplerate": 16000, "bogus_key": 1})
    assert app.config["pitch"] == 5.0
    assert app.config["use_phase_vocoder"] is True
    assert app.config["spk_id"] == 3 and app.config["samplerate"] == 16000
    assert "bogus_key" not in app.config


def test_convert_roundtrip(server):
    base, app = server
    sr = 16000
    _post_json(base + "/api/config", dict(RT, samplerate=sr))
    t = np.arange(sr) / sr
    audio = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    code, body, headers = _post(base + "/api/convert", _wav_bytes(audio, sr))
    assert code == 200
    out_sr, out = wavfile.read(io.BytesIO(body))
    assert out_sr == sr and len(out) == len(audio)
    assert float(headers["X-Rtf"]) > 0 and float(headers["X-Block-Ms"]) > 0
    assert app.stats["blocks"] == 10 and "times_s" not in app.stats


class _PortNoisy:
    """The port's pipeline with the same draws in every call (the engine
    reads ``infer`` and ``device``; without ``family`` its warmup is one
    block with the current arguments, as on the JAX side)."""

    def __init__(self, pipe, noise):
        self.pipe, self.noise, self.device = pipe, noise, pipe.device

    def infer(self, audio, sample_rate, **kwargs):
        return self.pipe.infer(audio, sample_rate, noise=self.noise, **kwargs)


class _JaxOnly:
    def __init__(self, pipe):
        self.infer = pipe.infer


def test_convert_matches_jax(monkeypatch, encoders, cascade, nsf):
    """Six 0.1 s blocks with 0.4 s of context through both GUIs from a
    16 kHz wav, the port's over HTTP."""
    jenc, penc = encoders
    jm, params, port = cascade
    t = (int(0.4 * SR) + int(0.1 * SR)) // BLOCK + 1
    noise = _noise(t, t * BLOCK)
    jmodel = Noisy(jm, ddsp_noise=jnp.asarray(noise["ddsp"]),
                   init_noise=jnp.asarray(noise["diffusion"]))
    jpipe = _jax_pipeline(monkeypatch, jmodel, params, _diffusion_args(), jenc,
                          nsf[0], noise)
    pipe = SvcPipeline.from_parts(port, None, DotDict(_diffusion_args()), nsf[1],
                                  device="cpu", units_encoder=penc)
    wav = _wav_bytes(voice(16000, 0.6, seed=3), 16000)
    audio, sr = load_wav(io.BytesIO(wav))
    settings = dict(RT, samplerate=SR, pitch=1.0, spk_id=2)

    japp = jweb.GuiApp(pipeline=_JaxOnly(jpipe))
    japp.config.update(settings)
    want, jstats = japp.convert(audio, sr)
    want = (np.clip(want, -1, 1) * 32767).astype(np.int16)

    app = GuiApp(pipeline=_PortNoisy(pipe, noise), device="cpu")
    srv, base = _serve(app)
    try:
        _post_json(base + "/api/config", settings)
        code, body, headers = _post(base + "/api/convert", wav)
    finally:
        srv.shutdown()
    assert code == 200 and float(headers["X-Rtf"]) > 0
    out_sr, got = wavfile.read(io.BytesIO(body))
    assert out_sr == SR and got.shape == want.shape
    assert app.stats["blocks"] == jstats["blocks"] == 6
    assert np.abs(got).max() > 0
    snr = snr_db(want.astype(np.float64), got.astype(np.float64))
    print(f"GUI convert SNR vs JAX: {snr:.1f} dB")
    assert snr >= 40.0


def test_convert_without_model_409_and_stream_501(server):
    base, _ = server
    req = urllib.request.Request(base + "/api/stream/start", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 501  # sounddevice is not installed
    srv, base = _serve(GuiApp(pipeline=None, device="cpu"))
    try:
        req = urllib.request.Request(base + "/api/convert", data=b"xx", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 409
    finally:
        srv.shutdown()


def test_derive_config_matches_jax(tmp_path):
    base = {"data": {"sampling_rate": 16000},
            "train": {"batch_size": 24, "lr": 0.0005, "cache_all_data": False},
            "env": {"expdir": "exp/old"}}
    overrides = {"batch_size": "6", "lr": 0.001, "expdir": "exp/new",
                 "cache_all_data": "true", "epochs": "", "bogus": 1}
    outs = {}
    for name, module in (("jax", jwf), ("port", wf)):
        (tmp_path / name).mkdir()
        save_config(tmp_path / name / "base.yaml", base)
        outs[name] = module.derive_config(str(tmp_path / name / "base.yaml"),
                                          dict(overrides))
        assert outs[name].endswith("base.gui.yaml")
    got, want = load_config(outs["port"]), jax_load_config(outs["jax"])
    assert got == want and jax_load_config(outs["port"]) == want
    assert got.train.batch_size == 6 and got.train.cache_all_data is True
    assert got.env.expdir == "exp/new" and "bogus" not in got.train


def test_job_argv_names_the_port_clis(tmp_path):
    for kind in ("preprocess", "train"):
        argv = wf.job_argv(kind, "/tmp/x.yaml")
        assert argv == [sys.executable, "-m", f"ddsp_svc_tpu_torch.cli.{kind}",
                        "-c", "/tmp/x.yaml"]
        assert wf.job_argv(kind, "/tmp/x.yaml", "cpu")[-2:] == ["--device", "cpu"]
    cfg = tmp_path / "c.yaml"
    save_config(cfg, {"env": {"expdir": str(tmp_path / "exp")}})
    argv = wf.job_argv("tensorboard", str(cfg))
    assert argv[argv.index("--logdir") + 1] == str(tmp_path / "exp")
    with pytest.raises(ValueError):
        wf.job_argv("nonsense", "x")
    r = wf.JobRunner()  # the real CLI, started outside the checkout
    r.start("preprocess", wf.job_argv("preprocess", "x.yaml")[:-2] + ["--help"],
            cwd=str(tmp_path))
    st = _wait(r, timeout=120)
    assert st["returncode"] == 0, st["lines"][-5:]
    assert any("usage" in ln.lower() for ln in st["lines"])


def _wait(runner, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = runner.poll()
        if not st["running"] and st["returncode"] is not None:
            return st
        time.sleep(0.05)
    raise TimeoutError("job did not finish")


def _script(code: str) -> list[str]:
    return [sys.executable, "-u", "-c", code]


def test_job_runner_start_poll_stop():
    r = wf.JobRunner()
    r.start("demo", _script("import sys; print('a'); print('b', file=sys.stderr)"))
    st = _wait(r)
    assert st["returncode"] == 0 and st["kind"] == "demo"
    assert set(st["lines"]) >= {"a", "b"}
    assert r.poll(since=st["next"])["lines"] == []
    r.start("slow", _script("import time; time.sleep(30)"))
    with pytest.raises(RuntimeError, match="still running"):
        r.start("again", _script("print('x')"))
    r.stop()
    assert _wait(r)["returncode"] != 0
    r.start("restarted", _script("print('ok')"))
    assert _wait(r)["lines"] == ["ok"]


def test_workflow_endpoints(server, monkeypatch, tmp_path):
    """A job through /api/workflow/start gets the GUI's device; the log,
    a refused second job, stop, and the derived config."""
    base, app = server
    seen = []

    def argv(kind, cfg, device=None):
        seen.append(device)
        return _script(f"print('ran {kind} on ' + {cfg!r})" if kind == "preprocess"
                       else "import time; time.sleep(30)")

    monkeypatch.setattr(wf, "job_argv", argv)
    code, out = _post_json(base + "/api/workflow/start",
                           {"kind": "preprocess", "config": "/tmp/c.yaml"})
    assert code == 200 and out["ok"] and seen == ["cpu"]
    _wait(app.jobs)
    log = json.loads(_get(base + "/api/workflow/log?since=0")[1])
    assert "ran preprocess on /tmp/c.yaml" in log["lines"] and log["returncode"] == 0
    assert _post_json(base + "/api/workflow/start",
                      {"kind": "train", "config": "x"})[0] == 200
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post_json(base + "/api/workflow/start", {"kind": "train", "config": "x"})
    assert exc.value.code == 409
    assert _post_json(base + "/api/workflow/stop", {})[0] == 200
    assert _wait(app.jobs)["returncode"] != 0
    cfg = tmp_path / "c.yaml"
    save_config(cfg, {"train": {"batch_size": 24}})
    code, out = _post_json(base + "/api/workflow/config",
                           {"base": str(cfg), "batch_size": 4})
    assert code == 200 and load_config(out["path"]).train.batch_size == 4


def test_cli_serves_and_preloads(monkeypatch):
    loaded = []
    monkeypatch.setattr(GuiApp, "load_model", lambda self, path: loaded.append(
        (path, self.device)))
    ready = threading.Event()
    servers = []

    def on_ready(srv):
        servers.append(srv)
        ready.set()

    th = threading.Thread(target=cli_gui.main, args=(
        ["--port", "0", "--model", "m.ckpt", "--device", "cpu"], on_ready),
        daemon=True)
    th.start()
    assert ready.wait(30)
    try:
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        assert _get(base + "/api/status")[0] == 200
    finally:
        servers[0].shutdown()
    th.join(30)
    assert loaded == [("m.ckpt", cli_gui.resolve_device("cpu"))]
