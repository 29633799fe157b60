"""Web GUI shell for the realtime engine (mirrors ddsp_svc_tpu/gui/web.py;
the reference's gui.py:152-380 window).

The reference renders its controls with PySimpleGUI and talks to
sounddevice directly; neither wheel is installed and card hosts are
headless, so the shell is a single-page web UI on the Python stdlib http
server instead:

  GET  /               the control panel (labels resolved via gui/i18n.py)
  GET  /api/status     model state + current settings + last run stats
  GET  /api/locales    the i18n tables (client renders labels)
  POST /api/config     JSON partial update of the settings below
  POST /api/load_model {"path": ...} -> build SvcPipeline from a checkpoint
  POST /api/convert    wav bytes -> converted wav (X-Rtf / X-Block-Ms
                       headers), run through RealtimeVC block streaming —
                       the same engine the live audio callback uses
  POST /api/stream/start|stop   live sounddevice IO when the wheel exists
                       (gated import, 501 otherwise)
  POST /api/workflow/config     {"base": path, ...train overrides} ->
                       derived YAML path (gui/workflow.py derive_config)
  POST /api/workflow/start      {"kind": preprocess|train|tensorboard,
                       "config": path-or-logdir} -> spawn the CLI as a
                       subprocess (one at a time, 409 when busy)
  POST /api/workflow/stop       terminate the running job (exact pgid)
  GET  /api/workflow/log?since=N  incremental job log + state
                       (the training-workflow surface of the reference's
                       webui (outdated).py:94-125)

Settings mirror the reference Config (gui.py:150-165): spk_id, threshold,
pitch, samplerate, block_time, crossfade_time, extra_time, f0_extractor,
use_enhancer, use_phase_vocoder, locale.

The pipeline runs on the app's device (the CUDA card unless ``device``
says otherwise); a conversion runs under ``torch.no_grad`` on the handler's
thread, its input brought to the engine's rate by ``ops/resample.py``.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import workflow as wf
from .i18n import LOCALES, get_locale

F0_MODES = ["yin", "crepe", "rmvpe"]

DEFAULTS = {
    "spk_id": 1,
    "threshold": -45.0,
    "pitch": 0.0,
    "samplerate": 44100,
    "block_time": 0.3,
    "crossfade_time": 0.04,
    "extra_time": 2.0,
    "f0_extractor": "yin",
    "use_enhancer": False,
    "use_phase_vocoder": False,
    "diff_silence": False,
    "locale": "en_US",
}


def _page() -> str:
    """The single-page shell: plain HTML/JS, labels filled from
    /api/locales, controls post to /api/config on change."""
    controls = [
        ("spk_id", "speaker_id", "number", {"min": 1, "max": 99, "step": 1}),
        ("threshold", "threshold", "range", {"min": -60, "max": 0, "step": 1}),
        ("pitch", "pitch_shift", "range", {"min": -24, "max": 24, "step": 1}),
        ("samplerate", "sample_rate", "number",
         {"min": 8000, "max": 96000, "step": 50}),
        ("block_time", "block_time", "range",
         {"min": 0.05, "max": 3.0, "step": 0.01}),
        ("crossfade_time", "crossfade_time", "range",
         {"min": 0.01, "max": 0.15, "step": 0.01}),
        ("extra_time", "extra_time", "range",
         {"min": 0.05, "max": 5.0, "step": 0.01}),
    ]
    rows = "\n".join(
        f'<label><span data-i18n="{i18n_key}"></span> '
        f'<input id="{key}" type="{typ}" '
        + " ".join(f'{a}="{v}"' for a, v in attrs.items())
        + f' onchange="setCfg(\'{key}\', this.value)">'
        f'<output for="{key}"></output></label>'
        for key, i18n_key, typ, attrs in controls
    )
    f0_opts = "".join(f'<option value="{m}">{m}</option>' for m in F0_MODES)
    lang_opts = "".join(
        f'<option value="{code}">{code}</option>' for code in LOCALES
    )
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title data-i18n="title"></title>
<style>
 body {{ font-family: sans-serif; max-width: 760px; margin: 2em auto; }}
 fieldset {{ margin-bottom: 1em; }}
 label {{ display: block; margin: .4em 0; }}
 output {{ margin-left: .6em; }}
 #stats, #status {{ font-family: monospace; }}
</style></head><body>
<h1 data-i18n="title"></h1>
<label><span data-i18n="language"></span>
 <select id="locale" onchange="setCfg('locale', this.value)">{lang_opts}</select>
</label>
<fieldset><legend data-i18n="model_section"></legend>
 <label><span data-i18n="model_path"></span>
  <input id="model_path" type="text" size="48"></label>
 <button onclick="loadModel()" data-i18n="load_model"></button>
 <span id="status" data-i18n="status_idle"></span>
</fieldset>
<fieldset><legend data-i18n="common_section"></legend>{rows}
 <label><span data-i18n="f0_extractor"></span>
  <select id="f0_extractor" onchange="setCfg('f0_extractor', this.value)">
  {f0_opts}</select></label>
 <label><input id="use_enhancer" type="checkbox"
  onchange="setCfg('use_enhancer', this.checked)">
  <span data-i18n="use_enhancer"></span></label>
 <label><input id="use_phase_vocoder" type="checkbox"
  onchange="setCfg('use_phase_vocoder', this.checked)">
  <span data-i18n="use_phase_vocoder"></span></label>
 <label><input id="diff_silence" type="checkbox"
  onchange="setCfg('diff_silence', this.checked)">
  <span data-i18n="diff_silence"></span></label>
</fieldset>
<fieldset><legend data-i18n="file_section"></legend>
 <input id="wav" type="file" accept=".wav">
 <button onclick="convert()" data-i18n="convert"></button>
 <div id="stats"></div>
 <audio id="player" controls></audio>
</fieldset>
<fieldset><legend data-i18n="training_section"></legend>
 <label><span data-i18n="base_config"></span>
  <input id="base_config" type="text" size="48"></label>
 <label><span data-i18n="override_batch_size"></span>
  <input id="ov_batch_size" type="number" min="1" step="1"></label>
 <label><span data-i18n="override_lr"></span>
  <input id="ov_lr" type="number" min="0" step="0.0001"></label>
 <button onclick="writeConfig()" data-i18n="write_config"></button>
 <button onclick="startJob('preprocess')" data-i18n="run_preprocess"></button>
 <button onclick="startJob('train')" data-i18n="run_train"></button>
 <button onclick="startJob('tensorboard')" data-i18n="run_tensorboard"></button>
 <button onclick="stopJob()" data-i18n="stop_job"></button>
 <span id="job_state" data-i18n="job_status_idle"></span>
 <pre id="job_log" style="max-height:16em;overflow:auto"></pre>
</fieldset>
<script>
let locales = {{}};
async function refresh() {{
  const st = await (await fetch('/api/status')).json();
  for (const [k, v] of Object.entries(st.config)) {{
    const el = document.getElementById(k);
    if (!el) continue;
    if (el.type === 'checkbox') el.checked = v; else el.value = v;
    const out = el.parentElement.querySelector('output');
    if (out) out.value = v;
  }}
  applyLocale(st.config.locale);
  document.getElementById('status').dataset.i18n =
    st.model_loaded ? 'status_loaded' : 'status_idle';
  translate();
}}
function applyLocale(code) {{
  window._t = locales[code] || locales['en_US'] || {{}};
}}
function translate() {{
  document.querySelectorAll('[data-i18n]').forEach(el => {{
    el.textContent = window._t[el.dataset.i18n] || el.dataset.i18n;
  }});
}}
async function setCfg(key, value) {{
  await fetch('/api/config', {{method: 'POST',
    body: JSON.stringify({{[key]: value}})}});
  refresh();
}}
async function loadModel() {{
  const path = document.getElementById('model_path').value;
  const r = await fetch('/api/load_model', {{method: 'POST',
    body: JSON.stringify({{path}})}});
  if (!r.ok) alert(await r.text());
  refresh();
}}
async function convert() {{
  const f = document.getElementById('wav').files[0];
  if (!f) return;
  const r = await fetch('/api/convert', {{method: 'POST', body: f}});
  if (!r.ok) {{ alert(await r.text()); return; }}
  const stats = document.getElementById('stats');
  stats.textContent = (window._t['stats_rtf'] || 'rtf') + ': ' +
    r.headers.get('X-Rtf') + '  ' +
    (window._t['stats_latency'] || 'ms') + ': ' +
    r.headers.get('X-Block-Ms');
  document.getElementById('player').src =
    URL.createObjectURL(await r.blob());
}}
let jobCursor = 0, jobTimer = null;
async function writeConfig() {{
  const r = await fetch('/api/workflow/config', {{method: 'POST',
    body: JSON.stringify({{
      base: document.getElementById('base_config').value,
      batch_size: document.getElementById('ov_batch_size').value,
      lr: document.getElementById('ov_lr').value,
    }})}});
  const j = await r.json();
  if (!r.ok) {{ alert(j.error); return; }}
  window._derived = j.path;
  document.getElementById('job_log').textContent = 'config: ' + j.path;
}}
async function startJob(kind) {{
  const cfg = window._derived || document.getElementById('base_config').value;
  const r = await fetch('/api/workflow/start', {{method: 'POST',
    body: JSON.stringify({{kind, config: cfg}})}});
  const j = await r.json();
  if (!r.ok) {{ alert(j.error); return; }}
  jobCursor = 0;
  document.getElementById('job_log').textContent = '';
  if (!jobTimer) jobTimer = setInterval(pollJob, 1500);
}}
async function stopJob() {{
  await fetch('/api/workflow/stop', {{method: 'POST', body: '{{}}'}});
}}
async function pollJob() {{
  const j = await (await fetch('/api/workflow/log?since=' + jobCursor)).json();
  const log = document.getElementById('job_log');
  if (j.lines.length) {{
    log.textContent += j.lines.join('\\n') + '\\n';
    log.scrollTop = log.scrollHeight;
  }}
  jobCursor = j.next;
  document.getElementById('job_state').dataset.i18n = j.running
    ? 'job_status_running'
    : (j.returncode === 0 || j.returncode === null
       ? 'job_status_idle' : 'job_status_failed');
  translate();
  if (!j.running && jobTimer) {{ clearInterval(jobTimer); jobTimer = null; }}
}}
(async () => {{
  locales = await (await fetch('/api/locales')).json();
  await refresh();
}})();
</script></body></html>"""


class GuiApp:
    """State container behind the handlers — pipeline injectable so the
    shell is testable without a checkpoint on disk."""

    def __init__(self, pipeline=None, pipeline_factory=None,
                 device: str | torch.device | None = None):
        self.device = device
        self.config = dict(DEFAULTS)
        self.pipeline = pipeline
        self.pipeline_factory = pipeline_factory or self._default_factory
        self.stats: dict = {}
        self.stream_thread = None
        self.jobs = wf.JobRunner()
        self._lock = threading.Lock()

    def _default_factory(self, path: str, f0_extractor: str, enhance: bool):
        from ..infer.pipeline import SvcPipeline

        return SvcPipeline(path, device=self.device, pitch_extractor=f0_extractor,
                           enhance=enhance)

    def load_model(self, path: str):
        self.pipeline = self.pipeline_factory(
            path, self.config["f0_extractor"], self.config["use_enhancer"]
        )

    def make_engine(self):
        from ..infer.realtime import RealtimeVC

        c = self.config
        return RealtimeVC(
            self.pipeline,
            sample_rate=int(c["samplerate"]),
            block_time=float(c["block_time"]),
            crossfade_time=float(c["crossfade_time"]),
            extra_time=float(c["extra_time"]),
            use_phase_vocoder=bool(c["use_phase_vocoder"]),
            spk_id=int(c["spk_id"]),
            key_shift=float(c["pitch"]),
            threhold=float(c["threshold"]),
            use_silence=bool(c["diff_silence"]),
        )

    def convert(self, audio: np.ndarray, sr: int) -> tuple[np.ndarray, dict]:
        """File-mode conversion through the block engine (same path as the
        live callback), with per-block latency stats."""
        from ..infer.realtime import drive_blocks
        from ..ops.resample import resample

        with self._lock, torch.no_grad():
            vc = self.make_engine()
            if sr != vc.sr:
                x = torch.as_tensor(np.asarray(audio, np.float32),
                                    device=getattr(self.pipeline, "device", "cpu"))
                audio = resample(x[None], sr, vc.sr)[0].cpu().numpy()
            vc.warmup()
            out, stats = drive_blocks(vc, audio)
            stats = {k: v for k, v in stats.items() if k != "times_s"}
            self.stats = stats
            return out, stats

    # ---- live audio (sounddevice gated, cli/realtime.py live mode) -----
    def stream_start(self):
        try:
            import sounddevice as sd
        except ImportError as e:
            raise NotImplementedError("sounddevice not installed") from e

        vc = self.make_engine()  # pragma: no cover
        vc.warmup()  # pragma: no cover

        def callback(indata, outdata, *_):  # pragma: no cover
            with torch.no_grad():  # grad mode is per thread
                outdata[:, 0] = vc.process_block(indata[:, 0].astype(np.float32))

        self.stream = sd.Stream(  # pragma: no cover
            samplerate=vc.sr, blocksize=vc.block_frame, channels=1,
            callback=callback,
        )
        self.stream.start()  # pragma: no cover

    def stream_stop(self):
        stream = getattr(self, "stream", None)
        if stream is not None:  # pragma: no cover
            stream.stop()
            stream.close()
            self.stream = None


def make_handler(app: GuiApp):
    from scipy.io import wavfile

    from ..features.audio import load_wav

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                body = _page().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/status":
                self._json({
                    "config": app.config,
                    "model_loaded": app.pipeline is not None,
                    "stats": app.stats,
                    "f0_modes": F0_MODES,
                })
            elif self.path == "/api/locales":
                self._json({k: get_locale(k) for k in LOCALES})
            elif self.path.startswith("/api/workflow/log"):
                since = 0
                if "since=" in self.path:
                    try:
                        since = int(self.path.split("since=")[1].split("&")[0])
                    except ValueError:
                        pass
                self._json(app.jobs.poll(since))
            else:
                self.send_error(404)

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def do_POST(self):
            self._headers_sent = False
            try:
                if self.path == "/api/config":
                    update = json.loads(self._read_body())
                    for k, v in update.items():
                        if k not in DEFAULTS:
                            continue
                        cur = DEFAULTS[k]
                        if isinstance(cur, bool):
                            v = v in (True, "true", "1", 1)
                        elif isinstance(cur, (int, float)):
                            v = type(cur)(float(v))
                        app.config[k] = v
                    self._json({"ok": True, "config": app.config})
                elif self.path == "/api/load_model":
                    path = json.loads(self._read_body()).get("path", "")
                    app.load_model(path)
                    self._json({"ok": True})
                elif self.path == "/api/convert":
                    if app.pipeline is None:
                        self._json({"error": "no model loaded"}, 409)
                        return
                    # load_wav handles every PCM dtype + mono-mixing
                    audio, sr = load_wav(io.BytesIO(self._read_body()))
                    out, stats = app.convert(audio, sr)
                    buf = io.BytesIO()
                    wavfile.write(
                        buf, int(app.config["samplerate"]),
                        (np.clip(out, -1, 1) * 32767).astype(np.int16),
                    )
                    body = buf.getvalue()
                    self._headers_sent = True
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Rtf", str(stats["rtf"]))
                    self.send_header("X-Block-Ms", str(stats["block_ms"]))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/api/stream/start":
                    try:
                        app.stream_start()
                        self._json({"ok": True})
                    except NotImplementedError as e:
                        self._json({"error": str(e)}, 501)
                elif self.path == "/api/stream/stop":
                    app.stream_stop()
                    self._json({"ok": True})
                elif self.path == "/api/workflow/config":
                    body = json.loads(self._read_body())
                    base = body.pop("base", "")
                    if not base:
                        self._json({"error": "no base config given"}, 400)
                        return
                    self._json({"ok": True,
                                "path": wf.derive_config(base, body)})
                elif self.path == "/api/workflow/start":
                    body = json.loads(self._read_body())
                    kind = body.get("kind", "")
                    target = body.get("config", "")
                    if kind not in wf.JOB_KINDS:
                        self._json({"error": f"unknown kind {kind!r}"}, 400)
                        return
                    try:
                        device = None if app.device is None else str(app.device)
                        app.jobs.start(kind, wf.job_argv(kind, target, device))
                        self._json({"ok": True, "kind": kind})
                    except RuntimeError as e:  # a job is still running
                        self._json({"error": str(e)}, 409)
                elif self.path == "/api/workflow/stop":
                    app.jobs.stop()
                    self._json({"ok": True})
                else:
                    self.send_error(404)
            except Exception as e:  # surface errors to the page
                if getattr(self, "_headers_sent", False):
                    # a response is already on the wire (e.g. the client
                    # aborted mid-download): never emit a second status line
                    self.close_connection = True
                    return
                self._json({"error": str(e)}, 500)

    return Handler


def serve(app: GuiApp, host: str = "127.0.0.1", port: int = 7860,
          background: bool = False, ready_cb=None) -> ThreadingHTTPServer:
    """``ready_cb(server)`` fires once the socket is bound (before the serve
    loop) — embedders/tests learn the real port when ``port=0`` and can stop
    the loop with ``server.shutdown()``."""
    server = ThreadingHTTPServer((host, port), make_handler(app))
    if ready_cb is not None:
        ready_cb(server)
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    print(f" [gui] http://{host}:{port}")
    server.serve_forever()
    return server
