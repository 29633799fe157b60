"""HTTP voice-change endpoint on the Python standard library (mirrors
ddsp_svc_tpu/cli/api.py: ``parse_multipart``, ``make_handler``,
``_strip_supervisor_args``, ``_Supervisor``, ``main``), the flask_api
contract:

POST /voiceChangeModel, multipart form data:
  sample        -- wav bytes
  fPitchChange  -- semitone shift (float)
  sSpeakId      -- speaker id (int)
  sampleRate    -- the response's sample rate
  [fSafePrefixPadLength; sample_method, sample_interval, skip_steps for
   the diffusion models; stream=1 for a chunked response through the
   realtime block engine]
-> the converted wav (PCM16). GET /health and /stats (the batchers'
counters) for monitoring.

  python -m ddsp_svc_tpu_torch.cli.api -m exp/model_N.ckpt [-p 6842] \\
      [--batch 8 --batch_wait_ms 5 --batch_buckets 128,256,512,1024] \\
      [--batch_i16 | --batch_mulaw] [--batch_f16_in] [--batch_pipeline 2] \\
      [--batch_encoder] [--batch_devices D] [--device_f0] \\
      [--audio_i16 | --audio_mulaw] [--voc_bf16] [--warmup] \\
      [--worker_max_requests N] [--worker_max_rss_mb MB] [--device cpu]

``--batch_devices D`` shards each batch's rows over the cards cuda:0 ..
cuda:D-1 (``BatchedSynth`` and ``BatchedEncoder`` with ``mesh``; with
``--device cpu``, over D CPU entries). A D above the cards this machine
has is refused: the port never serves on fewer cards than asked.

``--worker_max_requests N`` or ``--worker_max_rss_mb MB`` (either alone)
runs the recycling worker supervisor: this process owns the public socket
and starts no model and no CUDA context; it byte-splices each connection
to a worker process (``python -m ddsp_svc_tpu_torch.cli.api`` with the
same options on 127.0.0.1, port 0), which reports its port through a file
once the model is loaded, warmed and its kernels built. After N
connections, or above MB of resident memory, a fresh worker is started,
takes the new connections once it answers /health, and the old one is
terminated when its connections have drained. A supervised worker closes
each connection after one response, so the bound counts requests.
"""
from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

# set in a supervised worker's environment: one response per connection
SUPERVISED_ENV = "DDSP_SVC_TPU_TORCH_SUPERVISED"
ROOT = Path(__file__).resolve().parent.parent.parent


class Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog for bursts of
    concurrent clients (socketserver's default of 5 resets the rest) and
    handler threads that do not hold up shutdown."""

    request_queue_size = 128
    daemon_threads = True


def parse_multipart(body: bytes, content_type: str) -> dict:
    """A multipart/form-data body -> {field name: bytes} (stdlib email)."""
    from email import message_from_bytes
    from email.policy import HTTP

    msg = message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
        policy=HTTP)
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="Content-Disposition")
        if name:
            fields[name] = part.get_payload(decode=True)
    return fields


def _resample_host(audio: np.ndarray, orig: int, new: int, device) -> np.ndarray:
    from ..ops.resample import resample

    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)[None]
    return resample(x, orig, new)[0].cpu().numpy()


def make_handler(pipeline, default_kwargs: dict):
    """The request handler class of a server over ``pipeline``;
    ``default_kwargs`` go to every ``pipeline.infer`` (a request's own
    sampler fields win)."""
    from scipy.io import wavfile

    from ..features.audio import load_wav

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for the chunked streaming response; every other response
        # sets Content-Length
        protocol_version = "HTTP/1.1"
        # under the supervisor the recycle bound counts connections, so a
        # keep-alive client must not send many requests over one
        _close_per_request = bool(os.environ.get(SUPERVISED_ENV))

        def send_response(self, code, message=None):
            super().send_response(code, message)
            if self._close_per_request:
                self.send_header("Connection", "close")
                self.close_connection = True

        def do_GET(self):
            if self.path == "/health":
                body = {"status": "ok"}
            elif self.path == "/stats":
                batcher, enc_batcher = pipeline.batcher, pipeline.enc_batcher
                body = {"batching": batcher.stats() if batcher is not None else None,
                        "encoder_batching": (enc_batcher.stats()
                                             if enc_batcher is not None else None)}
            else:
                self.send_error(404)
                return
            payload = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path != "/voiceChangeModel":
                self.send_error(404)
                return
            self._headers_sent = False
            try:
                with torch.no_grad():  # grad mode is per thread
                    self._voice_change()
            except Exception as e:
                if self._headers_sent:  # never a second status line mid-stream
                    self.close_connection = True
                    return
                # one line: send_error puts the message in the status line
                msg = str(e).splitlines()[0][:200] if str(e) else type(e).__name__
                self.send_error(500, f"conversion failed: {msg}")

        def _voice_change(self):
            length = int(self.headers.get("Content-Length", 0))
            form = parse_multipart(self.rfile.read(length),
                                   self.headers["Content-Type"])

            def val(name, default):
                raw = form.get(name)
                return raw.decode().strip() if raw is not None else default

            wav_bytes = form["sample"]
            pitch = float(val("fPitchChange", 0.0))
            spk_id = int(float(val("sSpeakId", 1)))
            out_rate = int(val("sampleRate", 44100))
            pad = float(val("fSafePrefixPadLength", 0.0))
            # the diffusion fields (flask_api_diff.py:39-56); absent fields
            # leave the server's defaults
            extra = {}
            if "sample_method" in form:
                sm = val("sample_method", "None")
                extra["method"] = "pndm" if sm == "None" else "dpm-solver"
            if "sample_interval" in form:
                extra["speedup"] = int(float(val("sample_interval", 20)))
            if "skip_steps" in form:
                kstep = 1000 - int(float(val("skip_steps", 0)))
                if kstep < extra.get("speedup", 20):
                    kstep = 300
                extra["k_step"] = kstep
            audio, in_sr = load_wav(io.BytesIO(wav_bytes))
            model_sr = int(pipeline.args.data.sampling_rate)
            if val("stream", "0") not in ("0", "", "false") and out_rate == model_sr:
                return self._stream_convert(audio, in_sr, model_sr, spk_id,
                                            pitch, extra)
            out, sr = pipeline.infer(audio, in_sr, spk_id=spk_id, key_shift=pitch,
                                     silence_front=pad,
                                     **{**default_kwargs, **extra})
            if sr != out_rate:
                out = _resample_host(out, sr, out_rate, pipeline.device)
            buf = io.BytesIO()
            wavfile.write(buf, out_rate,
                          np.clip(out * 32767.0, -32768, 32767).astype(np.int16))
            payload = buf.getvalue()
            self._headers_sent = True
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _stream_convert(self, audio, in_sr, sr, spk_id, pitch, extra):
            """A chunked wav at the model's rate, block by block through the
            realtime engine (SOLA splicing), so the client reads while later
            blocks still convert."""
            from ..infer.realtime import RealtimeVC

            if in_sr != sr:
                audio = _resample_host(audio, in_sr, sr, pipeline.device)
            vc = RealtimeVC(pipeline, sample_rate=sr, spk_id=spk_id,
                            key_shift=pitch, **{**default_kwargs, **extra})
            bf = vc.block_frame
            n_blocks = int(np.ceil(len(audio) / bf)) or 1
            padded = np.pad(audio, (0, n_blocks * bf - len(audio)))
            data_bytes = 2 * len(audio)  # int16 mono
            self._headers_sent = True
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            chunk(b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt "
                  + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                  + b"data" + struct.pack("<I", data_bytes))
            sent = 0
            for i in range(n_blocks):
                seg = vc.process_block(padded[i * bf:(i + 1) * bf].astype(np.float32))
                take = min(len(seg), len(audio) - sent)
                if take > 0:
                    chunk(np.clip(seg[:take] * 32767.0, -32768, 32767)
                          .astype("<i2").tobytes())
                    sent += take
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *args):
            pass

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m ddsp_svc_tpu_torch.cli.api", allow_abbrev=False,
        description="Serve a checkpoint of the JAX package over HTTP on the "
                    "CUDA card (or --device cpu), with dynamic batching.")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-p", "--port", type=int, default=6842)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("-pe", "--pitch_extractor", default="yin")
    p.add_argument("--batch", type=int, default=0, metavar="N",
                   help="dynamic batching: up to N concurrent requests of one "
                        "(frame bucket, sampler settings) run as one forward")
    p.add_argument("--batch_wait_ms", type=float, default=5.0)
    p.add_argument("--batch_buckets", default="128,256,512,1024",
                   help="comma-separated frame buckets")
    p.add_argument("--batch_i16", action="store_true",
                   help="batch output to the host as int16")
    p.add_argument("--batch_mulaw", action="store_true",
                   help="batch output to the host as 8-bit mu-law")
    p.add_argument("--batch_f16_in", action="store_true",
                   help="host-staged units to the device as f16")
    p.add_argument("--batch_max_signatures", type=int, default=4,
                   help="distinct per-request sampler settings admitted to "
                        "batching; further ones run direct")
    p.add_argument("--batch_pipeline", type=int, default=1, metavar="K",
                   help="batches in flight (K >= 2: a delivery thread waits "
                        "for batch N while batch N + 1 launches)")
    p.add_argument("--batch_encoder", action="store_true",
                   help="batch the units encoder across requests too")
    p.add_argument("--batch_devices", type=int, default=1, metavar="D",
                   help="shard each batch's rows over the cards cuda:0 .. "
                        "cuda:D-1 (--batch divisible by D)")
    p.add_argument("--voc_bf16", action="store_true",
                   help="run the NSF-HiFiGAN (vocoder or enhancer) in bf16")
    p.add_argument("--device_f0", action="store_true",
                   help="the YIN f0 on the card (with --batch: in the "
                        "encoder's batch)")
    p.add_argument("--audio_i16", action="store_true",
                   help="request audio to the batched encoder as int16")
    p.add_argument("--audio_mulaw", action="store_true",
                   help="request audio to the batched encoder as 8-bit mu-law")
    p.add_argument("--warmup", action="store_true",
                   help="run every batching bucket before accepting traffic")
    p.add_argument("--worker_max_requests", type=int, default=0, metavar="N",
                   help="serve from a worker process, recycled (a fresh "
                        "process, drained hand-off, no downtime) after N "
                        "connections")
    p.add_argument("--worker_max_rss_mb", type=int, default=0, metavar="MB",
                   help="serve from a worker process, recycled when its "
                        "resident memory passes MB (alone or with "
                        "--worker_max_requests)")
    p.add_argument("--_port_file", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def batch_mesh(n_devices: int, device=None) -> list | None:
    """``--batch_devices``: None for one device, else the mesh the batchers
    shard rows over: cuda:0 .. cuda:D-1, or D CPU entries when ``device``
    is the CPU. More cards than this machine has is an error (JAX serves
    on the devices it finds; the port does not shrink a mesh unasked)."""
    if n_devices <= 1:
        return None
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    have = torch.cuda.device_count()
    if n_devices > have:
        raise ValueError(f"--batch_devices {n_devices}: this machine has "
                         f"{have} CUDA card(s)")
    return [torch.device("cuda", i) for i in range(n_devices)]


def parse_buckets(text: str) -> tuple[int, ...]:
    buckets = tuple(int(b.strip()) for b in text.split(",") if b.strip())
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"--batch_buckets: comma-separated positive frame "
                         f"counts, got {text!r}")
    return buckets


def configure(pipeline, cmd: argparse.Namespace) -> None:
    """The batching options of ``cmd`` applied to ``pipeline``."""
    if cmd.batch > 1:
        pipeline.enable_batching(
            buckets=parse_buckets(cmd.batch_buckets), max_batch=cmd.batch,
            max_wait_ms=cmd.batch_wait_ms,
            mesh=batch_mesh(cmd.batch_devices, cmd.device),
            max_signatures=cmd.batch_max_signatures,
            transfer="mulaw" if cmd.batch_mulaw else ("i16" if cmd.batch_i16
                                                      else "f32"),
            transfer_in="f16" if cmd.batch_f16_in else "f32",
            pipeline_depth=cmd.batch_pipeline, batch_encoder=cmd.batch_encoder,
            audio_in="mulaw" if cmd.audio_mulaw else ("i16" if cmd.audio_i16
                                                      else "f32"))
        if cmd.warmup:
            print("warming batch buckets ...", flush=True)
            pipeline.warmup_batching()


def _strip_supervisor_args(argv: list[str]) -> list[str]:
    """A worker's argv: the supervisor's own flags and the public port
    removed (the worker binds port 0 and reports it through
    ``--_port_file``)."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--worker_max_requests", "--worker_max_rss_mb", "-p",
                 "--port", "--_port_file"):
            skip = True
            continue
        if (a.startswith("--worker_max_requests=")
                or a.startswith("--worker_max_rss_mb=")
                or a.startswith("-p=") or a.startswith("--port=")
                or a.startswith("--_port_file=")):
            continue
        out.append(a)
    return out


class _Supervisor:
    """Serving workers of bounded lifetime (``--worker_max_requests``,
    ``--worker_max_rss_mb``).

    This process owns the public socket and byte-splices each connection
    to the current worker, a child ``python -m <worker_module>`` on
    127.0.0.1. Once a worker has taken ``max_requests`` connections, or
    its resident memory (``/proc/<pid>/statm``) passes ``max_rss_mb``, a
    fresh worker is started; it takes new connections once it has
    reported its port and answered /health, and the old worker is
    terminated after its connections drain. ``shutdown`` terminates every
    worker, a replacement still starting included. Nothing here loads a
    model or touches CUDA: the workers take ``--device`` from the argv.

    ``history`` holds one entry per worker: its generation, pid, seconds
    from spawn to healthy, connections served and resident MB when it was
    retired (None while it serves)."""

    worker_module = "ddsp_svc_tpu_torch.cli.api"  # a test stands in a stub
    rss_poll_s = 5.0  # between reads of the worker's resident memory
    drain_timeout_s = 600.0  # an old worker's connections end within it

    def __init__(self, port: int, worker_argv: list[str], max_requests,
                 spawn_timeout_s: float = 3600.0, max_rss_mb: int = 0,
                 host: str = "0.0.0.0"):
        self.worker_argv = list(worker_argv)
        self.max_requests = max_requests
        self.spawn_timeout_s = spawn_timeout_s
        self.max_rss_mb = int(max_rss_mb)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.server_address = self._sock.getsockname()
        self._lock = threading.Lock()
        self._stop = False
        self._current = None  # the worker taking new connections
        self._spawn_proc = None  # a replacement mid-spawn (shutdown kills it)
        self._retiring: list = []  # draining old workers (shutdown kills them)
        self._spawning = False
        self.generations = 0
        self.history: list[dict] = []

    # -- worker lifecycle -------------------------------------------------
    def _spawn_worker(self) -> dict:
        fd, port_file = tempfile.mkstemp(prefix="svc_api_port_", suffix=".txt")
        os.close(fd)
        os.unlink(port_file)  # the worker creates it by rename when ready
        env = dict(os.environ)
        env[SUPERVISED_ENV] = "1"
        # the worker imports what this process can
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
            [str(ROOT)] + [os.path.abspath(p) for p in sys.path if p]))
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", self.worker_module, *self.worker_argv,
             "--host", "127.0.0.1", "-p", "0", "--_port_file", port_file],
            env=env)
        with self._lock:
            self._spawn_proc = proc
        deadline = t0 + self.spawn_timeout_s
        port = None
        try:
            while time.monotonic() < deadline and not self._stop:
                if proc.poll() is not None:
                    raise RuntimeError(f"serving worker exited rc={proc.returncode} "
                                       "during startup")
                try:
                    with open(port_file) as f:
                        port = int(f.read().strip())
                    break
                except (OSError, ValueError):
                    time.sleep(0.2)
            # ready: the worker answers /health only after its model load,
            # warmup and kernel build, so no connection meets a cold worker
            while port is not None and not self._stop:
                if time.monotonic() >= deadline:
                    port = None
                    break
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/health", timeout=2.0):
                        break
                except (OSError, http.client.HTTPException):
                    if proc.poll() is not None:
                        raise RuntimeError(f"serving worker exited "
                                           f"rc={proc.returncode} before /health")
                    time.sleep(0.2)
            if port is None or self._stop:
                raise RuntimeError("serving worker stopped" if self._stop else
                                   "serving worker did not become healthy in "
                                   f"{self.spawn_timeout_s:g} s")
        except BaseException:
            self._end(proc)
            raise
        finally:
            with self._lock:
                self._spawn_proc = None
            for path in (port_file, port_file + ".tmp"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        with self._lock:
            self.generations += 1
            worker = {"proc": proc, "port": port, "served": 0, "active": 0,
                      "gen": self.generations}
            self.history.append({"gen": worker["gen"], "pid": proc.pid,
                                 "spawn_s": time.monotonic() - t0,
                                 "served": None, "rss_mb": None})
        return worker

    @staticmethod
    def _end(proc, timeout: float = 30.0) -> None:
        """Terminate ``proc`` and reap it (killed if it does not exit)."""
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def _retire(self, worker: dict) -> None:
        """Terminate ``worker`` once its connections drain."""
        rss = self.worker_rss_mb(worker)
        with self._lock:
            self._retiring.append(worker)
            entry = next(h for h in self.history if h["gen"] == worker["gen"])
            entry["served"], entry["rss_mb"] = worker["served"], rss
        print(f"retiring serving worker gen {worker['gen']} (pid "
              f"{worker['proc'].pid}, {worker['served']} connections, "
              f"RSS {rss:.1f} MB)", flush=True)

        def drain():
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if worker["active"] <= 0 or self._stop:
                        break
                time.sleep(0.05)
            self._end(worker["proc"])
            with self._lock:
                if worker in self._retiring:
                    self._retiring.remove(worker)

        threading.Thread(target=drain, daemon=True).start()

    @staticmethod
    def worker_rss_mb(worker: dict) -> float:
        """The worker's resident memory in MB (0 if it cannot be read)."""
        try:
            with open(f"/proc/{worker['proc'].pid}/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6
        except (OSError, ValueError):
            return 0.0

    def _maybe_recycle(self, force: bool = False, worker=None) -> None:
        with self._lock:
            if self._stop or self._spawning or self._current is None:
                return
            if worker is not None and self._current is not worker:
                return  # already swapped out by a count-triggered recycle
            if not force and self._current["served"] < self.max_requests:
                return
            self._spawning = True

        def swap():
            try:
                fresh = self._spawn_worker()
            except Exception as e:  # the old worker keeps serving
                with self._lock:
                    self._spawning = False
                if not self._stop:
                    print(f"worker recycle failed (keeping the old one): {e}",
                          flush=True)
                return
            with self._lock:
                old, self._current = self._current, fresh
                self._spawning = False
                stopped = self._stop
            if stopped:  # shutdown came during the spawn
                self._end(fresh["proc"])
                return
            print(f"recycled serving worker (gen {fresh['gen']}, pid "
                  f"{fresh['proc'].pid}, healthy after "
                  f"{self.history[-1]['spawn_s']:.2f} s)", flush=True)
            self._retire(old)

        threading.Thread(target=swap, daemon=True).start()

    # -- proxy ------------------------------------------------------------
    def _splice(self, client, worker: dict) -> None:
        try:
            backend = socket.create_connection(("127.0.0.1", worker["port"]),
                                               timeout=30)
            backend.settimeout(None)
        except OSError:
            client.close()
            with self._lock:
                worker["active"] -= 1
            return

        def pump(src, dst):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        back = threading.Thread(target=pump, args=(backend, client), daemon=True)
        back.start()
        pump(client, backend)
        back.join()
        for s in (client, backend):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            worker["active"] -= 1

    def _rss_monitor(self) -> None:
        """Recycle whenever the live worker's resident memory passes the
        cap (best effort: the old worker serves while the new one starts)."""
        while not self._stop:
            with self._lock:
                worker = self._current
            if worker is not None and self.worker_rss_mb(worker) >= self.max_rss_mb:
                self._maybe_recycle(force=True, worker=worker)
            time.sleep(self.rss_poll_s)

    def serve_forever(self) -> None:
        try:
            first = self._spawn_worker()
        except RuntimeError:
            if self._stop:
                return
            raise
        with self._lock:
            self._current = first
        print(f"supervised API on :{self.server_address[1]} (worker pid "
              f"{first['proc'].pid}, healthy after {self.history[0]['spawn_s']:.2f} "
              f"s, recycled every {self.max_requests} connections"
              + (f" or past {self.max_rss_mb} MB RSS" if self.max_rss_mb else "")
              + ")", flush=True)
        if self.max_rss_mb > 0:
            threading.Thread(target=self._rss_monitor, daemon=True).start()
        while not self._stop:
            try:
                client, _ = self._sock.accept()
            except OSError:
                break
            with self._lock:
                worker = self._current
                worker["served"] += 1
                worker["active"] += 1
            threading.Thread(target=self._splice, args=(client, worker),
                             daemon=True).start()
            self._maybe_recycle()

    def shutdown(self) -> None:
        """Stop accepting and terminate every worker (serving, draining, or
        still starting)."""
        self._stop = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            procs = [w["proc"] for w in ([self._current] if self._current else [])
                     + list(self._retiring)]
            if self._spawn_proc is not None:
                procs.append(self._spawn_proc)
        for proc in procs:
            self._end(proc)


def main(argv=None, ready_cb=None) -> None:
    """``ready_cb(server)``, if given, runs once the socket is bound and
    before ``serve_forever`` (a caller learns the port of ``-p 0`` and stops
    the server with ``server.shutdown()``); under the supervisor the server
    is the ``_Supervisor``."""
    cmd = parse_args(argv)
    if cmd.worker_max_requests > 0 or cmd.worker_max_rss_mb > 0:
        # no model and no CUDA context in this process: the workers have them
        sup = _Supervisor(
            cmd.port, _strip_supervisor_args(
                list(argv) if argv is not None else sys.argv[1:]),
            cmd.worker_max_requests if cmd.worker_max_requests > 0
            else float("inf"),
            max_rss_mb=cmd.worker_max_rss_mb, host=cmd.host)
        if ready_cb is not None:
            ready_cb(sup)
        if threading.current_thread() is threading.main_thread():
            # a terminated supervisor ends its workers (below), not orphans them
            signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
        try:
            sup.serve_forever()
        finally:
            sup.shutdown()
        return

    from ..infer.pipeline import SvcPipeline

    batch_mesh(cmd.batch_devices, cmd.device)  # refuse before loading
    pipeline = SvcPipeline(cmd.model_path, device=cmd.device,
                           pitch_extractor=cmd.pitch_extractor,
                           vocoder_bf16=cmd.voc_bf16, device_f0=cmd.device_f0)
    configure(pipeline, cmd)
    if pipeline.device.type == "cuda":
        from ..ops import kernels

        # built before the port is reported: a worker that follows loads
        # the finished library and never meets one being written
        kernels.library()
    server = Server((cmd.host, cmd.port), make_handler(pipeline, {}))
    print(f"voiceChangeModel API on :{server.server_address[1]}", flush=True)
    if cmd._port_file:
        # the supervised worker's handshake, after the load and warmup;
        # tmp + rename, so the supervisor never reads a partial number
        tmp = cmd._port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.server_address[1]))
        os.replace(tmp, cmd._port_file)
    if ready_cb is not None:
        ready_cb(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        pipeline.disable_batching()


if __name__ == "__main__":
    main()
