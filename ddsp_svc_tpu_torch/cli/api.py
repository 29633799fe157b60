"""HTTP voice-change endpoint on the Python standard library (mirrors
ddsp_svc_tpu/cli/api.py: ``parse_multipart``, ``make_handler``, ``main``),
the flask_api contract:

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
      [--batch_encoder] [--device_f0] [--audio_i16 | --audio_mulaw] \\
      [--voc_bf16] [--warmup] [--device cpu]

Refused, each naming the ROADMAP item that brings it: ``--batch_devices``
above 1 (multi-card batched serving) and the recycling worker supervisor
(``--worker_max_requests``, ``--worker_max_rss_mb``), which bounds a
tunnel client's upload leak that this serving path does not have.
"""
from __future__ import annotations

import argparse
import io
import json
import struct
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

BATCH_DEVICES_REFUSED = ("--batch_devices > 1 (multi-card batched serving) is "
                         "not ported yet (ROADMAP A item 12)")
SUPERVISOR_REFUSED = ("--worker_max_requests / --worker_max_rss_mb (the "
                      "recycling worker supervisor) are not ported yet "
                      "(ROADMAP A item 11)")


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
                   help="refused above 1: multi-card batching is not ported")
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
                   help="refused: the recycling worker supervisor is not ported")
    p.add_argument("--worker_max_rss_mb", type=int, default=0, metavar="MB",
                   help="refused: the recycling worker supervisor is not ported")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def check_ported(cmd: argparse.Namespace) -> None:
    """Refuse the JAX server's options this port does not have yet."""
    if cmd.batch_devices > 1:
        raise NotImplementedError(BATCH_DEVICES_REFUSED)
    if cmd.worker_max_requests > 0 or cmd.worker_max_rss_mb > 0:
        raise NotImplementedError(SUPERVISOR_REFUSED)


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


def main(argv=None, ready_cb=None) -> None:
    """``ready_cb(server)``, if given, runs once the socket is bound and
    before ``serve_forever`` (a caller learns the port of ``-p 0`` and stops
    the server with ``server.shutdown()``)."""
    from ..infer.pipeline import SvcPipeline

    cmd = parse_args(argv)
    check_ported(cmd)
    pipeline = SvcPipeline(cmd.model_path, device=cmd.device,
                           pitch_extractor=cmd.pitch_extractor,
                           vocoder_bf16=cmd.voc_bf16, device_f0=cmd.device_f0)
    configure(pipeline, cmd)
    server = Server((cmd.host, cmd.port), make_handler(pipeline, {}))
    print(f"voiceChangeModel API on :{server.server_address[1]}", flush=True)
    if ready_cb is not None:
        ready_cb(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        pipeline.disable_batching()


if __name__ == "__main__":
    main()
