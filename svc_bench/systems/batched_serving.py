"""The system under test of the serving cells: the port's ``SvcPipeline``
built as ``cli.api --batch N --batch_encoder --device_f0`` builds it, with
the benchmark's weights from the seed loaded into its models in place of a
checkpoint, served through ``SvcPipeline.infer`` (what ``cli.api``'s handler
calls).

How ``correct`` is decided here: the check follows the served path in two
stages, each against the plain reference (``svc_bench/reference``, float32,
TF32 off), from the same inputs and the same weights made again from the
seed, for the requests on the watch list (drawn from the seed before the
window: the longest request of the pool, one of each bucket, others at
random), each at its first admission:

- the front end by itself: the units, the f0 and the volume that the port's
  batched front end gave the request against the reference's, from the
  request's audio alone (each row of the masked batched encoder equals a
  solo encode);
- the synthesis over the very batch the port served it in: the batch's rows
  as the synthesis batcher received them (units, f0 and volume padded to the
  bucket, the dummy rows too), each row's draws from its seed, run through
  the reference's cascade and vocoder at that batch size, the request's row
  cut and masked as served, against the answer the port served. These
  inputs are the port's own front end's output: the first stage holds them
  to the reference.

The batch matters: the reference itself, run over one request alone and over
the batch that held it, differs by up to 5e-5 on some requests (f32 rounding
of other algorithms, amplified through the model), while the port and the
reference over the same batch agree within 6e-7 (PERF.md).
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from svc_bench import check, weights as W
from svc_bench.reference import request as ref
from svc_bench.trace import Spans


def sampler(cfg: dict) -> dict:
    """The configuration's sampler settings as ``SvcPipeline.infer`` takes
    them (what ``cli.api`` resolves from the same config by default)."""
    m, inf = cfg["model"], cfg["infer"]
    if m["type"] == "RectifiedFlow":
        return dict(infer_step=int(inf["infer_step"]), method=inf["method"],
                    t_start=float(m["t_start"]))
    return dict(k_step=int(m["k_step_max"]), speedup=int(inf["speedup"]),
                method=inf["method"])


def pipeline(cfg: dict, weights: dict, serve: dict, device, seed: int):
    """-> the port's pipeline with batching enabled at the mix's settings
    (not yet warmed up)."""
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.models.vocoder import Vocoder
    from ddsp_svc_tpu_torch.utils.config import DotDict

    voc = dict(cfg["vocoder"])
    args = DotDict({"data": dict(cfg["data"]), "model": dict(cfg["model"]),
                    "vocoder": {"type": voc.pop("type")}, "infer": dict(cfg["infer"])})
    model = build_model(args).to(device)
    model.load_state_dict(weights["model"], strict=True)
    vocoder = Vocoder(args.vocoder.type, voc).to(device)
    vocoder.load_state_dict(weights["vocoder"], strict=True)
    enc = cfg["encoder"]
    encoder = UnitsEncoder(enc["name"], encoder_sample_rate=enc["sample_rate"],
                           encoder_hop_size=enc["hop_size"], device=device, seed=seed)
    encoder.model.load_state_dict(weights["encoder"], strict=True)
    pipe = SvcPipeline.from_parts(model, None, args, vocoder, device=device,
                                  seed=seed, units_encoder=encoder,
                                  pitch_extractor=serve["pitch_extractor"],
                                  f0_min=serve["f0_min"], f0_max=serve["f0_max"],
                                  device_f0=serve["device_f0"])
    pipe.enable_batching(buckets=tuple(serve["buckets"]), max_batch=serve["max_batch"],
                         max_wait_ms=serve["max_wait_ms"],
                         batch_encoder=serve["batch_encoder"], **sampler(cfg))
    return pipe


def build(cfg: dict, mix: dict, seed: int, device) -> "System":
    return System(cfg, mix, seed, device)


class BatchTap:
    """Keeps the inputs of the first synthesis batch that holds each watched
    request (a device-side clone: nothing waits on the card) and the rows
    in it, by the request's seed."""

    def __init__(self, pipe, seeds: set):
        self.seeds, self.batches, self.at = set(seeds), [], {}
        batcher = pipe.batcher
        forward = batcher._forward

        def tapped(bucket, sig, units, f0, volume, spk, row_seeds, tframes):
            new = [i for i, s in enumerate(row_seeds)
                   if int(s) in self.seeds and int(s) not in self.at]
            if new:
                self.batches.append(dict(
                    units=torch.as_tensor(units).detach().clone(),
                    f0=torch.as_tensor(f0).detach().clone(),
                    volume=torch.as_tensor(volume).detach().clone(),
                    seeds=[int(s) for s in row_seeds],
                    frames=[int(t) for t in tframes]))
                for i in new:
                    self.at[int(row_seeds[i])] = (len(self.batches) - 1, i)
            return forward(bucket, sig, units, f0, volume, spk, row_seeds, tframes)

        batcher._forward = tapped
        self._undo = lambda: delattr(batcher, "_forward")

    def row(self, seed: int):
        """(batch, row index) of the request's first batch, or None."""
        at = self.at.get(int(seed))
        return None if at is None else (self.batches[at[0]], at[1])

    def close(self) -> None:
        self._undo()


def _spans(pipe) -> Spans:
    """The traced run's spans: ``layer.*`` around the model's calls,
    ``host.*`` around the serving threads' host work."""
    s = Spans()
    model = pipe.model
    denoiser = getattr(model, "denoise_fn", None) or getattr(model, "velocity_fn", None)
    s.on(pipe.units_encoder.model, "forward", "layer.encoder")
    s.on(model.ddsp_model, "forward", "layer.ddsp")
    s.on(pipe.vocoder, "extract", "layer.mel")
    if denoiser is not None:
        s.on(denoiser, "forward", "layer.denoiser")
        for layer in denoiser.layers:
            s.on(layer, "forward", "layer.conformer")
    s.on(pipe.vocoder, "infer", "layer.vocoder")
    enc = pipe.enc_batcher
    if enc is not None:
        s.on_factory(enc, "_f0_fn", "layer.f0")
        s.on(enc, "_run", "host.encoder_batch")
    s.on(pipe.batcher, "_run", "host.synth_batch")
    s.on(pipe.batcher, "_finish", "host.synth_deliver")
    s.on(pipe, "volume_and_mask", "host.volume")
    from ddsp_svc_tpu_torch.models import nsf_hifigan

    s.on(nsf_hifigan, "resblock_group", "layer.resblocks")
    return s


def _front_errs(got_units, got_f0, units, f0, t: int, got_vol=None, vol=None) -> dict:
    """The front end's readings over the request's real frames: the units'
    relative L2 error, the f0's largest relative error on any frame, the
    volume's relative L2 error where given, and ``front``, the largest of
    them (TF32 moves the units; it leaves the YIN's f0 and the host's volume
    as they are, so neither has a reading of its own to fail)."""
    gu = got_units[0, :t].float().cpu().numpy() if got_units is not None else None
    out = {"units": check.rel_err(gu, units[0, :t].cpu().numpy())}
    if vol is not None:
        out["volume"] = check.rel_err(got_vol, vol)
    if got_f0 is None:
        out["f0"] = check.MISSING
    else:
        a = got_f0[0, :t, 0].double().cpu().numpy()
        b = f0[0, :t, 0].double().cpu().numpy()
        out["f0"] = (float(np.max(np.abs(a - b) / b)) if np.all(np.isfinite(a))
                     else check.MISSING)
    out["front"] = max(out.values())
    return out


def _served(weights, cfg, batch, i: int, audio, device) -> np.ndarray:
    """The reference's answer for row i of a served batch: the batch run
    whole, the row cut to its frames and masked by its volume gate."""
    block, hop = cfg["data"]["block_size"], cfg["vocoder"]["hop_size"]
    units, f0, vol = (batch[k].to(device).float() for k in ("units", "f0", "volume"))
    out = ref.synthesize_rows(weights, cfg, units, f0, vol, batch["seeds"],
                              batch["frames"], device)
    t = batch["frames"][i]
    out = out[i, : t * hop].cpu().numpy()
    mask = ref.lerp_mask(ref.gate(ref.volume(np.asarray(audio, np.float32), block)), block)
    return (out * mask[: out.shape[-1]]).astype(np.float32)


class System:
    """One cell's pipeline, from set-up to the check."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.serve_cfg = mix["serve"]
        self.sample_rate = cfg["data"]["sampling_rate"]
        self.out_rate = cfg["vocoder"]["sampling_rate"]
        self.settings = sampler(cfg)
        self.pipe = pipeline(cfg, W.make(cfg, seed, device), self.serve_cfg, device,
                             seed)
        self.tap: BatchTap | None = None
        self.spans: Spans | None = None
        self.counters: dict = {}

    def warm(self) -> None:
        """Every bucket at every slot count of both batchers: the shapes the
        cell's traffic uses."""
        self.pipe.warmup_batching()

    def reseed(self, seed: int) -> None:
        """Another seed's weights, loaded in place (the packed copies follow)."""
        self.seed = int(seed)
        w = W.make(self.cfg, seed, self.device)
        with torch.no_grad():
            self.pipe.model.load_state_dict(w["model"], strict=True)
            self.pipe.vocoder.load_state_dict(w["vocoder"], strict=True)
            self.pipe.units_encoder.model.load_state_dict(w["encoder"], strict=True)

    def serve(self, request, seed: int) -> np.ndarray:
        """One request, blocking: the converted audio on the host."""
        with torch.no_grad():
            out, _ = self.pipe.infer(request.audio, self.sample_rate,
                                     spk_id=self.mix["speaker"],
                                     key_shift=self.mix["key_shift"], seed=seed,
                                     **self.settings)
        return out

    def watch(self, requests: list, n: int, seed: int) -> set:
        """Pool indices to check: the longest request, one of each bucket,
        then others drawn from the seed, n in all (or the whole pool)."""
        rng = np.random.default_rng(int(seed) ^ 0x5EED)
        block = self.cfg["data"]["block_size"]
        frames = [len(r.audio) // block + 1 for r in requests]
        pick = {int(np.argmax(frames))}
        by_bucket: dict = {}
        for i, f in enumerate(frames):
            by_bucket.setdefault(ref.bucket_for(f, self.serve_cfg["buckets"]), []).append(i)
        for b in sorted(by_bucket):
            pick.add(int(rng.choice(by_bucket[b])))
        rest = [int(i) for i in rng.permutation(len(requests)) if int(i) not in pick]
        pick.update(rest[: max(0, n - len(pick))])
        return pick

    def open_window(self, watch_seeds: set, traced: bool) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pipe.batcher.reset_stats()
        if self.pipe.enc_batcher is not None:
            self.pipe.enc_batcher.reset_stats()
        self.tap = BatchTap(self.pipe, watch_seeds)
        self.spans = _spans(self.pipe) if traced else None

    def close_window(self) -> None:
        self.tap.close()
        if self.spans is not None:
            self.spans.close()
        self.counters = self.pipe.batcher.stats()

    def release(self) -> None:
        """Free the program's state; the tapped batches stay for the check."""
        self.pipe.disable_batching()
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, picked: list) -> list[dict]:
        """Each watched request's readings, from weights made again: its
        front end against the reference's, its answer against the reference
        over its batch."""
        check.precision(False)
        weights = W.make(self.cfg, self.seed, self.device)
        block = self.cfg["data"]["block_size"]
        out = []
        for d in picked:
            audio, t = d.request.audio, len(d.request.audio) // block + 1
            units, f0 = ref.front_end(weights, self.cfg, self.serve_cfg, audio,
                                      self.device)
            found = self.tap.row(d.seed)
            if found is None or d.output is None:
                out.append({"units": check.MISSING, "f0": check.MISSING,
                            "volume": check.MISSING, "front": check.MISSING,
                            "synth": check.MISSING})
                continue
            batch, i = found
            row = _front_errs(batch["units"][i:i + 1], batch["f0"][i:i + 1], units, f0, t,
                              batch["volume"][i, :t, 0].double().cpu().numpy(),
                              ref.volume(np.asarray(audio, np.float32), block))
            row["synth"] = check.rel_err(d.output, _served(weights, self.cfg, batch, i,
                                                           audio, self.device))
            out.append(row)
        return out

    def control(self, picked: list) -> list[dict]:
        """The control's readings: the reference in TF32, the nearest
        precision below the configuration's float32, in the program's place,
        on the same requests: its front end against the float32 reference's,
        and its run over the served batch against the float32 reference's
        run over it."""
        weights = W.make(self.cfg, self.seed, self.device)
        block, dev = self.cfg["data"]["block_size"], self.device
        out = []
        try:
            for d in picked:
                found = self.tap.row(d.seed)
                if found is None:
                    continue
                batch, i = found
                audio, t = d.request.audio, len(d.request.audio) // block + 1
                check.precision(False)
                units, f0 = ref.front_end(weights, self.cfg, self.serve_cfg, audio, dev)
                want = _served(weights, self.cfg, batch, i, audio, dev)
                check.precision(True)
                units_c, f0_c = ref.front_end(weights, self.cfg, self.serve_cfg, audio, dev)
                got = _served(weights, self.cfg, batch, i, audio, dev)
                row = _front_errs(units_c, f0_c, units, f0, t)
                row["synth"] = check.rel_err(got, want)
                out.append(row)
        finally:
            check.precision(False)
        return out
