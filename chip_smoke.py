#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card:
every model family (DiffusionFast, RectifiedFlow, Diffusion, DiffusionNew
and the DDSP family with Sins and its NSF-HiFiGAN enhancer), from features,
from a recording, through the offline CLI and through the realtime engine,
the kernels' gradients, the bf16 vocoder, batched serving through the HTTP
server, training from preprocess to checkpoint and resume, the f0
front end (RMVPE, CREPE, FCPE, the host trackers), time-sharded
streaming over ranks that share the card, multi-process training
(data-parallel cli.train and cli.train_vocoder, the sequence-parallel
step, model.use_remat), upstream checkpoints, batch inference and export,
the last tools: ONNX export, the web GUI and the C++ batch prefetcher, and
batched serving sharded over a mesh, the recycling worker supervisor and
the NCCL backend.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is swallowed):
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build the hand-written kernels from ddsp_svc_tpu_torch/csrc (one nvcc
     per source, started together), print nvcc's -Xptxas -v lines, count
     the tensor-core instructions (HMMA/HGMMA) in the SASS of K2's, K2's
     bf16 class's, K3's and K3's bf16 class's (B3) kernels (none fails the
     run), and print the opcode mix of K1's and K4's kernels as compiled;
  3. each kernel against its plain PyTorch version on the card at the
     shapes of the 10 s request, with the tolerance stated, and its time
     beside the plain version's and the bound (K2 per stage and K3 with
     both bounds: f32 FMA at 67 TFLOP/s and split TF32 at 494.7 / 3). K2
     and K3 are timed by CUDA events over back-to-back calls; K1 and K4,
     whose calls are shorter than a host launch, by replaying 200 calls
     captured in one CUDA graph, cross-checked by torch.profiler's device
     time. K1 also at a ten-minute input, with the host wall and device
     operations of one combtooth() call; K4 also at B = 2; K2's bf16 class
     (B4, the fused kernel) at the four stages it serves (C = 128 ... 16)
     of the 10 s request and at B = 8 rows of the 1024-frame bucket, within
     1 bf16 ulp + 2^-7 x max|out| per element and <= 2 % of the elements
     beyond 1 ulp, its time beside the plain version's and the dense-bf16
     bound, and the bytes its launch plan moves per stage; B3 (K3's
     bf16 class) at the 10 s shapes and at the training shapes (B 48 x T
     172) within ``bf16_layer_agreement`` of its plain version, the kernel
     and both plain versions (card, CPU) against float64 sums and two
     planted extra bf16 roundings failing, > 35 dB from K3's f32 output,
     its device time (CUDA graph replay; also CUDA events over
     back-to-back calls) beside the plain version's and the bound (GEMMs
     at the dense bf16 rate, the depthwise conv at f32);
  4. the DiffusionFast path at configs/diffusion-fast.yaml widths (6 x 512
     trunk, k_step 100, DPM-Solver++ with speedup 10, the default
     NSF-HiFiGAN) with random weights from a seeded torch.Generator:
     requests of 2, 5 and 10 s through SvcPipeline.infer_features (one cold
     and WARM_RUNS (3) warm runs each, then one warm 10 s run under torch.profiler
     for the device-time breakdown), checking each output and the kernel
     launch counts of every run;
  5. its 2 s request on the card (kernels, TF32 off) against the same
     request on the CPU (plain versions) with the same weights and noise;
  6. the Sins path at configs/sins.yaml widths (n_unit 768, 128 harmonics,
     256 all-pass and 80 noise bins, a 3-layer PCmer) with the default
     NSF-HiFiGAN as its enhancer, served as phase 4 serves DiffusionFast;
  7. Sins at 2 s, card against CPU with the same weights and injected
     noise, and CombSubFast, CombSub and standalone CombSubSuperFast at 2 s
     without the enhancer, each at the same SNR bound;
  8. both paths from a wav: SvcPipeline.infer with the full contentvec768l12
     units encoder both configs name (random weights from the seed) and
     host YIN, on synthetic 44.1 kHz recordings with a pitch contour of 2,
     5 and 10 s (one cold and WARM_RUNS warm runs each: median, min, max, real-
     time factor), the launch counts of every run checked (DiffusionFast:
     K1 1, K2 5, K3 60; Sins: K4 1, K2 5); one warm 10 s request's host
     wall per stage (encoder, f0, volume/mask, model, vocoder or enhancer)
     with a synchronize() at each boundary; one warm 10 s request under
     torch.profiler with the encoder's kernels as their own group; and the
     10 s DiffusionFast request with the device YIN (device_f0), its wall
     beside the host YIN's and its f0 against the host's (identical
     voicing, < 0.05 cents);
  9. the 2 s recording through SvcPipeline.infer on the card and on the CPU
     with the same weights and injected noise: the units' error and the
     audio SNR (>= 40 dB) for both paths;
 10. the offline CLI's conversion (cli.infer.convert, on the pipelines in
     memory; phase 18 runs cli.infer.main from files) of a 12 s recording
     with two silences, so the slicer cuts it and the splice runs, for both
     paths: the output length as the JAX CLI computes it, finite audio,
     launches = segments x the per-request counts, and a PCM16 file written
     and read back;
 11. one 2 s DiffusionFast request per other sampler (ddim, pndm, unipc at
     speedup 10; the DDPM chain at k_step 100), K3's launches checked;
 12. gradients: K2 (its C = 256 stage), K3, B3 and K4 at the 10 s shapes
     with grad on, the forward (1e-4 x max|out|; B3 by its bf16 agreement)
     and every input's and weight's .grad (1e-4 x max|grad|) against plain
     autograd on the card (B3's backward is the f32 chain's), one kernel
     launch per forward and none in the backward; K1 refuses an f0 that
     requires grad;
 13. the rectified flow at configs/reflow.yaml widths (6 x 512 velocity
     net): 10 s requests from features and from a wav with euler 20 and
     rk4 5 at t_start 0.7, served as phase 4 serves DiffusionFast (K1 1,
     K3 120, K2 5 per request), and card vs CPU from features at 2 s;
 14. Unit2Mel and Unit2Wav at configs/diffusion.yaml and
     diffusion-new.yaml widths (20 x 512 WaveNets): one 10 s request each
     (K2 5, no K1 or K3) and card vs CPU; cli.infer.convert with -ddsp and
     -fs (Unit2Mel seeded by an external CombSubSuperFast) and with -mix
     (Unit2Wav, two speakers); a rectified-flow request with a random
     'nsf-hifigan-log10' ResBlock2 vocoder (plain convs: no K2), served
     as the others and card vs CPU at 2 s;
 15. RealtimeVC on the card (0.3 s blocks, 2 s of extra context, 5 s of a
     synthetic voice) for the DiffusionFast, rectified-flow and Sins
     pipelines from a wav: block walls as drive_blocks measures them,
     launches per block, and the first blocks against the port on the CPU
     with the same blocks and noise;
 16. the NSF-HiFiGAN in bf16 (vocoder_bf16): a 10 s DiffusionFast request
     (K1 1, K3 60, B4 4, K2 0) and a 10 s Sins request with a bf16
     enhancer, each against its f32 pipeline (>= 25 dB) with warm walls of
     both, card against CPU with bf16 on both (>= 40 dB), and
     cli.infer.convert with --voc_bf16;
 17. batched serving at diffusion-fast widths with contentvec768l12 and
     host YIN (enable_batching, buckets 128/256/512/1024, max_batch 8):
     (a) eight concurrent requests of one bucket, each row >= 80 dB against
     the same request (same seed) served alone, launches exactly K1 1, K2 5,
     K3 60 per batch; (b) the HTTP server (cli.api.make_handler on
     127.0.0.1): 16 concurrent POSTs, /health and /stats, a request past the
     largest bucket (direct), stream=1 (chunked), the i16 and mu-law
     transfers against f32, a server with voc_bf16 and one with the fused
     front end (batch_encoder, device_f0); (c) seconds of audio per wall
     second at concurrency 1, 4, 8 and 16 (and 8, 16 with the fused front
     end), and the device's busy share of one profiled round of each;
 18. training on the card at config widths, random weights from the seed:
     (a) ten synthetic 3-5 s recordings and two for validation, written to a
     temporary data/; cli.preprocess on the card (contentvec768l12 with
     random weights, YIN); cli.train.main from a copy of
     configs/diffusion-fast.yaml written by the port's config writer (paths
     and intervals changed; batch 48, 2 s crops, lr 2e-4): 20 steps with
     saves at 10 and 20, retention and validation, then a second
     cli.train.main that resumes at step 20 for 5 steps; launches exactly K1
     1 and K3 6 per step (none in the backward), finite losses;
     cli.infer.main on the saved checkpoint and config; (b) DiffusionFast
     with the bf16 trunk through train.solver.train (B3 6, K3 0 per step),
     then a 10 s request with it (B3 60, K3 0) against the same request on
     the f32 trunk; (c) three steps of Sins (K4 1), RectifiedFlow (K1 1, K3
     6), Unit2Mel and Unit2Wav (no kernel) at their configs' widths and
     batch sizes; (d) one DiffusionFast and one Sins step at batch 4 on the
     card against the port on the CPU with the same batch, parameters and
     draws: the loss and every gradient; (e) step times (median, min, max of
     the warm steps), samples and audio seconds per second, peak memory, and
     the device's busy share of one profiled DiffusionFast step;
 19. bf16 mixed-precision training on phase 18's corpus: (a)
     configs/diffusion-new-bf16.yaml as shipped (DiffusionNew 20 x 512,
     batch 48, 2 s crops, amp_dtype bf16) through cli.train.main for 20
     steps, then 5 after a resume, with float32 parameters; (b)
     DiffusionFast with amp_dtype bf16 through cli.train.main for 20 steps,
     exactly B5 6 and K1 1 per step (none in the backward, K3 and B3 none);
     (c) the f32 run from the same weights, batches and draws, its losses
     against the bf16 run's within BF16_BAND each step, and step times and
     peak memory, bf16 beside f32, for DiffusionFast and DiffusionNew; (d)
     three bf16 steps each of RectifiedFlow (B5 6, K1 1), Sins (K4 1),
     CombSubFast and Unit2Mel; (e) one bf16 DiffusionFast step at batch 4,
     card (B5) against CPU (its plain version), within the stated limits;
 20. NSF-HiFiGAN GAN training at configs/nsf-hifigan.yaml's full width
     (512 initial channels, rates 8, 8, 2, 2, 2, MPD + MSD, batch 16 x 0.5
     s crops) on phase 18's corpus: (a) cli.train_vocoder.main for 10
     iterations and a save, then 5 after a resume, K2 exactly once per
     stage in each step (10 per iteration); iteration times (median, min,
     max), samples per second and peak memory; (b) the device's busy share
     of one profiled iteration and K2's part of it; (c) one discriminator
     step and one generator step at batch 2, card against CPU, within the
     stated limits; (d) K2 per stage at the training shapes with its bound,
     B1's backward (the plain chain) and the repacking of a weight-normed
     generator's weights;
 21. the f0 front end, every net at full width from a weights file the
     port writes in the JAX package's format (random weights from a seed):
     (a) E2E0(4, 1), CREPE full and CFNaiveMelPE(512, 6) on 10 s of 44.1
     kHz audio, card against CPU (salience within F0_SALIENCE_TOL; decoded
     f0 within F0_CENTS_TOL on the frames whose top salience clears its
     runner-up by F0_DECISIVE; CREPE on its first CREPE_CPU_SECONDS), with
     the card's walls; (b) SvcPipeline.infer with pitch_extractor='rmvpe'
     on diffusion-fast from a 10 s wav, the drawn RMVPE's output bias
     raised at 220 Hz so the decoded f0 is decisive: exactly K1 1, K3 60,
     K2 5 a request, the RMVPE share of the warm wall, card against CPU
     >= 40 dB on 2 s; (c) cli.infer.main -pe rmvpe and -pe fcpe on a 10 s
     wav; (d) the walls of the host DIO, Harvest and praat on 10 s;
 22. time-sharded streaming (parallel/ over torch.distributed, gloo, the
     ranks sharing cuda:0): (a) configs/combsub.yaml CombSubSuperFast at
     worlds 2 and 4, configs/sins.yaml Sins, the diffusion-fast cascade mel
     (DPM-Solver++ at speedup 10) and the default NSF-HiFiGAN on 10 s,
     each streamed against the port's whole reference on the card within
     STREAM_LIMITS, exact launches on every rank gathered to rank 0 (K1 1,
     K4 1, K1 1 with K3 0, K2 5), and card against CPU ranks on the same
     10 s (>= 40 dB); (b) cli.infer.main --stream 2 on a 12 s wav for combsub and sins
     against the same CLI without --stream outside the last FRAME_HALO
     frames of each segment; (c) streamed and whole walls, WARM_RUNS warm runs;
 23. multi-process training, the ranks launched as torchrun launches them
     (``parallel/launch.py``; each rank is this script with ``--rank``,
     recording every step's wall, launches and loss terms) and sharing
     cuda:0 over gloo: (a) cli.train on configs/diffusion-fast.yaml at full
     width (batch 48, 24 rows a rank, 2 s crops), 10 steps on 2 ranks
     against 1 rank (the losses step by step, the saved parameters), the
     ranks bit for bit, rank 0 alone saving model_10.ckpt, both ranks
     resuming from it, K1 1 and K3 6 on each rank each step, the step
     walls and the gradient all-reduce's bytes and share; (b) the same for
     cli.train_vocoder on configs/nsf-hifigan.yaml (batch 16, 5
     iterations, K2 5 in each step on each rank); (c) the sequence-
     parallel cascade step (parallel/train_sp.py) at full width, dp x sp =
     1 x 2, batch 8 x 688 frames, against the dense step on the card with
     the same draws (K1 1, K3 0 a rank; peak memory per rank); (d)
     model.use_remat: a DiffusionFast step's gradients against the same
     step without it, K3 12 a step, peak memory;
 24. upstream checkpoints, cli.batch_infer and cli.export: (a) synthetic
     upstream files drawn from a seed at the published widths
     (``tests/torch_convert_helpers.py``: configs/diffusion-fast.yaml's
     DiffusionFast, configs/sins.yaml's Sins, configs/nsf-hifigan.yaml's
     NSF-HiFiGAN with its config.json, a fairseq contentvec768l12, RMVPE),
     each saved in upstream's wrapper and converted by
     ``python -m ddsp_svc_tpu_torch.convert``'s ``main``; every file loads
     strictly through the port's loaders; the converted pipeline's 10 s
     diffusion-fast request on the card against the CPU (>= 40 dB); (b)
     cli.batch_infer on the card over a nested tree of four wavs (2, 5, 10
     and 12 s) with the converted model, vocoder, encoder and -pe rmvpe:
     the output tree mirrors the input, each file bit for bit
     SvcPipeline.infer alone with its seed (ROADMAP C(kk)), exactly K1
     1, K3 60, K2 5 a file, the wall per file and per second of audio;
     (c) cli.export of the converted diffusion-fast checkpoint at
     --seconds 10 -kstep 100 and of the converted Sins, traced on the card,
     and the diffusion-fast traced from CPU inputs, each loaded with
     load_exported(..., "cuda"): per call exactly K1 1 and K3 60 (Sins K4
     1) and no plain version, the output against the eager model on the
     card with the same draws within EXPORT_REL_TOL of its peak, the export
     seconds, the artifact's MB, the artifact's and the eager call's walls;
 25. the last tools: (a) ``cli.export_onnx --check`` of a random
     configs/diffusion.yaml Unit2Mel (20 x 512 WaveNet, n_hidden 256,
     k_step_max 1000) on the card: the four graphs' export seconds and MB,
     and the PNDM chain through them (the numpy ONNX runtime) against the
     card's eager model >= 60 dB, no kernel launched; (b) the web GUI
     (``gui.GuiApp`` on 127.0.0.1:0): /api/load_model of a random
     configs/diffusion-fast.yaml checkpoint written by the port's saver,
     /api/convert of a 5 s recording at 44.1 kHz and at 16 kHz through the
     realtime engine (0.3 s blocks, 2 s of context): status, length, the
     X-Rtf and X-Block-Ms headers, exactly phase 15's launches per block
     over the blocks and the two warmup calls, and the output >= 80 dB
     against the engine driven directly on the same pipeline and request
     seeds (bit for bit expected); (c) cli.train of configs/combsub.yaml's
     CombSubSuperFast on phase 18's corpus with cache_all_data false, which
     takes the C++ prefetcher (the JAX solver's choice for an uncached
     corpus without mels), then with BatchSampler reading the files and
     with the corpus cached, then prefetched again: every batch bit for bit
     the same, exactly K1 1 per step, and each run's batch wait and step
     wall;
 26. (a) BatchedSynth and BatchedEncoder on a mesh of MESH x cuda:0
     (``enable_batching(mesh=, batch_encoder=True)`` on diffusion-fast
     from a wav, host YIN): eight concurrent requests of 2-10 s, one
     untimed round and one timed, on one device, on the mesh and on the
     mesh with pipeline_depth 2; exactly MESH x (K1 1, K2 5, K3 60) a
     batch; every row >= 80 dB (BATCH_ROW_SNR_DB) from the same request
     (same seed) on the single-device engine; the rounds' walls; with two
     or more cards also cli.api --batch_devices 2 (else said unmeasured);
     (b) ``python -m ddsp_svc_tpu_torch.cli.api --worker_max_requests 3``
     as a process on a random configs/diffusion-fast.yaml checkpoint,
     eight sequential 2 s POSTs across two recycles (each POST after a
     worker's third waits for the swap): each 200 and >= 80 dB from the
     in-process server (phase 17's handler, cli.api's defaults) over the
     same checkpoint; nvidia-smi --query-compute-apps never lists the
     supervisor, which holds no /dev/nvidia* open; the retired workers end
     and memory.used after two recycles is within 1.5 x one worker's;
     spawn-to-healthy times, RSS before each recycle, the first POST's
     wall after a hand-off against the steady median; (c) world_backend:
     NCCL for 1 rank on the card, gloo for 2 ranks sharing it; a 1-rank
     NCCL world's psum, all_gather, psum_flat, broadcast (real and
     complex) and replicate on cuda tensors against a 1-rank gloo world's,
     bit for bit, and NCCL's own all_reduce and all_gather_into_tensor;
     the 2-rank NCCL step said unmeasured on one card.
Phase 3 also holds K4's bf16-amplitude mode (the bf16 Sins: amplitudes
upsampled in bf16) to its plain version within 3e-5, timed as K4.
Phase 3 also holds B5 (K3's bf16 class on bf16 activations) to its plain
version by ``bf16_io_agreement`` at B 48 x T 172 and B 1 x T 862 (cond
f32 and bf16 at both), the kernel and both plain versions against float64
sums with two planted faults failing, with its device time by CUDA graph
replay, each of its three launches' device time (torch.profiler) and its
bound. Then B3 and B5 run once on every visible card at B 48 x T 172 with
cuda:0 left current (the wrappers make the tensor's card current; the C
launchers raise the kernels' shared-memory limit once per card), each held
to its plain version on that card; with one card the second is said
unmeasured.
It then prints one JSON line describing the kernels and, last, one JSON
line {"ok": true, "device": {...}}. TF32 is off for the whole run.
"""
from __future__ import annotations

import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 1234
SR, BLOCK, WIN = 44100, 512, 2048
REQUEST_SECONDS = (2, 5, 10)
WARM_RUNS = 3
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM f32, outside the tensor cores
# f32 accuracy on the tensor cores: split TF32, three MMAs per product at
# the dense TF32 rate (494.7 TFLOP/s), K2's and K3's route
PEAK_TF32X3_FLOP_PER_S = 494.7e12 / 3
PEAK_BF16_FLOP_PER_S = 989.4e12  # dense bf16 on the tensor cores: B4 and B3
K2_KERNEL_SIZES = (3, 7, 11)
K2_DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
K2_STAGES = ((256, 8), (128, 64), (64, 128), (32, 256), (16, 512))  # (C, L/T)
SINS = dict(n_harmonics=128, n_mag_allpass=256, n_mag_noise=80)  # sins.yaml
# the repo ships no CombSub config: the legacy combsub schema's widths
COMBSUB = dict(n_mag_allpass=256, n_mag_harmonic=512, n_mag_noise=256)
SNR_LIMIT_DB = 40.0
ENCODER = "contentvec768l12"  # every config's encoder
N_UNIT = 768  # its width, every config's encoder_out_channels
# (method, speedup, K3 launches per request: 6 layers x denoiser calls)
SAMPLERS = (("ddim", 10, 60), ("pndm", 10, 66), ("unipc", 10, 60),
            ("dpm-solver", 1, 600))  # speedup 1: the full DDPM chain
CLI_SILENCES = ((5.3, 5.9), (10.6, 11.2))  # seconds of a 12 s recording
# configs/reflow.yaml, configs/diffusion.yaml, configs/diffusion-new.yaml
REFLOW = dict(type="RectifiedFlow", win_length=WIN, n_layers=6, n_chans=512,
              use_pitch_aug=True, t_start=0.7)
UNIT2MEL = dict(type="Diffusion", n_layers=20, n_chans=512, n_hidden=256,
                use_pitch_aug=True, k_step_max=1000)
UNIT2WAV = dict(type="DiffusionNew", n_layers=20, n_chans=512, k_step_max=100,
                use_pitch_aug=True, pcmer_norm=False)
# (sampler, infer_step): the config's euler 20 at t_start 0.7, and rk4 5;
# K3 launches per request: 6 layers x 20 velocity calls either way
REFLOW_SAMPLERS = (("euler", 20), ("rk4", 5))
EXPECT_REFLOW = {"combtooth": 1, "resblock_group": 5, "conformer_layer": 120,
                 "harmonic_bank": 0}
EXPECT_WAVENET = {"combtooth": 0, "resblock_group": 5, "conformer_layer": 0,
                  "harmonic_bank": 0}
GRAD_TOL = 1e-4  # x max|grad|: the forward tolerance of K2 and K3
# each kernel's design for the H100, as the kernels line names it
REDESIGNED = {
    "combtooth": "one launch, frame increments carried by a look-back scan",
    "resblock_group": "wgmma in split TF32, one launch per conv",
    "resblock_group_bf16": "fused on the SM: a tile and its halo through the "
                           "stage (a conv pair at C = 128), TMA + wgmma bf16",
    "conformer_layer": "mma.sync in split TF32",
    "conformer_layer_bf16": "TMA + wgmma bf16, three launches, h and s in "
                            "bf16, the depthwise conv in GEMM 2's epilogue; "
                            "from M = 4096 that launch persistent, two "
                            "consumer warpgroups in ping-pong down a run of "
                            "row tiles",
    "conformer_layer_bf16_io": "B3's three TMA + wgmma launches on bf16 x "
                               "and out (cond by TMA when bf16), the "
                               "persistent ping-pong GLU + depthwise launch "
                               "from M = 4096",
    "harmonic_bank": "three-term recurrence over harmonics; the bf16-"
                     "amplitude mode's upsample in packed bf16x2"}
MIX = {1: 0.5, 2: 0.5}
# phase 18: the run's sizes, and the card-vs-CPU limits for one training
# step, stated before its first run: the loss relative, the gradients as
# L2 over every leaf (all and each) relative to the CPU's. The RSS loss and
# the log-mel weight near-zero bins by 1 / |S| (tests/test_torch_train_
# losses.py), so a few elements of a gradient carry the FFTs' rounding: an
# L2 measure, not a max; a DDSP synth's gradients are held under a linear
# loss (``train_card_vs_cpu``).
TRAIN_STEPS, RESUME_STEPS, BF16_STEPS, FAMILY_STEPS = 20, 5, 10, 3
TRAIN_FILES, VAL_FILES = 10, 2
CARD_CPU_BATCH = 4
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_LEAF_TOL = 1e-2
BF16_TRUNK_SNR_DB = 30.0
RT = dict(block_time=0.3, crossfade_time=0.04, extra_time=2.0)
RT_SECONDS, RT_CPU_BLOCKS = 5.0, 7


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def frames_for(seconds: float) -> int:
    return int(seconds * SR) // BLOCK + 1


def f0_contour(t: int) -> np.ndarray:
    """220 Hz with 5.5 Hz vibrato (+-0.5 semitone) and one unvoiced stretch
    over the middle tenth of the frames: (1, T, 1)."""
    time_s = np.arange(t) * BLOCK / SR
    f0 = 220.0 * 2.0 ** (0.5 / 12.0 * np.sin(2 * np.pi * 5.5 * time_s))
    f0[int(0.45 * t):int(0.55 * t)] = 0.0
    return f0.astype(np.float32)[None, :, None]


def synthetic_wave(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """A waveform for the volume features: a 220 Hz tone with a tremolo,
    light noise, and 0.25 s of silence in the middle (below -60 dB)."""
    n = int(seconds * SR)
    time_s = np.arange(n) / SR
    wave = 0.3 * np.sin(2 * np.pi * 220.0 * time_s) * (
        0.75 + 0.25 * np.sin(2 * np.pi * 3.0 * time_s))
    wave += 0.003 * rng.standard_normal(n)
    mid = n // 2
    wave[mid - SR // 8: mid + SR // 8] = 0.0
    return wave.astype(np.float32)


def voice_wave(seconds: float, rng: np.random.Generator,
               silences=None) -> np.ndarray:
    """Phase 4's waveform with its pitch contour: 220 Hz with 5.5 Hz vibrato
    (+-0.5 semitone) and a tremolo, light noise, and 0.25 s of silence in
    the middle (or the (start, stop) second spans of ``silences``)."""
    n = int(seconds * SR)
    time_s = np.arange(n) / SR
    f0 = 220.0 * 2.0 ** (0.5 / 12.0 * np.sin(2 * np.pi * 5.5 * time_s))
    wave = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR) * (
        0.75 + 0.25 * np.sin(2 * np.pi * 3.0 * time_s))
    wave += 0.003 * rng.standard_normal(n)
    for lo, hi in silences or ((seconds / 2 - 0.125, seconds / 2 + 0.125),):
        wave[int(lo * SR):int(hi * SR)] = 0.0
    return wave.astype(np.float32)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = float(np.sum((test.astype(np.float64) - ref) ** 2))
    return 10.0 * math.log10(float(np.sum(ref.astype(np.float64) ** 2))
                             / max(err, 1e-30))


def bound_ms(n_bytes: float, n_flops: float,
             peak: float = PEAK_F32_FLOP_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and flops over ``peak``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def phase_device(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; device_count={count}")
    log(card)  # nvidia-smi's own line: the card's name and power limit
    return name, card


# ---------------------------------------------------------------- phase 2


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
SASS_BRANCH = re.compile(r"(@!?P\d+\s+)?BRA\s+(0x[0-9a-f]+)$")


def sass_text(lib_path, nvcc: str) -> str:
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


# the tensor-core kernels of K2, K2's bf16 class, K3 and K3's bf16 class
# (B3), by the name in their SASS
TC_KERNELS = (("K2", "resblock_conv_tc_kernel"),
              ("B4", "resblock_fused_bf16_kernel"), ("K3", "gemm_tc_kernel"),
              ("B3", "conformer_bf16_kernel"))


def _opcode(text: str) -> str:
    return (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]


def tensor_core_insns(sass: str) -> tuple[dict, dict]:
    """({(kernel id, symbol): [HMMA/HGMMA instructions per instantiation]},
    {(kernel id, symbol): opcode counts of the innermost loop that holds
    tensor-core instructions, in the instantiation with the most of
    them})."""
    funcs = {key: [] for key in TC_KERNELS}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((key for key in TC_KERNELS if key[1] in line), None)
            if current is not None:
                funcs[current].append([])
        elif current is not None and (m := SASS_INSN.search(line)):
            funcs[current][-1].append((int(m.group(1), 16), m.group(2)))
    counts, loops = {}, {}
    for key, insts in funcs.items():
        counts[key] = [sum(_opcode(t) in ("HMMA", "HGMMA") for _, t in f)
                       for f in insts]
        best = {}
        for f in insts:
            mma_at = [a for a, t in f if _opcode(t) in ("HMMA", "HGMMA")]
            spans = []
            for a, t in f:
                m = SASS_BRANCH.match(t)
                if m and int(m.group(2), 16) < a and any(
                        int(m.group(2), 16) <= x <= a for x in mma_at):
                    spans.append((a - int(m.group(2), 16), int(m.group(2), 16), a))
            if not spans:
                continue
            _, head, tail = min(spans)
            hist = {}
            for a, t in f:
                if head <= a <= tail:
                    hist[_opcode(t)] = hist.get(_opcode(t), 0) + 1
            def n_mma(h):
                return h.get("HMMA", 0) + h.get("HGMMA", 0)

            if n_mma(hist) > n_mma(best):
                best = hist
        loops[key] = best
    return counts, loops


def function_opcodes(sass: str, symbol: str) -> dict:
    """Opcode counts of the SASS of the functions named ``symbol``, as
    compiled (static: a loop body counts once)."""
    hist, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
        elif inside and (m := SASS_INSN.search(line)):
            op = _opcode(m.group(2))
            hist[op] = hist.get(op, 0) + 1
    if not hist:
        fail(f"no SASS found for {symbol}")
    return hist


def phase_build() -> None:
    from ddsp_svc_tpu_torch.ops import kernels

    info = kernels.build()
    kernels.library()
    log(f"[build] {info.path.name} in {info.seconds:.2f} s "
        f"({'reused' if info.seconds == 0.0 else 'nvcc, one process per source'})")
    for line in info.log.splitlines():
        if line.startswith("==") or "ptxas info" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    sass = sass_text(info.path, kernels._nvcc())
    tc_counts, tc_opcodes = tensor_core_insns(sass)
    for (kid, symbol), per_inst in tc_counts.items():
        if not per_inst or min(per_inst) == 0:
            fail(f"{kid}'s SASS: no tensor-core instruction (HMMA/HGMMA) in "
                 f"{symbol} ({per_inst} per instantiation)")
        hist = sorted(tc_opcodes[(kid, symbol)].items(), key=lambda kv: -kv[1])
        log(f"[build] {kid} {symbol}: {per_inst} HMMA/HGMMA instructions in "
            f"the SASS of its {len(per_inst)} instantiations (tensor cores); "
            f"its innermost tensor-core loop: {sum(n for _, n in hist)} "
            f"instructions, "
            + ", ".join(f"{op} {n}" for op, n in hist[:14]))
    for kid, symbol in (("K1", "combtooth_kernel"), ("K4", "harmonic_bank_kernel")):
        hist = sorted(function_opcodes(sass, symbol).items(), key=lambda kv: -kv[1])
        log(f"[build] {kid} {symbol} as compiled: {sum(n for _, n in hist)} "
            f"instructions, " + ", ".join(f"{op} {n}" for op, n in hist[:14]))


# ---------------------------------------------------------------- phase 3


def _rand(torch, gen, shape, scale=1.0):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * scale


def phase_kernels(torch, card: str) -> dict:
    """Kernel vs plain at the 10 s request's shapes. Returns per-kernel
    measurements (launches filled in by the serving phases)."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (conformer_layer,
                                                       conformer_layer_plain)
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                      resblock_group,
                                                      resblock_group_plain)
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth, combtooth_plain
    from ddsp_svc_tpu_torch.tools.timing import (cuda_ms, graph_ms,
                                                 profiled_call, wall_ms)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    t = frames_for(10)
    results = {}
    problems = []  # every kernel is checked before the phase fails

    # K1 combtooth: f0 (1, T, 1) -> samples (1, T * 512) within 5e-5 and
    # phase_frames (1, T, 1) within 1e-6 rad of the plain version; at the
    # 10 s request and at a ten-minute input
    k1 = {}
    for seconds in (10, 600):
        frames = frames_for(seconds)
        f0 = torch.from_numpy(f0_contour(frames)).to(dev)
        got, got_phase = combtooth(f0, SR, BLOCK)
        want, want_phase = combtooth_plain(f0, SR, BLOCK)
        err = float((got - want).abs().max())
        p_err = float((got_phase - want_phase).abs().max())
        if not (err <= 5e-5 and p_err <= 1e-6):
            problems.append(f"K1 combtooth T={frames}: max abs err {err:.3e} "
                            f"(tol 5e-5), phase_frames {p_err:.3e} (tol 1e-6)")
        call = lambda f0=f0: combtooth(f0, SR, BLOCK)  # noqa: E731
        k1[seconds] = dict(frames=frames, err=err, p_err=p_err,
                           graph=graph_ms(call, 200 if seconds == 10 else 20),
                           prof=profiled_call(call, "combtooth_kernel"),
                           wall=wall_ms(call))
        del got, want, got_phase, want_phase
    f0 = torch.from_numpy(f0_contour(t)).to(dev)
    plain = cuda_ms(lambda: combtooth_plain(f0, SR, BLOCK), 50)
    r = k1[10]
    b_ms, b_by = bound_ms((t + t * BLOCK + t) * 4.0, 30.0 * t * BLOCK)
    results["combtooth"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combtooth.cu",
        replaces="ddsp_svc_tpu/ops/pallas_source.py:49",
        max_abs_err=max(r["err"], r["p_err"], k1[600]["err"], k1[600]["p_err"]),
        ms=r["graph"], plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    for seconds, r in k1.items():
        kern, ops, dev_ms = r["prof"]
        log(f"[kernels] K1 combtooth {seconds} s T={r['frames']}: max_abs_err "
            f"{r['err']:.3e} (tol 5e-5), phase_frames {r['p_err']:.3e} rad (tol "
            f"1e-6); one combtooth() call: {r['graph']:.5f} ms device (CUDA "
            f"graph replay), kernel {kern:.5f} ms by the profiler, {ops:g} "
            f"device ops ({dev_ms:.5f} ms), host wall {r['wall']:.4f} ms to "
            f"synchronize() [{card}]")
    log(f"[kernels] K1 combtooth T={t}: plain {plain:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}); no single PyTorch call computes it [{card}]")

    # K2 resblock stage at each of the five stages; tolerance 1e-4 x max|out|.
    # Weights are packed once, as the serving path packs them per model.
    tot = dict(ms=0.0, plain=0.0, bound=0.0, bound_fma=0.0, flops=0.0,
               bytes=0.0)
    worst_abs = 0.0
    for c, per_frame in K2_STAGES:
        length = t * per_frame
        x = torch.randn((1, length, c), generator=gen).to(dev)
        weights = []
        for k, dils in zip(K2_KERNEL_SIZES, K2_DILATIONS):
            bound = 1.0 / math.sqrt(c * k)
            weights.append([(_rand(torch, gen, (c, c, k), bound).to(dev),
                             _rand(torch, gen, (c,), bound).to(dev))
                            for _ in range(2 * len(dils))])
        packed = PackedResblocks(weights)
        got = resblock_group(x, packed, K2_KERNEL_SIZES, K2_DILATIONS)
        want = resblock_group_plain(x, weights, K2_KERNEL_SIZES, K2_DILATIONS)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        worst_abs = max(worst_abs, abs_err)
        if not rel <= 1e-4:
            problems.append(f"K2 resblock_group C={c}: {rel:.3e} x max|out| > 1e-4")
        iters = 20 if c >= 64 else 10
        k_ms = cuda_ms(lambda: resblock_group(
            x, packed, K2_KERNEL_SIZES, K2_DILATIONS), iters)
        p_ms = cuda_ms(lambda: resblock_group_plain(
            x, weights, K2_KERNEL_SIZES, K2_DILATIONS), iters)
        taps = sum(k * 2 * len(d) for k, d in zip(K2_KERNEL_SIZES, K2_DILATIONS))
        n_convs = sum(2 * len(d) for d in K2_DILATIONS)
        flops = 2.0 * length * c * c * taps + 48.0 * length * c
        nbytes = 4.0 * (2 * length * c + c * c * taps + n_convs * c)
        b_ms, _ = bound_ms(nbytes, flops, PEAK_TF32X3_FLOP_PER_S)
        b_fma, _ = bound_ms(nbytes, flops)
        for key, val in (("ms", k_ms), ("plain", p_ms), ("bound", b_ms),
                         ("bound_fma", b_fma), ("flops", flops),
                         ("bytes", nbytes)):
            tot[key] += val
        log(f"[kernels] K2 resblock_group C={c} L={length}: rel err {rel:.3e} "
            f"(abs {abs_err:.3e}, tol 1e-4 x max|out|); kernel {k_ms:.3f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms at 3xTF32 / {b_fma:.4f} ms at f32 FMA [{card}]")
        del x, weights, packed, got, want
    results["resblock_group"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/resblock.cu",
        replaces="ddsp_svc_tpu/ops/pallas_resblock.py:311",
        max_abs_err=worst_abs, ms=tot["ms"], plain_ms=tot["plain"],
        bound_ms=tot["bound"],
        bound_by=bound_ms(tot["bytes"], tot["flops"], PEAK_TF32X3_FLOP_PER_S)[1],
        library_ms=None)
    log(f"[kernels] K2 five stages of one 10 s request: kernel {tot['ms']:.3f} "
        f"ms ({tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s), plain "
        f"{tot['plain']:.3f} ms, bound {tot['bound']:.4f} ms at 3xTF32 / "
        f"{tot['bound_fma']:.4f} ms at f32 FMA; no single PyTorch call "
        f"computes a stage [{card}]")

    results["resblock_group_bf16"] = k2_bf16(torch, gen, t, card, problems)

    # K3 conformer layer: T=862, C=512, Hc=128, I=1024, k=31
    c, hc, inner, k = 512, 128, 1024, 31
    x = torch.randn((1, t, c), generator=gen).to(dev)
    cond = torch.randn((1, t, hc), generator=gen).to(dev)
    step = torch.randn((1, c), generator=gen).to(dev)
    w = tuple(_rand(torch, gen, shape, scale).to(dev) for shape, scale in (
        ((c, hc), hc ** -0.5), ((c,), hc ** -0.5),
        ((2 * inner, c), c ** -0.5), ((2 * inner,), c ** -0.5),
        ((inner, k), k ** -0.5), ((inner,), k ** -0.5),
        ((c, inner), inner ** -0.5), ((c,), inner ** -0.5)))
    got = conformer_layer(x, cond, step, w)
    want = conformer_layer_plain(x, cond, step, w)
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    if not rel <= 1e-4:
        problems.append(f"K3 conformer_layer: {rel:.3e} x max|out| > 1e-4")
    k_ms = cuda_ms(lambda: conformer_layer(x, cond, step, w), 100)
    p_ms = cuda_ms(lambda: conformer_layer_plain(x, cond, step, w), 100)
    flops = (2.0 * t * (hc * c + c * 2 * inner + inner * c) + 2.0 * t * inner * k
             + t * (3 * c + 8 * inner))
    nbytes = 4.0 * (2 * t * c + t * hc + c + c * hc + c + 2 * inner * c
                    + 2 * inner + inner * k + inner + c * inner + c)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_TF32X3_FLOP_PER_S)
    b_fma, _ = bound_ms(nbytes, flops)
    results["conformer_layer"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/conformer.cu",
        replaces="ddsp_svc_tpu/ops/pallas_conformer.py:125",
        max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"[kernels] K3 conformer_layer T={t} C={c}: rel err {rel:.3e} "
        f"(abs {abs_err:.3e}, tol 1e-4 x max|out|); kernel {k_ms:.4f} ms "
        f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms at 3xTF32 / {b_fma:.4f} ms at f32 FMA ({b_by}); no "
        f"single PyTorch call computes it [{card}]")
    results["conformer_layer_bf16"] = k3_bf16(torch, gen, (x, cond, step, w),
                                              got, card, problems)
    results["conformer_layer_bf16_io"] = k3_bf16_io(torch, gen, w, card, problems)
    bf16_trunk_per_card(torch, w, card, problems)
    # K4 harmonic bank: x (B, T*512, 1) cycles, amps (B, T, 128); 3e-5 abs
    from ddsp_svc_tpu_torch.ops.cuda_oscillator import (harmonic_bank,
                                                        harmonic_bank_plain)
    from ddsp_svc_tpu_torch.ops.interp import remove_above_fmax
    from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

    n_harm = SINS["n_harmonics"]
    k4 = {}
    for b, frames in ((1, t), (2, 37)):
        f0_frames = torch.from_numpy(np.concatenate(
            [f0_contour(frames) * (1.0 + 0.5 * i) for i in range(b)]
        ).astype(np.float32)).to(dev)
        x = cumsum_phase_source(torch.repeat_interleave(f0_frames, BLOCK, dim=1),
                                SR, BLOCK).contiguous()
        amps = remove_above_fmax(
            torch.exp(0.5 * torch.randn((b, frames, n_harm), generator=gen)).to(dev)
            / 128.0, f0_frames, SR / 2).contiguous()
        got = harmonic_bank(x, amps, BLOCK)
        want = harmonic_bank_plain(x, amps, BLOCK)
        err = float((got - want).abs().max())
        if not err <= 3e-5:
            problems.append(f"K4 harmonic_bank B={b} T={frames}: max abs err "
                            f"{err:.3e} > 3e-5")
        k4[b] = (x, amps, err, float(want.abs().max()))
    x, amps, err, peak = k4[1]
    call = lambda: harmonic_bank(x, amps, BLOCK)  # noqa: E731
    k_ms = graph_ms(call)
    prof_ms, _, _ = profiled_call(call, "harmonic_bank_kernel")
    p_ms = cuda_ms(lambda: harmonic_bank_plain(x, amps, BLOCK), 20)
    # the work, not any kernel's instructions: per (sample, harmonic) pair
    # one recurrence FMA and two accumulation FMAs, 6 flops; every
    # harmonic counts, those remove_above_fmax zeroed too
    pairs = float(x.numel()) * n_harm
    b_ms, b_by = bound_ms(4.0 * (2 * x.numel() + amps.numel()), pairs * 6.0)
    results["harmonic_bank"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/oscillator.cu",
        replaces="ddsp_svc_tpu/ops/pallas_oscillator.py:42",
        max_abs_err=max(err, k4[2][2]), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"[kernels] K4 harmonic_bank T={t} L={x.numel()} K={n_harm}: max_abs_err "
        f"{err:.3e} (max|out| {peak:.3f}; B=2 T=37: {k4[2][2]:.3e}; tol 3e-5 abs); "
        f"kernel {k_ms:.5f} ms (CUDA graph replay; {prof_ms:.5f} ms by the "
        f"profiler), {100 * b_ms / k_ms:.1f} % of the bound {b_ms:.5f} ms "
        f"({b_by}: {pairs:.0f} pairs x 6 flops), plain {p_ms:.4f} ms; no "
        f"single PyTorch call computes it [{card}]")
    results["harmonic_bank"]["bf16_amp"] = k4_bf16_amp(
        torch, {b: v[:2] for b, v in k4.items()}, card, problems)
    if problems:
        fail("kernel vs plain: " + "; ".join(problems))
    log("[kernels] K1 combtooth ok, K2 resblock_group ok, B4 ok, K3 "
        "conformer_layer ok, B3 conformer_layer_bf16 ok, K4 harmonic_bank ok "
        "(each within tolerance of its plain version)")
    return results


def k4_bf16_amp(torch, inputs: dict, card: str, problems: list) -> dict:
    """K4's bf16-amplitude mode (bf16 Sins: JAX's bf16 upsample of the bf16
    amplitudes) against its plain version on the card, on phase 3's K4
    inputs ({B: (x, f32 amplitudes)}) with the amplitudes rounded to bf16:
    3e-5 absolute, as the f32 mode. Its bound keeps K4's count, 6 flops a
    (sample, harmonic) pair, with the bf16 amplitudes' bytes."""
    from ddsp_svc_tpu_torch.ops.cuda_oscillator import (harmonic_bank,
                                                        harmonic_bank_plain)
    from ddsp_svc_tpu_torch.tools.timing import cuda_ms, graph_ms, profiled_call

    errs = {}
    for b, (x, amps) in inputs.items():
        a16 = amps.to(torch.bfloat16).contiguous()
        got = harmonic_bank(x, a16, BLOCK)
        want = harmonic_bank_plain(x, a16, BLOCK)
        errs[b] = float((got - want).abs().max())
        if not errs[b] <= 3e-5:
            problems.append(f"K4 bf16-amplitude mode B={b}: max abs err "
                            f"{errs[b]:.3e} > 3e-5")
    x, amps = inputs[1]
    a16 = amps.to(torch.bfloat16).contiguous()
    call = lambda: harmonic_bank(x, a16, BLOCK)  # noqa: E731
    k_ms = graph_ms(call)
    prof_ms, _, _ = profiled_call(call, "harmonic_bank_kernel")
    p_ms = cuda_ms(lambda: harmonic_bank_plain(x, a16, BLOCK), 20)
    pairs = float(x.numel()) * a16.shape[-1]
    b_ms, b_by = bound_ms(4.0 * 2 * x.numel() + 2.0 * a16.numel(), pairs * 6.0)
    log(f"[kernels] K4 bf16-amplitude mode T={a16.shape[1]} L={x.numel()} "
        f"K={a16.shape[-1]}: max_abs_err {errs[1]:.3e} (B=2 T=37: {errs[2]:.3e}; "
        f"tol 3e-5 abs); kernel {k_ms:.5f} ms (CUDA graph replay; {prof_ms:.5f} "
        f"ms by the profiler), {100 * b_ms / k_ms:.1f} % of the bound "
        f"{b_ms:.5f} ms ({b_by}: {pairs:.0f} pairs x 6 flops), plain "
        f"{p_ms:.4f} ms [{card}]")
    return dict(max_abs_err=max(errs.values()), ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def bf16_trunk_per_card(torch, w, card: str, problems: list) -> None:
    """B3 and B5 once on every visible card at B 48 x T 172, each against
    its plain version on that card, with cuda:0 left current: the wrappers
    must make the tensor's card current, and the C launchers raise the
    kernels' shared-memory limit once per card (not once per process). With
    one card the second is said unmeasured."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_gemm_weights,
                                                       bf16_io_agreement,
                                                       bf16_layer_agreement,
                                                       conformer_layer_bf16,
                                                       conformer_layer_bf16_io,
                                                       conformer_layer_bf16_io_plain,
                                                       conformer_layer_bf16_plain)

    n_cards = torch.cuda.device_count()
    c, hc = w[0].shape
    gen = torch.Generator().manual_seed(SEED + 1)
    for index in range(n_cards):
        dev = torch.device("cuda", index)
        wd = tuple(v.to(dev) for v in w)
        packed = bf16_gemm_weights(wd)
        x = torch.randn((48, 172, c), generator=gen).to(dev)
        cond = torch.randn((48, 172, hc), generator=gen).to(dev)
        step = torch.randn((48, c), generator=gen).to(dev)
        if torch.cuda.current_device() != 0:
            problems.append(f"cuda:{torch.cuda.current_device()} current, not cuda:0")
        got = conformer_layer_bf16(x, cond, step, wd, packed)
        b3 = bf16_layer_agreement(got, conformer_layer_bf16_plain(x, cond, step, wd), x)
        x16 = x.to(torch.bfloat16)
        got16 = conformer_layer_bf16_io(x16, cond, step, wd, packed)
        b5 = bf16_io_agreement(got16, conformer_layer_bf16_io_plain(x16, cond, step, wd),
                               x16)
        torch.cuda.synchronize(dev)
        for what, agree in (("B3", b3), ("B5", b5)):
            if not agree["ok"]:
                problems.append(f"{what} on cuda:{index} (cuda:0 current): {agree}")
        log(f"[kernels] B3 / B5 on cuda:{index} of {n_cards} (cuda:0 current) at "
            f"B 48 x T 172: B3 {b3['rel']:.3e} x max|branch| from plain "
            f"({'ok' if b3['ok'] else 'FAILS'}), B5 {100 * b5['differ']:.3f} % "
            f"differ, {100 * b5['beyond_ulp']:.3f} % beyond 1 ulp "
            f"({'ok' if b5['ok'] else 'FAILS'}) [{card}]")
    if n_cards < 2:
        log(f"[kernels] B3 / B5 on a second card: unmeasured ({n_cards} card "
            f"visible) [{card}]")


def conformer_bf16_chain(torch, x, cond, step, w, fault=None):
    """B3's function with exact (float64) GEMM sums, or with a planted extra
    bf16 rounding: "h" (h's f32 sum before its bias) or "gemm" (each GEMM's
    output)."""
    import torch.nn.functional as F

    def r(v):
        return v.to(torch.bfloat16).float()

    def mm(a, b):
        y = torch.matmul(r(a).double(), r(b).t().double()).float()
        return r(y) if fault == "gemm" else y

    wc, bc, w1, b1, wd, bd, w2, b2 = w
    h = x + step[:, None, :] + mm(cond, wc)
    if fault == "h":
        h = r(h)
    g = mm(h + bc, w1) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = F.conv1d(u.transpose(1, 2), wd[:, None, :], padding=(k - 1) // 2,
                 groups=u.shape[-1]).transpose(1, 2) + bd
    s = v * torch.sigmoid(v)
    return x + mm(s, w2) + b2


def k3_bf16(torch, gen, k3_inputs, k3_out, card: str, problems: list) -> dict:
    """B3 (K3's bf16 class) against its plain version by
    ``bf16_layer_agreement`` at the 10 s shapes (K3's inputs) and at the
    training shapes (B 48, T 172); at the 10 s shapes the kernel, the card's
    and the CPU's plain versions against float64 sums (each must pass) and
    two planted extra bf16 roundings (each must fail), and the SNR against
    K3's f32 output (> 35 dB, the JAX package's class check). Bound: the
    GEMMs' 2 T (Hc C + 3 I C) flops at the dense bf16 rate plus the
    depthwise conv's 2 T I k at f32, against x, cond, out (f32), the bf16
    GEMM weights and the f32 biases and depthwise taps read or written
    once."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_gemm_weights,
                                                       bf16_layer_agreement,
                                                       conformer_layer_bf16,
                                                       conformer_layer_bf16_plain)
    from ddsp_svc_tpu_torch.tools.timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    x, cond, step, w = k3_inputs
    c, hc = x.shape[-1], cond.shape[-1]
    inner, k = w[4].shape
    out = {}
    for batch, t in ((1, x.shape[1]), (48, 172)):
        what = f"B3 conformer_layer_bf16 B={batch} T={t}"
        if batch != 1:
            x = torch.randn((batch, t, c), generator=gen).to(dev)
            cond = torch.randn((batch, t, hc), generator=gen).to(dev)
            step = torch.randn((batch, c), generator=gen).to(dev)
        packed = bf16_gemm_weights(w)
        got = conformer_layer_bf16(x, cond, step, w, packed)
        want = conformer_layer_bf16_plain(x, cond, step, w)
        agree = bf16_layer_agreement(got, want, x)
        if not agree["ok"]:
            problems.append(f"{what}: {agree}")
        extra = ""
        if batch == 1:
            exact = conformer_bf16_chain(torch, x, cond, step, w)
            cpu_plain = conformer_layer_bf16_plain(
                x.cpu(), cond.cpu(), step.cpu(), [v.cpu() for v in w])
            parts = []
            for name, val, should in (("kernel", got, True), ("plain", want, True),
                                      ("CPU plain", cpu_plain, True),
                                      ("fault h", None, False),
                                      ("fault gemm", None, False)):
                if val is None:
                    val = conformer_bf16_chain(torch, x, cond, step, w,
                                               fault=name.split()[1])
                a = bf16_layer_agreement(val.to(dev), exact, x)
                parts.append(f"{name} {a['rel']:.3e} x max|branch|, "
                             f"{100 * a['beyond']:.3f} % beyond 2^-10 "
                             f"({'passes' if a['ok'] else 'fails'})")
                if a["ok"] != should:
                    problems.append(f"{what} vs exact sums: {name} "
                                    f"{'fails' if should else 'passes'}: {a}")
            log(f"[kernels] {what} against float64 sums: " + "; ".join(parts)
                + f" [{card}]")
            f32 = k3_out.double()
            snr = 10 * math.log10(float((f32 ** 2).sum())
                                  / max(float(((got.double() - f32) ** 2).sum()), 1e-30))
            if not snr > 35.0:
                problems.append(f"{what}: {snr:.2f} dB from K3's f32 output (> 35)")
            extra = f", {snr:.2f} dB from K3's f32 output (> 35)"
        iters = 100 if batch == 1 else 20
        call = lambda: conformer_layer_bf16(x, cond, step, w, packed)  # noqa: E731
        # device time by CUDA graph replay (a 10 s layer is shorter than the
        # host's work per call), and CUDA events over back-to-back calls
        k_ms = graph_ms(call, 50 if batch == 1 else 10)
        e_ms = cuda_ms(call, iters)
        p_ms = cuda_ms(lambda: conformer_layer_bf16_plain(x, cond, step, w),
                       iters // 4)
        m = batch * t
        gemm = 2.0 * m * (hc * c + 3 * inner * c)
        dw = 2.0 * m * inner * k
        nbytes = (4.0 * (2 * m * c + m * hc) + 2.0 * (hc * c + 3 * inner * c)
                  + 4.0 * (c + 2 * inner + inner * k + inner + c))
        t_ops = (gemm / PEAK_BF16_FLOP_PER_S + dw / PEAK_F32_FLOP_PER_S) * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        out[batch] = dict(err=agree["max_abs_err"], ms=k_ms, events=e_ms,
                          plain=p_ms, bound=b_ms, by=b_by)
        log(f"[kernels] {what}: {agree['rel']:.3e} x max|branch| from plain, "
            f"{100 * agree['beyond']:.3f} % beyond 2^-10 (limits 2^-8, 2 %)"
            f"{extra}; kernel {k_ms:.4f} ms device time by CUDA graph replay "
            f"({(gemm + dw) / k_ms / 1e9:.1f} TFLOP/s), {e_ms:.4f} ms by CUDA "
            f"events over back-to-back calls (the host's rate where it is "
            f"slower), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{gemm / 1e9:.3f} GFLOP bf16 + {dw / 1e9:.3f} GFLOP f32, "
            f"{nbytes / 1e6:.2f} MB); no single PyTorch call computes it [{card}]")
    r = out[1]
    return dict(route="cuda", source="ddsp_svc_tpu_torch/csrc/conformer.cu",
                replaces="ddsp_svc_tpu/ops/pallas_conformer.py:125",
                max_abs_err=max(o["err"] for o in out.values()), ms=r["ms"],
                plain_ms=r["plain"], bound_ms=r["bound"], bound_by=r["by"],
                library_ms=None, events_ms=r["events"], train_ms=out[48]["ms"],
                train_plain_ms=out[48]["plain"], train_bound_ms=out[48]["bound"])


def conformer_bf16_io_chain(torch, x, cond, step, w, fault=None):
    """B5's function with exact (float64) sums, or with a planted fault:
    "h" (an extra bf16 rounding of h before its bias) or "twice" (the
    branch rounded to bf16 before x is added, so the output is rounded
    twice)."""
    import torch.nn.functional as F

    def r(v):
        return v.to(torch.bfloat16).double()

    wc, bc, w1, b1, wd, bd, w2, b2 = (v.double() for v in w)
    x, cond = x.double(), cond.double()
    hp = torch.matmul(r(cond), r(wc).t())
    if fault == "h":
        hp = r(hp)
    h = x + r(step)[:, None, :] + hp + bc
    g = torch.matmul(r(h), r(w1).t()) + b1
    a, gate = g.chunk(2, dim=-1)
    u = a * torch.sigmoid(gate)
    k = wd.shape[-1]
    v = F.conv1d(u.transpose(1, 2), wd[:, None, :], padding=(k - 1) // 2,
                 groups=u.shape[-1]).transpose(1, 2) + bd
    s = v * torch.sigmoid(v)
    y = torch.matmul(r(s), r(w2).t()) + b2
    if fault == "twice":
        y = r(y)
    return (x + y).to(torch.bfloat16)


def k3_bf16_io(torch, gen, w, card: str, problems: list) -> dict:
    """B5 (K3's bf16 class on bf16 activations) against its plain version
    by ``bf16_io_agreement`` at the training shape (B 48 x T 172, cond f32
    as the DDSP mel arrives, and bf16) and at B 1 x T 862; at B 48 x T 172
    the kernel, the card's and the CPU's plain versions against float64
    sums (each must pass) and two planted faults (each must fail). Bound:
    B3's operations; bytes with x and out in bf16."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (bf16_gemm_weights,
                                                       bf16_io_agreement,
                                                       conformer_layer_bf16_io,
                                                       conformer_layer_bf16_io_plain)
    from ddsp_svc_tpu_torch.tools.timing import cuda_ms, graph_ms, launch_split

    from ddsp_svc_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    # the persistent launch 2's branch-free reciprocal against 1.0f / y at
    # every float y in [1, 2^126): its sigmoids are ddsp_sigmoid's bits
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    kernels.launch("rcp_fast", "ddsp_rcp_fast_mismatches", dev, bad.data_ptr())
    if int(bad.item()):
        problems.append(f"B3 / B5 rcp_fast differs from 1 / y at {int(bad.item())} y")
    log(f"[kernels] B3 / B5 rcp_fast: {int(bad.item())} of the 1.06e9 floats in "
        f"[1, 2^126) differ from 1.0f / y [{card}]")
    c, hc = w[0].shape
    inner, k = w[4].shape
    packed = bf16_gemm_weights(w)
    out = {}
    for batch, t, cond16 in ((48, 172, False), (48, 172, True), (1, 862, False),
                             (1, 862, True)):
        what = (f"B5 conformer_layer_bf16_io B={batch} T={t} cond "
                f"{'bf16' if cond16 else 'f32'}")
        x = torch.randn((batch, t, c), generator=gen).to(dev, torch.bfloat16)
        cond = torch.randn((batch, t, hc), generator=gen).to(dev)
        if cond16:
            cond = cond.to(torch.bfloat16)
        step = torch.randn((batch, c), generator=gen).to(dev)
        got = conformer_layer_bf16_io(x, cond, step, w, packed)
        want = conformer_layer_bf16_io_plain(x, cond, step, w)
        agree = bf16_io_agreement(got, want, x)
        if not agree["ok"]:
            problems.append(f"{what}: {agree}")
        if batch == 48 and not cond16:
            exact = conformer_bf16_io_chain(torch, x, cond, step, w)
            cpu_plain = conformer_layer_bf16_io_plain(
                x.cpu(), cond.cpu(), step.cpu(), [v.cpu() for v in w])
            parts = []
            for name, val, should in (("kernel", got, True), ("plain", want, True),
                                      ("CPU plain", cpu_plain, True),
                                      ("fault h", None, False),
                                      ("fault twice", None, False)):
                if val is None:
                    val = conformer_bf16_io_chain(torch, x, cond, step, w,
                                                  fault=name.split()[1])
                a = bf16_io_agreement(val.to(dev), exact, x)
                parts.append(f"{name} {100 * a['differ']:.3f} % differ, "
                             f"{100 * a['beyond_ulp']:.3f} % beyond 1 ulp, "
                             f"{a['rel']:.3e} x max|branch| "
                             f"({'passes' if a['ok'] else 'fails'})")
                if a["ok"] != should:
                    problems.append(f"{what} vs exact sums: {name} "
                                    f"{'fails' if should else 'passes'}: {a}")
            log(f"[kernels] {what} against float64 sums: " + "; ".join(parts)
                + f" [{card}]")
        call = lambda: conformer_layer_bf16_io(x, cond, step, w, packed)  # noqa: E731
        k_ms = graph_ms(call, 10 if batch > 1 else 50)
        split = launch_split(call, "conformer", 10)
        p_ms = cuda_ms(lambda: conformer_layer_bf16_io_plain(x, cond, step, w), 5)
        m = batch * t
        gemm = 2.0 * m * (hc * c + 3 * inner * c)
        dw = 2.0 * m * inner * k
        nbytes = (2.0 * 2 * m * c + cond.element_size() * m * hc + 4.0 * batch * c
                  + 2.0 * (hc * c + 3 * inner * c)
                  + 4.0 * (c + 2 * inner + inner * k + inner + c))
        t_ops = (gemm / PEAK_BF16_FLOP_PER_S + dw / PEAK_F32_FLOP_PER_S) * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        out[(batch, cond16)] = dict(err=agree["max_abs_err"], ms=k_ms,
                                    plain=p_ms, bound=b_ms, by=b_by)
        log(f"[kernels] {what}: {100 * agree['differ']:.3f} % differ from plain, "
            f"{100 * agree['beyond_ulp']:.3f} % beyond 1 ulp, {agree['rel']:.3e} x "
            f"max|branch| (limits 4 %, 0.5 %, 2^-8 + 1 ulp); kernel {k_ms:.4f} ms "
            f"device time by CUDA graph replay ({(gemm + dw) / k_ms / 1e9:.1f} "
            f"TFLOP/s; by launch, torch.profiler: "
            + ", ".join(f"{name} {ms:.5f} ms" for name, ms in split)
            + f"), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{gemm / 1e9:.3f} GFLOP bf16 + {dw / 1e9:.3f} GFLOP f32, "
            f"{nbytes / 1e6:.2f} MB); no single PyTorch call computes it [{card}]")
    r = out[(48, False)]
    return dict(route="cuda", source="ddsp_svc_tpu_torch/csrc/conformer.cu",
                replaces="ddsp_svc_tpu/ops/pallas_conformer.py:125",
                max_abs_err=max(o["err"] for o in out.values()), ms=r["ms"],
                plain_ms=r["plain"], bound_ms=r["bound"], bound_by=r["by"],
                library_ms=None, request_ms=out[(1, False)]["ms"],
                request_bound_ms=out[(1, False)]["bound"])


def bf16_chain(torch, x, weights, fault=None):
    """B4's function with exact sums (float64 convs on bf16-rounded
    operands), or with a planted fault: "z" (each chain's residual sum
    rounded to bf16), "total" (the running sum over the chains rounded to
    bf16), "t" (every conv output rounded to bf16, as intermediates stored
    in bf16 would be). x (B, L, C) bf16 -> (B, L, C) bf16."""
    import torch.nn.functional as F

    def r(v):
        return v.to(torch.bfloat16).float()

    xc = x.float().transpose(1, 2)
    total = None
    for k, dils, rbw in zip(K2_KERNEL_SIZES, K2_DILATIONS, weights):
        z, ci = xc, 0
        for d in dils:
            v = z
            for dd in (d, 1):
                w, b = rbw[ci]
                ci += 1
                v = r(F.leaky_relu(v, 0.1))
                v = F.conv1d(v.double(), r(w).double(), b.double(),
                             padding=(k - 1) * dd // 2, dilation=dd).float()
                if fault == "t":
                    v = r(v)
            z = v + z
            if fault == "z":
                z = r(z)
        total = z if total is None else total + z
        if fault == "total":
            total = r(total)
    return (total / len(weights)).transpose(1, 2).to(torch.bfloat16)


def b4_traffic(c: int, length: int, batch: int, plan) -> tuple[float, float]:
    """What B4's launch plan (``cuda_resblock.FUSED_PLAN``: convs per
    launch, output rows per block) moves for one stage: (bytes of
    activations through device memory, bytes of weights its blocks stream
    from L2). Every run's frame (the block's rows and the run's halo, whole
    tiles) is read once per block, bf16 x or f32 z; a run of one pair
    reads its residual z again at its own rows; each launch writes its rows
    once (f32 z, the f32 running sum, the bf16 output), and the chains
    after the first read the running sum."""
    mode, bm = plan
    convs = [(k, 1 if i % 2 else dils[i // 2])
             for k, dils in zip(K2_KERNEL_SIZES, K2_DILATIONS)
             for i in range(2 * len(dils))]
    per_chain, n_rb = 2 * len(K2_DILATIONS[0]), len(K2_KERNEL_SIZES)
    per = {"stage": len(convs), "chain": per_chain, "pair": 2}[mode]
    blocks = batch * math.ceil(length / bm)
    own = batch * length * c
    act = wts = 0.0
    for c0 in range(0, len(convs), per):
        i = c0
        while i < c0 + per:
            chain = i // per_chain
            end = min(c0 + per, (chain + 1) * per_chain)
            half = sum((k - 1) * d // 2 for k, d in convs[i:end])
            z_bytes = 2 if i % per_chain < 2 else 4
            act += blocks * (bm + 2 * half) * c * z_bytes
            if per == 2:
                act += own * z_bytes
            if end == (chain + 1) * per_chain:
                act += own * (2 if chain == n_rb - 1 else 4) + (own * 4 if chain else 0)
            else:
                act += own * 4
            wts += blocks * sum(k for k, _ in convs[i:end]) * 2.0 * c * c
            i = end
    return act, wts


def k2_bf16(torch, gen, t: int, card: str, problems: list) -> dict:
    """K2's bf16 class against its plain version at the four stages it
    serves (C = 128 ... 16) of the 10 s request, and at B = 8 rows of the
    1024-frame bucket, by ``bf16_agreement`` (1 bf16 ulp + 2^-7 x max|out|
    per element, <= 2 % of the elements beyond 1 ulp, <= 10 % differing).
    At the 10 s shapes the kernel is also held to the exact-sum version
    (``bf16_chain``), and the tolerance to its two sides: the plain version
    on the card (cuDNN's sum order) and on the CPU pass it against the
    exact sums, and three planted extra bf16 roundings fail it. Bound:
    2 L C^2 126 flops per stage at the dense bf16 rate against the bytes of
    x and out (bf16), the bf16 weights and the f32 biases, read or written
    once."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (FUSED_BLOCKS_PER_SM,
                                                      FUSED_PLAN,
                                                      PackedResblocks,
                                                      fused_rows,
                                                      bf16_agreement,
                                                      resblock_group_bf16,
                                                      resblock_group_bf16_plain)
    from ddsp_svc_tpu_torch.tools.timing import cuda_ms

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    taps = sum(k * 2 * len(d) for k, d in zip(K2_KERNEL_SIZES, K2_DILATIONS))
    n_convs = sum(2 * len(d) for d in K2_DILATIONS)
    tot = dict(ms=0.0, plain=0.0, bound=0.0, flops=0.0, bytes=0.0)
    worst = 0.0
    for batch, frames in ((1, t), (8, 1024)):
        for c, per_frame in K2_STAGES[1:]:
            length = frames * per_frame
            x = torch.randn((batch, length, c), generator=gen).to(dev).to(torch.bfloat16)
            weights = []
            for k, dils in zip(K2_KERNEL_SIZES, K2_DILATIONS):
                bound = 1.0 / math.sqrt(c * k)
                weights.append([(_rand(torch, gen, (c, c, k), bound).to(dev),
                                 _rand(torch, gen, (c,), bound).to(dev))
                                for _ in range(2 * len(dils))])
            packed = PackedResblocks(weights)
            got = resblock_group_bf16(x, packed, K2_KERNEL_SIZES, K2_DILATIONS)
            want = resblock_group_bf16_plain(x, weights, K2_KERNEL_SIZES,
                                             K2_DILATIONS)
            agree = bf16_agreement(got, want)
            worst = max(worst, agree["max_abs_err"])
            what = f"B4 C={c} B={batch} L={length}"
            if not agree["ok"]:
                problems.append(f"{what}: {agree}")
            if batch == 1:
                k2_bf16_witnesses(torch, x, weights, got, want, what, card,
                                  problems)
            iters = 20 if batch == 1 else 5
            k_ms = cuda_ms(lambda: resblock_group_bf16(
                x, packed, K2_KERNEL_SIZES, K2_DILATIONS), iters)
            p_ms = cuda_ms(lambda: resblock_group_bf16_plain(
                x, weights, K2_KERNEL_SIZES, K2_DILATIONS), max(3, iters // 4))
            flops = 2.0 * batch * length * c * c * taps
            nbytes = 2.0 * 2 * batch * length * c + 2.0 * c * c * taps + 4.0 * n_convs * c
            b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_PER_S)
            if batch == 1:
                for key, val in (("ms", k_ms), ("plain", p_ms), ("bound", b_ms),
                                 ("flops", flops), ("bytes", nbytes)):
                    tot[key] += val
            mode, most = FUSED_PLAN[c]
            plan = (mode, fused_rows(most, length, batch,
                                     sms * FUSED_BLOCKS_PER_SM[c]))
            act, wts = b4_traffic(c, length, batch, plan)
            log(f"[kernels] {what}: max abs err {agree['max_abs_err']:.3e} "
                f"(max|out| {float(want.float().abs().max()):.3f}; tol 1 bf16 ulp "
                f"+ 2^-7 x max|out|), {100 * agree['differ']:.3f} % of elements "
                f"differ, {100 * agree['beyond_ulp']:.4f} % by more than 1 ulp "
                f"(limits 2 % beyond, 10 % differ); kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} "
                f"TFLOP/s), plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"dense bf16); plan {plan} (convs per launch, rows per block) "
                f"moves {act / 1e6:.1f} MB of "
                f"activations through device memory and streams {wts / 1e6:.1f} "
                f"MB of weights from L2 [{card}]")
            del x, weights, packed, got, want
    log(f"[kernels] B4 four stages of one 10 s request: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain']:.3f} ms, bound "
        f"{tot['bound']:.4f} ms; no single PyTorch call computes a stage "
        f"[{card}]")
    return dict(route="cuda", source="ddsp_svc_tpu_torch/csrc/resblock.cu",
                replaces="ddsp_svc_tpu/ops/pallas_resblock.py:356",
                max_abs_err=worst, ms=tot["ms"], plain_ms=tot["plain"],
                bound_ms=tot["bound"],
                bound_by=bound_ms(tot["bytes"], tot["flops"],
                                  PEAK_BF16_FLOP_PER_S)[1],
                library_ms=None)


def k2_bf16_witnesses(torch, x, weights, got, want, what, card, problems):
    """The kernel (``got``), the plain version on the card (``want``) and
    on the CPU against the exact sums must pass ``bf16_agreement``; the
    planted faults against them must fail it."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (bf16_agreement,
                                                      resblock_group_bf16_plain)

    exact = bf16_chain(torch, x, weights)
    cpu_w = [[(w.cpu(), b.cpu()) for w, b in rbw] for rbw in weights]
    cpu_plain = resblock_group_bf16_plain(x.cpu(), cpu_w, K2_KERNEL_SIZES,
                                          K2_DILATIONS)
    parts = []
    for name, val, should in (("kernel", got, True), ("plain", want, True),
                              ("CPU plain", cpu_plain, True),
                              ("fault z", None, False),
                              ("fault total", None, False),
                              ("fault t", None, False)):
        if val is None:
            val = bf16_chain(torch, x, weights, fault=name.split()[1])
        a = bf16_agreement(val.to(exact.device), exact)
        parts.append(f"{name} {100 * a['differ']:.3f} % differ, "
                     f"{100 * a['beyond_ulp']:.4f} % beyond 1 ulp, max "
                     f"{a['max_abs_err']:.3e} ({'passes' if a['ok'] else 'fails'})")
        if a["ok"] != should:
            problems.append(f"{what} vs exact sums: {name} "
                            f"{'fails' if should else 'passes'} the bf16 "
                            f"tolerance: {a}")
    log(f"[kernels] {what} against the exact sums: " + "; ".join(parts)
        + f" [{card}]")


# ---------------------------------------------------------------- phase 4


def random_parts(torch, model_cfg: dict, enhancer: bool = False, n_spk: int = 1,
                 vocoder_type: str = "nsf-hifigan", vocoder_cfg=None):
    """(args, model, NSF-HiFiGAN) on the CPU, random weights (and FAVOR+
    buffers) from one seeded generator. The vocoder is the diffusion
    model's, or with ``enhancer`` the DDSP model's enhancer."""
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.models.vocoder import Vocoder
    from ddsp_svc_tpu_torch.utils.config import DotDict

    cfg = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                    "encoder_out_channels": N_UNIT},
           "model": dict(model_cfg, n_spk=n_spk)}
    if enhancer:
        cfg["enhancer"] = {"type": "nsf-hifigan", "ckpt": None}
    args = DotDict(cfg)
    gen = torch.Generator().manual_seed(SEED)
    model = random_init_(build_model(args), gen)
    vocoder = random_init_(Vocoder(vocoder_type, vocoder_cfg), gen)
    return args, model, vocoder


def build_parts(torch):
    """The diffusion-fast model and the default NSF-HiFiGAN."""
    args, model, vocoder = random_parts(torch, {
        "type": "DiffusionFast", "win_length": WIN, "n_layers": 6,
        "n_chans": 512, "k_step_max": 100, "use_pitch_aug": True})
    args["infer"] = {"speedup": 10, "method": "dpm-solver"}
    if float(model.denoise_fn.output_projection.weight.detach().abs().max()) == 0.0:
        fail("the denoiser's output projection is zero")
    return args, model, vocoder


def request_inputs(pipe, seconds: float, rng: np.random.Generator):
    wave = synthetic_wave(seconds, rng)
    volume, mask = pipe.volume_and_mask(wave, threshold=-60.0)
    t = volume.shape[1]
    units = rng.standard_normal((1, t, N_UNIT)).astype(np.float32)
    return dict(units=units, f0=f0_contour(t), volume=volume, frame_mask=mask)


def request_noise(rng: np.random.Generator, t: int, draws: str = "normal") -> dict:
    """Every draw of a request of T frames: the DDSP noise (N(0, 1) or U(-1,
    1)), the cascades' initial noise, the sine source's phases and noise."""
    ddsp = (rng.standard_normal((1, t * BLOCK)) if draws == "normal"
            else rng.uniform(-1.0, 1.0, (1, t * BLOCK)))
    noise = {"ddsp": ddsp, "diffusion": rng.standard_normal((1, t, 128)),
             "rand_ini": np.concatenate([[0.0], rng.random(8)])[None, None],
             "sine": rng.standard_normal((1, t * BLOCK, 9))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def check_audio(audio, t: int, what: str) -> np.ndarray:
    """(1, t * BLOCK) finite, not silent: a tensor from infer_features or
    the (L,) host array infer returns."""
    if hasattr(audio, "detach"):
        audio = audio.detach().float().cpu().numpy()
    a = np.asarray(audio, np.float32).reshape(1, -1)
    if a.shape != (1, t * BLOCK):
        fail(f"{what}: output shape {a.shape}, expected (1, {t * BLOCK})")
    if not np.isfinite(a).all():
        fail(f"{what}: non-finite samples")
    if not (np.abs(a).max() > 1e-4 and np.sqrt(np.mean(a * a)) > 1e-5):
        fail(f"{what}: output is silent")
    return a


def counts():
    from ddsp_svc_tpu_torch.ops.cuda_conformer import conformer_layer
    from ddsp_svc_tpu_torch.ops.cuda_oscillator import harmonic_bank
    from ddsp_svc_tpu_torch.ops.cuda_resblock import resblock_group
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth

    return {"combtooth": combtooth, "resblock_group": resblock_group,
            "conformer_layer": conformer_layer, "harmonic_bank": harmonic_bank}


# device kernels by name (and the wrapper whose launches they are); the
# port's own kernels live in an anonymous namespace, so "::gemm_tc_kernel<"
# is K3's and never a library GEMM
# SvcPipeline.encode_units runs inside the profiler range "units_encoder"
ENCODER_RANGE = {"encoder (GEMMs, convs, attention)": "units_encoder"}
KERNEL_GROUPS = (("K1 combtooth", "combtooth", ("combtooth_kernel",)),
                 ("K2 resblock", "resblock_group", ("resblock_conv_tc_kernel",)),
                 ("K3 conformer", "conformer_layer",
                  ("::gemm_tc_kernel<", "depthwise_silu_kernel")),
                 ("B4 resblock bf16", "resblock_group_bf16",
                  ("resblock_fused_bf16_kernel",)),
                 # B3's three launches, the depthwise conv inside the second
                 ("B3 / B5 conformer bf16", "conformer_layer_bf16",
                  ("conformer_bf16_kernel",)),
                 ("K4 harmonic bank", "harmonic_bank", ("harmonic_bank_kernel",)),
                 # the units encoder's kernels by where they were launched
                 # (ENCODER_RANGE), not by name
                 ("encoder (GEMMs, convs, attention)", None, ()),
                 ("FFT", None, ("fft",)),
                 ("conv/GEMM libraries", None, ("conv", "cudnn", "gemm", "xmma",
                                                "cutlass", "sm90")))


def _under(evt, name: str) -> bool:
    """Whether a profiler event ran inside the record_function ``name``."""
    parent = getattr(evt, "cpu_parent", None)
    while parent is not None:
        if parent.name == name:
            return True
        parent = getattr(parent, "cpu_parent", None)
    return False


def range_kernels_us(torch, prof, name: str) -> tuple[dict, dict]:
    """({kernel: device time (us)} of the kernels launched inside the
    record_function ``name``, {kernel: "op [input shapes]" of the CPU op
    that launched it first}): the kernels the profiler ties to the CPU
    events under that range."""
    found, ops = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not _under(evt, name):
            continue
        for kern in getattr(evt, "kernels", None) or ():
            found[kern.name] = found.get(kern.name, 0.0) + kern.duration
            ops.setdefault(kern.name, f"{evt.name} {getattr(evt, 'input_shapes', '')}")
    return found, ops


# torch.profiler's trace on the card loses the device records of the first
# few device ops it sees: when a request's h2d copies and K1 opened the
# trace, K1's record was among them though K1 ran. So LEAD_OPS spin kernels
# (torch.cuda._sleep, LEAD_CYCLES each) run inside the trace before the
# request, and every device record but theirs counts. They are told apart
# by name, not by time: on one run the trace placed request records before
# the request began on the host.
LEAD_OPS = 64
LEAD_CYCLES = 250_000
LEAD_KERNEL = "spin_kernel"


def _profiled(torch, request, ranges: dict):
    """One request under torch.profiler, after LEAD_OPS spin kernels traced
    before it -> (profile, wall in us, {device kernel: self device time in
    us} of the request, its device ops, the lead's device records kept)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(ranges)) as prof:
        for _ in range(LEAD_OPS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us, launches, lead_kept = {}, 0, 0
    for evt in prof.key_averages():
        # a range shows on the device as an annotation spanning its kernels
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key in ranges.values()):
            continue
        if LEAD_KERNEL in evt.key:
            lead_kept += evt.count
            continue
        us = getattr(evt, "self_device_time_total", 0) or getattr(
            evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels_us[evt.key] = kernels_us.get(evt.key, 0.0) + us
            launches += evt.count
    return prof, wall_us, kernels_us, launches, lead_kept


def profile_breakdown(torch, request, card: str, what: str,
                      expect: dict, ranges=None) -> None:
    """One warm request under torch.profiler (``_profiled``): device time
    by kernel group and the device's busy share of the request's wall
    time. A kernel group whose wrapper launched (``expect``) but which
    shows no device time fails the run. ``ranges`` {group: record_function
    name}: the kernels launched inside that range form the group, whatever
    their names."""
    ranges = ranges or {}
    prof, wall_us, kernels_us, launches, lead_kept = _profiled(torch, request,
                                                               ranges)
    busy = sum(kernels_us.values())
    if busy <= 0:
        fail(f"{what} profile: the profiler saw no device time")
    groups = {name: 0.0 for name, _, _ in KERNEL_GROUPS}
    range_lines = []
    for group, rname in ranges.items():
        inside, ops = range_kernels_us(torch, prof, rname)
        groups[group] = sum(inside.values())
        if groups[group] <= 0:
            log(f"[profile] {what}: the trace ties no kernel to the {rname!r} "
                "range (the stage walls give its time)")
        for key, us in inside.items():  # counted once, in the range's group
            if key in kernels_us:
                kernels_us[key] -= us
        for key, us in sorted(inside.items(), key=lambda kv: -kv[1])[:6]:
            range_lines.append(f"[profile]   {rname} top: {us / 1e3:.3f} ms  "
                               f"{key[:60]}  <- {ops[key][:110]}")
    groups["elementwise/other"] = 0.0
    for key, us in kernels_us.items():
        low = key.lower()
        name = next((g for g, _, subs in KERNEL_GROUPS
                     if any(sub.lower() in low for sub in subs)), "elementwise/other")
        groups[name] += us
    for name, wrapper, _ in KERNEL_GROUPS:
        if wrapper is not None and expect.get(wrapper, 0) > 0 and groups[name] <= 0:
            fail(f"{what} profile: {name} launched {expect.get(wrapper)} times but "
                 "no kernel of its group shows device time")
    log(f"[profile] {what} 10 s request: wall {wall_us / 1e3:.2f} ms (profiler "
        f"on), device busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f} % of "
        f"wall, {len(kernels_us)} distinct kernels, {launches} device ops; the "
        f"trace kept {lead_kept} of the lead's {LEAD_OPS} device ops [{card}]")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {name}: {us / 1e3:.3f} ms ({100 * us / busy:.1f} % of "
            "device time)")
    for key, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top: {us / 1e3:.3f} ms  {key[:90]}")
    for line in range_lines:
        log(line)


def check_on_card(pipe, what: str) -> None:
    if pipe.device.type != "cuda":
        fail(f"{what} pipeline on {pipe.device}, expected cuda")


def serve_requests(torch, what: str, expect: dict, card: str, requests,
                   ranges=None) -> dict:
    """``requests``: (seconds, T, call) with call() -> (audio, sr). Each
    runs once cold and WARM_RUNS times warm, checked for its output and its
    launch counts; then the last runs once more under torch.profiler
    (``ranges``: profile_breakdown's). Every count is set to 0 just before
    and read just after; returns them."""
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0

    def request(seconds, t, call, when):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, sr = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {n: w.launches - before[n] for n, w in wrappers.items()}
        if delta != expect:
            fail(f"{what} {seconds} s request ({when}): launches {delta}, "
                 f"expected {expect}")
        if sr != SR:
            fail(f"{what} {seconds} s request: sample rate {sr}, expected {SR}")
        check_audio(audio, t, f"{what} {seconds} s request")
        return wall

    walls = {}
    for seconds, t, call in requests:
        cold = request(seconds, t, call, "cold")
        runs = sorted(request(seconds, t, call, "warm") for _ in range(WARM_RUNS))
        med = walls[seconds] = runs[len(runs) // 2]
        log(f"[{what}] {seconds} s request T={t}: warm median {med * 1e3:.2f} ms "
            f"(min {runs[0] * 1e3:.2f}, max {runs[-1] * 1e3:.2f}, n={WARM_RUNS}; "
            f"cold {cold * 1e3:.1f} ms), real-time factor {med / seconds:.5f} "
            f"({seconds / med:.1f}x real time), launches per request {expect} "
            f"[{card}]")
    seconds, t, call = requests[-1]
    profile_breakdown(torch, lambda: request(seconds, t, call, "profiled"), card,
                      what, expect, ranges)
    return {n: w.launches for n, w in wrappers.items()}, walls


def serve_path(torch, pipe, what: str, expect: dict, card: str, **kwargs) -> dict:
    """Requests of 2, 5 and 10 s through ``pipe.infer_features`` (see
    ``serve_requests``); returns the launch counts."""
    check_on_card(pipe, what)
    rng = np.random.default_rng(SEED)
    requests = []
    for seconds in REQUEST_SECONDS:
        inputs = request_inputs(pipe, seconds, rng)
        requests.append((seconds, inputs["volume"].shape[1],
                         lambda inputs=inputs: pipe.infer_features(**inputs, **kwargs)))
    return serve_requests(torch, what, expect, card, requests)[0]


def phase_main_path(torch, args, model, vocoder, card: str) -> dict:
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    pipe = SvcPipeline.from_parts(model, None, args, vocoder, seed=SEED)
    expect = {"combtooth": 1, "resblock_group": 5, "conformer_layer": 60,
              "harmonic_bank": 0}
    return serve_path(torch, pipe, "diffusion-fast", expect, card, k_step=100,
                      speedup=10, method="dpm-solver")


# ---------------------------------------------------------------- phase 5


def phase_card_vs_cpu(torch, args, cpu_model, cpu_vocoder, card: str) -> None:
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    rng = np.random.default_rng(SEED + 1)
    gpu = SvcPipeline.from_parts(copy.deepcopy(cpu_model), None, args,
                                 copy.deepcopy(cpu_vocoder), seed=SEED)
    cpu = SvcPipeline.from_parts(cpu_model, None, args, cpu_vocoder,
                                 device="cpu", seed=SEED)
    inputs = request_inputs(cpu, 2, rng)
    t = inputs["volume"].shape[1]
    noise = request_noise(rng, t)
    mels, audios = {}, {}
    for name, pipe in (("card", gpu), ("cpu", cpu)):
        mel = pipe.cascade(inputs["units"], inputs["f0"], inputs["volume"],
                           k_step=100, speedup=10, noise=noise)
        audio = pipe.vocode(mel, inputs["f0"], inputs["frame_mask"], noise)
        mels[name] = mel.float().cpu().numpy()
        audios[name] = check_audio(audio, t, f"2 s request on {name}")
    mel_err = float(np.abs(mels["card"] - mels["cpu"]).max())
    snr = snr_db(audios["cpu"], audios["card"])
    log(f"[parity] diffusion-fast 2 s request, card (kernels) vs CPU (plain), "
        f"same weights and noise: mel max-abs diff {mel_err:.3e}, audio SNR "
        f"{snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} dB) [{card}]")
    if not snr >= SNR_LIMIT_DB:
        fail(f"card vs CPU audio SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")


# ---------------------------------------------------------------- phase 6


def phase_sins_path(torch, args, model, vocoder, card: str) -> dict:
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    pipe = SvcPipeline.from_parts(model, None, args, vocoder, seed=SEED,
                                  enhance=True)
    if pipe.enhancer is None:
        fail("the Sins pipeline has no enhancer")
    expect = {"combtooth": 0, "resblock_group": 5, "conformer_layer": 0,
              "harmonic_bank": 1}
    return serve_path(torch, pipe, "sins", expect, card)


# ---------------------------------------------------------------- phase 7


def phase_ddsp_card_vs_cpu(torch, card: str, sins_parts) -> None:
    """Sins (with the enhancer) and the other three DDSP models (without)
    at 2 s: card against CPU on the same weights and injected noise."""
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    rng = np.random.default_rng(SEED + 2)
    cases = [("Sins", sins_parts, True)]
    for cfg in ({"type": "CombSubFast"}, dict(COMBSUB, type="CombSub"),
                {"type": "CombSubSuperFast", "win_length": WIN}):
        cases.append((cfg["type"], random_parts(torch, cfg), False))
    for mtype, (args, model, vocoder), enhance in cases:
        gpu = SvcPipeline.from_parts(copy.deepcopy(model), None, args,
                                     copy.deepcopy(vocoder), seed=SEED,
                                     enhance=enhance)
        cpu = SvcPipeline.from_parts(model, None, args, vocoder, device="cpu",
                                     seed=SEED, enhance=enhance)
        inputs = request_inputs(cpu, 2, rng)
        t = inputs["volume"].shape[1]
        draw = rng.standard_normal if mtype == "CombSubSuperFast" else (
            lambda shape: rng.uniform(-1.0, 1.0, shape))
        noise = {"ddsp": draw((1, t * BLOCK)),
                 "rand_ini": np.concatenate([[0.0], rng.random(8)])[None, None],
                 "sine": rng.standard_normal((1, t * BLOCK, 9))}
        noise = {k: v.astype(np.float32) for k, v in noise.items()}
        audios = {}
        for name, pipe in (("card", gpu), ("cpu", cpu)):
            audio, sr = pipe.infer_features(**inputs, noise=noise)
            audios[name] = check_audio(audio, t, f"{mtype} 2 s on {name}")
        snr = snr_db(audios["cpu"], audios["card"])
        log(f"[parity] {mtype} 2 s request{' with the enhancer' if enhance else ''}"
            f", card (kernels) vs CPU (plain), same weights and noise: audio SNR "
            f"{snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} dB) [{card}]")
        if not snr >= SNR_LIMIT_DB:
            fail(f"{mtype} card vs CPU audio SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
        del gpu, cpu
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8


EXPECT_DIFFUSION = {"combtooth": 1, "resblock_group": 5, "conformer_layer": 60,
                    "harmonic_bank": 0}
EXPECT_SINS = {"combtooth": 0, "resblock_group": 5, "conformer_layer": 0,
               "harmonic_bank": 1}


def wav_pipeline(parts, enhance: bool, device=None, device_f0: bool = False,
                 encoder=None, pitch_extractor: str = "yin"):
    """An SvcPipeline with the units encoder (random weights from SEED,
    the same on every device) for (args, model, vocoder)."""
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    args, model, vocoder = parts
    encoder = encoder or UnitsEncoder(ENCODER, device=device, seed=SEED)
    return SvcPipeline.from_parts(model, None, args, vocoder, device=device,
                                  seed=SEED, enhance=enhance,
                                  units_encoder=encoder, device_f0=device_f0,
                                  pitch_extractor=pitch_extractor)


def stage_walls(torch, pipe, wave: np.ndarray, what: str, expect: dict,
                card: str) -> None:
    """One warm request stage by stage, synchronize() at each boundary: the
    host wall of each stage, and the request's launches."""
    wrappers = counts()
    before = {n: w.launches for n, w in wrappers.items()}
    walls = []

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((name, time.perf_counter() - t0))
        return out

    units = timed("encoder", lambda: pipe.encode_units(wave, SR))
    t = units.shape[1]
    f0 = timed("f0 (host YIN)", lambda: pipe.extract_f0(wave, SR))[:, :t]
    volume, mask = timed("volume/mask", lambda: pipe.volume_and_mask(wave, -60.0))
    volume = volume[:, :t]
    if pipe.family == "ddsp":
        audio = timed("synth + mask", lambda: pipe.apply_volume_mask(
            pipe.synth_ddsp(units, f0, volume), mask))
        audio, _ = timed("enhancer", lambda: pipe.enhance(audio, f0))
    else:
        mel = timed("cascade", lambda: pipe.cascade(units, f0, volume,
                                                    k_step=100, speedup=10))
        audio = timed("vocoder + mask", lambda: pipe.vocode(mel, f0, mask))
    seconds = len(wave) / SR
    check_audio(audio, t, f"{what} staged {seconds:g} s request")
    delta = {n: w.launches - before[n] for n, w in wrappers.items()}
    if delta != expect:
        fail(f"{what} staged request: launches {delta}, expected {expect}")
    total = sum(w for _, w in walls)
    log(f"[{what}] {seconds:g} s request by stage (host wall to synchronize()): "
        + ", ".join(f"{n} {w * 1e3:.2f} ms ({100 * w / total:.1f} %)"
                    for n, w in walls) + f"; sum {total * 1e3:.2f} ms [{card}]")


def cents_check(got: np.ndarray, want: np.ndarray, what: str,
                voicing: bool = True) -> float:
    """Identical voicing and < 0.05 cents on the frames voiced in both."""
    if got.shape != want.shape:
        fail(f"{what}: f0 shape {got.shape}, expected {want.shape}")
    if voicing and not np.array_equal(got > 0, want > 0):
        fail(f"{what}: voicing differs on {int(np.sum((got > 0) != (want > 0)))} "
             "frames")
    both = (got > 0) & (want > 0)
    cents = float(np.abs(1200 * np.log2(got[both] / want[both])).max())
    if not cents < 0.05:
        fail(f"{what}: {cents:.4f} cents from the host YIN (limit 0.05)")
    return cents


def phase_wav_paths(torch, card: str, diffusion_parts, sins_parts):
    """Both paths from a wav. Returns ({path: launch counts}, the diffusion
    and Sins pipelines)."""
    from ddsp_svc_tpu_torch.features.f0 import yin_f0
    from ddsp_svc_tpu_torch.features.yin_device import make_yin_fn

    rng = np.random.default_rng(SEED + 3)
    waves = {s: voice_wave(s, rng) for s in REQUEST_SECONDS}
    launches, pipes = {}, {}
    for what, parts, enhance, expect, kwargs in (
            ("diffusion-fast from a wav", diffusion_parts, False, EXPECT_DIFFUSION,
             dict(k_step=100, speedup=10, method="dpm-solver")),
            ("sins from a wav", sins_parts, True, EXPECT_SINS, {})):
        args, model, vocoder = parts
        pipe = pipes[what] = wav_pipeline(
            (args, copy.deepcopy(model), copy.deepcopy(vocoder)), enhance)
        check_on_card(pipe, what)
        requests = [(s, len(waves[s]) // BLOCK + 1,
                     lambda w=waves[s]: pipe.infer(w, SR, **kwargs))
                    for s in REQUEST_SECONDS]
        launches[what], walls = serve_requests(torch, what, expect, card,
                                               requests, ENCODER_RANGE)
        stage_walls(torch, pipe, waves[REQUEST_SECONDS[-1]], what, expect, card)
        launches[what + " (staged)"] = expect
        if enhance:
            continue
        # the same 10 s request with the f0 on the card
        dev = wav_pipeline((pipe.args, pipe.model, pipe.vocoder), False,
                           device_f0=True, encoder=pipe.units_encoder)
        seconds = REQUEST_SECONDS[-1]
        wave = waves[seconds]
        launches["diffusion-fast, device YIN"], dev_walls = serve_requests(
            torch, "diffusion-fast from a wav, device YIN", expect, card,
            [(seconds, len(wave) // BLOCK + 1, lambda: dev.infer(wave, SR, **kwargs))],
            ENCODER_RANGE)
        host_f0 = pipe.extract_f0(wave, SR)
        dev_f0 = dev.extract_f0(wave, SR).cpu().numpy()
        hop = pipe.hop_size(SR)
        raw_host = yin_f0(wave, SR, hop, pipe.f0_min, pipe.f0_max)
        raw_dev = make_yin_fn(len(wave), SR, hop, pipe.f0_min, pipe.f0_max)(
            torch.as_tensor(wave, device="cuda")).cpu().numpy()
        c_raw = cents_check(raw_dev, raw_host, "device YIN (before interpolation)")
        c_pipe = cents_check(dev_f0, host_f0, "device YIN (pipeline f0)", voicing=False)
        log(f"[devf0] {seconds} s diffusion-fast request: warm median wall with "
            f"the device YIN {dev_walls[seconds] * 1e3:.2f} ms, with the host YIN "
            f"{walls[seconds] * 1e3:.2f} ms; device YIN vs host YIN: identical voicing "
            f"({int((raw_host > 0).sum())} of {len(raw_host)} frames voiced), "
            f"max {c_raw:.5f} cents before interpolation, {c_pipe:.5f} cents "
            f"on the pipeline's f0 (limit 0.05) [{card}]")
    return launches, pipes


# ---------------------------------------------------------------- phase 9


def phase_wav_card_vs_cpu(torch, card: str, pipes: dict, cpu_parts: dict) -> None:
    """The 2 s recording through SvcPipeline.infer on the card and on the
    CPU: the same weights (the CPU encoder drawn from the same seed) and
    injected noise."""
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder

    rng = np.random.default_rng(SEED + 4)
    wave = voice_wave(2, rng)
    t = len(wave) // BLOCK + 1
    cpu_encoder = UnitsEncoder(ENCODER, device="cpu", seed=SEED)
    units = {}
    for what, gpu in pipes.items():
        enhance = gpu.enhancer is not None
        cpu = wav_pipeline(cpu_parts[what], enhance, device="cpu",
                           encoder=cpu_encoder)
        noise = request_noise(rng, t, "uniform" if enhance else "normal")
        audios = {}
        for name, pipe in (("card", gpu), ("cpu", cpu)):
            units[name] = pipe.encode_units(wave, SR).float().cpu().numpy()
            audio, sr = pipe.infer(wave, SR, noise=noise)
            audios[name] = check_audio(audio, t, f"{what} 2 s on {name}")
        u_err = float(np.abs(units["card"] - units["cpu"]).max()
                      / np.abs(units["cpu"]).max())
        snr = snr_db(audios["cpu"], audios["card"])
        log(f"[parity] {what}: 2 s recording through infer, card (kernels) vs "
            f"CPU (plain), same weights and noise: units max-abs diff "
            f"{u_err:.3e} x max|units|, audio SNR {snr:.2f} dB (limit >= "
            f"{SNR_LIMIT_DB:.0f} dB) [{card}]")
        if not snr >= SNR_LIMIT_DB:
            fail(f"{what} card vs CPU audio SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
        del cpu


# ---------------------------------------------------------------- phase 10


def phase_cli(torch, card: str, pipes: dict) -> dict:
    """cli.infer.convert on a 12 s recording with two silences for both
    paths. Returns {path: launch counts}."""
    import tempfile

    from ddsp_svc_tpu_torch.cli import infer as cli
    from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
    from ddsp_svc_tpu_torch.features.slicer import split_audio

    rng = np.random.default_rng(SEED + 5)
    wave = voice_wave(12, rng, silences=CLI_SILENCES)
    segments = split_audio(wave, SR)
    if len(segments) < 2:
        fail(f"the CLI's recording gave {len(segments)} segment(s), expected >= 2")
    # the JAX CLI's splice length: each segment's output (T_seg blocks at
    # the output rate) placed at its start frame, cross-faded when it
    # overlaps what came before
    expected_len = 0
    for start, seg in segments:
        silent = round(start // BLOCK * BLOCK) - expected_len
        expected_len += silent + (len(seg) // BLOCK + 1) * BLOCK
    wrappers = counts()
    launches = {}
    for what, pipe, per_request in (
            ("diffusion-fast CLI", pipes["diffusion-fast from a wav"], EXPECT_DIFFUSION),
            ("sins CLI", pipes["sins from a wav"], EXPECT_SINS)):
        options = cli.parse_args(["-m", "in-memory", "-i", "in.wav", "-o", "out.wav"])
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, sr = cli.convert(pipe, wave, SR, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[what] = {n: w.launches for n, w in wrappers.items()}
        expect = {n: len(segments) * c for n, c in per_request.items()}
        if launches[what] != expect:
            fail(f"{what}: launches {launches[what]}, expected {expect} "
                 f"({len(segments)} segments)")
        if sr != SR or audio.shape != (expected_len,):
            fail(f"{what}: {audio.shape} samples at {sr} Hz, expected "
                 f"({expected_len},) at {SR}")
        if not np.isfinite(audio).all() or np.abs(audio).max() <= 1e-4:
            fail(f"{what}: output non-finite or silent")
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "out.wav")
            save_wav(path, audio.astype(np.float32), sr)
            back, back_sr = load_wav(path)
        quant = float(np.abs(back - np.clip(audio, -1.0, 1.0)).max())
        if back_sr != sr or back.shape != audio.shape or quant > 2.0 / 32767:
            fail(f"{what}: the PCM16 file read back differs ({back.shape} at "
                 f"{back_sr} Hz, max diff {quant:.3e})")
        log(f"[cli] {what}: 12 s recording -> {len(segments)} segments "
            f"(starts {[s for s, _ in segments]}), {len(audio)} samples at {sr} "
            f"Hz as the JAX CLI splices them, wall {wall * 1e3:.1f} ms, launches "
            f"{launches[what]}, PCM16 file read back within {quant:.2e} [{card}]")
    return launches


# ---------------------------------------------------------------- phase 11


def phase_samplers(torch, card: str, pipe) -> dict:
    """One 2 s DiffusionFast request per other sampler. Returns {sampler:
    launch counts}."""
    rng = np.random.default_rng(SEED + 6)
    wave = voice_wave(2, rng)
    t = len(wave) // BLOCK + 1
    wrappers = counts()
    launches = {}
    for method, speedup, k3 in SAMPLERS:
        name = "ddpm chain" if speedup == 1 else method
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, sr = pipe.infer(wave, SR, k_step=100, speedup=speedup, method=method)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {n: w.launches for n, w in wrappers.items()}
        expect = dict(EXPECT_DIFFUSION, conformer_layer=k3)
        if launches[name] != expect:
            fail(f"sampler {name}: launches {launches[name]}, expected {expect}")
        check_audio(audio, t, f"sampler {name} 2 s request")
        log(f"[samplers] {name} (k_step 100, speedup {speedup}): 2 s request "
            f"{wall * 1e3:.1f} ms (first run of its shape), K3 launches {k3} "
            f"[{card}]")
    return launches


# ---------------------------------------------------------------- phase 12


def _backward(fn, leaves, grad_out):
    for leaf in leaves:
        leaf.grad = None
    out = fn()
    out.backward(grad_out)
    return out.detach(), [leaf.grad.clone() for leaf in leaves]


def phase_gradients(torch, card: str) -> None:
    """K2 (its C = 256 stage), K3, B3 and K4 at the 10 s request's shapes
    with grad on: each wrapper's forward (the kernel, one launch) and
    backward (autograd through the plain version, no launch), the forward
    within GRAD_TOL x max|out| (B3: ``bf16_layer_agreement`` with its bf16
    plain version) and every input's and weight's .grad within GRAD_TOL x
    max|grad| of plain autograd on the card (B3: of the f32 chain); K1
    refuses an f0 that requires grad."""
    from ddsp_svc_tpu_torch.ops import cuda_conformer, cuda_oscillator, cuda_resblock
    from ddsp_svc_tpu_torch.ops.cuda_source import combtooth
    from ddsp_svc_tpu_torch.ops.source import cumsum_phase_source

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 7)
    t = frames_for(10)

    def leaves(*shapes_scales):
        return [_rand(torch, gen, shape, scale).to(dev).requires_grad_()
                for shape, scale in shapes_scales]

    c, per_frame = K2_STAGES[0]
    x, = leaves(((1, t * per_frame, c), 1.0))
    weights = [[tuple(leaves(((c, c, k), (c * k) ** -0.5), ((c,), (c * k) ** -0.5)))
                for _ in range(2 * len(d))] for k, d in zip(K2_KERNEL_SIZES, K2_DILATIONS)]
    k2 = (cuda_resblock.resblock_group,
          [x] + [p for rbw in weights for wb in rbw for p in wb],
          lambda: cuda_resblock.resblock_group(
              x, cuda_resblock.PackedResblocks(weights), K2_KERNEL_SIZES, K2_DILATIONS),
          lambda: cuda_resblock.resblock_group_plain(
              x, weights, K2_KERNEL_SIZES, K2_DILATIONS))
    c, hc, inner, k = 512, 128, 1024, 31
    k3_leaves = leaves(((1, t, c), 1.0), ((1, t, hc), 1.0), ((1, c), 1.0),
                       ((c, hc), hc ** -0.5), ((c,), 0.1), ((2 * inner, c), c ** -0.5),
                       ((2 * inner,), 0.1), ((inner, k), k ** -0.5), ((inner,), 0.1),
                       ((c, inner), inner ** -0.5), ((c,), 0.1))
    k3 = (cuda_conformer.conformer_layer, k3_leaves,
          lambda: cuda_conformer.conformer_layer(*k3_leaves[:3], k3_leaves[3:]),
          lambda: cuda_conformer.conformer_layer_plain(*k3_leaves[:3], k3_leaves[3:]))
    f0 = torch.from_numpy(f0_contour(t)).to(dev)
    phase = cumsum_phase_source(torch.repeat_interleave(f0, BLOCK, dim=1), SR,
                                BLOCK).contiguous().requires_grad_()
    amps, = leaves(((1, t, SINS["n_harmonics"]), 0.02))
    k4 = (cuda_oscillator.harmonic_bank, [phase, amps],
          lambda: cuda_oscillator.harmonic_bank(phase, amps, BLOCK),
          lambda: cuda_oscillator.harmonic_bank_plain(phase, amps, BLOCK))
    # B3: the bf16 forward, the f32 chain's backward (as JAX's custom VJP);
    # its forward is held to its bf16 plain version by bf16_layer_agreement
    b3 = (cuda_conformer.conformer_layer_bf16, k3_leaves,
          lambda: cuda_conformer.conformer_layer_bf16(*k3_leaves[:3], k3_leaves[3:]),
          k3[3])

    def b3_forward(got, _):
        with torch.no_grad():
            want = cuda_conformer.conformer_layer_bf16_plain(*k3_leaves[:3],
                                                             k3_leaves[3:])
        a = cuda_conformer.bf16_layer_agreement(got, want, k3_leaves[0].detach())
        return a["rel"] if a["ok"] else float("inf")

    problems = []
    for kid, (wrapper, inputs, call, plain) in (("K2 resblock_group C=256", k2),
                                                 ("K3 conformer_layer", k3),
                                                 ("B3 conformer_layer_bf16", b3),
                                                 ("K4 harmonic_bank", k4)):
        with torch.no_grad():
            grad_out = torch.randn(plain().shape, generator=gen).to(dev)
        n0 = wrapper.launches
        got, got_grads = _backward(call, inputs, grad_out)
        torch.cuda.synchronize()
        launched = wrapper.launches - n0
        want, want_grads = _backward(plain, inputs, grad_out)
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got_grads, want_grads)]
        if kid.startswith("B3"):
            fwd = b3_forward(got, want)
            fwd_ok = fwd <= cuda_conformer.BF16_LAYER_ATOL
        else:
            fwd = float((got - want).abs().max() / want.abs().max())
            fwd_ok = fwd <= GRAD_TOL
        ok = (launched == 1 and wrapper.launches - n0 == 1
              and fwd_ok and max(errs) <= GRAD_TOL)
        if not ok:
            problems.append(f"{kid}: launches {launched}, forward rel err "
                            f"{fwd:.3e}, .grad rel err {max(errs):.3e}")
        log(f"[grad] {kid} at the 10 s shapes, grad on: forward {fwd:.3e} x "
            f"max|{'branch' if kid.startswith('B3') else 'out'}| from plain, "
            f"{len(errs)} gradients (every input and weight) "
            f"within {max(errs):.3e} x max|grad| of plain autograd (tol "
            f"{GRAD_TOL:g}); kernel launches: forward {launched}, backward "
            f"{wrapper.launches - n0 - launched} [{card}]")
    f0_grad = f0.clone().requires_grad_()
    try:
        combtooth(f0_grad, SR, BLOCK)
        problems.append("K1 combtooth returned on an f0 that requires grad")
    except RuntimeError as e:
        log(f"[grad] K1 combtooth on an f0 that requires grad: raises ({e})")
    if problems:
        fail("gradients: " + "; ".join(problems))


# ---------------------------------------------------------------- phase 13


def features_card_vs_cpu(torch, card: str, what: str, parts, seconds: float,
                         draws: str, seed: int = SEED + 8, **kwargs) -> float:
    """``seconds`` of features through ``infer_features`` on the card and
    on the CPU, the same weights and injected noise (``draws``: the DDSP
    noise's law, 'normal' or 'uniform'; inputs and noise drawn from
    ``seed``) -> the audio SNR, >= SNR_LIMIT_DB."""
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    args, model, vocoder = parts
    rng = np.random.default_rng(seed)
    gpu = SvcPipeline.from_parts(copy.deepcopy(model), None, args,
                                 copy.deepcopy(vocoder), seed=SEED)
    cpu = SvcPipeline.from_parts(copy.deepcopy(model), None, args,
                                 copy.deepcopy(vocoder), device="cpu", seed=SEED)
    inputs = request_inputs(cpu, seconds, rng)
    t = inputs["volume"].shape[1]
    noise = request_noise(rng, t, draws)
    audios = {}
    for name, pipe in (("card", gpu), ("cpu", cpu)):
        audio, _ = pipe.infer_features(**inputs, noise=noise, **kwargs)
        audios[name] = check_audio(audio, t, f"{what} {seconds:g} s on {name}")
    snr = snr_db(audios["cpu"], audios["card"])
    log(f"[parity] {what} {seconds:g} s request from features, card (kernels) vs "
        f"CPU (plain), same weights and noise: audio SNR {snr:.2f} dB (limit >= "
        f"{SNR_LIMIT_DB:.0f} dB) [{card}]")
    if not snr >= SNR_LIMIT_DB:
        fail(f"{what} card vs CPU audio SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
    del gpu, cpu
    torch.cuda.empty_cache()
    return snr


def phase_reflow(torch, card: str, encoder) -> tuple[dict, dict]:
    """The rectified-flow path at configs/reflow.yaml widths: 10 s requests
    from features and from a wav, euler 20 and rk4 5 at t_start 0.7, each
    served as phase 4 serves DiffusionFast; card vs CPU from features at
    2 s. Returns ({path: launch counts}, the CPU parts and the wav
    pipeline)."""
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    parts = random_parts(torch, REFLOW)
    args, model, vocoder = parts
    feat = SvcPipeline.from_parts(copy.deepcopy(model), None, args,
                                  copy.deepcopy(vocoder), seed=SEED)
    wav = wav_pipeline((args, copy.deepcopy(model), copy.deepcopy(vocoder)), False,
                       encoder=encoder)
    check_on_card(wav, "reflow")
    rng = np.random.default_rng(SEED + 9)
    seconds = REQUEST_SECONDS[-1]
    inputs = request_inputs(feat, seconds, rng)
    wave = voice_wave(seconds, rng)
    launches = {}
    for sampler, steps in REFLOW_SAMPLERS:
        kw = dict(method=sampler, infer_step=steps, t_start=0.7)
        for what, t, call in (
                (f"reflow {sampler} {steps}", inputs["volume"].shape[1],
                 lambda kw=kw: feat.infer_features(**inputs, **kw)),
                (f"reflow {sampler} {steps} from a wav", len(wave) // BLOCK + 1,
                 lambda kw=kw: wav.infer(wave, SR, **kw))):
            launches[what] = serve_requests(
                torch, what, EXPECT_REFLOW, card, [(seconds, t, call)],
                ENCODER_RANGE if what.endswith("wav") else None)[0]
    for sampler, steps in REFLOW_SAMPLERS:
        features_card_vs_cpu(torch, card, f"reflow {sampler} {steps}", parts, 2,
                             "normal", method=sampler, infer_step=steps)
    return launches, {"parts": parts, "wav": wav}


# ---------------------------------------------------------------- phase 14


def phase_wavenet_families(torch, card: str, encoder, reflow_parts) -> dict:
    """Unit2Mel and Unit2Wav at configs/diffusion.yaml and
    configs/diffusion-new.yaml widths (the latter with two speakers, for the
    mix): one 10 s request each from features, served as phase 4 serves
    DiffusionFast, and card vs CPU (Unit2Mel at 1 s: its 100 WaveNet calls
    of 20 layers are slow on the host); cli.infer.convert of phase 10's
    12 s recording with -ddsp and -fs (Unit2Mel seeded by an external
    CombSubSuperFast) and with -mix (Unit2Wav); one rectified-flow request
    with a random log10 ResBlock2 vocoder, served as the others, and card
    vs CPU at 2 s. Returns {path: launch counts}."""
    from ddsp_svc_tpu_torch.cli import infer as cli
    from ddsp_svc_tpu_torch.features.slicer import split_audio
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    launches = {}
    rng = np.random.default_rng(SEED + 10)
    families = (("unit2mel", random_parts(torch, UNIT2MEL), 1),
                ("unit2wav", random_parts(torch, UNIT2WAV, n_spk=2), 2))
    seconds = REQUEST_SECONDS[-1]
    for what, parts, cpu_seconds in families:
        args, model, vocoder = parts
        pipe = SvcPipeline.from_parts(copy.deepcopy(model), None, args,
                                      copy.deepcopy(vocoder), seed=SEED)
        inputs = request_inputs(pipe, seconds, rng)
        launches[what] = serve_requests(
            torch, what, EXPECT_WAVENET, card,
            [(seconds, inputs["volume"].shape[1],
              lambda pipe=pipe, inputs=inputs: pipe.infer_features(**inputs))])[0]
        del pipe
        features_card_vs_cpu(torch, card, what, parts, cpu_seconds,
                             "uniform" if what == "unit2wav" else "normal")

    wrappers = counts()
    wave = voice_wave(12, rng, silences=CLI_SILENCES)
    segments = split_audio(wave, SR)
    ddsp_args, ddsp_model, _ = random_parts(
        torch, {"type": "CombSubSuperFast", "win_length": WIN})
    ddsp_model = ddsp_model.to(encoder.device).eval()
    for what, parts, flags, per_segment in (
            ("unit2mel CLI -ddsp -fs 2", families[0][1],
             ["-ddsp", "in-memory", "-fs", "2", "-kstep", "100"],
             dict(EXPECT_WAVENET, combtooth=1)),
            ("unit2wav CLI -mix", families[1][1], ["-mix", str(MIX)], EXPECT_WAVENET)):
        args, model, vocoder = parts
        pipe = wav_pipeline((args, copy.deepcopy(model), copy.deepcopy(vocoder)),
                            False, encoder=encoder)
        options = cli.parse_args(["-m", "in-memory", "-i", "in.wav", "-o",
                                  "out.wav"] + flags)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, sr = cli.convert(pipe, wave, SR, options,
                                ddsp_model=ddsp_model if "-ddsp" in flags else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[what] = {n: w.launches for n, w in wrappers.items()}
        expect = {n: len(segments) * c for n, c in per_segment.items()}
        if launches[what] != expect:
            fail(f"{what}: launches {launches[what]}, expected {expect}")
        if sr != SR or not np.isfinite(audio).all() or np.abs(audio).max() <= 1e-4:
            fail(f"{what}: {audio.shape} samples at {sr} Hz, non-finite or silent")
        log(f"[cli] {what}: 12 s recording -> {len(segments)} segments, "
            f"{len(audio)} samples at {sr} Hz, wall {wall * 1e3:.1f} ms (first "
            f"run of its shapes), launches {launches[what]} [{card}]")
        del pipe

    args, model, _ = reflow_parts
    _, _, log10_voc = random_parts(
        torch, REFLOW, vocoder_type="nsf-hifigan-log10",
        vocoder_cfg={"resblock": "2", "resblock_dilation_sizes": ((1, 3),) * 3})
    pipe = SvcPipeline.from_parts(copy.deepcopy(model), None, args, log10_voc,
                                  seed=SEED)
    inputs = request_inputs(pipe, seconds, rng)
    what = "reflow, log10 ResBlock2 vocoder"
    launches[what] = serve_requests(
        torch, what, dict(EXPECT_REFLOW, resblock_group=0), card,
        [(seconds, inputs["volume"].shape[1], lambda: pipe.infer_features(**inputs))])[0]
    del pipe
    # inputs that no earlier request on these weights had
    features_card_vs_cpu(torch, card, what, (args, model, log10_voc), 2, "normal",
                         seed=SEED + 11)
    return launches


# ---------------------------------------------------------------- phase 15


def phase_realtime(torch, card: str, pipes: dict, cpu_parts: dict) -> dict:
    """RealtimeVC on the card over RT_SECONDS of a synthetic voice for the
    DiffusionFast, rectified-flow and Sins pipelines from a wav: the block
    walls of drive_blocks (median and max over all but the first two
    blocks), the launches of every block, and the first RT_CPU_BLOCKS
    blocks' spliced output against the port on the CPU with the same
    blocks and noise. Returns {path: launch counts}."""
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.infer.realtime import RealtimeVC, drive_blocks

    rng = np.random.default_rng(SEED + 11)
    wave = voice_wave(RT_SECONDS, rng)
    context = int(RT["extra_time"] * SR) + int(RT["block_time"] * SR)
    t = context // BLOCK + 1
    cpu_encoder = UnitsEncoder(ENCODER, device="cpu", seed=SEED)
    wrappers = counts()
    launches = {}
    for what, expect, kwargs in (
            ("diffusion-fast", EXPECT_DIFFUSION, dict(k_step=100, speedup=10)),
            ("reflow", EXPECT_REFLOW, {}),
            ("sins", EXPECT_SINS, {})):
        gpu = pipes[what]
        check_on_card(gpu, f"realtime {what}")
        enhance = gpu.enhancer is not None
        noise = request_noise(rng, t, "uniform" if what == "sins" else "normal")
        engines = {}
        for name, pipe in (("card", gpu), ("cpu", wav_pipeline(
                cpu_parts[what], enhance, device="cpu", encoder=cpu_encoder))):
            engines[name] = RealtimeVC(pipe, SR, **RT, noise=noise, **kwargs)
        vc = engines["card"]
        per_block = []
        process = vc.process_block

        def counted(block, process=process, per_block=per_block):
            before = {n: w.launches for n, w in wrappers.items()}
            out = process(block)
            per_block.append({n: w.launches - before[n] for n, w in wrappers.items()})
            return out

        vc.process_block = counted
        for w in wrappers.values():
            w.launches = 0
        out, stats = drive_blocks(vc, wave)
        launches[f"realtime {what}"] = {n: w.launches for n, w in wrappers.items()}
        bad = [i for i, c in enumerate(per_block) if c != expect]
        if bad:
            fail(f"realtime {what}: block {bad[0]} launched {per_block[bad[0]]}, "
                 f"expected {expect}")
        steady = np.asarray(stats["times_s"][2:] or stats["times_s"]) * 1e3
        if out.shape != wave.shape or not np.isfinite(out).all():
            fail(f"realtime {what}: output {out.shape}, non-finite or mis-sized")
        n_cmp = RT_CPU_BLOCKS * vc.block_frame
        want = drive_blocks(engines["cpu"], wave[:n_cmp])[0]
        snr = snr_db(want, out[:n_cmp])
        log(f"[realtime] {what}: {stats['blocks']} blocks of {RT['block_time']} s "
            f"with {RT['extra_time']} s of extra context over {RT_SECONDS:g} s; "
            f"block wall median {np.median(steady):.2f} ms, max {steady.max():.2f} "
            f"ms, mean {stats['block_ms']:.2f} ms (all but the first two blocks; "
            f"first {stats['times_s'][0] * 1e3:.1f} ms), real-time factor "
            f"{np.median(steady) / (RT['block_time'] * 1e3):.4f}; launches per "
            f"block {expect}; first {RT_CPU_BLOCKS} blocks card vs CPU, same "
            f"blocks and noise: SNR {snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} dB) "
            f"[{card}]")
        if not snr >= SNR_LIMIT_DB:
            fail(f"realtime {what} card vs CPU SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
    return launches


# ---------------------------------------------------------------- phase 16


EXPECT_DIFFUSION_BF16 = dict(EXPECT_DIFFUSION, resblock_group=0,
                             resblock_group_bf16=4, conformer_layer_bf16=0,
                             conformer_layer_bf16_io=0)
EXPECT_SINS_BF16 = dict(EXPECT_SINS, resblock_group=0, resblock_group_bf16=4,
                        conformer_layer_bf16=0, conformer_layer_bf16_io=0)
BF16_SNR_LIMIT_DB = 25.0  # bf16 against f32: the JAX package's gate


def all_counts():
    """``counts`` and the bf16 classes: K2's, which only phases 16-17
    launch, K3's (B3), which only phase 18 launches, and K3's on bf16
    activations (B5), which only phase 19 launches."""
    from ddsp_svc_tpu_torch.ops.cuda_conformer import (conformer_layer_bf16,
                                                       conformer_layer_bf16_io)
    from ddsp_svc_tpu_torch.ops.cuda_resblock import resblock_group_bf16

    return dict(counts(), resblock_group_bf16=resblock_group_bf16,
                conformer_layer_bf16=conformer_layer_bf16,
                conformer_layer_bf16_io=conformer_layer_bf16_io)


def _with_zeros(expect: dict) -> dict:
    return {n: expect.get(n, 0) for n in all_counts()}


def sibling(pipe, device=None, copy_weights: bool = False, **kwargs):
    """A pipeline over ``pipe``'s model, NSF-HiFiGAN and encoder (shared,
    or copied to ``device``) with other options (vocoder_bf16, device_f0)."""
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    voc = pipe.vocoder if pipe.vocoder is not None else pipe.enhancer.vocoder
    model, enc = pipe.model, pipe.units_encoder
    if copy_weights:
        model, voc = (copy.deepcopy(m).to(device) for m in (model, voc))
        enc = None
    return SvcPipeline.from_parts(model, None, pipe.args, voc, device=device,
                                  seed=SEED, enhance=pipe.enhancer is not None,
                                  units_encoder=enc, **kwargs)


def phase_bf16_vocoder(torch, card: str, pipes: dict) -> dict:
    """The NSF-HiFiGAN in bf16 (vocoder_bf16): a 10 s DiffusionFast request
    and a 10 s Sins request (bf16 enhancer) from features, their launches
    exactly, their audio against the f32 pipeline on the card, warm walls
    of both, the 2 s request card against CPU with bf16 on both sides, and
    cli.infer.convert with --voc_bf16. Returns {path: launch counts}."""
    from ddsp_svc_tpu_torch.cli import infer as cli
    from ddsp_svc_tpu_torch.features.slicer import split_audio

    wrappers = all_counts()
    rng = np.random.default_rng(SEED + 16)
    launches = {}
    for what, f32, expect, draws, kwargs in (
            ("diffusion-fast bf16 vocoder", pipes["diffusion-fast from a wav"],
             EXPECT_DIFFUSION_BF16, "normal",
             dict(k_step=100, speedup=10, method="dpm-solver")),
            ("sins bf16 enhancer", pipes["sins from a wav"], EXPECT_SINS_BF16,
             "uniform", {})):
        bf16 = sibling(f32, vocoder_bf16=True)
        inputs = request_inputs(bf16, 10, rng)
        t = inputs["volume"].shape[1]
        noise = request_noise(rng, t, draws)
        for w in wrappers.values():
            w.launches = 0
        audio, _ = bf16.infer_features(**inputs, noise=noise, **kwargs)
        torch.cuda.synchronize()
        got = {n: w.launches for n, w in wrappers.items()}
        if got != expect:
            fail(f"{what}: launches {got}, expected {expect}")
        launches[what] = got
        a_bf16 = check_audio(audio, t, what)
        a_f32 = check_audio(f32.infer_features(**inputs, noise=noise, **kwargs)[0],
                            t, what + " (f32)")
        snr = snr_db(a_f32, a_bf16)
        walls = {}
        for name, pipe in (("f32", f32), ("bf16", bf16)):
            runs = []
            for _ in range(WARM_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.infer_features(**inputs, noise=noise, **kwargs)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            walls[name] = sorted(runs)[len(runs) // 2]
        log(f"[bf16] {what} 10 s request T={t}: launches {got}; audio SNR "
            f"{snr:.2f} dB against the f32 pipeline (limit >= "
            f"{BF16_SNR_LIMIT_DB:.0f} dB); warm median wall bf16 "
            f"{walls['bf16'] * 1e3:.2f} ms, f32 {walls['f32'] * 1e3:.2f} ms "
            f"(n={WARM_RUNS}) [{card}]")
        if not snr >= BF16_SNR_LIMIT_DB:
            fail(f"{what}: bf16 vs f32 SNR {snr:.2f} dB < {BF16_SNR_LIMIT_DB} dB")
        # card against CPU, bf16 on both sides, 2 s
        cpu = sibling(f32, device="cpu", copy_weights=True, vocoder_bf16=True)
        inputs = request_inputs(cpu, 2, rng)
        t = inputs["volume"].shape[1]
        noise = request_noise(rng, t, draws)
        audios = {name: check_audio(p.infer_features(**inputs, noise=noise,
                                                     **kwargs)[0], t,
                                    f"{what} 2 s on {name}")
                  for name, p in (("card", bf16), ("cpu", cpu))}
        snr = snr_db(audios["cpu"], audios["card"])
        log(f"[bf16] {what} 2 s request, card (B4) vs CPU (its plain "
            f"version), bf16 on both, same weights and noise: audio SNR "
            f"{snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} dB) [{card}]")
        if not snr >= SNR_LIMIT_DB:
            fail(f"{what} card vs CPU SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
        del cpu, bf16
        torch.cuda.empty_cache()
    # the offline CLI's conversion with --voc_bf16 (mel cascades)
    wave = voice_wave(12, np.random.default_rng(SEED + 5), silences=CLI_SILENCES)
    segments = split_audio(wave, SR)
    options = cli.parse_args(["-m", "in-memory", "-i", "in.wav", "-o", "out.wav",
                              "--voc_bf16"])
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    audio, sr = cli.convert(pipes["diffusion-fast from a wav"], wave, SR, options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    what = "diffusion-fast CLI --voc_bf16"
    launches[what] = {n: w.launches for n, w in wrappers.items()}
    expect = {n: len(segments) * c for n, c in EXPECT_DIFFUSION_BF16.items()}
    if launches[what] != expect:
        fail(f"{what}: launches {launches[what]}, expected {expect}")
    if sr != SR or not np.isfinite(audio).all() or np.abs(audio).max() <= 1e-4:
        fail(f"{what}: output at {sr} Hz non-finite or silent")
    log(f"[bf16] {what}: 12 s recording, {len(segments)} segments, {len(audio)} "
        f"samples, wall {wall * 1e3:.1f} ms, launches {launches[what]} [{card}]")
    return launches


# ---------------------------------------------------------------- phase 17


BUCKETS = (128, 256, 512, 1024)
BATCH = 8
BATCH_WAIT_MS = 100.0  # long enough for concurrent front ends to meet
BATCH_ROW_SNR_DB = 80.0
DIFF_KW = dict(k_step=100, speedup=10, method="dpm-solver")
EXPECT_BATCH = dict(EXPECT_DIFFUSION)  # per batch, whatever its rows


def _concurrently(fns) -> list:
    """Run the callables in threads started together -> their results (an
    exception in any fails the run)."""
    import threading

    out, errors = [None] * len(fns), []
    barrier = threading.Barrier(len(fns))

    def run(i):
        try:
            barrier.wait()
            out[i] = fns[i]()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail(f"a concurrent request failed: {errors[0]!r}")
    return out


def _post(base: str, wave: np.ndarray, **fields):
    import io
    import urllib.request
    import uuid

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, np.clip(wave * 32767, -32768, 32767).astype(np.int16))
    fields = {"sample": buf.getvalue(), "fPitchChange": 0.0, "sSpeakId": 1,
              "sampleRate": SR, **fields}
    boundary = uuid.uuid4().hex
    body = b"".join(
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
        .encode() + (v if isinstance(v, bytes) else str(v).encode()) + b"\r\n"
        for k, v in fields.items()) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        base + "/voiceChangeModel", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        status, payload, headers = r.status, r.read(), dict(r.headers)
    out_sr, data = wavfile.read(io.BytesIO(payload))
    return status, out_sr, data.astype(np.float32) / 32767.0, headers


def _check_wav(status, sr, data, n_in: int, what: str) -> None:
    n = (n_in // BLOCK + 1) * BLOCK
    if status != 200 or sr != SR or data.shape != (n,):
        fail(f"{what}: status {status}, {data.shape} samples at {sr} Hz, "
             f"expected 200 and ({n},) at {SR}")
    if not np.isfinite(data).all() or np.abs(data).max() <= 1e-4:
        fail(f"{what}: non-finite or silent")


def _serve(pipe):
    import threading

    from ddsp_svc_tpu_torch.cli.api import Server, make_handler

    srv = Server(("127.0.0.1", 0), make_handler(pipe, DIFF_KW))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def phase_batched_serving(torch, card: str, wav_pipe) -> dict:
    """Batched serving at configs/diffusion-fast.yaml widths with the
    contentvec768l12 encoder and host YIN: (a) eight concurrent requests of
    one bucket against each alone in a batch of one, and the one that fills
    the bucket against the direct path (batching off, its row's draws
    handed over by ``request_noise``); (b) the HTTP server; (c)
    aggregate throughput at concurrency 1, 4, 8 and 16 and the device's
    busy share of one profiled batch. Returns {path: launch counts}."""
    import json
    import urllib.request

    wrappers = all_counts()
    rng = np.random.default_rng(SEED + 17)
    pipe = sibling(wav_pipe)
    launches = {}

    # (a) rows against solo requests; the last fills bucket 1024 exactly
    lengths = [9.0 + 0.35 * i for i in range(BATCH - 1)]
    waves = [voice_wave(s, rng) for s in lengths]
    waves.append(voice_wave(12.0, rng)[:(BUCKETS[-1] - 1) * BLOCK])
    lengths.append(len(waves[-1]) / SR)
    seeds = [1000 + i for i in range(BATCH)]
    direct = pipe.infer(waves[-1], SR, noise=pipe.request_noise(
        seeds[-1], BUCKETS[-1]), **DIFF_KW)[0]
    batcher = pipe.enable_batching(buckets=BUCKETS, max_batch=BATCH,
                                   max_wait_ms=BATCH_WAIT_MS, **DIFF_KW)
    solo = [pipe.infer(w, SR, seed=s, **DIFF_KW)[0] for w, s in zip(waves, seeds)]
    before = batcher.stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rows = _concurrently([lambda w=w, s=s: pipe.infer(w, SR, seed=s, **DIFF_KW)[0]
                          for w, s in zip(waves, seeds)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: w.launches for n, w in wrappers.items()}
    stats = batcher.stats()
    n_b = stats["batches"] - before["batches"]
    expect = {n: n_b * c for n, c in _with_zeros(EXPECT_BATCH).items()}
    if got != expect:
        fail(f"batched rows: launches {got} over {n_b} batches, expected {expect}")
    launches["batched serving (a)"] = got
    snrs = [snr_db(a, b) for a, b in zip(solo, rows)]
    snr_direct = snr_db(direct, rows[-1]) if direct.shape == rows[-1].shape else -math.inf
    for i, (w, r) in enumerate(zip(waves, rows)):
        check_audio(r, len(w) // BLOCK + 1, f"batched row {i}")
    log(f"[batch] (a) {BATCH} concurrent requests of {lengths[0]:.2f}-"
        f"{lengths[-1]:.2f} s (bucket 1024): {n_b} batches, occupancy "
        f"{stats['mean_batch_occupancy']}, fill {stats['mean_batch_fill']}, "
        f"launches {got} ({EXPECT_BATCH} per batch), wall {wall * 1e3:.1f} ms; "
        f"rows vs the same requests alone in a batch of one: SNR min "
        f"{min(snrs):.1f} dB; the {lengths[-1]:.3f} s row (1024 frames) vs the "
        f"direct path with its draws: {snr_direct:.1f} dB (limits >= "
        f"{BATCH_ROW_SNR_DB:.0f} dB), recent batches "
        f"{stats['recent_batches'][-n_b:]} [{card}]")
    if not min(snrs) >= BATCH_ROW_SNR_DB:
        fail(f"batched rows vs solo: SNR {min(snrs):.1f} dB < {BATCH_ROW_SNR_DB} dB")
    if not snr_direct >= BATCH_ROW_SNR_DB:
        fail(f"batched row vs the direct path: SNR {snr_direct:.1f} dB < "
             f"{BATCH_ROW_SNR_DB} dB ({direct.shape} vs {rows[-1].shape})")

    # (b) over HTTP
    srv, base = _serve(pipe)
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("/health did not answer ok")
        http_waves = [voice_wave(2.0 + 0.5 * i, rng) for i in range(16)]
        before = batcher.stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        answers = _concurrently([lambda w=w: _post(base, w) for w in http_waves])
        wall = time.perf_counter() - t0
        launches["batched serving over HTTP"] = {n: w.launches
                                                 for n, w in wrappers.items()}
        for i, (w, (status, sr, data, _)) in enumerate(zip(http_waves, answers)):
            _check_wav(status, sr, data, len(w), f"HTTP request {i}")
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())["batching"]
        log(f"[batch] (b) 16 concurrent POSTs of 2-9.5 s: all 200 with the "
            f"right length, wall {wall * 1e3:.1f} ms; /stats: "
            f"{stats['requests'] - before['requests']} requests in "
            f"{stats['batches'] - before['batches']} batches, occupancy "
            f"{stats['mean_batch_occupancy']}, p50 {stats['latency_ms_p50']} ms, "
            f"p99 {stats['latency_ms_p99']} ms [{card}]")
        long_wave = voice_wave(13.0, rng)
        n_req = batcher.stats()["requests"]
        status, sr, data, _ = _post(base, long_wave)
        _check_wav(status, sr, data, len(long_wave), "13 s request (direct)")
        if batcher.stats()["requests"] != n_req:
            fail("the request past the largest bucket went through the batcher")
        stream_wave = voice_wave(3.0, rng)
        status, sr, data, headers = _post(base, stream_wave, stream=1)
        if (status != 200 or headers.get("Transfer-Encoding") != "chunked"
                or data.shape != stream_wave.shape or not np.isfinite(data).all()):
            fail(f"stream=1: status {status}, {headers.get('Transfer-Encoding')}, "
                 f"{data.shape} samples for {stream_wave.shape}")
        log(f"[batch] (b) a 13 s request ran direct ({len(data)} samples back), "
            f"stream=1 answered chunked with {len(stream_wave)} samples [{card}]")
    finally:
        srv.shutdown()

    # the codecs: the same requests (same seeds) through i16 and mu-law
    for transfer in ("i16", "mulaw"):
        pipe.enable_batching(buckets=BUCKETS, max_batch=BATCH,
                             max_wait_ms=BATCH_WAIT_MS, transfer=transfer, **DIFF_KW)
        coded = _concurrently([lambda w=w, s=s: pipe.infer(w, SR, seed=s, **DIFF_KW)[0]
                               for w, s in zip(waves[:4], seeds[:4])])
        snr = min(snr_db(a, b) for a, b in zip(rows[:4], coded))
        # i16 rounds to 1/32767 (~80 dB at these levels), mu-law companding
        # keeps ~38 dB on speech-scale signals
        limit = 60.0 if transfer == "i16" else 30.0
        log(f"[batch] (b) transfer {transfer}: 4 rows against f32, SNR min "
            f"{snr:.2f} dB (limit >= {limit:.0f} dB) [{card}]")
        if not snr >= limit:
            fail(f"transfer {transfer}: SNR {snr:.2f} dB < {limit} dB")

    # a server with the bf16 vocoder, one with the fused front end
    for what, kwargs, batch_kw, expect_key in (
            ("voc_bf16", dict(vocoder_bf16=True), {}, "resblock_group_bf16"),
            ("batch_encoder + device_f0", dict(device_f0=True),
             dict(batch_encoder=True), "resblock_group")):
        other = sibling(wav_pipe, **kwargs)
        other.enable_batching(buckets=BUCKETS, max_batch=BATCH,
                              max_wait_ms=BATCH_WAIT_MS, **DIFF_KW, **batch_kw)
        srv, base = _serve(other)
        try:
            for w in wrappers.values():
                w.launches = 0
            some = http_waves[:4]
            answers = _concurrently([lambda w=w: _post(base, w) for w in some])
            for i, (w, (status, sr, data, _)) in enumerate(zip(some, answers)):
                _check_wav(status, sr, data, len(w), f"{what} request {i}")
            got = {n: w.launches for n, w in wrappers.items()}
            if got[expect_key] <= 0 or (expect_key == "resblock_group_bf16"
                                        and got["resblock_group"] != 0):
                fail(f"{what} server: launches {got}")
            launches[f"HTTP {what}"] = got
            enc = other.enc_batcher.stats() if other.enc_batcher is not None else None
            if batch_kw and not (enc and enc["batches"] > 0):
                fail(f"{what}: the encoder batcher ran no batch ({enc})")
            log(f"[batch] (b) server with {what}: 4 concurrent POSTs answered, "
                f"launches {got}, encoder batcher {enc and {k: enc[k] for k in ('requests', 'batches', 'mean_batch_occupancy')}} [{card}]")
        finally:
            srv.shutdown()
            other.disable_batching()

    # (c) aggregate throughput and the device's busy share of one round:
    # the host YIN and solo encoder per request, then the fused front end
    tput_waves = [voice_wave(5.0, rng) for _ in range(16)]
    fused = sibling(wav_pipe, device_f0=True)
    for what, p, levels, batch_kw in (
            ("host YIN, solo encoder", pipe, (1, 4, 8, 16), {}),
            ("fused front end (device YIN, batched encoder)", fused, (8, 16),
             dict(batch_encoder=True))):
        p.enable_batching(buckets=BUCKETS, max_batch=BATCH,
                          max_wait_ms=BATCH_WAIT_MS, **DIFF_KW, **batch_kw)
        for conc in levels:
            per = 16 // conc
            t0 = time.perf_counter()
            _concurrently([lambda i=i, p=p: [
                p.infer(tput_waves[(i * per + j) % 16], SR, **DIFF_KW)
                for j in range(per)] for i in range(conc)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[batch] (c) {what}, concurrency {conc}: 16 requests of 5 s in "
                f"{wall:.3f} s wall = {16 * 5.0 / wall:.2f} s of audio per s "
                f"[{card}]")
        _, wall_us, kernels_us, n_ops, _ = _profiled(
            torch, lambda p=p: _concurrently([lambda w=w: p.infer(w, SR, **DIFF_KW)
                                              for w in tput_waves[:BATCH]]), {})
        busy = sum(kernels_us.values())
        log(f"[batch] (c) {what}: one round of {BATCH} concurrent 5 s requests "
            f"under the profiler: wall {wall_us / 1e3:.2f} ms, device busy "
            f"{busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f} % of wall, {n_ops} "
            f"device ops [{card}]")
        p.disable_batching()
    return launches


# ---------------------------------------------------------------- phase 18


CONFIGS = Path(__file__).resolve().parent / "configs"


def expect_train(args, bf16_trunk: bool = False) -> dict:
    """Kernel launches of one training step (forward only: the kernels'
    backward is the plain chain): K1 once for CombSubSuperFast, K3 (B3 with
    the bf16 trunk, B5 in a bf16 model) once per trunk layer, K4 once for
    Sins, nothing for Unit2Mel and Unit2Wav."""
    mtype = args.model.type
    if mtype in ("DiffusionFast", "RectifiedFlow"):
        bf16 = str(args.train.amp_dtype or "fp32").lower() in (
            "bf16", "bfloat16", "fp16", "float16")
        trunk = ("conformer_layer_bf16_io" if bf16 else
                 "conformer_layer_bf16" if bf16_trunk else "conformer_layer")
        return {"combtooth": 1, trunk: int(args.model.n_layers)}
    if mtype == "CombSubSuperFast":
        return {"combtooth": 1}
    return {"harmonic_bank": 1} if mtype == "Sins" else {}


def train_config(root: Path, name: str, config: str):
    """A copy of ``configs/<config>`` written by the port's config writer,
    with only the paths and the intervals changed -> (path, args)."""
    from ddsp_svc_tpu_torch.utils.config import load_config, save_config

    args = load_config(CONFIGS / config)
    args["data"]["train_path"] = str(root / "data" / "train")
    args["data"]["valid_path"] = str(root / "data" / "val")
    args["env"]["expdir"] = str(root / "exp" / name)
    args["train"].update(interval_log=5, interval_val=10, interval_force_save=20)
    path = root / f"{name}.yaml"
    save_config(path, args)
    return str(path), args


class StepMeter:
    """Wraps the solver's train steps: each step's wall (synchronized), its
    loss terms and its kernel launches, which must be ``expect`` exactly
    (forward launches only: a backward that launched would add to them)."""

    def __init__(self, torch, what: str, expect: dict):
        self.torch, self.what = torch, what
        self.expect = _with_zeros(expect)
        self.walls, self.losses, self.batch = [], [], 0

    def wrap(self, step_fn):
        wrappers = all_counts()

        def step(state, batch, generator=None, draws=None):
            before = {n: w.launches for n, w in wrappers.items()}
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, batch, generator, draws)
            self.torch.cuda.synchronize()
            self.walls.append(time.perf_counter() - t0)
            delta = {n: w.launches - before[n] for n, w in wrappers.items()}
            if delta != self.expect:
                fail(f"[train] {self.what} step {state.step}: launches {delta}, "
                     f"expected {self.expect}")
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                fail(f"[train] {self.what} step {state.step}: loss {loss}")
            self.losses.append(loss)
            self.batch = batch["units"].shape[0]
            return metrics
        return step

    def report(self, seconds: float, card: str) -> None:
        warm = sorted(self.walls[2:] or self.walls)
        med = warm[len(warm) // 2]
        line = (f"{len(self.walls)} steps at batch {self.batch}: warm step "
                f"median {med * 1e3:.1f} ms (min {warm[0] * 1e3:.1f}, max "
                f"{warm[-1] * 1e3:.1f}, n={len(warm)}; first {self.walls[0] * 1e3:.1f}), "
                f"{self.batch / med:.1f} samples/s, {self.batch * seconds / med:.1f} "
                f"s of audio per s; losses {self.losses[0]:.4f} -> "
                f"{self.losses[-1]:.4f} [{card}]")
        log(f"[train] {self.what}: {line}")


def metered(torch, solver, what: str, expect: dict):
    """Install a StepMeter around ``solver.build_train_step`` -> (meter,
    restore)."""
    meter, original = StepMeter(torch, what, expect), solver.build_train_step

    def build(args, mel_fn=None, mesh=None):
        family, step = original(args, mel_fn, mesh)
        return family, meter.wrap(step)

    solver.build_train_step = build
    return meter, lambda: setattr(solver, "build_train_step", original)


def write_corpus(root: Path, rng) -> None:
    from ddsp_svc_tpu_torch.features.audio import save_wav

    for split, n in (("train", TRAIN_FILES), ("val", VAL_FILES)):
        (root / "data" / split / "audio").mkdir(parents=True)
        for i in range(n):
            seconds = 3.0 + 2.0 * rng.random()
            wave = voice_wave(seconds, rng) * (0.5 + rng.random())
            save_wav(str(root / "data" / split / "audio" / f"{i}.wav"), wave, SR)


def step_grads(torch, model, family: str, batch: dict, draws: dict, mel_fn,
               probe=None):
    """One training step's loss and every parameter's gradient (no update),
    with the draws injected; with ``probe`` a DDSP synth's gradients are
    those of sum(signal x probe), its loss still the RSS loss."""
    from ddsp_svc_tpu_torch.ops.losses import RSSLoss

    model.zero_grad(set_to_none=True)
    if family == "ddsp":
        signal, _ = model(batch["units"], batch["f0"], batch["volume"],
                          noise=draws["noise"])
        loss = RSSLoss(256, 2048, 4)(signal, batch["audio"], draws["rss_idx"])
        target = loss if probe is None else (signal * probe).sum()
    else:
        ddsp_loss, diff_loss = model.loss(
            batch["units"], batch["f0"], batch["volume"], batch["mel"],
            mel_extract_fn=mel_fn, aug_shift=batch.get("aug_shift"), k_step=100,
            ddsp_noise=draws["ddsp_noise"], t=draws["t"], noise=draws["noise"])
        loss = target = ddsp_loss + diff_loss
    target.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters()}


def _grad_gap(g_c: dict, g_h: dict) -> tuple:
    """(L2 over all leaves, (worst leaf's L2, its name)), relative to the
    CPU's."""
    num = sum(float(((g_c[n] - g_h[n]) ** 2).sum()) for n in g_h)
    den = sum(float((g_h[n] ** 2).sum()) for n in g_h)
    leaf = max((float((g_c[n] - g_h[n]).norm() / max(float(g_h[n].norm()), 1e-30)), n)
               for n in g_h)
    return math.sqrt(num / den), leaf


def train_card_vs_cpu(torch, card: str, what: str, args, model, family: str,
                      batch_np: dict) -> None:
    """Phase 18 (d): one step of ``model`` (on the card) and of a CPU copy
    on the same batch and draws: the loss within TRAIN_LOSS_TOL, the
    gradients within TRAIN_GRAD_TOL (L2 over all leaves) and TRAIN_LEAF_TOL
    (L2 of each leaf), relative to the CPU's. A DDSP synth's gradients are
    held under sum(signal x probe): under RSS the 1 / |S| weight of its log
    term turns the harmonic bank's allowed 3e-5 (K4 against its plain
    version) into gradient gaps of up to ~5e-3 on the H100 (it moves with
    the batch), which is printed beside it and not held."""
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor
    from ddsp_svc_tpu_torch.train.steps import to_device

    rng = np.random.default_rng(SEED + 18)
    b, t = batch_np["units"].shape[:2]
    if family == "ddsp":
        draws = {"noise": rng.uniform(-1, 1, (b, t * BLOCK)).astype(np.float32),
                 "rss_idx": rng.integers(0, 16, 4)}
        probe = rng.standard_normal((b, t * BLOCK)).astype(np.float32)
    else:
        draws = {"ddsp_noise": rng.standard_normal((b, t * BLOCK)).astype(np.float32),
                 "t": rng.integers(0, 100, b),
                 "noise": rng.standard_normal((b, t, 128)).astype(np.float32)}
        probe = None
    out, rss = {}, {}
    cpu_model = copy.deepcopy(model).cpu()
    for key, m in (("card", model), ("cpu", cpu_model)):
        dev = next(m.parameters()).device
        d = {k: (v if k == "rss_idx" else torch.from_numpy(np.asarray(v)).to(dev))
             for k, v in draws.items()}
        mel_fn = build_mel_extractor(args, dev).extract
        batch = to_device(batch_np, dev)
        out[key] = step_grads(torch, m, family, batch, d, mel_fn,
                              None if probe is None else torch.from_numpy(probe).to(dev))
        if probe is not None:
            rss[key] = step_grads(torch, m, family, batch, d, mel_fn)[1]
    (loss_c, g_c), (loss_h, g_h) = out["card"], out["cpu"]
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    total, leaf = _grad_gap(g_c, g_h)
    held = "sum(signal x probe)" if probe is not None else "the loss"
    extra = ""
    if rss:
        r_total, r_leaf = _grad_gap(rss["card"], rss["cpu"])
        extra = (f"; under the RSS loss itself (not held): {r_total:.2e}, worst "
                 f"leaf {r_leaf[0]:.2e} at {r_leaf[1]}")
    log(f"[train] (d) {what} at batch {b}, card vs CPU: loss {loss_c:.6f} vs "
        f"{loss_h:.6f} ({loss_err:.2e} relative, limit {TRAIN_LOSS_TOL:g}); "
        f"gradients of {len(g_h)} leaves under {held}: {total:.2e} (L2 over "
        f"all, limit {TRAIN_GRAD_TOL:g}), worst leaf {leaf[0]:.2e} at {leaf[1]} "
        f"(limit {TRAIN_LEAF_TOL:g}){extra} [{card}]")
    if not (loss_err <= TRAIN_LOSS_TOL and total <= TRAIN_GRAD_TOL
            and leaf[0] <= TRAIN_LEAF_TOL):
        fail(f"[train] (d) {what}: card vs CPU beyond the stated limits")


def family_steps(torch, card: str, fargs, what: str, dtype=None):
    """FAMILY_STEPS steps of the config's family at its widths and batch
    (the model built with ``dtype``, the training init), each step's
    launches held to ``expect_train`` -> (model, launch counts)."""
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor
    from ddsp_svc_tpu_torch.data.dataset import BatchSampler, get_datasets
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model, model_family
    from ddsp_svc_tpu_torch.train import solver
    from ddsp_svc_tpu_torch.train.state import create_train_state
    from ddsp_svc_tpu_torch.train.steps import to_device

    dev = torch.device("cuda")
    wrappers = all_counts()
    for w in wrappers.values():
        w.launches = 0
    model = random_init_(build_model(fargs, dtype=dtype),
                         torch.Generator().manual_seed(SEED), training=True).to(dev)
    state = create_train_state(model, lr=float(fargs.train.lr))
    family = model_family(fargs.model.type)
    mel_fn = (build_mel_extractor(fargs, dev).extract
              if family in ("diffusion", "reflow") else None)
    _, step = solver.build_train_step(fargs, mel_fn)
    meter = StepMeter(torch, what, expect_train(fargs))
    step = meter.wrap(step)
    sampler = BatchSampler(get_datasets(fargs)[0], int(fargs.train.batch_size))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model.train()
    for _ in range(FAMILY_STEPS):
        step(state, to_device(sampler.sample(), dev), gen)
    meter.report(float(fargs.data.duration), card)
    return model, {n: w.launches for n, w in wrappers.items()}


def phase_training(torch, card: str, root: Path) -> dict:
    """Phase 18: see the module docstring; the corpus it preprocesses under
    ``root`` is phases 19's and 20's too. Returns {path: launch counts}."""
    from ddsp_svc_tpu_torch.cli import infer as cli_infer
    from ddsp_svc_tpu_torch.cli import preprocess as cli_preprocess
    from ddsp_svc_tpu_torch.cli import train as cli_train
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor
    from ddsp_svc_tpu_torch.data.dataset import BatchSampler, get_datasets
    from ddsp_svc_tpu_torch.features.audio import load_wav
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
    from ddsp_svc_tpu_torch.models.cascade import Unit2WavFast
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model, model_family
    from ddsp_svc_tpu_torch.models.vocoder import Vocoder
    from ddsp_svc_tpu_torch.train import solver
    from ddsp_svc_tpu_torch.train.state import create_train_state
    from ddsp_svc_tpu_torch.train.steps import to_device

    dev = torch.device("cuda")
    wrappers = all_counts()
    paths = {}
    # (a) the entry points: preprocess, train 20 steps, resume for 5
    write_corpus(root, np.random.default_rng(SEED + 180))
    cfg, args = train_config(root, "diffusion-fast", "diffusion-fast.yaml")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    cli_preprocess.main(["-c", cfg, "--seed", str(SEED)])
    torch.cuda.synchronize()
    log(f"[train] (a) cli.preprocess on the card: {TRAIN_FILES} + {VAL_FILES} "
        f"recordings in {time.perf_counter() - t0:.2f} s (contentvec768l12, "
        f"random weights, YIN on the host) [{card}]")
    meter, restore = metered(torch, solver, "(a) DiffusionFast, cli.train",
                             expect_train(args))
    torch.cuda.reset_peak_memory_stats()
    try:
        state = cli_train.main(["-c", cfg, "--max_steps", str(TRAIN_STEPS)])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expdir = Path(args.env.expdir)
        saved = sorted(p.name for p in expdir.glob("model_*.ckpt"))
        if state.step != TRAIN_STEPS or saved != [f"model_{TRAIN_STEPS}.ckpt"]:
            fail(f"[train] (a) after {TRAIN_STEPS} steps: step {state.step}, "
                 f"checkpoints {saved} (retention keeps model_20 only)")
        log(f"[train] (a) peak device memory {peak:.2f} GiB (max_memory_allocated)"
            f"; checkpoints {saved}; validation logged: "
            f"{'validation' in (expdir / 'log_info.txt').read_text()} [{card}]")
        state = cli_train.main(["-c", cfg, "--max_steps", str(RESUME_STEPS)])
    finally:
        restore()
    want_lr = float(args.train.lr) * float(args.train.gamma) ** (
        (TRAIN_STEPS + RESUME_STEPS) // int(args.train.decay_step))
    adam_step = float(next(iter(state.optimizer.state.values()))["step"])
    if (state.step != TRAIN_STEPS + RESUME_STEPS or adam_step != state.step
            or abs(state.lr() - want_lr) > 1e-12 * want_lr):
        fail(f"[train] (a) resume: step {state.step}, AdamW step {adam_step}, "
             f"lr {state.lr()} (expected {TRAIN_STEPS + RESUME_STEPS}, {want_lr})")
    if len(meter.walls) != TRAIN_STEPS + RESUME_STEPS:
        fail(f"[train] (a) {len(meter.walls)} metered steps")
    log(f"[train] (a) resumed at step {TRAIN_STEPS} from "
        f"model_{TRAIN_STEPS}.ckpt and trained to {state.step}: AdamW step "
        f"{adam_step:g}, lr {state.lr():.3g}; launches per step K1 1, K3 6, "
        f"none in the backward [{card}]")
    val_wav = root / "data" / "val" / "audio" / "0.wav"
    out_wav = root / "converted.wav"
    cli_infer.main(["-m", str(expdir / f"model_{TRAIN_STEPS}.ckpt"), "-i",
                    str(val_wav), "-o", str(out_wav)])
    audio, sr = load_wav(str(out_wav))
    n_in = len(load_wav(str(val_wav))[0])
    if sr != SR or len(audio) < n_in - BLOCK or not np.isfinite(audio).all():
        fail(f"[train] (a) cli.infer.main on the checkpoint: {len(audio)} "
             f"samples at {sr} Hz for {n_in}")
    log(f"[train] (a) cli.infer.main read {expdir.name}/config.yaml and "
        f"model_{TRAIN_STEPS}.ckpt and converted a {n_in / SR:.2f} s recording "
        f"[{card}]")
    meter.report(float(args.data.duration), card)
    paths["training (a) DiffusionFast"] = {n: w.launches for n, w in wrappers.items()}

    # (b) the bf16 trunk through train.solver.train, then a 10 s request
    for w in wrappers.values():
        w.launches = 0
    _, bargs = train_config(root, "diffusion-fast-bf16", "diffusion-fast.yaml")
    d, m = bargs.data, bargs.model
    # random init with a live output projection (not the zero training
    # init), so that the trunk shapes the request's mel in the check below
    model = random_init_(Unit2WavFast(
        d.sampling_rate, d.block_size, m.win_length, d.encoder_out_channels,
        m.n_spk, bool(m.use_pitch_aug), 128, m.n_layers, m.n_chans,
        k_step_max=m.k_step_max, trunk_bf16=True),
        torch.Generator().manual_seed(SEED)).to(dev)
    state = create_train_state(model, lr=float(bargs.train.lr))
    meter, restore = metered(torch, solver, "(b) DiffusionFast bf16 trunk",
                             expect_train(bargs, bf16_trunk=True))
    try:
        solver.train(bargs, state, build_mel_extractor(bargs, dev).extract,
                     device=dev, max_steps=BF16_STEPS)
    finally:
        restore()
    meter.report(float(bargs.data.duration), card)
    model.eval()
    f32 = Unit2WavFast(d.sampling_rate, d.block_size, m.win_length,
                       d.encoder_out_channels, m.n_spk, bool(m.use_pitch_aug),
                       128, m.n_layers, m.n_chans, k_step_max=m.k_step_max)
    f32.load_state_dict(model.state_dict())
    vocoder = random_init_(Vocoder(), torch.Generator().manual_seed(SEED))
    outs = {}
    per_request = 10 * int(m.n_layers)  # DPM-Solver++, k_step 100, speedup 10
    for what, mod, expect in (
            ("bf16 trunk", model, {"combtooth": 1, "resblock_group": 5,
                                   "conformer_layer_bf16": per_request}),
            ("f32 trunk", f32.to(dev).eval(), {"combtooth": 1,
                                               "resblock_group": 5,
                                               "conformer_layer": per_request})):
        pipe = SvcPipeline.from_parts(mod, None, bargs, vocoder, seed=SEED)
        # the same features and draws for both
        inputs = request_inputs(pipe, 10, np.random.default_rng(SEED + 182))
        noise = request_noise(np.random.default_rng(SEED + 181),
                              inputs["volume"].shape[1])
        before = {n: w.launches for n, w in wrappers.items()}
        with torch.no_grad():
            audio, _ = pipe.infer_features(**inputs, k_step=100, speedup=10,
                                           method="dpm-solver", noise=noise)
        torch.cuda.synchronize()
        delta = {n: w.launches - before[n] for n, w in wrappers.items()}
        if delta != _with_zeros(expect):
            fail(f"[train] (b) 10 s request, {what}: launches {delta}")
        outs[what] = check_audio(audio, inputs["volume"].shape[1],
                                 f"(b) {what}")
    snr = snr_db(outs["f32 trunk"], outs["bf16 trunk"])
    log(f"[train] (b) a 10 s request with the trained bf16-trunk model: "
        f"B3 {per_request}, K3 0; its audio {snr:.2f} dB from the same request on the "
        f"f32 trunk (limit {BF16_TRUNK_SNR_DB:g} dB) [{card}]")
    if not snr >= BF16_TRUNK_SNR_DB:
        fail(f"[train] (b) bf16 trunk {snr:.2f} dB from the f32 trunk")
    paths["training (b) bf16 trunk"] = {n: w.launches for n, w in wrappers.items()}
    del model, f32, state

    # (c) three steps of each other family at its config's widths
    for mtype, config in (("Sins", "sins.yaml"), ("RectifiedFlow", "reflow.yaml"),
                          ("Diffusion", "diffusion.yaml"),
                          ("DiffusionNew", "diffusion-new.yaml")):
        _, fargs = train_config(root, mtype, config)
        model, counts_ = family_steps(torch, card, fargs, f"(c) {mtype}")
        paths[f"training (c) {mtype}"] = counts_
        if mtype == "Sins":
            sins = (fargs, model)
        del model
        torch.cuda.empty_cache()

    # (d) card vs CPU, one step at batch 4: DiffusionFast and Sins
    df_model = random_init_(build_model(args), torch.Generator().manual_seed(SEED))
    for what, fargs, model in (("DiffusionFast", args, df_model.to(dev)),
                               ("Sins", *sins)):
        sampler = BatchSampler(get_datasets(fargs)[0], CARD_CPU_BATCH, seed=SEED)
        train_card_vs_cpu(torch, card, what, fargs, model,
                          model_family(fargs.model.type), sampler.sample())
    del sins

    # (e) the device's busy share of one profiled DiffusionFast step
    state = create_train_state(df_model, lr=float(args.train.lr))
    _, step = solver.build_train_step(args, build_mel_extractor(args, dev).extract)
    sampler = BatchSampler(get_datasets(args)[0], int(args.train.batch_size),
                           seed=SEED)
    batch = to_device(sampler.sample(), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step(state, batch, gen)  # warm
    _, wall_us, kernels_us, n_ops, kept = _profiled(
        torch, lambda: step(state, batch, gen), {})
    busy = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
    log(f"[train] (e) one DiffusionFast step at batch "
        f"{int(args.train.batch_size)} under the profiler: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms = "
        f"{100 * busy / wall_us:.1f} % of wall, {n_ops} device ops (the trace "
        f"kept {kept} of the lead's {LEAD_OPS}); top: "
        + "; ".join(f"{us / 1e3:.2f} ms {k[:50]}" for k, us in top) + f" [{card}]")
    return paths


# phase 19: bf16 training. Limits stated before its first run: card vs CPU
# for one bf16 DiffusionFast step (B5 and cuDNN's bf16 convs against their
# CPU versions: each bf16 rounding that a sum order flips moves the step
# by about one bf16 ulp of a value), the loss within BF16_CARD_LOSS_TOL
# relative and the gradients within BF16_CARD_GRAD_TOL in L2 over every
# leaf; and the bf16 run's losses over its first BF16_BAND_STEPS steps
# within BF16_BAND of the f32 run's from the same weights, batches and
# draws, each step.
BF16_CARD_LOSS_TOL = 1e-3
BF16_CARD_GRAD_TOL = 2e-2
BF16_BAND_STEPS, BF16_BAND = 20, 0.05
# phase 20: vocoder training. Iterations of configs/nsf-hifigan.yaml, and
# card vs CPU for one discriminator step and one generator step at batch 2:
# losses within VOC_LOSS_TOL relative, each network's gradients within
# VOC_GRAD_TOL in L2 over its leaves (K2 against its plain version is held
# at 1e-4 x max|out| per stage; the MSD's spectral-normed first conv sums
# its gradient to ~1e-3 of its terms, so its worst leaf is printed, not
# held).
VOC_STEPS, VOC_RESUME_STEPS, VOC_CPU_BATCH = 10, 5, 2
VOC_LOSS_TOL, VOC_GRAD_TOL = 1e-4, 1e-3


def _bf16_config(root: Path, name: str, config: str, **model):
    """``train_config`` with ``train.amp_dtype: bf16`` (and the model keys
    given) -> (path, args)."""
    from ddsp_svc_tpu_torch.utils.config import save_config

    path, args = train_config(root, name, config)
    args["train"]["amp_dtype"] = "bf16"
    args["model"].update(model)
    save_config(path, args)
    return path, args


def _train_cli(torch, cli_train, solver, cfg, what, args, steps, card,
               expect=None):
    """``cli.train.main`` for ``steps`` steps under a StepMeter -> (state,
    meter, peak GiB)."""
    meter, restore = metered(torch, solver, what,
                             expect_train(args) if expect is None else expect)
    torch.cuda.reset_peak_memory_stats()
    try:
        state = cli_train.main(["-c", cfg, "--max_steps", str(steps)])
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return state, meter, peak


def phase_bf16_training(torch, card: str, root: Path) -> dict:
    """Phase 19: bf16 mixed-precision training through ``cli.train.main`` on
    phase 18's preprocessed corpus. Returns {path: launch counts}."""
    from ddsp_svc_tpu_torch.cli import train as cli_train
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor
    from ddsp_svc_tpu_torch.data.dataset import BatchSampler, get_datasets
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.train import solver
    from ddsp_svc_tpu_torch.train.steps import to_device

    dev = torch.device("cuda")
    wrappers = all_counts()
    paths, walls = {}, {}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    # (a) configs/diffusion-new-bf16.yaml as shipped: 20 steps, then 5 more
    # after a resume
    zero()
    cfg, args = train_config(root, "diffusion-new-bf16", "diffusion-new-bf16.yaml")
    state, meter, peak = _train_cli(torch, cli_train, solver, cfg,
                                    "(a) DiffusionNew bf16, cli.train", args,
                                    TRAIN_STEPS, card)
    if state.step != TRAIN_STEPS or {p.dtype for p in state.model.parameters()} != {
            torch.float32}:
        fail(f"[bf16] (a) step {state.step}, parameter types "
             f"{ {p.dtype for p in state.model.parameters()} }")
    net = state.model.denoise_fn
    if net.input_projection.compute_dtype is not torch.bfloat16:
        fail("[bf16] (a) the WaveNet does not compute in bf16")
    state, meter2, _ = _train_cli(torch, cli_train, solver, cfg,
                                  "(a) DiffusionNew bf16, resumed", args,
                                  RESUME_STEPS, card)
    if state.step != TRAIN_STEPS + RESUME_STEPS:
        fail(f"[bf16] (a) resume reached step {state.step}")
    meter.report(float(args.data.duration), card)
    walls["DiffusionNew bf16"] = (meter.walls, peak)
    log(f"[bf16] (a) configs/diffusion-new-bf16.yaml (DiffusionNew 20 x 512, "
        f"batch {args.train.batch_size}, amp_dtype bf16): {TRAIN_STEPS} steps, "
        f"resumed to {state.step}; peak {peak:.2f} GiB; float32 parameters and "
        f"checkpoints [{card}]")
    paths["bf16 training (a) DiffusionNew"] = {n: w.launches for n, w in wrappers.items()}
    del state
    torch.cuda.empty_cache()

    # (b) DiffusionFast with amp_dtype bf16 through cli.train: B5 6, K1 1 a
    # step, none in the backward, K3 and B3 none
    zero()
    cfg, args = _bf16_config(root, "diffusion-fast-bf16-amp", "diffusion-fast.yaml")
    state, meter, peak = _train_cli(torch, cli_train, solver, cfg,
                                    "(b) DiffusionFast bf16, cli.train", args,
                                    BF16_BAND_STEPS, card)
    meter.report(float(args.data.duration), card)
    walls["DiffusionFast bf16"] = (meter.walls, peak)
    bf16_losses = list(meter.losses)
    n_layers = int(args.model.n_layers)
    got = {n: w.launches for n, w in wrappers.items()}
    if got["conformer_layer"] or got["conformer_layer_bf16"]:
        fail(f"[bf16] (b) K3 or B3 launched in a bf16 run: {got}")
    log(f"[bf16] (b) DiffusionFast with amp_dtype bf16: launches per step B5 "
        f"{n_layers}, K1 1, K3 0, B3 0, none in the backward (each step held by "
        f"its meter); over the run, validations included: B5 "
        f"{got['conformer_layer_bf16_io']}, K1 {got['combtooth']}; peak "
        f"{peak:.2f} GiB [{card}]")
    paths["bf16 training (b) DiffusionFast"] = got
    del state
    torch.cuda.empty_cache()

    # (c) the f32 run from the same weights, batches and draws: the loss band
    # and the f32 step time beside the bf16 one
    zero()
    cfg32, args32 = train_config(root, "diffusion-fast-f32-band", "diffusion-fast.yaml")
    state, meter32, peak32 = _train_cli(torch, cli_train, solver, cfg32,
                                        "(c) DiffusionFast f32", args32,
                                        BF16_BAND_STEPS, card)
    walls["DiffusionFast f32"] = (meter32.walls, peak32)
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16_losses, meter32.losses)]
    log(f"[bf16] (c) bf16 against f32 over {BF16_BAND_STEPS} steps from the same "
        f"weights, batches and draws: loss relative gap per step max "
        f"{max(rel):.4f}, mean {sum(rel) / len(rel):.4f} (limit {BF16_BAND} each); "
        f"bf16 {bf16_losses[0]:.4f} -> {bf16_losses[-1]:.4f}, f32 "
        f"{meter32.losses[0]:.4f} -> {meter32.losses[-1]:.4f} [{card}]")
    if len(rel) != BF16_BAND_STEPS or max(rel) > BF16_BAND:
        fail(f"[bf16] (c) bf16 losses outside the band: {rel}")
    del state
    torch.cuda.empty_cache()
    cfgn, argsn = train_config(root, "diffusion-new-f32", "diffusion-new.yaml")
    state, metern, peakn = _train_cli(torch, cli_train, solver, cfgn,
                                      "(c) DiffusionNew f32", argsn,
                                      FAMILY_STEPS + 2, card)
    walls["DiffusionNew f32"] = (metern.walls, peakn)
    del state
    torch.cuda.empty_cache()
    for what, (w, pk) in walls.items():
        warm = sorted(w[2:] or w)
        log(f"[bf16] (c) step time {what}: warm median {warm[len(warm) // 2] * 1e3:.1f} "
            f"ms (min {warm[0] * 1e3:.1f}, max {warm[-1] * 1e3:.1f}, n={len(warm)}), "
            f"peak {pk:.2f} GiB [{card}]")

    # (d) three bf16 steps of RectifiedFlow (B5 6, K1 1), Sins (K4 1),
    # CombSubFast and Unit2Mel through the solver's step
    for mtype, config, model_keys in (
            ("RectifiedFlow", "reflow.yaml", {}), ("Sins", "sins.yaml", {}),
            ("CombSubFast", "sins.yaml", {"type": "CombSubFast"}),
            ("Diffusion", "diffusion.yaml", {})):
        _, fargs = _bf16_config(root, f"{mtype}-bf16", config, **model_keys)
        _, paths[f"bf16 training (d) {mtype}"] = family_steps(
            torch, card, fargs, f"(d) {mtype} bf16", torch.bfloat16)
        torch.cuda.empty_cache()

    # (e) card vs CPU, one bf16 DiffusionFast step at batch 4
    zero()
    model = random_init_(build_model(args, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(SEED)).to(dev)
    sampler = BatchSampler(get_datasets(args)[0], CARD_CPU_BATCH, seed=SEED)
    rng = np.random.default_rng(SEED + 19)
    batch_np = sampler.sample()
    b, t = batch_np["units"].shape[:2]
    draws = {"ddsp_noise": rng.standard_normal((b, t * BLOCK)).astype(np.float32),
             "t": rng.integers(0, 100, b),
             "noise": rng.standard_normal((b, t, 128)).astype(np.float32)}
    out = {}
    for key, m in (("card", model), ("cpu", copy.deepcopy(model).cpu())):
        d = next(m.parameters()).device
        out[key] = step_grads(torch, m, "diffusion", to_device(batch_np, d),
                              {k: torch.from_numpy(np.asarray(v)).to(d)
                               for k, v in draws.items()},
                              build_mel_extractor(args, d).extract)
    (loss_c, g_c), (loss_h, g_h) = out["card"], out["cpu"]
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    total, leaf = _grad_gap(g_c, g_h)
    b5 = wrappers["conformer_layer_bf16_io"].launches
    log(f"[bf16] (e) one bf16 DiffusionFast step at batch {b}, card vs CPU: loss "
        f"{loss_c:.6f} vs {loss_h:.6f} ({loss_err:.2e} relative, limit "
        f"{BF16_CARD_LOSS_TOL:g}); gradients of {len(g_h)} leaves {total:.2e} (L2 "
        f"over all, limit {BF16_CARD_GRAD_TOL:g}), worst leaf {leaf[0]:.2e} at "
        f"{leaf[1]} (not held); B5 launches {b5} (the card's step) [{card}]")
    if not (loss_err <= BF16_CARD_LOSS_TOL and total <= BF16_CARD_GRAD_TOL):
        fail("[bf16] (e) card vs CPU beyond the stated limits")
    if b5 != n_layers:
        fail(f"[bf16] (e) B5 launched {b5} times in one step")
    paths["bf16 training (e) card vs CPU"] = {n: w.launches for n, w in wrappers.items()}
    return paths


def k2_training_stages(torch, card: str, cfg: dict, batch: int,
                       crop: int) -> None:
    """Phase 20 (d): K2 per stage at the vocoder's training shapes (B x the
    stage's length x C), its bound, B1's backward (autograd through the plain
    chain) and the repacking a weight-normed generator does every call."""
    from ddsp_svc_tpu_torch.ops.cuda_resblock import (PackedResblocks,
                                                      ResblockGroupFunction,
                                                      _launch, resblock_group)
    from ddsp_svc_tpu_torch.tools.timing import cuda_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 20)
    ks = tuple(cfg["resblock_kernel_sizes"])
    ds = tuple(tuple(d) for d in cfg["resblock_dilation_sizes"])
    frames = crop
    total = dict(k=0.0, bound=0.0, bwd=0.0, pack=0.0)
    c = int(cfg["upsample_initial_channel"])
    for rate in cfg["upsample_rates"]:
        frames, c = frames * rate, c // 2
        x = torch.randn((batch, frames, c), generator=gen).to(dev)
        weights = []
        for k, dils in zip(ks, ds):
            bound = 1.0 / math.sqrt(c * k)
            weights.append([(_rand(torch, gen, (c, c, k), bound).to(dev),
                             _rand(torch, gen, (c,), bound).to(dev))
                            for _ in range(2 * len(dils))])
        flat = [t for rbw in weights for wb in rbw for t in wb]

        def pack():
            return PackedResblocks(weights).packed
        pack_ms = cuda_ms(pack, 5)
        packed = PackedResblocks(weights)
        k_ms = cuda_ms(lambda: resblock_group(x, packed, ks, ds), 5)
        xg = x.clone().requires_grad_(True)
        leaves = [t.clone().requires_grad_(True) for t in flat]

        def fwd_bwd():
            out = ResblockGroupFunction.apply(_launch, xg, packed, ks, ds, *leaves)
            out.backward(torch.ones_like(out))
        fb_ms = cuda_ms(fwd_bwd, 3)
        taps = sum(k * 2 * len(d) for k, d in zip(ks, ds))
        n_convs = sum(2 * len(d) for d in ds)
        m = batch * frames
        flops = 2.0 * m * c * c * taps + 48.0 * m * c
        nbytes = 4.0 * (2 * m * c + c * c * taps + n_convs * c)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_TF32X3_FLOP_PER_S)
        total["k"] += k_ms
        total["bound"] += b_ms
        total["bwd"] += fb_ms - k_ms
        total["pack"] += pack_ms
        log(f"[vocoder] (d) K2 at B={batch} L={frames} C={c}: {k_ms:.3f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), bound {b_ms:.3f} ms ({b_by}), "
            f"{100 * b_ms / k_ms:.1f} % of it; B1 backward (plain chain) "
            f"{fb_ms - k_ms:.3f} ms; repacking the 18 convs' weights "
            f"{pack_ms:.3f} ms [{card}]")
        del x, xg, weights, flat, leaves, packed
    log(f"[vocoder] (d) K2 five stages of one training batch: {total['k']:.3f} ms "
        f"(bound {total['bound']:.3f} ms), B1 backward {total['bwd']:.3f} ms, "
        f"repacking {total['pack']:.3f} ms a call [{card}]")


def _grads_of(module) -> dict:
    return {n: p.grad.detach().double().cpu() for n, p in module.named_parameters()
            if p.grad is not None}


def phase_vocoder_training(torch, card: str, root: Path) -> dict:
    """Phase 20: NSF-HiFiGAN GAN training (configs/nsf-hifigan.yaml at full
    width) through ``cli.train_vocoder.main`` on phase 18's corpus. Returns
    {path: launch counts}."""
    from ddsp_svc_tpu_torch.cli import train_vocoder as cli_voc
    from ddsp_svc_tpu_torch.data.dataset import AudioDataset, BatchSampler
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.train import vocoder_solver as vs
    from ddsp_svc_tpu_torch.train.steps import to_device

    dev = torch.device("cuda")
    wrappers = all_counts()
    for w in wrappers.values():
        w.launches = 0
    cfg_path, args = train_config(root, "nsf-hifigan", "nsf-hifigan.yaml")
    args["train"].update(interval_log=5, interval_val=VOC_STEPS)
    from ddsp_svc_tpu_torch.utils.config import save_config
    save_config(cfg_path, args)
    cfg = cli_voc.vocoder_config(args)
    n_stages = len(cfg["upsample_rates"])
    walls, per_iter = [], []
    orig = (cli_voc.disc_step, cli_voc.gen_step)

    def timed(fn, kind):
        def step(*a, **k):
            before = wrappers["resblock_group"].launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            walls.append((kind, time.perf_counter() - t0))
            per_iter.append((kind, wrappers["resblock_group"].launches - before))
            return out
        return step

    cli_voc.disc_step, cli_voc.gen_step = timed(orig[0], "d"), timed(orig[1], "g")
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        state_g, state_d = cli_voc.main(["-c", cfg_path, "--max_steps", str(VOC_STEPS)])
        first_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = sorted(p.name for p in Path(args.env.expdir).glob("model_*.ckpt"))
        if state_g.step != VOC_STEPS or saved != [f"model_{VOC_STEPS}.ckpt"]:
            fail(f"[vocoder] (a) step {state_g.step}, checkpoints {saved}")
        state_g, state_d = cli_voc.main(["-c", cfg_path, "--max_steps",
                                         str(VOC_RESUME_STEPS)])
    finally:
        cli_voc.disc_step, cli_voc.gen_step = orig
    if state_g.step != VOC_STEPS + VOC_RESUME_STEPS or state_d.step != state_g.step:
        fail(f"[vocoder] (a) resume reached {state_g.step} / {state_d.step}")
    counts_d = {n for kind, n in per_iter if kind == "d"}
    counts_g = {n for kind, n in per_iter if kind == "g"}
    if counts_d != {n_stages} or counts_g != {n_stages}:
        fail(f"[vocoder] (a) K2 launches per step: disc {counts_d}, gen {counts_g}, "
             f"expected {n_stages} each ({2 * n_stages} per iteration)")
    iters = [walls[i][1] + walls[i + 1][1] for i in range(0, len(walls), 2)]
    warm = sorted(iters[2:VOC_STEPS] + iters[VOC_STEPS + 2:])
    med = warm[len(warm) // 2]
    batch = int(args.train.batch_size)
    log(f"[vocoder] (a) configs/nsf-hifigan.yaml at full width (512 initial "
        f"channels, rates {tuple(cfg['upsample_rates'])}, MPD (2, 3, 5, 7, 11) + "
        f"MSD 3, batch {batch} x {args.data.duration} s crops): {VOC_STEPS} "
        f"iterations and a save in {first_run:.1f} s, resumed to {state_g.step}; "
        f"K2 {2 * n_stages} per iteration ({n_stages} in each step); iteration "
        f"warm median {med * 1e3:.1f} ms (min {warm[0] * 1e3:.1f}, max "
        f"{warm[-1] * 1e3:.1f}, n={len(warm)}), {batch / med:.2f} samples/s, "
        f"{batch * float(args.data.duration) / med:.2f} s of audio per s; peak "
        f"{peak:.2f} GiB [{card}]")
    paths = {"vocoder training (a)": {n: w.launches for n, w in wrappers.items()}}

    # (b) the busy share of one profiled iteration
    ds = AudioDataset(args.data.train_path, waveform_sec=args.data.duration,
                      hop_size=args.data.block_size,
                      sample_rate=args.data.sampling_rate, with_mel=True)
    sampler = BatchSampler(ds, batch, seed=SEED)
    vb = to_device(cli_voc._vocoder_batch(sampler.sample()), dev)
    mel_fn = cli_voc.build_mel(cfg).to(dev).extract
    rng = torch.Generator(device=dev).manual_seed(SEED)

    def iteration():
        vs.disc_step(state_d, state_g.model, vb, rng=rng)
        vs.gen_step(state_g, state_d.model, vb, mel_fn, rng=rng)
    iteration()
    _, wall_us, kernels_us, n_ops, kept = _profiled(torch, iteration, {})
    busy = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
    k2_us = sum(us for k, us in kernels_us.items() if "resblock_conv_tc_kernel" in k)
    log(f"[vocoder] (b) one iteration under the profiler: wall {wall_us / 1e3:.2f} "
        f"ms, device busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.1f} % of "
        f"wall, {n_ops} device ops; K2's kernels {k2_us / 1e3:.2f} ms = "
        f"{100 * k2_us / busy:.1f} % of busy; top: "
        + "; ".join(f"{us / 1e3:.2f} ms {k[:50]}" for k, us in top) + f" [{card}]")
    del state_g, state_d
    torch.cuda.empty_cache()

    # (c) card vs CPU: one discriminator step and one generator step at batch 2
    gen = random_init_(cli_voc.build_generator(cfg), torch.Generator().manual_seed(SEED))
    discs = random_init_(vs.Discriminators(), torch.Generator().manual_seed(SEED + 1))
    small = BatchSampler(ds, VOC_CPU_BATCH, seed=SEED).sample()
    small = cli_voc._vocoder_batch(small)
    t = small["mel"].shape[1]
    r = np.random.default_rng(SEED + 20)
    sine = {"rand_ini": r.random((1, 1, 9)).astype(np.float32),
            "noise": r.standard_normal((VOC_CPU_BATCH, t * gen.upp, 9)).astype(np.float32)}
    sine["rand_ini"][..., 0] = 0.0
    res = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        g, d = copy.deepcopy(gen).to(device), copy.deepcopy(discs).to(device)
        sg, sd = vs.create_states(g, d, float(args.train.lr))
        b = to_device(small, device)
        sk = {k: torch.from_numpy(v).to(device) for k, v in sine.items()}
        m = cli_voc.build_mel(cfg).to(device).extract
        md = vs.disc_step(sd, g, b, sine_kwargs=sk)
        gd = _grads_of(d)
        mg = vs.gen_step(sg, d, b, m, sine_kwargs=sk)
        res[key] = (float(md["disc_loss"]), float(mg["gen_loss"]), gd, _grads_of(g))
        del g, d, sg, sd
    (dl_c, gl_c, gd_c, gg_c), (dl_h, gl_h, gd_h, gg_h) = res["card"], res["cpu"]
    errs = (abs(dl_c - dl_h) / abs(dl_h), abs(gl_c - gl_h) / abs(gl_h))
    (d_tot, d_leaf), (g_tot, g_leaf) = _grad_gap(gd_c, gd_h), _grad_gap(gg_c, gg_h)
    log(f"[vocoder] (c) one disc step and one gen step at batch {VOC_CPU_BATCH}, "
        f"card vs CPU: disc loss {dl_c:.6f} vs {dl_h:.6f} ({errs[0]:.2e}), gen loss "
        f"{gl_c:.6f} vs {gl_h:.6f} ({errs[1]:.2e}; limit {VOC_LOSS_TOL:g}); "
        f"discriminator gradients {d_tot:.2e}, generator gradients {g_tot:.2e} "
        f"(L2 over all leaves, limit {VOC_GRAD_TOL:g}); worst leaves (not held) "
        f"{d_leaf[0]:.2e} at {d_leaf[1]}, {g_leaf[0]:.2e} at {g_leaf[1]} [{card}]")
    if not (max(errs) <= VOC_LOSS_TOL and max(d_tot, g_tot) <= VOC_GRAD_TOL):
        fail("[vocoder] (c) card vs CPU beyond the stated limits")
    paths["vocoder training (c) card vs CPU"] = {n: w.launches for n, w in wrappers.items()}
    del gen, discs
    torch.cuda.empty_cache()

    # (d) K2 at the training shapes, B1's backward, the repacking
    crop = int(float(args.data.duration) / (args.data.block_size / args.data.sampling_rate))
    k2_training_stages(torch, card, cfg, batch, crop)
    return paths



# ---------------------------------------------------------------- phase 21

F0_NETS = ("rmvpe", "crepe", "fcpe")
F0_FILES = {"rmvpe": "model.msgpack", "crepe": "full.msgpack", "fcpe": "fcpe.msgpack"}
# card against CPU: saliences in (0, 1), absolute (f32 on both, TF32 off)
F0_SALIENCE_TOL = 1e-4
# decoded f0 compared on the frames whose top salience clears its
# runner-up by this much, within F0_CENTS_TOL
F0_DECISIVE = 20 * F0_SALIENCE_TOL
F0_CENTS_TOL = 0.05
# a few units above the other bins at 220 Hz, in the nets of (b) and (c)
F0_PEAK = 4.0
F0_PEAK_HZ = 220.0
CREPE_CPU_SECONDS = 1.0  # CREPE full is ~0.56 TFLOP a second of audio


def f0_peak_bin(kind: str) -> int:
    cents = 1200.0 * math.log2(F0_PEAK_HZ / 10.0)
    if kind == "fcpe":
        from ddsp_svc_tpu_torch.features.fcpe import cent_table

        return int(np.argmin(np.abs(cent_table() - cents)))
    return int(round((cents - 1997.3794084376191) / 20.0))


def draw_f0_net(torch, kind: str, seed: int, peak: bool):
    """The full-width f0 net ``kind`` on the CPU with random weights from
    ``seed``: conv, dense and GRU weights U(-1/sqrt(fan_in), +), biases
    U(-0.1, 0.1) (a GRU's r and z hidden biases 0, which flax's GRUCell
    has not), BatchNorm scales U(0.8, 1.2), means U(-0.1, 0.1), variances
    U(0.5, 1.5), a weight-normed Dense's gain the norm of its direction.
    With ``peak`` the output layer's bias is raised by F0_PEAK at the bin of
    220 Hz: at random init the 360 saliences sit near-tied around one
    value, so an argmax flips on a 1e-7 difference; with the peak the
    decoded f0 is decisive on the card and on the CPU alike."""
    from ddsp_svc_tpu_torch.features import crepe, fcpe, rmvpe
    from ddsp_svc_tpu_torch.models.nn import BatchNorm, WNLinear

    gen = torch.Generator().manual_seed(seed)
    net = {"rmvpe": rmvpe.E2E0, "crepe": crepe.Crepe, "fcpe": fcpe.CFNaiveMelPE}[kind]()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.uniform_(0.8, 1.2, generator=gen)
                mod.bias.uniform_(-0.1, 0.1, generator=gen)
                mod.mean.uniform_(-0.1, 0.1, generator=gen)
                mod.var.uniform_(0.5, 1.5, generator=gen)
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name == "weight_g":
                    continue
                if p.dim() > 1:
                    bound = 1.0 / math.sqrt(math.prod(p.shape[1:]))
                    p.uniform_(-bound, bound, generator=gen)
                else:
                    p.uniform_(-0.1, 0.1, generator=gen)
                if name.startswith("bias_hh"):
                    p[:2 * p.shape[0] // 3] = 0.0
            if isinstance(mod, WNLinear):
                mod.weight_g.copy_(torch.linalg.norm(mod.weight_v, dim=1))
        if peak:
            out = getattr(net, {"rmvpe": "fc", "crepe": "classifier",
                                "fcpe": "output_proj"}[kind])
            out.bias[f0_peak_bin(kind)] += F0_PEAK
    return net


def _f0_decode(kind: str, salience: np.ndarray) -> np.ndarray:
    if kind == "rmvpe":
        from ddsp_svc_tpu_torch.features.rmvpe import to_local_average_f0

        return to_local_average_f0(salience, thred=0.03)
    if kind == "crepe":
        from ddsp_svc_tpu_torch.features.crepe import weighted_argmax_f0

        return weighted_argmax_f0(salience, 50.0, 1100.0)[0]
    from ddsp_svc_tpu_torch.features.fcpe import local_argmax_f0

    return local_argmax_f0(salience, threshold=0.006)


def _timed_runs(torch, fn, n: int):
    """One cold and ``n`` warm runs of fn() to synchronize() -> (the last
    result, sorted warm walls in s, the cold wall)."""
    walls = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls[1:]), walls[0]


def _walls_text(runs, cold) -> str:
    return (f"warm median {runs[len(runs) // 2] * 1e3:.2f} ms (min "
            f"{runs[0] * 1e3:.2f}, max {runs[-1] * 1e3:.2f}, n={len(runs)}; cold "
            f"{cold * 1e3:.1f} ms)")


def phase_f0_front_end(torch, card: str, diffusion_cpu) -> dict:
    """The f0 front end: (a) each net, card against CPU; (b) the slice's
    path, SvcPipeline.infer with pitch_extractor='rmvpe' on diffusion-fast
    from a 10 s wav; (c) cli.infer.main -pe rmvpe and -pe fcpe; (d) the host
    trackers' walls. Every net reads a weights file in the JAX package's
    format, written by the port from random weights. Returns {path: launch
    counts}."""
    import os
    import tempfile

    from ddsp_svc_tpu_torch.cli import infer as cli_infer
    from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
    from ddsp_svc_tpu_torch.features.f0 import F0Extractor
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.io.jax_params import f0_net_variables, write_msgpack
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import DotDict, save_config

    rng = np.random.default_rng(SEED + 21)
    wave = voice_wave(10, rng)
    wrappers = counts()
    launches = {}
    env_keys = [f"DDSP_SVC_TPU_{k.upper()}_CKPT" for k in F0_NETS]
    saved_env = {k: os.environ.get(k) for k in env_keys}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_f0_")
    root = Path(tmp.name)
    try:
        files = {}
        for i, kind in enumerate(F0_NETS):
            for peak in (False, True):
                net = draw_f0_net(torch, kind, SEED + 21 + i, peak)
                path = root / ("peak" if peak else "drawn") / "pretrain" / kind
                path = path / F0_FILES[kind]
                write_msgpack(str(path), f0_net_variables(kind, net.state_dict()))
                files[kind, peak] = path
        log(f"[f0] weights files written in the JAX package's format from "
            f"random full-width nets (seeds {SEED + 21}-{SEED + 23}; the (b) / "
            f"(c) copies with the output bias +{F0_PEAK:g} at 220 Hz) [{card}]")

        # (a) each net at full width, card against CPU
        for kind in F0_NETS:
            os.environ[f"DDSP_SVC_TPU_{kind.upper()}_CKPT"] = str(files[kind, False])
            exts = {dev: F0Extractor(kind, SR, BLOCK, 50.0, 1100.0, device=dev)
                    for dev in ("cuda", "cpu")}
            for dev, ext in exts.items():
                if ext.net is None or ext.net.device.type != dev:
                    fail(f"[f0] (a) {kind}: the extractor's net is not on {dev}")
            card_net = exts["cuda"].net
            sal, runs, cold = _timed_runs(
                torch, lambda: card_net.salience(wave, SR), 5)
            _, ext_runs, ext_cold = _timed_runs(
                torch, lambda: exts["cuda"].extract(wave, uv_interp=True), 3)
            seconds = CREPE_CPU_SECONDS if kind == "crepe" else 10.0
            clip = wave[:int(seconds * SR)]
            s_card = card_net.salience(clip, SR).float().cpu().numpy()
            s_cpu = exts["cpu"].net.salience(clip, SR).numpy()
            if s_card.shape != s_cpu.shape or not np.isfinite(s_card).all():
                fail(f"[f0] (a) {kind}: salience {s_card.shape} on the card, "
                     f"{s_cpu.shape} on the CPU, or non-finite")
            err = float(np.abs(s_card - s_cpu).max())
            if not err <= F0_SALIENCE_TOL:
                fail(f"[f0] (a) {kind}: salience card vs CPU {err:.3e} > "
                     f"{F0_SALIENCE_TOL:g}")
            top2 = np.sort(s_cpu, axis=1)[:, -2:]
            decisive = (top2[:, 1] - top2[:, 0]) > F0_DECISIVE
            f_card, f_cpu = _f0_decode(kind, s_card), _f0_decode(kind, s_cpu)
            both = decisive & (f_card > 0) & (f_cpu > 0)
            cents = (float(np.abs(1200 * np.log2(f_card[both] / f_cpu[both])).max())
                     if both.any() else 0.0)
            if not cents < F0_CENTS_TOL:
                fail(f"[f0] (a) {kind}: decoded f0 card vs CPU {cents:.4f} cents "
                     f"on the decisive frames (limit {F0_CENTS_TOL})")
            log(f"[f0] (a) {kind} full width on a 10 s 44.1 kHz recording "
                f"({sal.shape[0]} frames): net + front end on the card "
                f"{_walls_text(runs, cold)}; F0Extractor.extract (net, decode, "
                f"regrid to the hop grid) "
                f"{_walls_text(ext_runs, ext_cold)}; card vs CPU on {seconds:g} s "
                f"({s_cpu.shape[0]} frames): salience max abs diff {err:.3e} (limit "
                f"{F0_SALIENCE_TOL:g}), salience {float(s_cpu.min()):.4f}.."
                f"{float(s_cpu.max()):.4f}, decoded f0 {cents:.5f} cents on the "
                f"{int(both.sum())} frames whose top salience clears the runner-up "
                f"by > {F0_DECISIVE:g} (limit {F0_CENTS_TOL}) [{card}]")
            del exts, card_net
            torch.cuda.empty_cache()

        # (b) the slice's path from a wav, the RMVPE front end
        for kind in F0_NETS:
            os.environ[f"DDSP_SVC_TPU_{kind.upper()}_CKPT"] = str(files[kind, True])
        what = "diffusion-fast from a wav, RMVPE"
        args, model, vocoder = diffusion_cpu
        pipe = wav_pipeline((args, copy.deepcopy(model), copy.deepcopy(vocoder)),
                            False, pitch_extractor="rmvpe")
        check_on_card(pipe, what)
        ext = pipe.f0_extractor(SR)
        if ext.f0_extractor != "rmvpe" or ext.net.device.type != "cuda":
            fail(f"[f0] (b) the pipeline's f0 extractor is {ext.f0_extractor} "
                 "on the wrong device")
        kw = dict(k_step=100, speedup=10, method="dpm-solver")
        t = len(wave) // BLOCK + 1
        launches[what], walls = serve_requests(
            torch, what, EXPECT_DIFFUSION, card,
            [(10, t, lambda: pipe.infer(wave, SR, **kw))], ENCODER_RANGE)
        f0, f0_runs, f0_cold = _timed_runs(torch, lambda: pipe.extract_f0(wave, SR), 5)
        f0 = np.asarray(f0)[0, :, 0]
        rmvpe_ms, total_ms = f0_runs[len(f0_runs) // 2] * 1e3, walls[10] * 1e3
        if not (np.isfinite(f0).all() and np.all(np.abs(f0 - F0_PEAK_HZ) < 15.0)):
            fail(f"[f0] (b) RMVPE f0 {f0.min():.1f}..{f0.max():.1f} Hz, expected "
                 f"near {F0_PEAK_HZ:g} (the drawn peak)")
        log(f"[f0] (b) {what}: 10 s request warm median {total_ms:.2f} ms, of "
            f"which RMVPE f0 {_walls_text(f0_runs, f0_cold)} "
            f"({100 * rmvpe_ms / total_ms:.1f} %), the rest {total_ms - rmvpe_ms:.2f} "
            f"ms; f0 {f0.min():.2f}..{f0.max():.2f} Hz [{card}]")
        # card against CPU on 2 s, the same weights, weights file and noise
        wave2 = voice_wave(2, rng)
        t2 = len(wave2) // BLOCK + 1
        cpu = wav_pipeline(diffusion_cpu, False, device="cpu",
                           encoder=UnitsEncoder(ENCODER, device="cpu", seed=SEED),
                           pitch_extractor="rmvpe")
        noise = request_noise(rng, t2)
        audios, f0s = {}, {}
        for name, p in (("card", pipe), ("cpu", cpu)):
            f0s[name] = np.asarray(p.extract_f0(wave2, SR))[0, :, 0]
            audio, _ = p.infer(wave2, SR, noise=noise, **kw)
            audios[name] = check_audio(audio, t2, f"{what} 2 s on {name}")
        cents = float(np.abs(1200 * np.log2(f0s["card"] / f0s["cpu"])).max())
        snr = snr_db(audios["cpu"], audios["card"])
        log(f"[f0] (b) {what}: 2 s recording card (kernels, RMVPE on the card) "
            f"vs CPU (plain, RMVPE on the CPU), same weights and noise: f0 max "
            f"{cents:.5f} cents, audio SNR {snr:.2f} dB (limit >= "
            f"{SNR_LIMIT_DB:.0f} dB) [{card}]")
        if not (snr >= SNR_LIMIT_DB and cents < F0_CENTS_TOL):
            fail(f"[f0] (b) card vs CPU: SNR {snr:.2f} dB, f0 {cents:.4f} cents")
        del pipe, cpu
        torch.cuda.empty_cache()

        # (c) the offline CLI from files, -pe rmvpe and -pe fcpe
        cargs = DotDict({
            "data": {"sampling_rate": SR, "block_size": BLOCK, "duration": 2,
                     "encoder": ENCODER, "encoder_ckpt": None,
                     "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                     "encoder_out_channels": N_UNIT, "f0_extractor": "rmvpe",
                     "f0_min": 65, "f0_max": 800},
            "model": {"type": "CombSubSuperFast", "win_length": WIN, "n_spk": 1},
            "infer": {}})
        expdir = root / "exp"
        smodel = random_init_(build_model(cargs), torch.Generator().manual_seed(SEED))
        ckpt = save_checkpoint(str(expdir), 1, smodel, cargs.model)
        save_config(str(expdir / "config.yaml"), dict(cargs))
        in_wav = root / "in.wav"
        save_wav(str(in_wav), wave, SR)
        for pe in ("rmvpe", "fcpe"):
            out_wav = root / pe / "out.wav"
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli_infer.main(["-m", ckpt, "-i", str(in_wav), "-o", str(out_wav),
                            "-pe", pe, "-e", "false"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"cli.infer -pe {pe}"] = {n: w.launches for n, w in wrappers.items()}
            audio, sr = load_wav(str(out_wav))
            cache = list((root / pe / "cache").glob(f"{pe}_*.npy"))
            f0 = np.load(cache[0]) if len(cache) == 1 else np.zeros(1)
            if (sr != SR or len(audio) < len(wave) - BLOCK
                    or not np.isfinite(audio).all() or np.abs(audio).max() <= 1e-4):
                fail(f"[f0] (c) cli.infer -pe {pe}: {len(audio)} samples at {sr} Hz")
            if not np.all(np.abs(f0 - F0_PEAK_HZ) < 15.0):
                fail(f"[f0] (c) cli.infer -pe {pe}: cached f0 {f0.min():.1f}.."
                     f"{f0.max():.1f} Hz")
            if launches[f"cli.infer -pe {pe}"]["combtooth"] < 1:
                fail(f"[f0] (c) cli.infer -pe {pe}: K1 was not launched")
            log(f"[f0] (c) cli.infer.main -pe {pe} -e false on a 10 s wav "
                f"(CombSubSuperFast, the {ENCODER} encoder, {pe} on the card): "
                f"wall {wall:.2f} s including model load, {len(audio)} samples "
                f"at {sr} Hz, cached f0 {f0.min():.2f}..{f0.max():.2f} Hz, "
                f"launches {launches[f'cli.infer -pe {pe}']} [{card}]")

        # (d) the host trackers on the same 10 s
        for kind in ("dio", "harvest", "praat"):
            ext = F0Extractor(kind, SR, BLOCK, 50.0, 1100.0)
            f0, runs, cold = _timed_runs(torch, lambda: ext.extract(wave), 2)
            voiced = f0[f0 > 0]
            if not len(voiced) or abs(float(np.median(voiced)) - 220.0) > 20.0:
                fail(f"[f0] (d) {kind}: median voiced f0 "
                     f"{float(np.median(voiced)) if len(voiced) else 0:.1f} Hz")
            log(f"[f0] (d) {kind} on a 10 s recording on the host: "
                f"{_walls_text(runs, cold)}; {100 * len(voiced) / len(f0):.1f} % "
                f"voiced, median {float(np.median(voiced)):.2f} Hz [{card}]")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    return launches


# ---------------------------------------------------------------- phase 22

# phase 22: time-sharded streaming (parallel/). The limits, stated before
# the first chip run: the streamed output against the port's whole
# reference on the card, relative to the peak (the CPU contract is 2e-5;
# the cascade's whole reference runs K3, its streamed denoiser JAX's stock
# chain); card against CPU; the CLI with --stream against itself without,
# outside the last FRAME_HALO frames of each segment. The CLI pads a
# segment to a multiple of the ranks, as the JAX CLI does, and the padded
# frame enters the segment-wide statistics (GroupNorm, FAVOR+'s sums), so
# the two differ a little everywhere: the card-vs-CPU bar, not equality.
STREAM_LIMITS = {"combsub": 1e-4, "sins": 1e-4, "cascade mel": 1e-3,
                 "vocoder": 1e-4}
STREAM_CLI_SNR_DB = 40.0
STREAM_EXPECT = {  # launches on every rank of one streamed call
    "combsub": {"combtooth": 1}, "sins": {"harmonic_bank": 1},
    "cascade mel": {"combtooth": 1}, "vocoder": {"resblock_group": 5}}


def _silence_noise_filter(model) -> None:
    """The noise filter's magnitude bias at -30 (exp(-30): off), so runs
    with different noise draws agree (tests/test_torch_cli.py's device)."""
    import torch

    u = model.unit2ctrl
    start = 0
    for name, size in u.output_splits.items():
        if name == "noise_magnitude":
            with torch.no_grad():
                u.dense_out.bias[start:start + size] = -30.0
        start += size


class _X(str):
    """A keyword argument taken from the inputs by this name."""


def _stream_parts(torch):
    """The four streamed paths at 10 s (T = 862): (the inputs and draws by
    name, {path: (model on the CPU with random weights from the seed, the
    names of its positional inputs, its keyword arguments; ``_X`` names an
    input)})."""
    from ddsp_svc_tpu_torch.parallel import stream

    rng = np.random.default_rng(SEED + 22)
    t = frames_for(10)
    x = dict(units=rng.standard_normal((1, t, N_UNIT)),
             f0=f0_contour(t), volume=rng.uniform(0.1, 0.5, (1, t, 1)),
             normal=rng.standard_normal((1, t * BLOCK)),
             uniform=rng.uniform(-1, 1, (1, t * BLOCK)),
             init=rng.standard_normal((1, t, 128)),
             mel=rng.normal(-5.0, 2.0, (1, t, 128)), f0_voc=f0_contour(t)[..., 0],
             voc_noise=rng.standard_normal(
                 (1, (t + 2 * stream.VOCODER_HALO) * BLOCK, 9)),
             rand_ini=np.concatenate([[0.0], rng.random(8)])[None, None])
    x = {k: v.astype(np.float32) for k, v in x.items()}
    _, combsub, _ = random_parts(torch, {"type": "CombSubSuperFast",
                                         "win_length": WIN})
    _, sins, _ = random_parts(torch, dict(SINS, type="Sins"))
    _, cascade, vocoder = build_parts(torch)
    controls = ("units", "f0", "volume")
    return x, {
        "combsub": (combsub.eval(), controls, dict(noise=_X("normal"))),
        "sins": (sins.eval(), controls, dict(noise=_X("uniform"))),
        "cascade mel": (cascade.eval(), controls, dict(
            ddsp_noise=_X("normal"), init_noise=_X("init"), mel=vocoder.mel,
            infer_speedup=10, sampler="dpm-solver", k_step=100)),
        "vocoder": (vocoder.model.eval(), ("mel", "f0_voc"), dict(
            noise=_X("voc_noise"), rand_ini=_X("rand_ini")))}


def _stream_call(torch, path, model, names, kw, x, frames, device):
    """(entry point, positional tensors, keyword args) of one path at its
    first ``frames`` frames on ``device``."""
    from ddsp_svc_tpu_torch.parallel import stream

    def cut(key):
        a = x[key]
        if key == "voc_noise":
            a = a[:, :(frames + 2 * stream.VOCODER_HALO) * BLOCK]
        elif key in ("normal", "uniform"):
            a = a[:, :frames * BLOCK]
        elif key != "rand_ini":
            a = a[:, :frames]
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = [cut(n) for n in names]
    kwargs = {k: (cut(v) if isinstance(v, _X) else
                  (v.to(device) if hasattr(v, "to") else v))
              for k, v in kw.items()}
    if path == "vocoder":
        return stream.streamed_nsf_hifigan, [model] + args, kwargs
    return stream.streamed_forward, [model] + args, kwargs


def _stream_whole(torch, path, model, args, kwargs):
    from ddsp_svc_tpu_torch.parallel import stream

    with torch.no_grad():
        if path == "vocoder":
            return stream.nsf_hifigan_padded_forward(*args, **kwargs)
        if path == "cascade mel":
            kw = dict(kwargs)
            mel = kw.pop("mel")
            return stream.whole_cascade_reference(*args, mel, **kw)
        return args[0](*args[1:], **kwargs)[0]


def _rank_launches(world, what: str, expect: dict, card: str) -> dict:
    counts = world.launches()
    want = {n: expect.get(n, 0) for n in counts[0]}
    for r, c in enumerate(counts):
        if c != want:
            fail(f"[stream] {what}: rank {r} launched {c}, expected {want}")
    log(f"[stream] {what}: launches per rank {want} on all {len(counts)} "
        f"ranks (gathered to rank 0) [{card}]")
    return {n: sum(c[n] for c in counts) for n in want}


def _world_paths(torch, world, parts, x, card, paths_run, frames, timed,
                 launches):
    """Each path of ``paths_run`` through ``world`` at ``frames``: the
    streamed output against the whole reference on rank 0's device, exact
    launches per rank, and with ``timed`` WARM_RUNS warm walls of each.
    Returns {path: streamed output (CPU numpy)}."""
    outs = {}
    dev = world.device
    for path in paths_run:
        model, names, kw = parts[path]
        model = model.to(dev)
        fn, args, kwargs = _stream_call(torch, path, model, names, kw, x,
                                        frames, dev)
        whole = _stream_whole(torch, path, model, args, kwargs)
        world.reset_launches()
        got = world.call(fn, *args, **kwargs)
        if dev.type == "cuda":
            launches[f"streamed {path} ({world.size} ranks)"] = _rank_launches(
                world, f"{path} at {frames} frames over {world.size} ranks",
                STREAM_EXPECT[path], card)
        got, whole = (a.detach().float().cpu().numpy() for a in (got, whole))
        if got.shape != whole.shape or not np.isfinite(got).all():
            fail(f"[stream] {path}: streamed {got.shape} against whole "
                 f"{whole.shape}, or non-finite")
        err = float(np.abs(got - whole).max() / np.abs(whole).max())
        log(f"[stream] {path} ({frames} frames, {world.size} ranks on {dev}): "
            f"streamed against the whole reference {err:.3e} relative to the "
            f"peak (limit {STREAM_LIMITS[path]:.0e}) [{card}]")
        if err > STREAM_LIMITS[path]:
            fail(f"[stream] {path}: streamed against whole {err:.3e}")
        if timed:
            _, st_runs, st_cold = _timed_runs(
                torch, lambda: world.call(fn, *args, **kwargs), WARM_RUNS)
            _, wh_runs, wh_cold = _timed_runs(
                torch, lambda: _stream_whole(torch, path, model, args, kwargs),
                WARM_RUNS)
            log(f"[stream] (c) {path} 10 s, {world.size} ranks sharing one "
                f"card: streamed {_walls_text(st_runs, st_cold)}; whole "
                f"{_walls_text(wh_runs, wh_cold)}; streamed / whole "
                f"{st_runs[len(st_runs) // 2] / wh_runs[len(wh_runs) // 2]:.2f}x "
                f"[{card}]")
        outs[path] = got
        model.to("cpu")
    return outs


def _stream_cli(torch, card: str, root: Path) -> None:
    """(b) cli.infer.main --stream 2 on a 12 s wav (three segments) for
    combsub and sins, against the same CLI without --stream, outside the
    last FRAME_HALO frames of each segment; the enhancer off and the noise
    filter off (the two runs draw their noise differently)."""
    from ddsp_svc_tpu_torch.cli import infer as cli_infer
    from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
    from ddsp_svc_tpu_torch.features.slicer import split_audio
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.parallel.stream import FRAME_HALO
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import DotDict, save_config

    wave = voice_wave(12, np.random.default_rng(SEED + 23),
                      silences=CLI_SILENCES)
    segments = split_audio(wave, SR)
    in_wav = root / "in.wav"
    save_wav(str(in_wav), wave, SR)
    keep = np.ones(len(wave) // BLOCK * BLOCK + 4 * BLOCK, bool)
    for start, seg in segments:
        end = (start // BLOCK + len(seg) // BLOCK + 1) * BLOCK
        keep[end - FRAME_HALO * BLOCK:end] = False
    for what, model_cfg in (("combsub", {"type": "CombSubSuperFast",
                                         "win_length": WIN, "n_spk": 1}),
                            ("sins", dict(SINS, type="Sins", n_spk=1))):
        cargs = DotDict({
            "data": {"sampling_rate": SR, "block_size": BLOCK, "duration": 2,
                     "encoder": ENCODER, "encoder_ckpt": None,
                     "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                     "encoder_out_channels": N_UNIT, "f0_extractor": "yin",
                     "f0_min": 65, "f0_max": 800},
            "model": model_cfg, "infer": {}})
        expdir = root / what
        model = random_init_(build_model(cargs), torch.Generator().manual_seed(SEED))
        _silence_noise_filter(model)
        ckpt = save_checkpoint(str(expdir), 1, model, cargs.model)
        save_config(str(expdir / "config.yaml"), dict(cargs))
        audio = {}
        for mode, extra in (("whole", []), ("stream", ["--stream", "2"])):
            out = expdir / mode / "out.wav"
            t0 = time.perf_counter()
            cli_infer.main(["-m", ckpt, "-i", str(in_wav), "-o", str(out),
                            "-e", "false"] + extra)
            wall = time.perf_counter() - t0
            audio[mode], sr = load_wav(str(out))
            log(f"[stream] (b) cli.infer.main {' '.join(extra) or '(no --stream)'} "
                f"{what}: {len(audio[mode])} samples at {sr} Hz, wall {wall:.2f} s "
                f"(model and encoder load and the helper rank's start included) "
                f"[{card}]")
        a, b = audio["whole"], audio["stream"]
        if a.shape != b.shape or not np.isfinite(b).all():
            fail(f"[stream] (b) {what}: {b.shape} samples with --stream, "
                 f"{a.shape} without, or non-finite")
        mask = keep[:len(a)]
        snr = snr_db(a[mask], b[mask])
        tail = snr_db(a[~mask], b[~mask]) if (~mask).any() else float("inf")
        log(f"[stream] (b) {what}: --stream 2 against no --stream on a 12 s "
            f"wav ({len(segments)} segments): {snr:.2f} dB outside the last "
            f"{FRAME_HALO} frames of each segment (limit >= "
            f"{STREAM_CLI_SNR_DB:.0f} dB), {tail:.2f} dB inside them (may "
            f"differ by design) [{card}]")
        if snr < STREAM_CLI_SNR_DB:
            fail(f"[stream] (b) {what}: {snr:.2f} dB")


def phase_streaming(torch, card: str, root: Path) -> dict:
    """Time-sharded streaming on the card: (a) combsub (worlds 2 and 4),
    sins, the diffusion-fast cascade mel and the NSF-HiFiGAN at full width
    on 10 s, each against the port's whole reference, exact launches per
    rank, and the card's streamed output against the CPU ranks'; (b) the
    CLI's --stream; (c) walls. Returns {path: launch counts summed over
    the ranks}."""
    from ddsp_svc_tpu_torch.parallel.mesh import World

    t0 = time.perf_counter()
    x, parts = _stream_parts(torch)
    launches = {}
    order = ("combsub", "sins", "cascade mel", "vocoder")
    with World(2) as world:  # both ranks on cuda:0
        on_card = _world_paths(torch, world, parts, x, card, order,
                               frames_for(10), True, launches)
    t_cpu = time.perf_counter()
    with World(2, device="cpu") as world:
        on_cpu = _world_paths(torch, world, parts, x, card, order,
                              frames_for(10), False, {})
    log(f"[stream] the CPU ranks' four paths at 10 s, whole references "
        f"included: {time.perf_counter() - t_cpu:.1f} s [{card}]")
    for path in order:
        snr = snr_db(on_cpu[path], on_card[path])
        log(f"[stream] {path} 10 s streamed over 2 ranks, card (kernels) "
            f"against CPU (plain): {snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} "
            f"dB) [{card}]")
        if snr < SNR_LIMIT_DB:
            fail(f"[stream] {path}: card against CPU {snr:.2f} dB")
    # world 4: T padded to a multiple of 4 (as the CLI pads a segment)
    t4 = -(-frames_for(10) // 4) * 4
    x4 = dict(x, normal=np.pad(x["normal"], ((0, 0), (0, t4 * BLOCK
                                                     - x["normal"].shape[1]))))
    for k in ("units", "f0", "volume"):
        x4[k] = np.pad(x[k], ((0, 0), (0, t4 - x[k].shape[1]), (0, 0)),
                       mode="edge")
    with World(4) as world:
        _world_paths(torch, world, parts, x4, card, ("combsub",), t4, True,
                     launches)
    _stream_cli(torch, card, root)
    log(f"[stream] phase 22 took {time.perf_counter() - t0:.1f} s [{card}]")
    return launches



# ---------------------------------------------------------------- phase 23

# Multi-process training. Limits stated before its first run (PERF.md §6).
# 2 ranks against 1 (both launched with torchrun's environment,
# cuDNN's defaults as a user's run has them): step 1's loss within
# DP_FIRST_LOSS_TOL relative (the same arithmetic on half the rows, summed
# in another order), every later step's within DP_LOSS_TOL (AdamW's first
# update turns the elements whose gradient is within those ulps of 0, lr
# each way, and the later steps start from there); the final parameters
# within 2 lr x steps of each other; the ranks bit for bit. The
# sequence-parallel step (1 x 2, TF32 off as this process) against the
# dense step on the card with the same draws: the loss terms within
# SP_LOSS_TOL relative (its denoiser runs the masked stock chain, the
# dense one K3, 4.5e-6 apart per layer), the gradients within
# SP_GRAD_TOL in L2 over all leaves and SP_LEAF_TOL per leaf (the log-mel's
# 1 / mel weights, as TRAIN_LEAF_TOL). Remat: the gradients within
# REMAT_GRAD_TOL in L2 of those without it (the same kernels on the same
# activations; cuDNN's weight gradients may sum in another order).
DP_STEPS, DP_RESUME_STEPS, VOC_DP_STEPS = 10, 1, 5
DP_FIRST_LOSS_TOL, DP_LOSS_TOL = 1e-5, 1e-3
# the GAN's later steps: set after the phase's first run on an H100 missed
# DP_LOSS_TOL at iteration 4's mel L1 by 1.03e-3 (each network's update
# feeds the other's next loss, which amplifies the turned elements of
# AdamW's first updates); PERF.md §6 keeps the miss
VOC_DP_LOSS_TOL = 1e-2
SP_BATCH, SP_FRAMES = 8, 688
SP_LOSS_TOL, SP_GRAD_TOL, SP_LEAF_TOL = 1e-4, 1e-3, 1e-2
REMAT_GRAD_TOL = 1e-5
RANK_WALL = 600.0  # a launched world's bound (s)


def _digest(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _state_digests(state) -> dict:
    """Digests of a TrainState's parameters and buffers and of AdamW's
    state (moments and step counts)."""
    opt = {f"{n}.{k}": v for n, p in state.model.named_parameters()
           for k, v in state.optimizer.state.get(p, {}).items()}
    return {"params": _digest(state.model.state_dict()), "opt": _digest(opt),
            "step": state.step}


def _step_peak(torch, fn) -> float:
    """Run ``fn`` -> the device memory its peak held above what was
    allocated before it (GiB): activations, gradients and buffers, not
    the process's standing tensors."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def sp_inputs(torch, args, b: int, t: int, device):
    """The sequence-parallel check's batch and draws (numpy from the seed,
    the same in every process) on ``device``."""
    rng = np.random.default_rng(SEED + 23)
    f0 = 110.0 * 2 ** (rng.uniform(0, 1.5, (b, 1, 1))
                       + 0.1 * np.sin(np.arange(t) / 17.0)[None, :, None])
    x = {"units": rng.standard_normal((b, t, args.data.encoder_out_channels)),
         "f0": f0, "volume": rng.uniform(0.05, 0.5, (b, t, 1)),
         "mel": rng.uniform(-9.0, 0.0, (b, t, 128)),
         "aug_shift": rng.uniform(-3, 3, (b, 1, 1)),
         "spk_id": np.ones((b, 1), np.int64)}
    d = {"ddsp_noise": rng.standard_normal((b, t * BLOCK)),
         "t": rng.integers(0, int(args.model.k_step_max), b),
         "noise": rng.standard_normal((b, t, 128))}

    def tt(v):
        v = torch.from_numpy(np.asarray(v))
        return (v.float() if v.is_floating_point() else v).to(device)
    return {k: tt(v) for k, v in x.items()}, {k: tt(v) for k, v in d.items()}


def sp_model(torch, args):
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model

    return random_init_(build_model(args), torch.Generator().manual_seed(SEED + 23))


def rank_main(argv) -> None:
    """One rank of a phase 23 world (``python3 chip_smoke.py --rank KIND
    OUT [ARGS]``, torchrun's environment set by ``parallel.launch``): KIND
    'train' runs cli.train.main(ARGS), 'vocoder' cli.train_vocoder.main
    (ARGS), 'sp' the sequence-parallel step; each step's wall, launches
    and loss terms, the gradient all-reduce's wall and bytes, and digests
    of the final states go to OUT/rank<r>.json."""
    import os

    import torch

    from ddsp_svc_tpu_torch.parallel import mesh as mesh_lib

    kind, out, rest = argv[0], Path(argv[1]), argv[2:]
    rank = int(os.environ["RANK"])
    wrappers = all_counts()
    rec = {"steps": [], "allreduce": []}
    psum_flat = mesh_lib.TimeGroup.psum_flat

    def timed_psum(self, tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summed = psum_flat(self, tensors)
        torch.cuda.synchronize()
        rec["allreduce"].append([time.perf_counter() - t0,
                                 sum(t.numel() * t.element_size() for t in tensors)])
        return summed
    mesh_lib.TimeGroup.psum_flat = timed_psum

    def recorded(fn, what):
        def step(*a, **k):
            before = {n: w.launches for n, w in wrappers.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = fn(*a, **k)
            torch.cuda.synchronize()
            rec["steps"].append({
                "what": what, "wall": time.perf_counter() - t0,
                "launches": {n: w.launches - before[n] for n, w in wrappers.items()},
                "metrics": {m: float(v) for m, v in metrics.items()}})
            return metrics
        return step

    if kind == "train":
        from ddsp_svc_tpu_torch.cli import train as cli_train
        from ddsp_svc_tpu_torch.train import solver

        build = solver.build_train_step

        def build_recorded(args, mel_fn=None, mesh=None):
            family, step = build(args, mel_fn, mesh)
            return family, recorded(step, "step")
        solver.build_train_step = build_recorded
        rec["digests"] = _state_digests(cli_train.main(rest))
    elif kind == "vocoder":
        from ddsp_svc_tpu_torch.cli import train_vocoder as cli_voc

        cli_voc.disc_step = recorded(cli_voc.disc_step, "d")
        cli_voc.gen_step = recorded(cli_voc.gen_step, "g")
        state_g, state_d = cli_voc.main(rest)
        rec["digests"] = {"generator": _state_digests(state_g),
                          "discriminators": _state_digests(state_d)}
    else:  # 'sp': one step of make_sp_cascade_train_step, TF32 off
        from ddsp_svc_tpu_torch.parallel.train_sp import make_sp_cascade_train_step
        from ddsp_svc_tpu_torch.train.state import create_train_state
        from ddsp_svc_tpu_torch.utils.config import load_config

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = mesh_lib.join_launched_world()
        try:
            world = mesh_lib.make_mesh(1, int(os.environ["WORLD_SIZE"]), dev)
            args = load_config(CONFIGS / "diffusion-fast.yaml")
            model = sp_model(torch, args).to(dev)
            from ddsp_svc_tpu_torch.cli.common import build_mel_extractor

            step = make_sp_cascade_train_step(
                model, build_mel_extractor(args, dev), world,
                k_step_max=int(args.model.k_step_max))
            state = create_train_state(model, lr=float(args.train.lr))
            batch, draws = sp_inputs(torch, args, SP_BATCH, SP_FRAMES, dev)
            rec["peak_gib"] = _step_peak(torch, lambda: recorded(step, "sp")(
                state, batch, draws=draws))
            if rank == 0:
                torch.save({n: p.grad.detach().cpu() for n, p in
                            model.named_parameters() if p.grad is not None},
                           out / "grads.pt")
        finally:
            torch.distributed.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(rec))


def _launch_ranks(kind: str, out: Path, nproc: int, args: list) -> tuple:
    """``nproc`` ranks of ``rank_main`` -> (each rank's record, each rank's
    output, the world's wall)."""
    from ddsp_svc_tpu_torch.parallel.launch import launch

    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        outs = launch([str(Path(__file__).resolve()), "--rank", kind, str(out)]
                      + [str(a) for a in args], nproc, RANK_WALL,
                      cwd=str(Path(__file__).resolve().parent))
    except RuntimeError as e:
        fail(f"[multi] {kind} world of {nproc}: {e}")
    wall = time.perf_counter() - t0
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)]
    return recs, outs, wall


def _check_launches(recs, what: str, expect: dict, kinds=None) -> dict:
    """Each step of each rank launched exactly ``expect`` -> the launches
    summed over the ranks."""
    total = {}
    want = _with_zeros(expect)
    for r, rec in enumerate(recs):
        for s in rec["steps"]:
            if kinds is not None and s["what"] not in kinds:
                continue
            if s["launches"] != want:
                fail(f"[multi] {what} rank {r} {s['what']}: launches "
                     f"{s['launches']}, expected {want}")
            for n, c in s["launches"].items():
                total[n] = total.get(n, 0) + c
    return total


def _same_ranks(recs, what: str) -> None:
    if any(r["digests"] != recs[0]["digests"] for r in recs[1:]):
        fail(f"[multi] {what}: the ranks' states differ: "
             f"{[r['digests'] for r in recs]}")


def _losses_close(one, two, what: str, later_tol: float = DP_LOSS_TOL) -> str:
    """Step by step, two ranks' loss terms against one rank's: the first
    step's within DP_FIRST_LOSS_TOL, the later ones' within ``later_tol``."""
    worst = []
    for i, (a, b) in enumerate(zip(one, two)):
        for k, want in a["metrics"].items():
            err = abs(b["metrics"][k] - want) / abs(want)
            lim = DP_FIRST_LOSS_TOL if i == 0 else later_tol
            if not err <= lim:
                fail(f"[multi] {what} step {i + 1} {k}: 2 ranks "
                     f"{b['metrics'][k]:.6f}, 1 rank {want:.6f} ({err:.2e} "
                     f"relative, limit {lim:g})")
            worst.append((i, err))
    return (f"first step {max(e for i, e in worst if i == 0):.2e}, worst "
            f"{max(e for _, e in worst):.2e}")


def _params_close(path1: Path, path2: Path, lr: float, steps: int, what: str) -> str:
    """The parameters two runs saved, within AdamW's reach of 2 lr a step."""
    from ddsp_svc_tpu_torch.train.checkpoint import load_checkpoint

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, np.float64)
    (p1, _), (p2, _) = load_checkpoint(str(path1)), load_checkpoint(str(path2))
    a, b = dict(flat(p1["params"])), dict(flat(p2["params"]))
    if a.keys() != b.keys():
        fail(f"[multi] {what}: the checkpoints' trees differ")
    worst = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    if not worst <= 2 * lr * steps:
        fail(f"[multi] {what}: parameters {worst:.3e} apart (limit {2 * lr * steps:g})")
    return f"parameters within {worst:.2e} (limit 2 lr x steps = {2 * lr * steps:g})"


def _med(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_multi_training(torch, card: str, root: Path) -> dict:
    """Phase 23: see the module docstring. Returns {path: launch counts
    summed over the ranks}."""
    from ddsp_svc_tpu_torch.utils.config import save_config

    t_phase = time.perf_counter()
    paths = {}

    # (a) cli.train, diffusion-fast at full width, 1 rank and 2 ranks
    cfgs = {}
    for n in (1, 2):
        cfg, args = train_config(root, f"diffusion-fast-dp{n}", "diffusion-fast.yaml")
        args["train"].update(interval_log=5, interval_val=DP_STEPS)
        save_config(cfg, args)
        cfgs[n] = cfg
    argv = lambda n, steps: ["train", root / "multi" / f"a{n}-{steps}", n,  # noqa: E731
                             ["-c", cfgs[n], "--max_steps", steps]]
    runs = {}
    for n in (1, 2):
        kind, out, nproc, a = argv(n, DP_STEPS)
        runs[n] = _launch_ranks(kind, out, nproc, a)
    (one, _, wall1), (two, outs2, wall2) = runs[1], runs[2]
    expect = expect_train(args)
    counts = _check_launches(one + two, "(a) DiffusionFast", expect)
    _same_ranks(two, "(a) DiffusionFast")
    close = _losses_close(one[0]["steps"], two[0]["steps"], "(a) DiffusionFast")
    exp2 = Path(root / "exp" / "diffusion-fast-dp2")
    pclose = _params_close(root / "exp" / "diffusion-fast-dp1" / f"model_{DP_STEPS}.ckpt",
                           exp2 / f"model_{DP_STEPS}.ckpt", float(args.train.lr),
                           DP_STEPS, "(a)")
    saved = sorted(p.name for p in exp2.glob("model_*.ckpt"))
    if saved != [f"model_{DP_STEPS}.ckpt"] or "model saved" not in outs2[0] \
            or "model saved" in outs2[1]:
        fail(f"[multi] (a) 2 ranks saved {saved}; rank 0 said "
             f"{'model saved' in outs2[0]}, rank 1 {'model saved' in outs2[1]}")
    kind, out, nproc, a = argv(2, DP_RESUME_STEPS)
    resumed, outs_r, _ = _launch_ranks(kind, out, nproc, a)
    counts_r = _check_launches(resumed, "(a) DiffusionFast resumed", expect)
    _same_ranks(resumed, "(a) resumed")
    if (any(f"model_{DP_STEPS}.ckpt (step {DP_STEPS})" not in o for o in outs_r)
            or resumed[0]["digests"]["step"] != DP_STEPS + DP_RESUME_STEPS):
        fail(f"[multi] (a) the resume did not continue from model_{DP_STEPS}")
    w1 = _med([s["wall"] for s in one[0]["steps"][2:]])
    w2 = _med([s["wall"] for s in two[0]["steps"][2:]])
    ar = two[0]["allreduce"][2:]
    ar_wall, ar_bytes = _med([a[0] for a in ar]), ar[0][1]
    log(f"[multi] (a) cli.train configs/diffusion-fast.yaml ({args.model.n_layers} "
        f"x {args.model.n_chans}, batch {args.train.batch_size} x "
        f"{args.data.duration} s): {DP_STEPS} steps on 2 "
        f"ranks sharing the card (gloo, through the host) against 1 rank: losses "
        f"{close} relative (limits {DP_FIRST_LOSS_TOL:g}, {DP_LOSS_TOL:g}), "
        f"{pclose}; the ranks' parameters and AdamW state bit for bit; rank 0 alone saved "
        f"model_{DP_STEPS}.ckpt; both ranks resumed from it to step "
        f"{DP_STEPS + DP_RESUME_STEPS}; launches per rank and step K1 1, K3 "
        f"{args.model.n_layers}, none in the backward [{card}]")
    b = int(args.train.batch_size)
    log(f"[multi] (a) warm step median: 2 ranks {w2 * 1e3:.1f} ms (each {b // 2} "
        f"rows), 1 rank {w1 * 1e3:.1f} ms ({b} rows); the gradient all-reduce "
        f"{ar_bytes / 2 ** 20:.1f} MiB a step, {ar_wall * 1e3:.1f} ms = "
        f"{100 * ar_wall / w2:.1f} % of the 2-rank step; worlds {wall1:.1f} s and "
        f"{wall2:.1f} s, launch and {DP_STEPS} steps and the save [{card}]")
    paths["multi (a) cli.train"] = {n: counts.get(n, 0) + counts_r.get(n, 0)
                                    for n in counts}

    # (b) cli.train_vocoder, nsf-hifigan at full width, 1 rank and 2 ranks
    vcfg = {}
    for n in (1, 2):
        cfg, vargs = train_config(root, f"nsf-hifigan-dp{n}", "nsf-hifigan.yaml")
        vargs["train"].update(interval_log=5, interval_val=VOC_DP_STEPS)
        save_config(cfg, vargs)
        vcfg[n] = cfg
    vruns = {n: _launch_ranks("vocoder", root / "multi" / f"b{n}", n,
                              ["-c", vcfg[n], "--max_steps", VOC_DP_STEPS])
             for n in (1, 2)}
    (vone, _, _), (vtwo, vouts, _) = vruns[1], vruns[2]
    from ddsp_svc_tpu_torch.cli import train_vocoder as cli_voc

    n_stages = len(cli_voc.vocoder_config(vargs)["upsample_rates"])
    vcounts = _check_launches(vone + vtwo, "(b) NSF-HiFiGAN",
                              {"resblock_group": n_stages})
    _same_ranks(vtwo, "(b) NSF-HiFiGAN")
    # the steps in order: the first discriminator step is the first step
    vclose = _losses_close(vone[0]["steps"], vtwo[0]["steps"], "(b) NSF-HiFiGAN",
                           VOC_DP_LOSS_TOL)
    if "vocoder ckpt saved" not in vouts[0] or "vocoder ckpt saved" in vouts[1]:
        fail("[multi] (b) the save was not rank 0's alone")
    vpclose = _params_close(
        *(root / "exp" / f"nsf-hifigan-dp{n}" / f"model_{VOC_DP_STEPS}.ckpt"
          for n in (1, 2)), float(vargs.train.lr), 2 * VOC_DP_STEPS, "(b)")
    vres, vres_outs, _ = _launch_ranks("vocoder", root / "multi" / "b2-resume", 2,
                                       ["-c", vcfg[2], "--max_steps", 1])
    vcounts_r = _check_launches(vres, "(b) resumed", {"resblock_group": n_stages})
    _same_ranks(vres, "(b) resumed")
    if any(f"model_{VOC_DP_STEPS}.ckpt (step {VOC_DP_STEPS})" not in o
           for o in vres_outs):
        fail(f"[multi] (b) the resume did not continue from model_{VOC_DP_STEPS}")

    def iters(rec):
        s = rec["steps"]
        return [s[i]["wall"] + s[i + 1]["wall"] for i in range(0, len(s), 2)][1:]
    vbytes = sorted({a[1] for a in vtwo[0]["allreduce"]})
    log(f"[multi] (b) cli.train_vocoder configs/nsf-hifigan.yaml (batch "
        f"{vargs.train.batch_size} x {vargs.data.duration} s): {VOC_DP_STEPS} "
        f"iterations on 2 ranks against 1: losses {vclose} relative, {vpclose}; "
        f"ranks bit "
        f"for bit (both networks, AdamW state); rank 0 alone saved; resumed by "
        f"both; K2 {n_stages} in each step ({2 * n_stages} per iteration) on "
        f"each rank; iteration median 2 ranks {_med(iters(vtwo[0])) * 1e3:.1f} ms, "
        f"1 rank {_med(iters(vone[0])) * 1e3:.1f} ms; all-reduces "
        f"{' and '.join(f'{b / 2 ** 20:.1f}' for b in vbytes)} MiB [{card}]")
    paths["multi (b) cli.train_vocoder"] = {n: vcounts.get(n, 0) + vcounts_r.get(n, 0)
                                            for n in vcounts}

    # (c) the sequence-parallel step, 1 x 2, against the dense step
    srecs, _, swall = _launch_ranks("sp", root / "multi" / "c", 2, [])
    scounts = _check_launches(srecs, "(c) sequence-parallel step", {"combtooth": 1})
    sp_grads = torch.load(root / "multi" / "c" / "grads.pt", weights_only=True)
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor
    from ddsp_svc_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    args = load_config(CONFIGS / "diffusion-fast.yaml")
    model = sp_model(torch, args).to(dev)
    batch, draws = sp_inputs(torch, args, SP_BATCH, SP_FRAMES, dev)
    wrappers = all_counts()
    before = {n: w.launches for n, w in wrappers.items()}
    mel_fn = build_mel_extractor(args, dev).extract
    terms = []

    def dense_step():
        ddsp, diff = model.loss(
            batch["units"], batch["f0"], batch["volume"], batch["mel"],
            mel_extract_fn=mel_fn, spk_id=batch["spk_id"],
            aug_shift=batch["aug_shift"], k_step=int(args.model.k_step_max),
            **draws)
        (ddsp + diff).backward()
        terms.extend([float(ddsp.detach()), float(diff.detach())])
    dense_peak = _step_peak(torch, dense_step)
    ddsp_l, diff_l = terms
    dense_counts = {n: w.launches - before[n] for n, w in wrappers.items()}
    dense = _grads_of(model)
    sp_m = srecs[0]["steps"][0]["metrics"]
    errs = (abs(sp_m["ddsp_loss"] - ddsp_l) / abs(ddsp_l),
            abs(sp_m["diff_loss"] - diff_l) / abs(diff_l))
    total, leaf = _grad_gap({n: g.double() for n, g in sp_grads.items()}, dense)
    log(f"[multi] (c) the sequence-parallel step (configs/diffusion-fast.yaml "
        f"widths, dp x sp = 1 x 2, batch {SP_BATCH} x {SP_FRAMES} frames, "
        f"{SP_FRAMES // 2} a rank) against the dense step on the card with the "
        f"same draws: ddsp loss {sp_m['ddsp_loss']:.6f} vs {ddsp_l:.6f} "
        f"({errs[0]:.2e}), diff loss {sp_m['diff_loss']:.6f} vs "
        f"{diff_l:.6f} ({errs[1]:.2e}; limit {SP_LOSS_TOL:g}); gradients "
        f"{total:.2e} in L2 over {len(dense)} leaves (limit {SP_GRAD_TOL:g}), worst "
        f"leaf {leaf[0]:.2e} at {leaf[1]} (limit {SP_LEAF_TOL:g}); launches per "
        f"rank K1 1, K3 0 (the dense step K1 {dense_counts['combtooth']}, K3 "
        f"{dense_counts['conformer_layer']}); the step's peak memory above "
        f"what was allocated before it, per rank "
        + ", ".join(f"{r['peak_gib']:.3f}" for r in srecs)
        + f" GiB against the dense step's {dense_peak:.3f} GiB; world "
        f"{swall:.1f} s [{card}]")
    if not (max(errs) <= SP_LOSS_TOL and total <= SP_GRAD_TOL
            and leaf[0] <= SP_LEAF_TOL):
        fail("[multi] (c) the sequence-parallel step beyond the stated limits")
    paths["multi (c) sequence-parallel step"] = scounts
    del model, sp_grads, dense
    torch.cuda.empty_cache()

    # (d) model.use_remat: one DiffusionFast step with and without remat
    from ddsp_svc_tpu_torch.data.dataset import BatchSampler, get_datasets
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.train.steps import to_device

    cfg, args = train_config(root, "diffusion-fast-remat", "diffusion-fast.yaml")
    x = to_device(BatchSampler(get_datasets(args)[0], int(args.train.batch_size),
                               seed=SEED).sample(), dev)
    b, t = x["units"].shape[:2]
    rng = np.random.default_rng(SEED + 230)
    d = {"ddsp_noise": torch.from_numpy(rng.standard_normal(
             (b, t * BLOCK)).astype(np.float32)).to(dev),
         "t": torch.from_numpy(rng.integers(0, 100, b)).to(dev),
         "noise": torch.from_numpy(rng.standard_normal(
             (b, t, 128)).astype(np.float32)).to(dev)}
    weights = sp_model(torch, args).state_dict()
    res = {}
    for remat in (False, True):
        args["model"]["use_remat"] = remat
        model = build_model(args)
        model.load_state_dict(weights)
        model.to(dev)
        before = {n: w.launches for n, w in wrappers.items()}
        mel_fn = build_mel_extractor(args, dev).extract
        out = []
        peak = _step_peak(torch, lambda: out.append(step_grads(
            torch, model, "diffusion", x, d, mel_fn)[1]))
        res[remat] = (out[0], peak,
                      {n: w.launches - before[n] for n, w in wrappers.items()})
        del model
    (g0, peak0, c0), (g1, peak1, c1) = res[False], res[True]
    layers = int(args.model.n_layers)
    if c0 != _with_zeros({"combtooth": 1, "conformer_layer": layers}) or \
            c1 != _with_zeros({"combtooth": 1, "conformer_layer": 2 * layers}):
        fail(f"[multi] (d) launches without remat {c0}, with {c1}")
    rtotal, rleaf = _grad_gap(g1, g0)
    same = all(torch.equal(g1[n], g0[n]) for n in g0)
    log(f"[multi] (d) model.use_remat on a DiffusionFast step (batch {b} x {t} "
        f"frames): gradients {rtotal:.2e} in L2 from the step without it (limit "
        f"{REMAT_GRAD_TOL:g}; bit for bit: {same}), worst leaf {rleaf[0]:.2e}; K3 "
        f"{2 * layers} a step with remat ({layers} without), K1 1; the step's "
        f"peak memory above what was allocated before it {peak1:.3f} GiB with "
        f"remat, {peak0:.3f} GiB without [{card}]")
    if not rtotal <= REMAT_GRAD_TOL:
        fail("[multi] (d) remat's gradients beyond the stated limit")
    paths["multi (d) remat"] = {n: c0[n] + c1[n] for n in c0}
    log(f"[multi] phase 23 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return paths


# ---------------------------------------------------------------- phase 24

BATCH_INFER_SECONDS = {"a.wav": 2, "set/b.wav": 5, "set/live/c.wav": 10,
                       "set/live/d.wav": 12}
EXPORT_REL_TOL = 1e-5  # the artifact against the eager model, x max|out|
EXPECT_EXPORT = {"diffusion-fast": {"combtooth": 1, "conformer_layer": 60},
                 "sins": {"harmonic_bank": 1}}
PLAIN_VERSIONS = (("cuda_source", "combtooth_plain"),
                  ("cuda_conformer", "conformer_layer_plain"),
                  ("cuda_oscillator", "harmonic_bank_plain"))


class _NoPlain:
    """Within the block, calling a kernel's plain version fails the run."""

    def __enter__(self):
        import importlib

        self.saved = []
        for mod_name, fn in PLAIN_VERSIONS:
            mod = importlib.import_module(f"ddsp_svc_tpu_torch.ops.{mod_name}")
            self.saved.append((mod, fn, getattr(mod, fn)))
            setattr(mod, fn, lambda *a, _fn=fn, **k: fail(
                f"the plain version {_fn} ran inside an exported program"))
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)


def write_upstream(root: Path) -> dict:
    """Phase 24 (a): synthetic upstream files at the published widths, each
    in upstream's wrapper, converted by the port's converter CLI. Returns
    the paths of the converted model checkpoints (each with its config)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_convert_helpers as up
    from ddsp_svc_tpu_torch.convert.__main__ import main as convert
    from ddsp_svc_tpu_torch.features.hubert import ENCODER_CONFIGS
    from ddsp_svc_tpu_torch.utils.config import load_config, save_config

    t0 = time.perf_counter()
    voc = load_config(str(CONFIGS / "nsf-hifigan.yaml"))
    voc_cfg = dict(voc.vocoder, sampling_rate=SR, hop_size=BLOCK)
    voc_cfg.pop("type", None)
    (root / "nsf_hifigan").mkdir()
    (root / "nsf_hifigan" / "config.json").write_text(json.dumps(voc_cfg))
    up.save_upstream(root / "nsf_hifigan" / "model",
                     up.nsf_hifigan_state_dict(voc_cfg, seed=SEED + 240), "generator")
    enc = ENCODER_CONFIGS[ENCODER]
    up.save_upstream(root / "contentvec.pt", up.hubert_state_dict(
        "fairseq", enc.dim, enc.ffn_dim, enc.num_layers, seed=SEED + 241,
        proj_dim=enc.proj_dim), "model")
    up.save_upstream(root / "rmvpe.pt", up.rmvpe_state_dict(seed=SEED + 242), "model")
    for argv in (["nsf-hifigan", str(root / "nsf_hifigan" / "model")],
                 ["hubert", str(root / "contentvec.pt"), ENCODER,
                  str(root / "contentvec.msgpack")],
                 ["rmvpe", str(root / "rmvpe.pt")]):
        if convert(argv) != 0:
            fail(f"convert {argv[0]} failed")
    models = {}
    for name, config in (("diffusion-fast", "diffusion-fast.yaml"),
                         ("sins", "sins.yaml")):
        args = load_config(str(CONFIGS / config))
        args["data"]["encoder_ckpt"] = str(root / "contentvec.msgpack")
        section = "vocoder" if name == "diffusion-fast" else "enhancer"
        args[section]["ckpt"] = str(root / "nsf_hifigan" / "model")
        d = root / name
        d.mkdir()
        save_config(d / "config.yaml", dict(args))
        written = load_config(str(d / "config.yaml"))
        if (written.data.encoder_ckpt != str(root / "contentvec.msgpack")
                or written[section]["ckpt"] != str(root / "nsf_hifigan" / "model")):
            fail(f"{name}: the config does not name the converted files")
        up.save_upstream(d / "model_4000.pt",
                         up.model_state_dict(args, seed=SEED + 243), "model")
        if convert(["model", str(d / "model_4000.pt"), str(d / "config.yaml"),
                    str(d)]) != 0:
            fail(f"convert model {name} failed")
        models[name] = d / "model_4000.ckpt"
    log(f"[convert] upstream files drawn at the published widths and converted "
        f"(nsf-hifigan, hubert {ENCODER}, rmvpe, model diffusion-fast and sins) "
        f"in {time.perf_counter() - t0:.1f} s; sizes "
        + ", ".join(f"{p.name} {p.stat().st_size / 1e6:.1f} MB" for p in (
            root / "nsf_hifigan" / "model.msgpack", root / "contentvec.msgpack",
            root / "rmvpe.msgpack", models["diffusion-fast"], models["sins"])))
    return models


def check_converted(torch, card: str, root: Path, models: dict) -> None:
    """Phase 24 (a): every converted file loads strictly through the port's
    loaders; the converted pipeline's 10 s request, card against CPU."""
    from ddsp_svc_tpu_torch.features.hubert import UnitsEncoder
    from ddsp_svc_tpu_torch.features.rmvpe import E2E0
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
    from ddsp_svc_tpu_torch.io import jax_params as jp
    from ddsp_svc_tpu_torch.models.registry import load_model, load_vocoder

    # each loader raises on a missing or unexpected key
    for name, path in models.items():
        load_model(str(path), device="cpu")
    load_vocoder(str(root / "nsf_hifigan" / "model"), device="cpu")
    UnitsEncoder(ENCODER, params=jp.read_msgpack(str(root / "contentvec.msgpack")),
                 device="cpu")
    jp.load_state(E2E0(), jp.f0_net_state_dict(
        "rmvpe", jp.read_msgpack(str(root / "rmvpe.msgpack"))))
    rng = np.random.default_rng(SEED + 244)
    wave = voice_wave(10, rng)
    t = len(wave) // BLOCK + 1
    noise = request_noise(rng, t)
    audio = {}
    for dev in (None, "cpu"):
        pipe = SvcPipeline(str(models["diffusion-fast"]), device=dev, seed=SEED)
        out, sr = pipe.infer(wave, SR, k_step=100, noise=noise)
        audio[dev] = check_audio(out, t, f"converted diffusion-fast 10 s on {dev}")
        del pipe
    snr = snr_db(audio["cpu"], audio[None])
    log(f"[convert] every file loads strictly (load_model, load_vocoder, "
        f"UnitsEncoder, E2E0); the converted diffusion-fast pipeline's 10 s "
        f"request from a wav, card (kernels) against CPU (plain), same "
        f"weights and noise: {snr:.2f} dB (limit >= {SNR_LIMIT_DB:.0f} dB) [{card}]")
    if not snr >= SNR_LIMIT_DB:
        fail(f"converted pipeline card vs CPU {snr:.2f} dB < {SNR_LIMIT_DB} dB")


def batch_infer_tree(torch, card: str, root: Path, model: Path) -> dict:
    """Phase 24 (b): cli.batch_infer on the card over a nested tree."""
    import os

    from scipy.io import wavfile

    from ddsp_svc_tpu_torch.cli import batch_infer
    from ddsp_svc_tpu_torch.features.audio import load_wav, save_wav
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    os.environ["DDSP_SVC_TPU_RMVPE_CKPT"] = str(root / "rmvpe.msgpack")
    rng = np.random.default_rng(SEED + 245)
    for rel, seconds in BATCH_INFER_SECONDS.items():
        (root / "in" / rel).parent.mkdir(parents=True, exist_ok=True)
        save_wav(str(root / "in" / rel), voice_wave(seconds, rng), SR)
    wrappers = counts()
    for w in wrappers.values():
        w.launches = 0
    per_file, infer = [], SvcPipeline.infer

    def metered(self, audio, sr, **kwargs):
        before = {n: w.launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(self, audio, sr, **kwargs)
        torch.cuda.synchronize()
        per_file.append((time.perf_counter() - t0, len(audio) / sr,
                         {n: w.launches - before[n] for n, w in wrappers.items()}))
        return out

    SvcPipeline.infer = metered
    try:
        t0 = time.perf_counter()
        files = batch_infer.main(["-m", str(model), "-i", str(root / "in"), "-o",
                                  str(root / "out"), "-kstep", "100", "-pe", "rmvpe"])
        total = time.perf_counter() - t0
    finally:
        SvcPipeline.infer = infer
    launches = {n: w.launches for n, w in wrappers.items()}
    written = sorted(str(p.relative_to(root / "out"))
                     for p in (root / "out").rglob("*.wav"))
    if files != sorted(BATCH_INFER_SECONDS) or written != files:
        fail(f"batch_infer: wrote {written} for the inputs {files}")
    for wall, seconds, delta in per_file:
        if delta != EXPECT_DIFFUSION:
            fail(f"batch_infer: a {seconds:g} s file launched {delta}, expected "
                 f"{EXPECT_DIFFUSION}")
    solo = SvcPipeline(str(model), seed=SEED, pitch_extractor="rmvpe")
    seeds = np.random.default_rng(0)
    for rel in files:
        wave, sr = load_wav(str(root / "in" / rel))
        want, _ = solo.infer(wave, sr, k_step=100, seed=int(seeds.integers(1 << 62)))
        want16 = np.clip(np.round(want * 32767.0), -32768, 32767)
        got16 = wavfile.read(str(root / "out" / rel))[1].astype(np.float64)
        if not np.array_equal(got16, want16):
            snr = snr_db(want16, got16) if got16.shape == want16.shape else -math.inf
            fail(f"batch_infer {rel}: not bit for bit SvcPipeline.infer alone "
                 f"({snr:.2f} dB; ROADMAP C(kk))")
    audio_s = sum(s for _, s, _ in per_file)
    log(f"[batch_infer] {len(files)} files ({', '.join(files)}) mirrored; each "
        f"bit for bit SvcPipeline.infer alone; launches per "
        f"file {EXPECT_DIFFUSION}; wall per file "
        + ", ".join(f"{s:g} s {w * 1e3:.1f} ms ({w / s * 1e3:.2f} ms per s of "
                    f"audio)" for w, s, _ in per_file)
        + f"; {audio_s:g} s of audio in {sum(w for w, _, _ in per_file):.2f} s "
        f"of requests, {total:.2f} s with the pipeline's load and the wav IO [{card}]")
    del solo
    return {"batch_infer": launches}


def export_artifacts(torch, card: str, root: Path, models: dict) -> dict:
    """Phase 24 (c): cli.export on the card and from CPU inputs, each
    artifact loaded on the card and held against the eager model."""
    from ddsp_svc_tpu_torch.cli import export as cli_export
    from ddsp_svc_tpu_torch.models.registry import load_model

    wrappers, launches = all_counts(), {}
    for name, path, device in (("diffusion-fast", models["diffusion-fast"], None),
                               ("diffusion-fast", models["diffusion-fast"], "cpu"),
                               ("sins", models["sins"], None)):
        what = f"{name} exported on {'the CPU' if device else 'the card'}"
        out = root / f"{name}-{device or 'cuda'}.pt2"
        k_step = ["-kstep", "100"] if name == "diffusion-fast" else []
        meta = cli_export.main(["-m", str(path), "-o", str(out), "--seconds", "10"]
                               + k_step + (["--device", device] if device else []))
        torch.cuda.empty_cache()
        program = cli_export.load_exported(str(out), "cuda", seed=SEED)
        frames, dev = meta["frames"], program.device
        rng = np.random.default_rng(SEED + 246)
        x = {"units": torch.from_numpy(rng.standard_normal(
                 (1, frames, N_UNIT)).astype(np.float32)).to(dev),
             "f0": torch.from_numpy(f0_contour(frames)).to(dev),
             "volume": torch.full((1, frames, 1), 0.5, device=dev),
             "spk_id": torch.ones((1, 1), dtype=torch.int32, device=dev)}
        draws = cli_export.draw(meta, frames, torch.Generator().manual_seed(SEED),
                                dev)
        model, args = load_model(str(path))
        eager, _ = cli_export.build_forward(model.eval(), args,
                                            100 if k_step else None, dev)
        inputs = [{**x, **draws}[n] for n in meta["inputs"]]

        def call_artifact():
            return program(**x, **draws)

        def call_eager():
            with torch.no_grad():
                return eager(*inputs)

        walls, launches[what] = {}, dict.fromkeys(wrappers, 0)
        for label, call in (("artifact", call_artifact), ("eager", call_eager)):
            runs = []
            for _ in range(1 + 3):
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _NoPlain():
                    got = call()
                    torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
                delta = {n: w.launches for n, w in wrappers.items()}
                if delta != _with_zeros(EXPECT_EXPORT[name]):
                    fail(f"{what} ({label}): launches {delta}, expected "
                         f"{_with_zeros(EXPECT_EXPORT[name])} a call")
                if label == "artifact":
                    for n, c in delta.items():
                        launches[what][n] += c
            walls[label] = (runs[0], sorted(runs[1:])[1], got)
        got, want = walls["artifact"][2], walls["eager"][2]
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{what}: output {tuple(got.shape)}, eager {tuple(want.shape)}")
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"[export] {what} ({meta['type']}, {frames} frames, inputs "
            f"{meta['inputs']}): export {meta['seconds']:.1f} s, artifact "
            f"{meta['bytes'] / 1e6:.1f} MB; on the card per call exactly "
            f"{EXPECT_EXPORT[name]}, no plain version; against the eager model "
            f"with the same draws {rel:.3e} x max|out| (limit {EXPORT_REL_TOL:g}); "
            f"warm median wall artifact {walls['artifact'][1] * 1e3:.2f} ms (cold "
            f"{walls['artifact'][0] * 1e3:.1f}), eager {walls['eager'][1] * 1e3:.2f} "
            f"ms (cold {walls['eager'][0] * 1e3:.1f}) [{card}]")
        if not rel <= EXPORT_REL_TOL:
            fail(f"{what}: {rel:.3e} x max|out| from the eager model")
        del program, eager, model
        torch.cuda.empty_cache()
    return launches


def phase_convert_export(torch, card: str, root: Path) -> dict:
    """Phase 24; returns {path: launch counts}."""
    t0 = time.perf_counter()
    models = write_upstream(root)
    check_converted(torch, card, root, models)
    launches = batch_infer_tree(torch, card, root, models["diffusion-fast"])
    launches.update(export_artifacts(torch, card, root, models))
    log(f"[convert] phase 24 took {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------- phase 25

ONNX_SNR_DB = 60.0  # cli.export_onnx --check's own gate
GUI_SNR_DB = 80.0
GUI_SECONDS = 5.0
GUI_RATES = (44100, 16000)
PREFETCH_STEPS = 8
PREFETCH_CONFIG = "combsub.yaml"  # CombSubSuperFast: no mels, so it streams


def random_checkpoint(torch, root: Path, name: str, config: str) -> Path:
    """A JAX-format checkpoint of a model drawn from the seed at
    ``configs/<config>``'s widths, written by the port's saver with its
    config beside it (the vocoder's and the encoder's weight files absent,
    so the pipeline draws them from its seed) -> (the checkpoint's path,
    its config)."""
    from ddsp_svc_tpu_torch.models.nn import random_init_
    from ddsp_svc_tpu_torch.models.registry import build_model
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import load_config, save_config

    args = load_config(CONFIGS / config)
    for key in ("vocoder", "enhancer"):
        if args.get(key):
            args[key]["ckpt"] = str(root / "absent" / key)
    args["data"]["encoder_ckpt"] = str(root / "absent" / "encoder.msgpack")
    d = root / name
    d.mkdir(parents=True)
    save_config(d / "config.yaml", args)
    model = random_init_(build_model(args, vocoder_dimension=args.model.out_dims or 128),
                         torch.Generator().manual_seed(SEED))
    return Path(save_checkpoint(str(d), 1, model, args.model)), args


def onnx_export_check(torch, card: str, root: Path) -> dict:
    """(a) cli.export_onnx --check on a random configs/diffusion.yaml
    Unit2Mel: the four graphs traced on the card, their export seconds and
    sizes, and the PNDM chain through them against the card's eager model.
    Returns {path: launch counts} (none: the JAX package has no Pallas
    kernel on this path)."""
    import contextlib
    import io

    import ddsp_svc_tpu_torch.cli.export_onnx as cli_onnx

    ckpt, args = random_checkpoint(torch, root, "unit2mel", "diffusion.yaml")
    m = args.model
    export, spent = cli_onnx.export_onnx, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = export(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out

    wrappers = all_counts()
    for w in wrappers.values():
        w.launches = 0
    cli_onnx.export_onnx = timed
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            paths = cli_onnx.main(["-m", str(ckpt), "-o", str(root / "onnx"),
                                   "--project", "unit2mel", "--check"])
    except SystemExit as e:
        fail(f"[onnx] cli.export_onnx --check failed: {e} ({out.getvalue()!r})")
    finally:
        cli_onnx.export_onnx = export
    wall = time.perf_counter() - t0
    launched = {n: w.launches for n, w in wrappers.items()}
    check = re.search(r"check: ([-0-9.]+) dB SNR vs checkpoint \((\d+)-step PNDM, "
                      r"max abs err ([-0-9.e+]+)\)", out.getvalue())
    if check is None:
        fail(f"[onnx] no check line in the CLI's output: {out.getvalue()!r}")
    snr, steps = float(check.group(1)), int(check.group(2))
    sizes = {g: Path(p).stat().st_size / 2 ** 20 for g, p in paths.items()}
    log(f"[onnx] (a) cli.export_onnx --check of a random configs/diffusion.yaml "
        f"Unit2Mel ({m.n_layers} x {m.n_chans} WaveNet, n_hidden {m.n_hidden}, "
        f"k_step_max {m.k_step_max}, {args.data.encoder_out_channels} units, "
        f"{m.out_dims or 128} mel bins), traced on the card: export {spent[0]:.2f} s, "
        f"graphs " + ", ".join(f"{g} {mb:.2f} MB" for g, mb in sizes.items())
        + f"; the {steps}-step PNDM chain through the four graphs (numpy runtime "
        f"on the host, 24 frames) against the card's eager Unit2Mel (sampler "
        f"pndm, same init noise): SNR {snr:.1f} dB (gate >= {ONNX_SNR_DB:.0f} dB), "
        f"max abs err {check.group(3)}; export and check {wall:.2f} s; "
        f"launches {launched} [{card}]")
    if not snr >= ONNX_SNR_DB or any(launched.values()):
        fail(f"[onnx] SNR {snr} dB or launches {launched}")
    return {"onnx export": launched}


def _gui_call(base: str, path: str, body: bytes):
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), dict(r.headers)


def gui_convert(torch, card: str, root: Path) -> dict:
    """(b) the web GUI on 127.0.0.1:0: /api/load_model of a random
    configs/diffusion-fast.yaml checkpoint (the default factory builds the
    pipeline on the card), then /api/convert of a 5 s recording at 44.1 kHz
    and at 16 kHz: status, length, headers, exact launches, and the output
    against the engine driven directly on the same pipeline with the same
    request seeds (PCM16 both). Returns {path: launch counts}."""
    import io

    from scipy.io import wavfile

    from ddsp_svc_tpu_torch.gui import GuiApp, serve
    from ddsp_svc_tpu_torch.infer.realtime import drive_blocks
    from ddsp_svc_tpu_torch.ops.resample import resample

    from ddsp_svc_tpu_torch.utils.device import resolve_device

    ckpt, _ = random_checkpoint(torch, root, "diffusion-fast", "diffusion-fast.yaml")
    app = GuiApp()
    srv = serve(app, port=0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    wrappers = all_counts()
    launches = {}
    try:
        t0 = time.perf_counter()
        status, _, _ = _gui_call(base, "/api/load_model",
                                 json.dumps({"path": str(ckpt)}).encode())
        load_s = time.perf_counter() - t0
        pipe = app.pipeline
        if (status != 200 or pipe is None
                or pipe.device.type != resolve_device(None).type):
            fail(f"[gui] /api/load_model: status {status}, pipeline on "
                 f"{getattr(pipe, 'device', None)}")
        _gui_call(base, "/api/config", json.dumps(dict(RT, samplerate=SR)).encode())
        rng = np.random.default_rng(SEED + 250)
        for rate in GUI_RATES:
            wave = voice_wave(GUI_SECONDS, rng)
            if rate != SR:  # the same voice recorded at another rate
                wave = resample(torch.from_numpy(wave)[None], SR, rate)[0].numpy()
            buf = io.BytesIO()
            wavfile.write(buf, rate, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
            seeds = pipe._seeds.bit_generator.state
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            status, body, headers = _gui_call(base, "/api/convert", buf.getvalue())
            wall = time.perf_counter() - t0
            got_launches = {n: w.launches for n, w in wrappers.items()}
            out_sr, got = wavfile.read(io.BytesIO(body))
            # the reference: the same request's engine driven here
            pipe._seeds.bit_generator.state = seeds
            audio = (np.clip(wave, -1, 1) * 32767).astype(np.int16) / 32768.0
            with torch.no_grad():
                x = torch.as_tensor(audio.astype(np.float32), device=pipe.device)
                if rate != SR:
                    x = resample(x[None], rate, SR)[0]
                vc = app.make_engine()
                vc.warmup()
                want, stats = drive_blocks(vc, x.cpu().numpy())
            want = (np.clip(want, -1, 1) * 32767).astype(np.int16)
            n_out = int(math.ceil(SR * len(wave) / rate))
            calls = stats["blocks"] + 2  # the blocks and warmup's two variants
            expect = {n: c * calls for n, c in _with_zeros(EXPECT_DIFFUSION).items()}
            if (status != 200 or out_sr != SR or got.shape != (n_out,)
                    or float(headers.get("X-Rtf", 0)) <= 0
                    or float(headers.get("X-Block-Ms", 0)) <= 0):
                fail(f"[gui] /api/convert at {rate} Hz: status {status}, {out_sr} "
                     f"Hz, {got.shape} (want {n_out}), headers {headers}")
            if got_launches != expect:
                fail(f"[gui] /api/convert at {rate} Hz launched {got_launches}, "
                     f"expected {expect} ({calls} engine calls)")
            differ = int(np.count_nonzero(got != want))
            snr = snr_db(want.astype(np.float64), got.astype(np.float64)) \
                if differ else float("inf")
            what = f"gui convert {rate} Hz"
            launches[what] = got_launches
            log(f"[gui] (b) POST /api/convert, {GUI_SECONDS:g} s at {rate} Hz -> "
                f"{out_sr} Hz: {stats['blocks']} blocks of {RT['block_time']} s with "
                f"{RT['extra_time']} s of context (+ 2 warmup calls); X-Rtf "
                f"{headers['X-Rtf']}, X-Block-Ms {headers['X-Block-Ms']}, request "
                f"wall {wall:.2f} s; launches {calls} x {EXPECT_DIFFUSION} exactly; "
                f"against drive_blocks on the same pipeline and seeds: "
                f"{differ} of {got.size} PCM16 samples differ, SNR {snr:.1f} dB "
                f"(limit >= {GUI_SNR_DB:.0f} dB) [{card}]")
            if not snr >= GUI_SNR_DB:
                fail(f"[gui] {what}: SNR {snr:.2f} dB < {GUI_SNR_DB} dB")
        log(f"[gui] (b) /api/load_model built the pipeline on the card in "
            f"{load_s:.2f} s [{card}]")
    finally:
        srv.shutdown()
        srv.server_close()
    return launches


class _SamplerMeter:
    """Records every batch a sampler class hands out and the wall of each
    ``sample()`` call (the time the training loop waits for its batch)."""

    def __init__(self, cls):
        self.cls, self.original = cls, cls.sample
        self.batches, self.waits = [], []
        meter = self

        def sample(sampler):
            t0 = time.perf_counter()
            batch = meter.original(sampler)
            meter.waits.append(time.perf_counter() - t0)
            meter.batches.append({k: v.copy() for k, v in batch.items()})
            return batch

        cls.sample = sample

    def restore(self):
        self.cls.sample = self.original


def prefetched_training(torch, card: str, root: Path) -> dict:
    """(c) cli.train of configs/combsub.yaml's CombSubSuperFast on phase
    18's corpus with cache_all_data false, so the solver takes the C++
    prefetcher (as the JAX solver does: an uncached corpus without mels);
    then the same run with BatchSampler reading the files each step, and
    with the corpus cached, then prefetched again (the first run in the
    process pays its warmup, so the prefetcher runs first and last): every
    batch bit for bit the same, exactly K1 1 per step, and each run's batch
    wait and warm step wall. Returns {path: launch counts}."""
    import ddsp_svc_tpu_torch.data.prefetch as prefetch
    from ddsp_svc_tpu_torch.cli import train as cli_train
    from ddsp_svc_tpu_torch.data.dataset import BatchSampler
    from ddsp_svc_tpu_torch.train import solver
    from ddsp_svc_tpu_torch.utils.config import save_config

    runs, read, real = {}, {}, prefetch.PrefetchBatchSampler
    wrappers = all_counts()
    for i, (what, cached) in enumerate((
            ("prefetched", False), ("uncached BatchSampler", False),
            ("cached BatchSampler", True), ("prefetched again", False))):
        cfg, args = train_config(root, f"prefetch-{i}", PREFETCH_CONFIG)
        args["train"]["cache_all_data"] = cached
        save_config(cfg, args)
        cls = real if what.startswith("prefetched") else BatchSampler
        sampler = _SamplerMeter(cls)
        if what == "uncached BatchSampler":  # the solver's other arm, forced
            prefetch.PrefetchBatchSampler = BatchSampler
        meter, restore = metered(torch, solver, f"(c) CombSubSuperFast, {what}",
                                 expect_train(args))
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        try:
            cli_train.main(["-c", cfg, "--max_steps", str(PREFETCH_STEPS)])
        finally:
            restore()
            sampler.restore()
            prefetch.PrefetchBatchSampler = real
        read[what] = {n: w.launches for n, w in wrappers.items()}
        if len(sampler.batches) != PREFETCH_STEPS:
            fail(f"[prefetch] {what}: {len(sampler.batches)} batches from "
                 f"{cls.__name__}, expected {PREFETCH_STEPS}")
        runs[what] = (sampler, meter, time.perf_counter() - t0)
    ref = runs["prefetched"][0].batches
    for what in list(runs)[1:]:
        for i, (got, want) in enumerate(zip(ref, runs[what][0].batches)):
            bad = [k for k in want if not np.array_equal(got.get(k), want[k])]
            if bad or set(got) != set(want):
                fail(f"[prefetch] batch {i}: the prefetcher's {bad or set(got)} "
                     f"differ from the {what}'s")
    batch = ref[0]["units"].shape[0]
    for what, (sampler, meter, run_s) in runs.items():
        waits = sorted(sampler.waits[2:])
        steps = sorted(meter.walls[2:])
        log(f"[prefetch] (c) {what}: {PREFETCH_STEPS} CombSubSuperFast steps at "
            f"batch {batch} x {ref[0]['audio'].shape[1] / SR:g} s crops, warm "
            f"iteration wall (batch wait + synchronized step) median "
            f"{(waits[len(waits) // 2] + steps[len(steps) // 2]) * 1e3:.2f} ms: "
            f"batch wait median {waits[len(waits) // 2] * 1e3:.2f} ms (min "
            f"{waits[0] * 1e3:.2f}, max {waits[-1] * 1e3:.2f}), step median "
            f"{steps[len(steps) // 2] * 1e3:.2f} ms (min {steps[0] * 1e3:.2f}, max "
            f"{steps[-1] * 1e3:.2f}, n={len(steps)}); the run {run_s:.2f} s; "
            f"launches per step {({n: c for n, c in meter.expect.items() if c})} "
            f"exactly, over the run {({n: c for n, c in read[what].items() if c})} "
            f"[{card}]")
    log(f"[prefetch] (c) all {PREFETCH_STEPS} batches of the four runs bit for "
        f"bit equal (warm page cache: the corpus was just written and read) "
        f"[{card}]")
    return {f"train {what}": counts for what, counts in read.items()
            if what.startswith("prefetched")}


def phase_tools(torch, card: str, root: Path) -> dict:
    """Phase 25; ``root`` holds phase 18's corpus. Returns {path: launch
    counts}."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        launches = onnx_export_check(torch, card, Path(tmp))
        torch.cuda.empty_cache()
        launches.update(gui_convert(torch, card, Path(tmp)))
        torch.cuda.empty_cache()
    launches.update(prefetched_training(torch, card, root))
    log(f"[tools] phase 25 took {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------- phase 26

MESH = 2  # entries of the serving mesh on the one card
MESH_SECONDS = (2.0, 3.1, 4.2, 5.3, 6.4, 7.5, 8.6, 10.0)
SUPERVISED_RECYCLE = 3  # --worker_max_requests
SUPERVISED_POSTS = 8  # across two recycles
SUPERVISED_SECONDS = 2.0
SUPERVISOR_WALL = 300.0  # a worker's start, a POST, the end (s)
DEFAULT_TF32 = (False, True)  # (matmul, cuDNN) as a fresh process has them; main reads them


def _mesh_round(torch, pipe, waves, seeds, what: str, per_batch: int,
                wrappers) -> tuple:
    """One untimed round of the requests, then a timed one -> (rows, wall,
    launches, batches); launches exactly ``per_batch`` x (K1 1, K2 5, K3
    60) a batch."""
    def round_():
        return _concurrently([lambda w=w, s=s: pipe.infer(w, SR, seed=s, **DIFF_KW)[0]
                              for w, s in zip(waves, seeds)])

    round_()
    before = pipe.batcher.stats()["batches"]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = round_()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: w.launches for n, w in wrappers.items()}
    n_b = pipe.batcher.stats()["batches"] - before
    expect = {n: n_b * per_batch * c for n, c in _with_zeros(EXPECT_BATCH).items()}
    if got != expect:
        fail(f"[mesh] {what}: launches {got} over {n_b} batches, expected {expect}")
    for i, (wave, row) in enumerate(zip(waves, rows)):
        check_audio(row, len(wave) // BLOCK + 1, f"{what} row {i}")
    return rows, wall, got, n_b


def mesh_serving(torch, card: str, wav_pipe, root: Path) -> dict:
    """Phase 26 (a): BatchedSynth and BatchedEncoder sharded over a mesh of
    MESH entries of the one card against the single-device engines."""
    wrappers = all_counts()
    rng = np.random.default_rng(SEED + 26)
    waves = [voice_wave(s, rng) for s in MESH_SECONDS]
    seeds = [2600 + i for i in range(len(waves))]
    pipe = sibling(wav_pipe)
    mesh = [torch.device("cuda", 0)] * MESH
    out, launches = {}, {}
    try:
        for what, m, depth in (("one device", None, 1), ("mesh", mesh, 1),
                               ("mesh, pipeline_depth 2", mesh, 2)):
            pipe.enable_batching(buckets=BUCKETS, max_batch=BATCH,
                                 max_wait_ms=BATCH_WAIT_MS, mesh=m,
                                 pipeline_depth=depth, batch_encoder=True, **DIFF_KW)
            out[what] = _mesh_round(torch, pipe, waves, seeds, what,
                                    1 if m is None else MESH, wrappers)
            if m is not None and not (pipe.batcher.mesh == mesh
                                      and pipe.enc_batcher.mesh == mesh):
                fail(f"[mesh] {what}: the batchers hold no mesh of {MESH}")
            launches[f"mesh serving ({what})"] = out[what][2]
    finally:
        pipe.disable_batching()
    single = out["one device"][0]
    for what in ("mesh", "mesh, pipeline_depth 2"):
        rows, wall, got, n_b = out[what]
        snrs = [math.inf if np.array_equal(a, b) else snr_db(a, b)
                for a, b in zip(single, rows)]
        log(f"[mesh] (a) {len(waves)} concurrent requests of {MESH_SECONDS[0]:g}-"
            f"{MESH_SECONDS[-1]:g} s, BatchedSynth + BatchedEncoder on a mesh of "
            f"{MESH} x cuda:0 ({what}): {n_b} batches, launches {got} "
            f"({MESH} x {EXPECT_BATCH} a batch); rows against the single-device "
            f"engine with the same seeds: SNR min {min(snrs):.1f} dB, "
            f"{sum(s == math.inf for s in snrs)} of {len(snrs)} bit for bit "
            f"(limit >= {BATCH_ROW_SNR_DB:.0f} dB) [{card}]")
        if not min(snrs) >= BATCH_ROW_SNR_DB:
            fail(f"[mesh] {what}: a row {min(snrs):.1f} dB from the single-device "
                 f"engine (limit {BATCH_ROW_SNR_DB} dB)")
    log(f"[mesh] (a) wall of the timed round (after one untimed): one device "
        f"{out['one device'][1] * 1e3:.1f} ms, mesh {out['mesh'][1] * 1e3:.1f} ms, "
        f"mesh with pipeline_depth 2 {out['mesh, pipeline_depth 2'][1] * 1e3:.1f} "
        f"ms; one card either way, so no speed is claimed [{card}]")
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"[mesh] (a) --batch_devices 2 through cli.api: not measured, this "
            f"machine has {n_cards} card [{card}]")
        return launches
    # two cards: the server's own mesh, cuda:0 and cuda:1
    import threading

    from ddsp_svc_tpu_torch.cli import api

    ckpt, _ = random_checkpoint(torch, root, "mesh-server", "diffusion-fast.yaml")
    ready, holder = threading.Event(), {}
    th = threading.Thread(target=api.main, daemon=True, kwargs=dict(
        argv=["-m", str(ckpt), "-p", "0", "--host", "127.0.0.1", "--batch",
              str(BATCH), "--batch_devices", "2", "--batch_wait_ms",
              str(BATCH_WAIT_MS)],
        ready_cb=lambda srv: (holder.setdefault("srv", srv), ready.set())))
    th.start()
    if not ready.wait(SUPERVISOR_WALL):
        fail("[mesh] cli.api --batch_devices 2 did not start")
    srv = holder["srv"]
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        answers = _concurrently([lambda w=w: _post(base, w) for w in waves])
        wall = time.perf_counter() - t0
        for i, (w, (status, sr, data, _)) in enumerate(zip(waves, answers)):
            _check_wav(status, sr, data, len(w), f"--batch_devices 2 request {i}")
        got = {n: w.launches for n, w in wrappers.items()}
        log(f"[mesh] (a) cli.api --batch_devices 2 on cuda:0 and cuda:1: "
            f"{len(waves)} concurrent POSTs answered in {wall * 1e3:.1f} ms, "
            f"launches {got} [{card}]")
        launches["cli.api --batch_devices 2"] = got
    finally:
        srv.shutdown()
        th.join(60)
    return launches


def _gpu_query(query: str) -> list[list[str]]:
    """nvidia-smi's CSV rows for ``query`` (no header, no units)."""
    kind = "--query-compute-apps" if query.startswith("pid") else "--query-gpu"
    text = subprocess.run(["nvidia-smi", f"{kind}={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60).stdout
    return [[c.strip() for c in line.split(",")] for line in text.splitlines()
            if line.strip()]


def _memory_used_mib() -> float:
    return float(_gpu_query("memory.used")[0][0])


def _opens_the_card(pid: int) -> bool:
    """Whether process ``pid`` holds a file of the card's driver open (a
    CUDA context opens /dev/nvidia*)."""
    import os

    fd_dir = Path(f"/proc/{pid}/fd")
    for fd in fd_dir.iterdir() if fd_dir.exists() else ():
        try:
            if os.readlink(fd).startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def _alive(pid: int) -> bool:
    return Path(f"/proc/{pid}").exists()


def supervised_server(torch, card: str, root: Path) -> None:
    """Phase 26 (b): ``python -m ddsp_svc_tpu_torch.cli.api
    --worker_max_requests 3`` on a diffusion-fast checkpoint, 8 sequential
    POSTs across two recycles against phase 17's in-process server over
    the same checkpoint."""
    import os
    import threading

    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    ckpt, _ = random_checkpoint(torch, root, "supervised", "diffusion-fast.yaml")
    wave = voice_wave(SUPERVISED_SECONDS, np.random.default_rng(SEED + 261))
    # the in-process server over the same checkpoint: request j of a fresh
    # pipeline draws the j-th seed of cli.api's sequence, as a worker's j-th
    # does; TF32 as a cli.api process has it (PyTorch's defaults)
    ref_pipe = SvcPipeline(str(ckpt))
    srv, base = _serve_default(ref_pipe)
    ours = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = DEFAULT_TF32
    try:
        refs = []
        for _ in range(SUPERVISED_RECYCLE):
            status, sr, data, _ = _post(base, wave)
            _check_wav(status, sr, data, len(wave), "the in-process server")
            refs.append(data)
    finally:
        srv.shutdown()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = ours
    del ref_pipe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_base = _memory_used_mib()
    lines, lines_lock = [], threading.Lock()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddsp_svc_tpu_torch.cli.api", "-m", str(ckpt), "-p",
         "0", "--host", "127.0.0.1", "--worker_max_requests",
         str(SUPERVISED_RECYCLE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(Path(__file__).resolve().parent))

    def read():
        for line in proc.stdout:
            with lines_lock:
                lines.append((time.perf_counter(), line.rstrip()))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    samples, stop = [], threading.Event()

    def sample():  # the compute processes nvidia-smi lists, and the parent's fds
        while not stop.is_set():
            pids = {int(r[0]) for r in _gpu_query("pid,used_memory") if r[0].isdigit()}
            samples.append((pids, _opens_the_card(proc.pid)))
            stop.wait(0.5)

    def wait_line(pattern: str, after: int = 0):
        deadline = time.perf_counter() + SUPERVISOR_WALL
        while time.perf_counter() < deadline:
            with lines_lock:
                for t, line in lines[after:]:
                    found = re.search(pattern, line)
                    if found:
                        return found
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        with lines_lock:
            tail = "\n".join(line for _, line in lines[-20:])
        fail(f"[supervisor] no line matching {pattern!r} (rc {proc.poll()}):\n{tail}")

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    workers, walls, mem = [], [], {}
    try:
        first = wait_line(r"supervised API on :(\d+) \(worker pid (\d+),.*"
                          r"healthy after ([\d.]+) s")
        port, spawn = int(first.group(1)), [float(first.group(3))]
        workers.append(int(first.group(2)))
        base = f"http://127.0.0.1:{port}"
        for i in range(SUPERVISED_POSTS):
            t0 = time.perf_counter()
            status, sr, data, _ = _post(base, wave)
            walls.append(time.perf_counter() - t0)
            _check_wav(status, sr, data, len(wave), f"supervised POST {i}")
            snr = (math.inf if np.array_equal(data, refs[i % SUPERVISED_RECYCLE])
                   else snr_db(refs[i % SUPERVISED_RECYCLE], data))
            if not snr >= BATCH_ROW_SNR_DB:
                fail(f"[supervisor] POST {i} {snr:.1f} dB from the in-process "
                     f"server's request {i % SUPERVISED_RECYCLE} (limit "
                     f"{BATCH_ROW_SNR_DB} dB)")
            if i == 1:  # the first worker alone, two requests served
                mem["one worker"] = _memory_used_mib()
            if i % SUPERVISED_RECYCLE == SUPERVISED_RECYCLE - 1 and i + 1 < SUPERVISED_POSTS:
                gen = len(workers) + 1
                # the next POST waits for the swap, so each worker serves 3
                rec = wait_line(rf"recycled serving worker \(gen {gen}, pid (\d+), "
                                r"healthy after ([\d.]+) s")
                workers.append(int(rec.group(1)))
                spawn.append(float(rec.group(2)))
                old = workers[-2]
                deadline = time.perf_counter() + 60
                while _alive(old) and time.perf_counter() < deadline:
                    time.sleep(0.05)
                if _alive(old):
                    fail(f"[supervisor] the retired worker {old} still runs")
        mem["after two recycles"] = _memory_used_mib()
    finally:
        stop.set()
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(10)
        sampler.join(10)
        for pid in workers:
            if _alive(pid):
                os.kill(pid, 9)
    if any(_alive(pid) for pid in workers):
        fail("[supervisor] a worker outlived its supervisor")
    seen = set().union(*(p for p, _ in samples)) if samples else set()
    if proc.pid in seen or any(fds for _, fds in samples):
        fail(f"[supervisor] the supervisor (pid {proc.pid}) held the card: listed "
             f"{proc.pid in seen}, /dev/nvidia* open {any(f for _, f in samples)}")
    listed = sorted(seen & set(workers))
    rss = [float(m.group(1)) for m in (re.search(
        r"retiring serving worker gen \d+ \(pid \d+, \d+ connections, RSS ([\d.]+) MB",
        line) for _, line in lines) if m]
    one = mem["one worker"] - mem_base
    after = mem["after two recycles"] - mem_base
    steady = [w for i, w in enumerate(walls) if i % SUPERVISED_RECYCLE]
    handoff = [w for i, w in enumerate(walls) if i and i % SUPERVISED_RECYCLE == 0]
    log(f"[supervisor] (b) cli.api --worker_max_requests {SUPERVISED_RECYCLE}: "
        f"{SUPERVISED_POSTS} sequential POSTs of {SUPERVISED_SECONDS:g} s, all 200, "
        f"each >= {BATCH_ROW_SNR_DB:.0f} dB from the in-process server over the "
        f"same checkpoint (its request j for a worker's j-th); workers "
        f"{workers} (spawn to healthy {', '.join(f'{s:.2f}' for s in spawn)} s); "
        f"RSS before each recycle {', '.join(f'{r:.1f}' for r in rss)} MB; "
        f"nvidia-smi listed {listed} of the workers over {len(samples)} samples "
        f"and never the supervisor (pid {proc.pid}), which opened no /dev/nvidia* "
        f"[{card}]")
    log(f"[supervisor] (b) POST walls: first after each hand-off "
        f"{', '.join(f'{w * 1e3:.1f}' for w in handoff)} ms (max "
        f"{max(handoff) * 1e3:.1f}), steady median {_med(steady) * 1e3:.1f} ms; "
        f"memory.used above the base: one worker {one:.0f} MiB, after two "
        f"recycles {after:.0f} MiB (limit 1.5 x one worker); no speed is "
        f"claimed [{card}]")
    if len(workers) != 3 or len(rss) < 2:
        fail(f"[supervisor] workers {workers}, RSS lines {rss}: not two recycles")
    if not after <= 1.5 * one:
        fail(f"[supervisor] the retired workers' device memory was not returned: "
             f"{after:.0f} MiB against one worker's {one:.0f}")


def _serve_default(pipe):
    """Phase 17's in-process server over ``pipe`` with cli.api's defaults."""
    import threading

    from ddsp_svc_tpu_torch.cli.api import Server, make_handler

    srv = Server(("127.0.0.1", 0), make_handler(pipe, {}))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def nccl_world(torch, card: str) -> None:
    """Phase 26 (c): the backend chooser, and a 1-rank NCCL world's
    collectives on the card against a 1-rank gloo world's."""
    import tempfile

    import torch.distributed as dist

    from ddsp_svc_tpu_torch.parallel import mesh as m

    n_cards = torch.cuda.device_count()
    want2 = "nccl" if n_cards >= 2 else "gloo"
    if m.world_backend(1) != "nccl" or m.world_backend(2) != want2:
        fail(f"[nccl] world_backend: 1 rank {m.world_backend(1)}, 2 ranks "
             f"{m.world_backend(2)} on {n_cards} card(s)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 262)
    x = torch.randn((4, 862, 128), generator=gen, device=dev)
    z = torch.complex(torch.randn((2, 4096), generator=gen, device=dev),
                      torch.randn((2, 4096), generator=gen, device=dev))
    model = torch.nn.Sequential(torch.nn.Linear(128, 256), torch.nn.BatchNorm1d(256)).to(dev)
    answers = {}
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
            init = f"{tmp}/rendezvous"
            if backend == "nccl":
                group = m.init_rank(0, 1, init, None)  # the chooser's pick
            else:
                dist.init_process_group("gloo", init_method=f"file://{init}",
                                        rank=0, world_size=1)
                group = m.TimeGroup(0, 1, dev)
            try:
                if dist.get_backend() != backend or group.nccl != (backend == "nccl"):
                    fail(f"[nccl] a {backend} world reads {dist.get_backend()}")
                mesh = m.Mesh(1, 1, dev)
                rep = copy.deepcopy(model)
                m.replicate(mesh, rep)
                out = {"psum": group.psum(x), "all_gather": group.all_gather(x),
                       "psum_flat": torch.cat([t.reshape(-1) for t in
                                               group.psum_flat([x, 2 * x])]),
                       "broadcast": group.broadcast(x),
                       "broadcast_complex": group.broadcast(z),
                       "replicate": torch.cat([t.detach().reshape(-1).double() for t in
                                               list(rep.parameters()) + list(rep.buffers())])}
                if backend == "nccl":  # the collectives themselves on the card
                    total = x.clone()
                    dist.all_reduce(total)
                    gathered = torch.empty_like(x)
                    dist.all_gather_into_tensor(gathered, x)
                    if not (torch.equal(total, x) and torch.equal(gathered, x)):
                        fail("[nccl] a 1-rank all_reduce / all_gather changed x")
                torch.cuda.synchronize()
                answers[backend] = out
            finally:
                dist.destroy_process_group()
    for k, v in answers["nccl"].items():
        w = answers["gloo"][k]
        if v.device != dev or w.device != dev or not torch.equal(v, w):
            fail(f"[nccl] {k}: NCCL and gloo differ ({v.device}, {w.device})")
    log(f"[nccl] (c) world_backend: 1 rank on the card nccl, 2 ranks {want2} "
        f"({n_cards} card); a 1-rank NCCL world against a 1-rank gloo world on "
        f"cuda tensors, bit for bit: {', '.join(answers['nccl'])}; NCCL's own "
        f"all_reduce and all_gather_into_tensor on the card [{card}]")
    if n_cards < 2:
        log(f"[nccl] (c) a 2-rank DiffusionFast step on NCCL: not measured, this "
            f"machine has {n_cards} card (phase 23's 2 ranks share it on gloo) [{card}]")
    else:
        log(f"[nccl] (c) phase 23 (a)'s 2 ranks held a card each, so world_backend "
            f"put them on NCCL: their step walls and all-reduce share above are "
            f"NCCL's; gloo at a card a rank is not run [{card}]")


def phase_mesh_supervisor_nccl(torch, card: str, wav_pipe, root: Path) -> dict:
    """Phase 26; returns {path: launch counts}."""
    t0 = time.perf_counter()
    launches = mesh_serving(torch, card, wav_pipe, root)
    torch.cuda.empty_cache()
    supervised_server(torch, card, root)
    nccl_world(torch, card)
    log(f"[mesh] phase 26 took {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        import ddsp_svc_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    global DEFAULT_TF32
    DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, card = phase_device(torch)

    def mark(phases: str) -> None:
        log(f"[time] phases {phases} done at {time.perf_counter() - t_start:.1f} s "
            f"[{card}]")

    phase_build()
    results = phase_kernels(torch, card)
    mark("1-3")

    args, model, vocoder = build_parts(torch)
    diffusion_cpu = (args, copy.deepcopy(model), copy.deepcopy(vocoder))
    paths = {"diffusion-fast": phase_main_path(torch, args, model, vocoder, card)}
    del model, vocoder
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch, args, *diffusion_cpu[1:], card)
    mark("4-5")

    sins_parts = random_parts(torch, dict(SINS, type="Sins"), enhancer=True)
    args, model, vocoder = sins_parts
    paths["sins"] = phase_sins_path(torch, args, copy.deepcopy(model),
                                    copy.deepcopy(vocoder), card)
    torch.cuda.empty_cache()
    phase_ddsp_card_vs_cpu(torch, card, sins_parts)
    mark("6-7")

    wav_launches, pipes = phase_wav_paths(torch, card, diffusion_cpu, sins_parts)
    paths.update(wav_launches)
    phase_wav_card_vs_cpu(torch, card, pipes, {
        "diffusion-fast from a wav": diffusion_cpu, "sins from a wav": sins_parts})
    mark("8-9")
    paths.update(phase_cli(torch, card, pipes))
    paths.update(phase_samplers(torch, card, pipes["diffusion-fast from a wav"]))
    mark("10-11")

    phase_gradients(torch, card)
    mark("12")
    encoder = pipes["diffusion-fast from a wav"].units_encoder
    reflow_launches, reflow = phase_reflow(torch, card, encoder)
    paths.update(reflow_launches)
    mark("13")
    paths.update(phase_wavenet_families(torch, card, encoder, reflow["parts"]))
    mark("14")
    torch.cuda.empty_cache()
    paths.update(phase_realtime(
        torch, card,
        {"diffusion-fast": pipes["diffusion-fast from a wav"],
         "reflow": reflow["wav"], "sins": pipes["sins from a wav"]},
        {"diffusion-fast": diffusion_cpu, "reflow": reflow["parts"],
         "sins": sins_parts}))
    mark("15")
    torch.cuda.empty_cache()
    paths.update(phase_bf16_vocoder(torch, card, pipes))
    mark("16")
    paths.update(phase_batched_serving(torch, card,
                                       pipes["diffusion-fast from a wav"]))
    mark("17")
    diffusion_wav = pipes["diffusion-fast from a wav"]  # phase 26 serves it again
    del pipes, reflow, encoder
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        paths.update(phase_training(torch, card, root))
        mark("18")
        torch.cuda.empty_cache()
        paths.update(phase_bf16_training(torch, card, root))
        mark("19")
        torch.cuda.empty_cache()
        paths.update(phase_vocoder_training(torch, card, root))
        mark("20")
        torch.cuda.empty_cache()
        paths.update(phase_f0_front_end(torch, card, diffusion_cpu))
        mark("21")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as stmp:
            paths.update(phase_streaming(torch, card, Path(stmp)))
        mark("22")
        torch.cuda.empty_cache()
        paths.update(phase_multi_training(torch, card, root))
        mark("23")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as ctmp:
            paths.update(phase_convert_export(torch, card, Path(ctmp)))
        mark("24")
        torch.cuda.empty_cache()
        paths.update(phase_tools(torch, card, root))  # phase 18's corpus
        mark("25")
        torch.cuda.empty_cache()
        paths.update(phase_mesh_supervisor_nccl(torch, card, diffusion_wav, root))
        mark("26")

    table = []
    for kname in ("combtooth", "resblock_group", "resblock_group_bf16",
                  "conformer_layer", "conformer_layer_bf16",
                  "conformer_layer_bf16_io", "harmonic_bank"):
        r = results[kname]
        launches = sum(c.get(kname, 0) for c in paths.values())
        if launches <= 0:
            fail(f"kernel {kname} was not launched on a serving or training path")
        log(f"[done] {kname}: {launches} launches over the paths: "
            + ", ".join(f"{p} {c[kname]}" for p, c in paths.items()
                        if c.get(kname)))
        table.append({"name": kname, "route": r["route"], "source": r["source"],
                      "replaces": r["replaces"], "launches": launches,
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      "redesigned": REDESIGNED[kname]})
        if "bf16_amp" in r:  # K4's bf16-amplitude mode, on the same counter
            table[-1]["bf16_amp"] = r["bf16_amp"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"[{card}]")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # a rank of phase 23's worlds
        rank_main(sys.argv[2:])
    else:
        main()
