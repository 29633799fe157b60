"""k2_roofline (%): the least time the NSF-HiFiGAN ResBlock groups' work
needs at the card's peaks, over the device time the profiler gives that
layer (the kernels launched inside the benchmark's ``layer.resblocks``
spans, whatever their names). The work is what the completed requests need:
2 L C^2 126 FLOPs a stage on their real frames at the split-TF32 rate
(494.7 / 3 TFLOP/s), against each stage's input and output once and every
stage's weights once per vocoder call, at 3.35 TB/s. Moves audio_s_per_s."""
from svc_bench import work


def read(run):
    t = run.trace
    dev_s = (t or {}).get("layer_s", {}).get("layer.resblocks", 0.0)
    done = run.completed
    if not dev_s or not done:
        return None
    voc, block = run.cfg["vocoder"], run.cfg["data"]["block_size"]
    frames = [work.frames(len(d.request.audio), block) for d in done]
    flops = sum(work.resblock_flops(voc, f) for f in frames)
    n_bytes = (sum(work.resblock_bytes(voc, f) for f in frames)
               + t["calls"].get("layer.vocoder", 0) * work.resblock_weight_bytes(voc))
    return 100.0 * work.least_seconds(flops, n_bytes, work.PEAK_F32_TC_FLOP_PER_S) / dev_s
