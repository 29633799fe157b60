"""k3_roofline (%): the least time the denoiser's conformer layers' work
needs at the card's peaks, over the device time the profiler gives that
layer (the kernels launched inside the benchmark's ``layer.conformer``
spans, whatever their names). The work is what the completed requests
need: every layer at every sampler call on their real frames (the
condition projection, the GLU conv, the depthwise conv, the output conv)
at the split-TF32 rate (494.7 / 3 TFLOP/s), against x, cond and the output
once a layer call and the layer's weights once per launch, at 3.35 TB/s.
Moves audio_s_per_s."""
from svc_bench import work


def read(run):
    t = run.trace
    dev_s = (t or {}).get("layer_s", {}).get("layer.conformer", 0.0)
    done = run.completed
    if not dev_s or not done:
        return None
    m, mels = run.cfg["model"], run.cfg["vocoder"]["num_mels"]
    dim, block = m["n_chans"], run.cfg["data"]["block_size"]
    layer_calls = work.sampler_calls(run.cfg) * m["n_layers"]
    frames = [work.frames(len(d.request.audio), block) for d in done]
    flops = layer_calls * sum(work.conformer_layer_flops(dim, mels, f) for f in frames)
    n_bytes = (layer_calls * sum(work.conformer_layer_bytes(dim, mels, f) for f in frames)
               + t["calls"].get("layer.conformer", 0) * work.conformer_weight_bytes(dim, mels))
    return 100.0 * work.least_seconds(flops, n_bytes, work.PEAK_F32_TC_FLOP_PER_S) / dev_s
