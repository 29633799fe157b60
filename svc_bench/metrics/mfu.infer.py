"""mfu.infer (%): the model FLOPs of every request the window completed,
counted from its real frames at the configuration's widths
(``svc_bench.work.request_flops``: encoder, device YIN, DDSP stage, mel,
every sampler call of the denoiser, vocoder), over the window's seconds
times the card's float32 tensor-core peak (split TF32, 494.7 / 3 TFLOP/s
at 700 W). Moves audio_s_per_s: the whole step's share of the peak, which
bounds what any kernel's gain can bring."""
from svc_bench import work


def read(run):
    done = run.completed
    if not done or run.window_s <= 0:
        return None
    flops = sum(sum(work.request_flops(run.cfg, run.mix["serve"], len(d.request.audio)).values())
                for d in done)
    return 100.0 * flops / (run.window_s * work.PEAK_F32_TC_FLOP_PER_S)
