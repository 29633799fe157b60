"""device_idle_pct (%): the share of the traced window in which no kernel,
copy or fill ran on the card (the union of the profiler's device intervals,
the spin lead left out). Moves audio_s_per_s: an idle card serves nothing."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
