"""batch_occupancy (%): real rows per dispatched slot of the synthesis
batcher over the window (``BatchedSynth.stats``, reset when the window
opens). Moves audio_s_per_s: dummy rows are work the card does for no one."""


def read(run):
    occ = run.counters.get("mean_batch_occupancy")
    return None if occ is None else 100.0 * occ
