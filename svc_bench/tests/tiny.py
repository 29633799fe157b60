"""A cell at a size a CPU test can run: the real cells' structure and
mix, with the units encoder, the denoiser and the vocoder cut to toy widths
and the requests to short ones."""
from __future__ import annotations

import copy

from svc_bench import registry


CELLS = {"diffusion-fast": "dfast.serve.r60", "reflow": "reflow.serve.r60"}


def tiny_cell(config: str = "diffusion-fast", door: int = 64) -> dict:
    """The cell's own mix at a CPU's rate, through a door of ``door``
    requests in flight (64 never fills there; 2 stays full)."""
    cell = CELLS[config]
    out = registry.cell(registry.benchmark(), cell)
    cfg = copy.deepcopy(out["config"])
    cfg["encoder"] = {"name": "tiny", "dim": 64, "heads": 2, "ffn_dim": 128,
                      "layers": 2, "proj_dim": 256, "pad_center": True,
                      "sample_rate": 16000, "hop_size": 320}
    cfg["data"]["encoder_out_channels"] = 256
    cfg["model"]["n_chans"] = 32
    cfg["model"]["n_layers"] = 2
    cfg["vocoder"]["upsample_initial_channel"] = 64
    if config == "reflow":
        cfg["model"] = {"type": "RectifiedFlow", "win_length": 2048, "n_layers": 2,
                        "n_chans": 32, "use_pitch_aug": True, "n_spk": 1, "t_start": 0.7}
        cfg["infer"] = {"infer_step": 4, "method": "euler"}
    mix = copy.deepcopy(out["mix"])
    mix.update(pool=6, warm_s=0.0, length_s={"log_uniform": [0.4, 1.4]}, rate_rps=4.0,
               door=door)
    mix["serve"].update(buckets=[64, 128], max_batch=4, max_wait_ms=20.0)
    mix["check"] = {"requests": 1000}  # every answer
    out.update(config=cfg, mix=mix)
    return out
