"""YAML config access (mirrors ddsp_svc_tpu/utils/config.py: DotDict,
load_config). ``yaml`` is imported only when a file is read."""
from __future__ import annotations

import os


class DotDict(dict):
    """dict with attribute access; nested dicts are wrapped lazily.
    Missing keys return None, which the config schema relies on (e.g. an
    optional ``model.use_pitch_aug``)."""

    def __getattr__(*args):
        val = dict.get(*args)
        return DotDict(val) if type(val) is dict else val

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def load_config(path_config: str | os.PathLike) -> DotDict:
    """Load a YAML config (the reference schema, configs/*.yaml)."""
    import yaml

    with open(path_config, "r") as f:
        return DotDict(yaml.safe_load(f))
