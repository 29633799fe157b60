"""Shared builders for the training parity tests (``test_torch_train_*.py``):
one small config per model family, the JAX model and the port's built from
it by each package's registry, JAX variables drawn from numpy (buffers
included), the port loaded with them, and a numpy batch."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.registry import build_model as jax_build_model
from ddsp_svc_tpu_torch.io.jax_params import load_state, model_state_dict
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_helpers import randomize_tree

SR, BLOCK, N_UNIT, T = 44100, 512, 32, 16
MODEL = {
    "Sins": dict(n_harmonics=16, n_mag_allpass=16, n_mag_noise=16),
    "CombSub": dict(n_mag_allpass=16, n_mag_harmonic=16, n_mag_noise=16),
    "CombSubFast": {},
    "CombSubSuperFast": dict(win_length=1024),
    "DiffusionFast": dict(win_length=1024, n_layers=2, n_chans=32,
                          k_step_max=100, use_pitch_aug=True),
    "RectifiedFlow": dict(win_length=1024, n_layers=2, n_chans=32,
                          t_start=0.2, use_pitch_aug=True),
    "Diffusion": dict(n_layers=2, n_chans=16, n_hidden=32, k_step_max=100,
                      use_pitch_aug=True),
    "DiffusionNew": dict(n_layers=2, n_chans=16, k_step_max=100),
}


def tiny_config(mtype: str, **train) -> DotDict:
    return DotDict({
        "data": {"sampling_rate": SR, "block_size": BLOCK, "duration": 0.5,
                 "encoder_out_channels": N_UNIT, "encoder": "contentvec768l12",
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "f0_extractor": "yin", "f0_min": 65, "f0_max": 800,
                 "extensions": ["wav"]},
        "model": dict(type=mtype, n_spk=1, **MODEL[mtype]),
        "train": dict({"lr": 1e-3, "lambda_ddsp": 1.0, "seed": 0}, **train),
        "infer": {"speedup": 10, "method": "dpm-solver", "infer_step": 2},
        "env": {"expdir": "exp"}})


def jax_mel_fn():
    from ddsp_svc_tpu.cli.common import build_mel_extractor

    return build_mel_extractor(tiny_config("DiffusionFast")).extract


def port_mel_fn():
    from ddsp_svc_tpu_torch.cli.common import build_mel_extractor

    return build_mel_extractor(tiny_config("DiffusionFast")).extract


def batch(mtype: str, b: int = 2, t: int = T, seed: int = 0,
          n_unit: int = N_UNIT) -> dict:
    rng = np.random.default_rng(seed)
    out = {"units": rng.standard_normal((b, t, n_unit)).astype(np.float32),
           "f0": (200.0 + 60.0 * rng.random((b, 1, 1))
                  * np.linspace(0.8, 1.2, t)[None, :, None]).astype(np.float32),
           "volume": rng.uniform(0.05, 0.4, (b, t, 1)).astype(np.float32),
           "audio": (0.3 * rng.standard_normal((b, t * BLOCK))).astype(np.float32)}
    if mtype not in ("Sins", "CombSub", "CombSubFast", "CombSubSuperFast"):
        out["mel"] = (rng.standard_normal((b, t, 128)) - 5.0).astype(np.float32)
        out["aug_shift"] = rng.uniform(-3, 3, (b, 1, 1)).astype(np.float32)
    return out


def jax_variables(args, jmodel, seed: int = 1, shapes_only: bool = False) -> dict:
    """Variables of the JAX model for ``args``: params re-drawn from numpy,
    buffers (PCmer's FAVOR+ projections) as flax draws them -- or, with
    ``shapes_only``, from the init's shapes alone (no forward runs), each
    projection drawn by the JAX package's own
    ``gaussian_orthogonal_random_matrix`` from a key of its own."""
    mtype = args.model.type
    x = batch(mtype, b=1, n_unit=args.data.encoder_out_channels)
    kwargs = {}
    if "mel" in x:
        kwargs = dict(gt_spec=x["mel"], infer=False, key=jax.random.PRNGKey(2))
        if mtype != "Diffusion":
            kwargs["mel_extract_fn"] = jax_mel_fn()
        if mtype in ("DiffusionFast", "DiffusionNew", "Diffusion"):
            kwargs["k_step"] = 100
        if args.model.use_pitch_aug:
            kwargs["aug_shift"] = x["aug_shift"]

    def init():
        return jmodel.init({"params": jax.random.PRNGKey(0),
                            "noise": jax.random.PRNGKey(1)},
                           x["units"], x["f0"], x["volume"], **kwargs)
    variables = jax.eval_shape(init)
    if not shapes_only and "buffers" in variables:
        # flax's own projection draws: the model's init runs (eagerly);
        # without buffers every leaf is re-drawn from numpy below, so the
        # shapes alone give the same variables
        variables = init()
    out = {"params": randomize_tree(variables["params"], seed)}
    if "buffers" in variables:
        from ddsp_svc_tpu.models.pcmer import gaussian_orthogonal_random_matrix

        keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1000), 64))
        out["buffers"] = jax.tree_util.tree_map(
            (lambda a: np.asarray(gaussian_orthogonal_random_matrix(
                next(keys), *a.shape))) if shapes_only else np.asarray,
            variables["buffers"])
    return out


def pair(mtype: str, seed: int = 1):
    """(args, JAX model, JAX variables, the port model loaded with them);
    the variables from the init's shapes (an eager init of a model with
    buffers costs ~20 s of op-by-op compiles)."""
    args = tiny_config(mtype)
    jmodel = jax_build_model(args)
    variables = jax_variables(args, jmodel, seed, shapes_only=True)
    port = build_model(args)
    load_state(port, model_state_dict(args.model, variables["params"],
                                      variables.get("buffers")))
    return args, jmodel, variables, port


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def leaves(tree, prefix=""):
    """A nested dict -> {'a/b': numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)
