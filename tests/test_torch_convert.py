"""The port's converter of upstream checkpoints (``ddsp_svc_tpu_torch.
convert``) against the JAX package's (``ddsp_svc_tpu.convert``) on the same
synthetic upstream files, drawn from a seed at small widths by
``torch_convert_helpers`` and saved with ``torch.save`` in upstream's
wrappers.

For every converter and every model type the JAX converter takes:

  - the file the port's CLI writes decodes to the JAX converter's tree,
    leaf for leaf, bit for bit (both only move data, except the HuBERT
    positional conv's weight-norm fold and RMVPE's GRU bias sums, which
    the port computes in numpy in the JAX converter's own arithmetic, so
    those are bit for bit too), and the JAX package's own loader reads it;
  - the port's in-memory state dict equals ``io/jax_params``' reader
    applied to the JAX converter's tree, and loads strictly into the
    port's module;
  - a forward from converted weights on both sides, one family of each
    branch: CombSubSuperFast (the models; jitted JAX, 2e-3 of the peak as
    tests/test_torch_ddsp_models.py), HuBERT (1e-5, tests/test_torch_
    hubert.py), FCPE at hidden 64 (2e-6 on saliences, tests/test_torch_
    f0_nets.py).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_convert_helpers as up
from ddsp_svc_tpu.utils.config import load_config as jax_load_config
from ddsp_svc_tpu.utils.config import save_config
from ddsp_svc_tpu_torch.convert.__main__ import main
from ddsp_svc_tpu_torch.convert import hubert as phubert
from ddsp_svc_tpu_torch.convert.common import check_tree_shapes, load_state_dict
from ddsp_svc_tpu_torch.convert.flatdict import flatten, unflatten
from ddsp_svc_tpu_torch.io import jax_params as jp
from torch_helpers import rel_err

SR, BLOCK, WIN, N_UNIT = 16000, 64, 256, 16


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_same_tree(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        value, other = np.asarray(value), np.asarray(got[path])
        assert other.dtype == value.dtype and other.shape == value.shape, path
        np.testing.assert_array_equal(other, value, err_msg=path)


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k], err_msg=k)


MODEL_CONFIGS = {
    "Sins": dict(n_harmonics=8, n_mag_allpass=8, n_mag_noise=8),
    "CombSub": dict(n_mag_allpass=8, n_mag_harmonic=8, n_mag_noise=8),
    "CombSubFast": {},
    "CombSubSuperFast": dict(win_length=WIN),
    "Diffusion": dict(n_layers=2, n_chans=16, n_hidden=16, k_step_max=10,
                      use_pitch_aug=True),
    "DiffusionNew": dict(n_layers=2, n_chans=16, k_step_max=10, use_pitch_aug=True),
    "DiffusionFast": dict(win_length=WIN, n_layers=2, n_chans=16, k_step_max=10,
                          use_pitch_aug=True),
    "RectifiedFlow": dict(win_length=WIN, n_layers=2, n_chans=16, use_pitch_aug=True),
}


def _model_dir(tmp_path, mtype, n_spk=2):
    config = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                       "encoder_out_channels": N_UNIT, "duration": 2},
              "model": dict(type=mtype, n_spk=n_spk, **MODEL_CONFIGS[mtype])}
    save_config(tmp_path / "config.yaml", config)
    args = jax_load_config(str(tmp_path / "config.yaml"))
    sd = up.model_state_dict(args, seed=len(mtype))
    ckpt = tmp_path / "upstream" / "model_1200.pt"
    ckpt.parent.mkdir()
    up.save_upstream(ckpt, sd, "model")
    return args, ckpt


@pytest.mark.parametrize("mtype", sorted(MODEL_CONFIGS))
def test_model_matches_jax_converter(tmp_path, mtype):
    from ddsp_svc_tpu.convert.models import convert_reference_model as jax_convert
    from ddsp_svc_tpu.models.registry import load_model as jax_load_model
    from ddsp_svc_tpu_torch.convert.models import convert_reference_model
    from ddsp_svc_tpu_torch.models.registry import load_model

    args, ckpt = _model_dir(tmp_path, mtype)
    jax_out = jax_convert(str(ckpt), args, str(tmp_path / "jax" / "model_1200.pt"))
    jax_params, jax_buffers = jax_out if isinstance(jax_out, tuple) else (jax_out, None)
    assert main(["model", str(ckpt), str(tmp_path / "config.yaml"),
                 str(tmp_path / "port")]) == 0
    got = jp.read_msgpack(str(tmp_path / "port" / "model_1200.ckpt"))
    want = jp.read_msgpack(str(tmp_path / "jax" / "model_1200.ckpt"))
    assert_same_tree(got, want)
    assert check_tree_shapes(got["params"], want["params"]) == []
    assert sorted(flatten(got)) == sorted(flatten(unflatten(flatten(want))))
    assert got["global_step"] == 1200
    assert ("buffers" in got) == (mtype in ("Sins", "CombSub", "CombSubFast",
                                            "DiffusionNew"))
    # the in-memory state dict is the reader's view of JAX's tree
    state = convert_reference_model(str(ckpt), args)
    assert_same_state(state, jp.model_state_dict(args.model, jax_params, jax_buffers))
    # both packages load the port's file
    (tmp_path / "port" / "config.yaml").write_text(
        (tmp_path / "config.yaml").read_text())
    load_model(str(tmp_path / "port" / "model_1200.ckpt"), device="cpu")
    _, variables, _ = jax_load_model(str(tmp_path / "port" / "model_1200.ckpt"))
    assert_same_tree(variables["params"], jax_params)
    if jax_buffers is not None:
        assert_same_tree(variables["buffers"], jax_buffers)


def test_model_refusals(tmp_path):
    from ddsp_svc_tpu_torch.convert.models import convert_state_dict
    from ddsp_svc_tpu_torch.utils.config import DotDict

    with pytest.raises(NotImplementedError, match="Unknown"):
        convert_state_dict({}, DotDict({"type": "Unknown"}))
    args, ckpt = _model_dir(tmp_path, "CombSubSuperFast")
    sd = up.model_state_dict(args, seed=0)
    del sd["unit2ctrl.norm.bias"]
    up.save_upstream(ckpt, sd, None)
    with pytest.raises(KeyError, match="norm.bias"):
        main(["model", str(ckpt), str(tmp_path / "config.yaml"), str(tmp_path / "o")])
    assert main([]) == 1 and main(["-h"]) == 0 and main(["onnx"]) == 1


def test_combsub_superfast_forward_matches_jax(tmp_path):
    """The port's model from the port's file against JAX's model.apply on
    the JAX converter's tree, the noise injected (2e-3: XLA's jitted phase
    rounding through the combtooth's sinc, tests/test_torch_ddsp_models)."""
    from ddsp_svc_tpu.convert.models import convert_reference_model as jax_convert
    from ddsp_svc_tpu.models.ddsp import CombSubSuperFast as JModel
    from ddsp_svc_tpu_torch.models.registry import load_model

    args, ckpt = _model_dir(tmp_path, "CombSubSuperFast")
    jax_params = jax_convert(str(ckpt), args)
    main(["model", str(ckpt), str(tmp_path / "config.yaml"), str(tmp_path)])
    port, _ = load_model(str(tmp_path / "model_1200.ckpt"), device="cpu")
    rng = np.random.default_rng(5)
    t = 12
    units = rng.standard_normal((1, t, N_UNIT)).astype(np.float32)
    f0 = np.full((1, t, 1), 220.0, np.float32)
    vol = np.full((1, t, 1), 0.5, np.float32)
    noise = rng.standard_normal((1, t * BLOCK)).astype(np.float32)
    jm = JModel(SR, BLOCK, WIN, N_UNIT, 2)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a[:3],
                                          spk_id=jnp.ones((1, 1), jnp.int32),
                                          noise=a[3])[0])(jax_params, units, f0, vol, noise)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (units, f0, vol)),
                   spk_id=torch.ones((1, 1), dtype=torch.int64),
                   noise=torch.from_numpy(noise))[0]
    assert rel_err(got, want) <= 2e-3


NSF_CONFIG = dict(sampling_rate=16000, num_mels=8, n_fft=64, win_size=64,
                  hop_size=16, fmin=40, fmax=8000, upsample_rates=[2, 2],
                  upsample_kernel_sizes=[4, 4], upsample_initial_channel=16,
                  resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
                  discriminator_periods=[2, 3])


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_nsf_hifigan_matches_jax_converter(tmp_path, resblock):
    from ddsp_svc_tpu.convert.nsf_hifigan import convert_nsf_hifigan as jax_convert
    from ddsp_svc_tpu.models.vocoder import load_vocoder_params
    from ddsp_svc_tpu_torch.convert.nsf_hifigan import convert_nsf_hifigan
    from ddsp_svc_tpu_torch.models.registry import load_vocoder

    config = dict(NSF_CONFIG, resblock=resblock)
    (tmp_path / "config.json").write_text(json.dumps(config))
    up.save_upstream(tmp_path / "model", up.nsf_hifigan_state_dict(config, seed=3),
                     "generator")
    jax_convert(str(tmp_path / "model"), str(tmp_path / "jax.msgpack"))
    assert main(["nsf-hifigan", str(tmp_path / "model")]) == 0
    got = jp.read_msgpack(str(tmp_path / "model.msgpack"))
    want = jp.read_msgpack(str(tmp_path / "jax.msgpack"))
    assert_same_tree(got, want)
    assert "discriminator_periods" not in got["config"]
    state = convert_nsf_hifigan(str(tmp_path / "model"), str(tmp_path / "again.msgpack"))
    assert_same_state(state, jp.generator_state_dict(want["params"], 2, 2, 2, resblock))
    vocoder = load_vocoder(str(tmp_path / "model"), device="cpu")
    assert vocoder.model.resblock == resblock
    params, jax_config = load_vocoder_params(str(tmp_path / "model"))
    assert_same_tree(params, want["params"])
    assert jax_config["upsample_rates"] == [2, 2]


HUBERT_CASES = {
    # layout, options of the upstream file
    "bshall": ("bshall", {}),
    "fairseq": ("fairseq", {}),
    "hf": ("hf", {}),
    "hf-parametrized": ("hf", {"parametrized": True}),
}


@pytest.mark.parametrize("case", sorted(HUBERT_CASES))
def test_hubert_matches_jax_converter(tmp_path, case):
    from ddsp_svc_tpu.convert.hubert import convert_hubert as jax_convert
    from ddsp_svc_tpu_torch.features.hubert import ENCODER_CONFIGS, UnitsEncoder

    layout, options = HUBERT_CASES[case]
    cfg = ENCODER_CONFIGS["tiny"]
    sd = up.hubert_state_dict(layout, cfg.dim, cfg.ffn_dim, cfg.num_layers, seed=7,
                              proj_dim=cfg.proj_dim, **options)
    up.save_upstream(tmp_path / "hubert.pt", sd, None)
    jax_convert(str(tmp_path / "hubert.pt"), "tiny", str(tmp_path / "jax.msgpack"))
    assert main(["hubert", str(tmp_path / "hubert.pt"), "tiny",
                 str(tmp_path / "port.msgpack")]) == 0
    want = jp.read_msgpack(str(tmp_path / "jax.msgpack"))
    assert_same_tree(jp.read_msgpack(str(tmp_path / "port.msgpack")), want)
    state = phubert.convert_hubert(str(tmp_path / "hubert.pt"), "tiny",
                                   str(tmp_path / "again.msgpack"))
    assert_same_state(state, jp.hubert_state_dict(want["params"], cfg))
    UnitsEncoder("tiny", params=want, device="cpu")  # loads strictly


def test_hubert_layer_norm_extractor_keeps_the_final_norm(tmp_path):
    """fairseq's 'layer_norm' extractor on a pre-LN encoder with an early
    exit (HuBERT-Large's shape, narrow): the JAX converter writes the
    encoder's final LayerNorm, which the model does not run; so does the
    port, and its reader drops it."""
    from ddsp_svc_tpu.convert.hubert import convert_hubert_state_dict as jax_convert
    from ddsp_svc_tpu.features.hubert import HubertConfig as JConfig
    from ddsp_svc_tpu_torch.features.hubert import HubertConfig, HubertModel

    shape = dict(dim=64, heads=2, ffn_dim=128, num_layers=2, output_layer=2,
                 pre_norm=True, extractor_layer_norm=True, pad_center=False)
    sd = up.hubert_state_dict("fairseq", 64, 128, 2, seed=8, ln_mode=True)
    want = jax_convert(sd, JConfig(**shape))
    cfg = HubertConfig(**shape)
    state, kept = phubert.convert_state_dict(sd, cfg)
    assert_same_tree(phubert.hubert_tree(state, kept, cfg), want)
    assert "norm" in want["params"] and "norm.weight" not in state
    assert_same_state(state, jp.hubert_state_dict(want["params"], cfg))
    jp.load_state(HubertModel(cfg), state)


def test_hubert_forward_matches_jax(tmp_path):
    """The fairseq layout converted on both sides: the port's encoder
    against JAX's HubertModel.apply within 1e-5 of the peak."""
    from ddsp_svc_tpu.convert.hubert import convert_hubert_state_dict as jax_convert
    from ddsp_svc_tpu.features.hubert import ENCODER_CONFIGS as JCONFIGS
    from ddsp_svc_tpu.features.hubert import HubertModel as JModel
    from ddsp_svc_tpu_torch.features.hubert import ENCODER_CONFIGS, HubertModel

    cfg = ENCODER_CONFIGS["tiny"]
    sd = up.hubert_state_dict("fairseq", cfg.dim, cfg.ffn_dim, cfg.num_layers,
                              seed=9, proj_dim=cfg.proj_dim)
    state, _ = phubert.convert_state_dict(sd, cfg)
    port = jp.load_state(HubertModel(cfg).eval(), state)
    audio = (0.3 * np.random.default_rng(2).standard_normal((1, 4000))).astype(np.float32)
    want = jax.jit(JModel(JCONFIGS["tiny"]).apply)(jax_convert(sd, JCONFIGS["tiny"]),
                                                    jnp.asarray(audio))
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


F0_CASES = {
    "rmvpe": (lambda: up.rmvpe_state_dict(seed=11), {}),
    "crepe": (lambda: up.crepe_state_dict(seed=12), {}),
    "fcpe": (lambda: up.fcpe_state_dict(seed=13, n_layers=2, hidden=64),
             dict(n_layers=2)),
}


@pytest.mark.parametrize("kind", sorted(F0_CASES))
def test_f0_net_matches_jax_converter(tmp_path, kind):
    import importlib

    jax_module = importlib.import_module(f"ddsp_svc_tpu.convert.{kind}")
    port_module = importlib.import_module(f"ddsp_svc_tpu_torch.convert.{kind}")
    draw, cfg = F0_CASES[kind]
    up.save_upstream(tmp_path / f"{kind}.pt", draw(), "model")
    getattr(jax_module, f"convert_{kind}")(str(tmp_path / f"{kind}.pt"),
                                           str(tmp_path / "jax.msgpack"))
    assert main([kind, str(tmp_path / f"{kind}.pt")]) == 0
    want = jp.read_msgpack(str(tmp_path / "jax.msgpack"))
    assert_same_tree(jp.read_msgpack(str(tmp_path / f"{kind}.msgpack")), want)
    state = port_module.convert_state_dict(load_state_dict(str(tmp_path / f"{kind}.pt")))
    assert_same_state(state, jp.f0_net_state_dict(kind, want, **cfg))


def test_fcpe_forward_matches_jax(tmp_path):
    """FCPE at hidden 64, two layers, converted on both sides: the
    saliences within 2e-6 (tests/test_torch_f0_nets.py's bound)."""
    from ddsp_svc_tpu.convert.fcpe import convert_fcpe_state_dict as jax_convert
    from ddsp_svc_tpu.features.fcpe import CFNaiveMelPE as JNet
    from ddsp_svc_tpu_torch.convert.fcpe import convert_state_dict
    from ddsp_svc_tpu_torch.features.fcpe import CFNaiveMelPE

    sd = up.fcpe_state_dict(seed=14, n_layers=2, hidden=64)
    port = jp.load_state(CFNaiveMelPE(hidden=64, n_layers=2).eval(),
                         convert_state_dict(sd))
    mel = np.random.default_rng(3).standard_normal((1, 20, 128)).astype(np.float32)
    want = jax.jit(JNet(hidden=64, n_layers=2).apply)(jax_convert(sd), jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() <= 2e-6
