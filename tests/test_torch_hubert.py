"""The port's HuBERT / ContentVec encoder (features/hubert.py) against the
JAX package's on the same randomised params, carried across by
io/jax_params ``hubert_state_dict``, and the same inputs made with numpy.

Tolerance: 1e-5 x max|out| in f32 for every piece and for the whole model
(flax's one-pass LayerNorm variance and the sum orders of the convs and
GEMMs put the two ~1e-6 apart). The units encoder's nearest-index
alignment is held exactly."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddsp_svc_tpu.convert.flatdict import flatten
from ddsp_svc_tpu.features import hubert as jh
from ddsp_svc_tpu.utils.params import load_params as j_load_params
from ddsp_svc_tpu_torch.features import hubert as ph
from ddsp_svc_tpu_torch.io.jax_params import (hubert_state_dict, load_params,
                                              load_state)
from torch_helpers import randomize_tree, rel_err, tt

TOL = 1e-5
TINY = jh.ENCODER_CONFIGS["tiny"]
CONFIGS = {
    "tiny": TINY,  # post-LN, GroupNorm extractor, centre pad, projection
    # pre-LN layers, LayerNorm extractor, waveform normalisation, top-k gate
    "prenorm": replace(TINY, pre_norm=True, extractor_layer_norm=True,
                       pad_center=False, input_normalize=True, topk_gate=5),
    # pre-LN with an early exit: no final norm
    "prenorm_exit": replace(TINY, pre_norm=True, extractor_layer_norm=True,
                            pad_center=False, num_layers=3, output_layer=2),
}


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 210 * t) + 0.05 * rng.standard_normal(n)
            ).astype(np.float32)[None]


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(JAX config, JAX params, port model with the same weights)."""
    cfg = CONFIGS[request.param]
    shapes = jax.eval_shape(lambda: jh.HubertModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1600))))
    params = randomize_tree(shapes["params"], seed=5)
    pcfg = ph.HubertConfig(**cfg.__dict__)
    model = ph.HubertModel(pcfg)
    load_state(model, hubert_state_dict(params, pcfg))
    return cfg, params, model.eval()


def test_state_dict_maps_every_leaf(pair):
    cfg, params, model = pair
    n_leaves = len(jax.tree_util.tree_leaves(params))
    state = hubert_state_dict(params, model.config)
    assert len(state) == n_leaves == len(model.state_dict())
    extra = dict(params, extra={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="left unmapped"):
        hubert_state_dict(extra, model.config)
    missing = {k: v for k, v in params.items() if k != "fp_proj"}
    with pytest.raises(KeyError, match="missing"):
        hubert_state_dict(missing, model.config)


def test_whole_model_matches(pair):
    cfg, params, model = pair
    a = _audio(3200)
    want = jax.jit(lambda p, x: jh.HubertModel(cfg).apply({"params": p}, x))(
        params, jnp.asarray(a))
    with torch.no_grad():
        got = model(tt(a))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    if cfg.topk_gate:
        assert (got > 0).sum(-1).max() <= cfg.topk_gate
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_feature_extractor_matches(pair):
    cfg, params, model = pair
    a = _audio(4000, seed=1)
    fe = jh.FeatureExtractor(layer_norm_mode=cfg.extractor_layer_norm)
    want = fe.apply({"params": params["feature_extractor"]}, jnp.asarray(a))
    with torch.no_grad():
        got = model.feature_extractor(tt(a))
    assert got.shape == want.shape == (1, jh.conv_out_frames(4000), 512)
    assert ph.conv_out_frames(4000) == jh.conv_out_frames(4000)
    assert rel_err(got, want) <= TOL


def test_positional_conv_and_layers_match(pair):
    cfg, params, model = pair
    x = np.random.default_rng(2).standard_normal((2, 37, cfg.dim)).astype(np.float32)
    want = jh.PositionalConvEmbedding(cfg.dim).apply(
        {"params": params["pos_conv"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.pos_conv(tt(x))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    for i in range(cfg.output_layer or cfg.num_layers):
        layer = jh.TransformerLayer(cfg.dim, cfg.heads, cfg.ffn_dim, cfg.pre_norm)
        want = layer.apply({"params": params[f"layer{i}"]}, jnp.asarray(x))
        with torch.no_grad():
            got = model.layers[i](tt(x))
        assert rel_err(got, want) <= TOL, i


@pytest.mark.parametrize("sample_rate,n", [(44100, 22050), (44100, 300),
                                           (16000, 5000)])
def test_units_encoder_matches(sample_rate, n):
    """Resampling to 16 kHz (44.1 kHz input), the >= 400-sample pad (a
    300-sample input) and the nearest-index alignment onto the hop grid,
    through params loaded from the JAX encoder's own variables."""
    jenc = jh.UnitsEncoder("tiny")
    variables = {"params": randomize_tree(jenc.variables["params"], seed=7)}
    jenc = jh.UnitsEncoder("tiny", params=variables)
    penc = ph.UnitsEncoder("tiny", params=variables, device="cpu")
    hop = 512 * sample_rate // 44100
    rng = np.random.default_rng(3)
    a = (0.2 * rng.standard_normal((1, n))).astype(np.float32)
    want = np.asarray(jenc.encode(jnp.asarray(a), sample_rate, hop))
    got = penc.encode(a, sample_rate, hop)
    assert got.shape == want.shape == (1, n // hop + 1, 256)
    assert rel_err(got, want) <= TOL
    # the alignment: each synth frame takes the same encoder frame, so the
    # frames that repeat are the same on both sides
    same_j = np.all(want[0, 1:] == want[0, :-1], axis=-1)
    same_p = np.all(got[0, 1:].numpy() == got[0, :-1].numpy(), axis=-1)
    np.testing.assert_array_equal(same_p, same_j)


def test_random_init_is_seeded():
    a = _audio(1600)
    enc = [ph.UnitsEncoder("tiny", device="cpu", seed=s) for s in (3, 3, 4)]
    out = [e.encode(a, 16000, 320) for e in enc]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])


@pytest.mark.parametrize("fmt", ["npz", "msgpack"])
def test_load_params_reads_both_formats(tmp_path, fmt):
    """The port reads a converted encoder file as utils/params.load_params
    does: .npz through its copy of ``unflatten``, .msgpack through its own
    reader."""
    from flax import serialization

    variables = {"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=8)}
    path = tmp_path / f"enc.{fmt}"
    if fmt == "npz":
        np.savez(path, **flatten(variables))
    else:
        path.write_bytes(serialization.msgpack_serialize(
            jax.tree_util.tree_map(np.asarray, variables)))
    got, want = load_params(str(path)), j_load_params(str(path))
    flat_got, flat_want = flatten(got), flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    assert load_params(str(tmp_path / "absent.npz")) is None


def test_encoder_configs_match():
    assert ph.ENCODER_CONFIGS.keys() == jh.ENCODER_CONFIGS.keys()
    for name, cfg in jh.ENCODER_CONFIGS.items():
        assert ph.ENCODER_CONFIGS[name].__dict__ == cfg.__dict__, name
