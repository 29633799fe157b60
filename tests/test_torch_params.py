"""JAX params -> the port's state dicts (io/jax_params.py): every leaf maps
and every port parameter is set, the weight-norm folds equal the JAX
modules' folds (per output channel for Conv1d/Dense, per input channel
for ConvTranspose1d), and a checkpoint written by the JAX trainer's
``save_checkpoint`` loads through the port's own msgpack reader -- for the
DDSP family with its ``buffers`` tree (the FAVOR+ projections) too."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from ddsp_svc_tpu.models import nn as jnn
from ddsp_svc_tpu.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline
from ddsp_svc_tpu_torch.io import jax_params
from ddsp_svc_tpu_torch.models import nn as tnn
from ddsp_svc_tpu_torch.models.cascade import Unit2WavFast
from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
from test_torch_ddsp_models import WIDTHS, build_ddsp, inputs
from test_torch_models import N_LAYERS, _cascade_kwargs, build_cascade
from torch_helpers import randomize_tree, tt


@pytest.fixture(scope="module")
def cascade():
    return build_cascade()


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_every_cascade_param_maps(cascade):
    _, params, port, _ = cascade
    sd = jax_params.unit2wav_fast_state_dict(params, N_LAYERS)
    assert set(sd) == set(port.state_dict())
    n_jax = sum(v.size for v in _leaves(params).values())
    n_port = sum(p.numel() for p in port.parameters())
    # weight-norm gains fold away: the port holds no more numbers than JAX
    assert 0 < n_port <= n_jax


def test_leftover_or_missing_leaves_raise(cascade):
    _, params, _, _ = cascade
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray/kernel"):
        jax_params.unit2wav_fast_state_dict(extra, N_LAYERS)
    missing = {k: v for k, v in params.items() if k != "denoise_fn"}
    with pytest.raises(KeyError, match="denoise_fn"):
        jax_params.unit2wav_fast_state_dict(missing, N_LAYERS)
    port = Unit2WavFast(**_cascade_kwargs())
    sd = jax_params.unit2wav_fast_state_dict(params, N_LAYERS)
    sd.pop("denoise_fn.output_projection.bias")
    with pytest.raises(KeyError, match="output_projection.bias"):
        jax_params.load_state(port, sd)


def test_aug_shift_embed_maps_when_present(cascade):
    _, params, _, _ = cascade
    sd = jax_params.unit2wav_fast_state_dict(params, N_LAYERS)
    assert "ddsp_model.unit2ctrl.aug_shift_embed.weight" in sd
    u2c = dict(params["ddsp_model"]["unit2ctrl"])
    del u2c["aug_shift_embed"]
    without = dict(params, ddsp_model={"unit2ctrl": u2c})
    port = Unit2WavFast(**_cascade_kwargs())
    jax_params.load_state(port, jax_params.unit2wav_fast_state_dict(without, N_LAYERS))
    assert port.ddsp_model.unit2ctrl.aug_shift_embed is None


def test_every_generator_param_maps():
    from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator

    cfg = dict(sampling_rate=44100, num_mels=128, upsample_initial_channel=32)
    params = randomize_tree(jax.eval_shape(lambda: JGenerator(**cfg).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=2)
    port = Generator(**cfg)
    sd = jax_params.generator_state_dict(params)
    assert set(sd) == set(port.state_dict())
    jax_params.load_state(port, sd)


def test_weight_norm_folds_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 40, 12)).astype(np.float32)
    # Conv1d: the JAX module's own fold (fold_only) vs the port's
    conv = jnn.Conv1d(8, 5, padding=2, dilation=3, weight_norm=True)
    p = randomize_tree(jax.eval_shape(lambda: conv.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]), seed=4)
    kernel, _ = jax.jit(lambda q: conv.apply({"params": q}, jnp.asarray(x),
                                             fold_only=True))(p)
    sd = {}
    jax_params._put_conv(sd, jax_params._Leaves({"c": p}), "c", "c")
    np.testing.assert_allclose(sd["c.weight"], np.asarray(kernel).transpose(2, 1, 0),
                               rtol=1e-6, atol=1e-7)
    # Dense: the fold is over the input axis, per output unit
    dense = jnn.Dense(6, weight_norm=True)
    p = randomize_tree(jax.eval_shape(lambda: dense.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]), seed=5)
    want = jax.jit(lambda q: dense.apply({"params": q}, jnp.asarray(x)))(p)
    sd = {}
    jax_params._put_dense(sd, jax_params._Leaves({"d": p}), "d", "d")
    lin = torch.nn.Linear(12, 6)
    lin.load_state_dict({"weight": tt(sd["d.weight"]), "bias": tt(sd["d.bias"])})
    with torch.no_grad():
        np.testing.assert_allclose(lin(tt(x)).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2)])
def test_conv_transpose_fold_and_layout_equal_jax(k, u):
    """Weight norm per input channel, (k, in, out) -> (in, out, k) without a
    flip, padding (k - u) // 2: the port's ConvTranspose1d equals the JAX
    module (whose lhs-dilated lowering flips the kernel itself)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, 9, 12)).astype(np.float32)
    jconv = jnn.ConvTranspose1d(6, k, stride=u, padding=(k - u) // 2,
                                weight_norm=True)
    p = randomize_tree(jax.eval_shape(lambda: jconv.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]), seed=6)
    want = jax.jit(lambda q: jconv.apply({"params": q}, jnp.asarray(x)))(p)
    sd = {}
    jax_params._put_conv_transpose(sd, jax_params._Leaves({"u": p}), "u", "u")
    conv = tnn.ConvTranspose1d(12, 6, k, stride=u, padding=(k - u) // 2)
    conv.load_state_dict({"weight": tt(sd["u.weight"]), "bias": tt(sd["u.bias"])})
    with torch.no_grad():
        got = conv(tt(x))
    assert got.shape == want.shape == (1, 9 * u, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_jax_checkpoint_loads_through_the_port_reader(cascade, tmp_path):
    """save_checkpoint's msgpack (flax's ndarray ext type) -> read_msgpack,
    leaf for leaf; then registry.load_model builds the model from it and
    its config.yaml, and the vocoder payload loads the same way."""
    from ddsp_svc_tpu_torch.models.registry import load_model, load_vocoder

    _, params, port, _ = cascade
    path = save_checkpoint(str(tmp_path), 7, params)
    payload = jax_params.read_msgpack(path)
    assert payload["global_step"] == 7
    got, want = _leaves(payload["params"]), _leaves(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "config.yaml").write_text(
        "data: {sampling_rate: 44100, block_size: 512, encoder_out_channels: 64}\n"
        "model: {type: DiffusionFast, win_length: 2048, n_layers: 2, n_chans: 64,\n"
        "        k_step_max: 100, use_pitch_aug: true, n_spk: 2}\n")
    model, args = load_model(path, device="cpu")
    assert args.model.type == "DiffusionFast"
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator

    cfg = dict(upsample_initial_channel=32)
    vparams = randomize_tree(jax.eval_shape(lambda: JGenerator(
        44100, 128, **cfg).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 128)), jnp.ones((1, 4)))["params"]), seed=8)
    vpath = os.path.join(tmp_path, "vocoder.msgpack")
    with open(vpath, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": vparams, "config": cfg}))
    vocoder = load_vocoder(vpath, device="cpu")
    assert vocoder.config["upsample_initial_channel"] == 32
    assert load_vocoder(os.path.join(tmp_path, "absent"), device="cpu") is None

    # the checkpoint constructor: model, config and the vocoder it names
    with open(tmp_path / "config.yaml", "a") as f:
        f.write(f"vocoder: {{type: nsf-hifigan, ckpt: {vpath}}}\n")
    pipe = SvcPipeline(path, device="cpu")
    rng = np.random.default_rng(9)
    t = 8
    audio, sr = pipe.infer_features(
        rng.standard_normal((1, t, 64)), np.full((1, t, 1), 220.0),
        np.full((1, t, 1), 0.1), np.ones(t), spk_id=2, k_step=100)
    assert sr == 44100 and audio.shape == (1, t * 512)
    assert torch.isfinite(audio).all()


@pytest.mark.parametrize("mtype", sorted(WIDTHS))
def test_every_ddsp_param_and_buffer_maps(mtype):
    """Sins, CombSub, CombSubFast and CombSubSuperFast: the state dict from
    the JAX params (and, for the PCmer models, buffers) sets exactly the
    port's parameters and buffers, and round-trips: the loaded module's
    state dict gives back every array."""
    _, params, buffers, port = build_ddsp(mtype, inputs(t=4))
    pcmer = mtype != "CombSubSuperFast"
    assert (buffers is not None) == pcmer
    sd = jax_params.ddsp_state_dict(params, buffers, pcmer=pcmer)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    if pcmer:
        assert sum(k.endswith("projection_matrix") for k in sd) == 3
        with pytest.raises(KeyError, match="buffers missing"):
            jax_params.ddsp_state_dict(params, None)
        extra = {"unit2ctrl": dict(buffers["unit2ctrl"], stray={"m": np.zeros(2)})}
        with pytest.raises(KeyError, match="stray/m"):
            jax_params.ddsp_state_dict(params, extra)


def test_ddsp_checkpoint_loads_with_its_buffers(tmp_path):
    """A Sins checkpoint saved with its ``buffers`` (as the JAX trainer and
    converters write it) -> registry.load_model, param and buffer for
    buffer; the checkpoint constructor with ``enhance`` builds the enhancer
    (random weights: the configured payload is absent) and serves."""
    from ddsp_svc_tpu_torch.models.registry import load_model, model_family

    x = inputs(t=4)
    _, params, buffers, port = build_ddsp("Sins", x)
    path = save_checkpoint(str(tmp_path), 3, params, extra={"buffers": buffers})
    w = WIDTHS["Sins"]
    (tmp_path / "config.yaml").write_text(
        "data: {sampling_rate: 44100, block_size: 512, encoder_out_channels: 32}\n"
        f"model: {{type: Sins, n_spk: 2, n_harmonics: {w['n_harmonics']},\n"
        f"        n_mag_allpass: {w['n_mag_allpass']}, n_mag_noise: {w['n_mag_noise']}}}\n"
        f"enhancer: {{type: nsf-hifigan, ckpt: {tmp_path}/absent.msgpack}}\n")
    model, args = load_model(path, device="cpu")
    assert model_family(args.model.type) == "ddsp"
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    pipe = SvcPipeline(path, device="cpu", enhance=True)
    assert pipe.enhancer is not None
    audio, sr = pipe.infer_features(x["units"], x["f0"], x["volume"],
                                    np.ones(4, np.float32), spk_id=2)
    assert sr == 44100 and audio.shape == (1, 4 * 512)
    assert torch.isfinite(audio).all()
    assert SvcPipeline(path, device="cpu").enhancer is None
