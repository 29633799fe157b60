"""Files the training path reads and writes, against the JAX package and the
libraries it uses: the standard-library msgpack codec against
``flax.serialization`` (bytes) and the ``msgpack`` package (values), the
standard-library config reader against ``yaml.safe_load`` with the writer
round-tripping, checkpoints written by the port read by the JAX package
and the reverse (the same model output at 1e-5), ``latest_checkpoint``,
retention and the strict=False warm start, and the offline CLI running from
a config and checkpoint file with PyYAML and msgpack unavailable."""
import glob
import os
import sys

import msgpack
import numpy as np
import pytest
import torch
import yaml

import jax
import optax
from flax import serialization

from ddsp_svc_tpu.models.registry import load_model as jax_load_model
from ddsp_svc_tpu.train import checkpoint as jckpt
from ddsp_svc_tpu_torch.io import msgpack_codec
from ddsp_svc_tpu_torch.io.jax_params import model_state_dict
from ddsp_svc_tpu_torch.models.nn import random_init_
from ddsp_svc_tpu_torch.models.registry import build_model
from ddsp_svc_tpu_torch.train import checkpoint as ckpt
from ddsp_svc_tpu_torch.train.state import create_train_state, opt_state_to_optax
from ddsp_svc_tpu_torch.utils import config as pconfig
from torch_train_helpers import batch, jax_variables, leaves, pair, tiny_config, tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payload():
    args, _, variables, _ = pair("DiffusionFast")
    params = variables["params"]
    tx = optax.chain(optax.adamw(1e-3, weight_decay=0.1))
    opt = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, tx.init(params)))
    return {"global_step": 1234, "params": params, "opt_state": opt,
            "extra": {"neg": -3, "big": 2 ** 40, "f": 0.25, "s": "x" * 40,
                      "scalar": np.float32(1.5), "list": [1, 2.5, "a"]}}


def test_msgpack_codec_matches_flax_and_msgpack():
    payload = _payload()
    data = serialization.msgpack_serialize(payload)
    assert msgpack_codec.packb(payload) == data
    got = msgpack_codec.unpackb(data)
    ref = msgpack.unpackb(data, raw=False, ext_hook=lambda code, b: (
        serialization._msgpack_ext_unpack(code, b)))
    flat_got, flat_ref = leaves(got), leaves(ref)
    assert set(flat_got) == set(flat_ref)
    for k in flat_ref:
        np.testing.assert_array_equal(flat_got[k], flat_ref[k], err_msg=k)
        assert np.asarray(flat_got[k]).dtype == np.asarray(flat_ref[k]).dtype, k
    assert type(got["extra"]["scalar"]) is np.float32
    assert got["global_step"] == 1234 and got["extra"]["list"] == [1, 2.5, "a"]
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(data[:-3])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_config_reader_and_writer(path, tmp_path):
    with open(path) as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert pconfig.loads(text) == want
    # what the JAX saver writes (yaml.safe_dump) reads back too
    assert pconfig.loads(yaml.safe_dump(want, sort_keys=False)) == want
    pconfig.save_config(tmp_path / "c.yaml", pconfig.DotDict(want))
    with open(tmp_path / "c.yaml") as f:
        written = f.read()
    assert yaml.safe_load(written) == want
    assert pconfig.load_config(tmp_path / "c.yaml") == want


def test_config_scalars_as_yaml_resolves_them():
    text = ("a: 2e-4\nb: 1.0e-4\nc: 0x1f\nd: yes\ne: ~\nf: '1.5'\ng: -.inf\n"
            "h: {x: 1, y: [2, 3]}\ni:\n- - 1\n  - 2\n- 3\nj: \"q\\\"s\" # c\n")
    assert pconfig.loads(text) == yaml.safe_load(text)
    tree = {"a": 1e-5, "b": "yes", "c": None, "d": [1, [2.5]], "e": {},
            "f": "it's", "g": 3}
    assert yaml.safe_load(pconfig.dumps(tree)) == tree == pconfig.loads(
        pconfig.dumps(tree))


def _port_output(port, mtype, x, noise):
    with torch.no_grad():
        if mtype == "Sins":
            return port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                        noise=tt(noise))[0].numpy()
        return port(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                    mel_extract_fn=lambda a: tt(x["mel"]), k_step=20,
                    infer_speedup=10, ddsp_noise=tt(noise),
                    init_noise=tt(x["init"])).numpy()


def _jax_output(jmodel, variables, mtype, x, noise):
    if mtype == "Sins":
        return np.asarray(jmodel.apply(variables, x["units"], x["f0"],
                                       x["volume"], noise=noise)[0])
    return np.asarray(jmodel.apply(variables, x["units"], x["f0"], x["volume"],
                                   gt_spec=x["mel"], k_step=20, infer_speedup=10,
                                   ddsp_noise=noise, init_noise=x["init"],
                                   key=jax.random.PRNGKey(0)))


def _inputs(mtype):
    x = batch(mtype, b=1, seed=7)
    rng = np.random.default_rng(8)
    x["init"] = rng.standard_normal((1, x["units"].shape[1], 128)).astype(np.float32)
    noise = rng.uniform(-1, 1, x["audio"].shape).astype(np.float32)
    return x, noise


@pytest.mark.parametrize("mtype", ["DiffusionFast", "Sins"])
def test_port_checkpoint_read_by_jax(mtype, tmp_path):
    """The port saves a random model (with AdamW's state) and its config;
    the JAX package's ``load_model`` (its config reader, checkpoint reader
    and, for Sins, the FAVOR+ buffers), ``restore_into`` (strict) and
    ``restore_opt_state`` read them, and the JAX model gives the port's
    output at 1e-5."""
    args = tiny_config(mtype)
    port = random_init_(build_model(args), torch.Generator().manual_seed(3))
    state = create_train_state(port, lr=1e-3)
    path = ckpt.save_checkpoint(str(tmp_path), 7, port, args.model,
                                opt_state_to_optax(state, args.model))
    pconfig.save_config(tmp_path / "config.yaml", args)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    jmodel, variables, jargs = jax_load_model(path)
    assert jargs == args
    payload, step = jckpt.load_checkpoint(path)
    assert step == 7
    # the JAX resume path: restore_into a freshly initialised tree, strictly
    template = jax_variables(args, jmodel, seed=11)["params"]
    variables = dict(variables, params=jckpt.restore_into(
        template, payload["params"], strict=True))
    tx = optax.chain(optax.adamw(1e-3))
    restored = jckpt.restore_opt_state(tx.init(variables["params"]),
                                       payload["opt_state"])
    assert int(restored[0][0].count) == 0
    x, noise = _inputs(mtype)
    want = _jax_output(jmodel, variables, mtype, x, noise)
    got = _port_output(port, mtype, x, noise)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_jax_checkpoint_read_by_port(tmp_path):
    """A checkpoint the JAX package writes (params and optax state) resumes
    the port: ``latest_checkpoint`` finds it, ``restore_into`` loads it, the
    port's output matches JAX's, and the optimizer state restores."""
    from ddsp_svc_tpu_torch.train.state import restore_opt_state

    args, jmodel, variables, _ = pair("DiffusionFast", seed=4)
    tx = optax.chain(optax.adamw(1e-3))
    opt = tx.init(variables["params"])
    jckpt.save_checkpoint(str(tmp_path), 3, variables["params"])
    jckpt.save_checkpoint(str(tmp_path), 12, variables["params"], opt)
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("model_12.ckpt")
    payload, step = ckpt.load_checkpoint(path)
    assert step == 12
    port = random_init_(build_model(args), torch.Generator().manual_seed(0))
    ckpt.restore_into(port, args.model, payload, strict=True)
    x, noise = _inputs("DiffusionFast")
    want = _jax_output(jmodel, variables, "DiffusionFast", x, noise)
    got = _port_output(port, "DiffusionFast", x, noise)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    state = create_train_state(port, lr=1e-3)
    assert restore_opt_state(state, args.model, payload["opt_state"])


def test_retention_and_warm_start(tmp_path):
    """Retention keeps force-save multiples only; a model_0 with a missing
    leaf and a leaf of another shape warm-starts the rest (strict=False)
    and is refused with strict=True."""
    args, _, variables, _ = pair("CombSubSuperFast", seed=5)
    for step in (10, 20, 30):
        jckpt.save_checkpoint(str(tmp_path), step, variables["params"])
    ckpt.apply_retention(str(tmp_path), 10, 20)
    ckpt.apply_retention(str(tmp_path), 20, 20)
    assert sorted(os.listdir(tmp_path)) == ["model_20.ckpt", "model_30.ckpt"]
    ckpt.apply_retention(str(tmp_path), 30, 0)
    assert sorted(os.listdir(tmp_path)) == ["model_20.ckpt"]
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None

    params = jax.tree_util.tree_map(np.array, variables["params"])
    del params["unit2ctrl"]["f0_embed"]
    params["unit2ctrl"]["norm"]["scale"] = np.ones(7, np.float32)
    warm = str(tmp_path / "warm")
    jckpt.save_checkpoint(warm, 0, params)
    payload, _ = ckpt.load_checkpoint(ckpt.latest_checkpoint(warm))
    port = random_init_(build_model(args), torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ckpt.restore_into(port, args.model, payload)
    sd = port.state_dict()
    assert torch.equal(sd["unit2ctrl.f0_embed.weight"], before["unit2ctrl.f0_embed.weight"])
    assert torch.equal(sd["unit2ctrl.norm.weight"], before["unit2ctrl.norm.weight"])
    want = model_state_dict(args.model, variables["params"])
    for k in ("unit2ctrl.dense_out.weight_v", "unit2ctrl.stack_conv0.weight"):
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    with pytest.raises((KeyError, ValueError)):
        ckpt.restore_into(port, args.model, payload, strict=True)


def test_cli_infer_reads_files_without_yaml_or_msgpack(tmp_path, monkeypatch):
    """The card machine has neither PyYAML nor msgpack: with both imports
    failing, ``cli.infer.main`` reads a config.yaml and a model_<step>.ckpt
    (written here by the port) and converts a wav."""
    from scipy.io import wavfile

    from ddsp_svc_tpu_torch.cli import infer as pcli

    args = tiny_config("CombSubSuperFast")
    args["data"].update(encoder="tiny", encoder_ckpt=str(tmp_path / "absent.npz"),
                        encoder_out_channels=256, sampling_rate=16000,
                        block_size=64)
    args["model"]["win_length"] = 256
    port = random_init_(build_model(args), torch.Generator().manual_seed(2))
    ckpt.save_checkpoint(str(tmp_path), 1, port, args.model)
    pconfig.save_config(tmp_path / "config.yaml", args)
    n = np.arange(16000)
    wavfile.write(tmp_path / "in.wav", 16000,
                  (0.4 * np.sin(2 * np.pi * 220 * n / 16000) * 32767).astype(np.int16))
    for name in ("yaml", "msgpack"):
        monkeypatch.setitem(sys.modules, name, None)  # import raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    pcli.main(["-m", str(tmp_path / "model_1.ckpt"), "-i", str(tmp_path / "in.wav"),
               "-o", str(tmp_path / "out.wav"), "--device", "cpu"])
    sr, out = wavfile.read(tmp_path / "out.wav")
    assert sr == 16000 and len(out) >= 16000 - 64 and np.isfinite(out).all()
