"""The DDSP family in the port against the JAX package at small widths:
PCmer (FAVOR+ with the JAX projection buffers carried across, never
redrawn), Unit2Control's PCmer branch, the four synthesisers (Sins,
CombSubFast, CombSub, standalone CombSubSuperFast) with injected noise,
and ``Enhancer.enhance`` with the vocoder's sine noise injected. The same
randomised params go to both sides through io/jax_params; the JAX side
runs jitted on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddsp_svc_tpu.models.vocoder as jvoc
from ddsp_svc_tpu.models import ddsp as jddsp
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.models.pcmer import PCmer as JPCmer
from ddsp_svc_tpu.models.pcmer import gaussian_orthogonal_random_matrix
from ddsp_svc_tpu.models.unit2control import Unit2Control as JUnit2Control
from ddsp_svc_tpu_torch.io.jax_params import (_Leaves, _put_pcmer, ddsp_state_dict,
                                              generator_state_dict, load_state)
from ddsp_svc_tpu_torch.models import ddsp
from ddsp_svc_tpu_torch.models.pcmer import PCmer
from ddsp_svc_tpu_torch.models.unit2control import Unit2Control
from ddsp_svc_tpu_torch.models.vocoder import Enhancer, Vocoder
from torch_helpers import f0_contour, randomize_tree, rel_err, snr_db, tt

SR, BLOCK, N_UNIT, N_SPK, T = 44100, 512, 32, 2, 20
VOC_CFG = dict(upsample_initial_channel=32)
WIDTHS = {  # small widths of each model's own controls
    "Sins": dict(n_harmonics=24, n_mag_allpass=16, n_mag_noise=12),
    "CombSub": dict(n_mag_allpass=16, n_mag_harmonic=32, n_mag_noise=12),
    "CombSubFast": {},
    "CombSubSuperFast": dict(win_length=512),
}


def inputs(t=T, seed=0):
    rng = np.random.default_rng(seed)
    return dict(units=rng.standard_normal((1, t, N_UNIT)).astype(np.float32),
                f0=f0_contour(t), volume=rng.uniform(0, 0.3, (1, t, 1)).astype(np.float32),
                spk_id=np.array([[2]], np.int32),
                noise=rng.uniform(-1, 1, (1, t * BLOCK)).astype(np.float32),
                normal=rng.standard_normal((1, t * BLOCK)).astype(np.float32))


def jax_variables(init, seed):
    """(params of ``init()``'s shapes re-drawn from numpy, FAVOR+ buffers
    drawn by the JAX package's own ``gaussian_orthogonal_random_matrix``,
    or None)."""
    shapes = jax.eval_shape(init)
    buffers = None
    if "buffers" in shapes:
        buffers = jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.asarray(gaussian_orthogonal_random_matrix(
                jax.random.PRNGKey(seed + int(path[-3].key[-1])), *leaf.shape)),
            shapes["buffers"])
    return randomize_tree(shapes["params"], seed), buffers


def build_ddsp(mtype, x, seed=1):
    """(JAX module, params, buffers, port module with the same weights)."""
    w = WIDTHS[mtype]
    jm = getattr(jddsp, mtype)(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, **w)
    params, buffers = jax_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x["units"]), jnp.asarray(x["f0"]), jnp.asarray(x["volume"]),
        spk_id=jnp.asarray(x["spk_id"])), seed)
    pm = getattr(ddsp, mtype)(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, **w)
    load_state(pm, ddsp_state_dict(params, buffers,
                                   pcmer=mtype != "CombSubSuperFast"))
    return jm, params, buffers, pm.eval()


def test_pcmer_matches():
    """Three PCmer layers (FAVOR+ attention with the JAX init's projection
    buffers, conformer with LayerNorm), B = 2: 1e-5 relative to the peak
    (pcmer_norm: test_unit2control_pcmer_branch_matches)."""
    x = np.random.default_rng(0).standard_normal((2, 17, 256)).astype(np.float32)
    jm = JPCmer(3, 8, 256)
    params, buffers = jax_variables(
        lambda: jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), seed=4)
    want = jax.jit(lambda p, b, a: jm.apply({"params": p, "buffers": b}, a))(
        params, buffers, jnp.asarray(x))
    port = PCmer(3, 8, 256)
    sd: dict = {}
    tree, buf = _Leaves({"m": params}), _Leaves({"m": buffers})
    _put_pcmer(sd, tree, buf, "m", "m", 3)
    tree.finish()
    buf.finish()
    load_state(port, {k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(tt(x))
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("conv_stack,pcmer_norm", [(True, False), (False, True)])
def test_unit2control_pcmer_branch_matches(conv_stack, pcmer_norm):
    """The default (PCmer) decoder, with the conv stack or its single conv,
    with and without pcmer_norm, a second speaker and the weight-normed
    output projection: 1e-5 relative."""
    x = inputs()
    splits = {"a": 24, "b": 16}
    flags = dict(use_conv_stack=conv_stack, pcmer_norm=pcmer_norm)
    ju = JUnit2Control(N_UNIT, N_SPK, splits, **flags)
    phase = np.random.default_rng(2).uniform(-np.pi, np.pi, (1, T, 1)).astype(np.float32)
    args = [x["units"], x["f0"], phase, x["volume"]]
    params, buffers = jax_variables(lambda: ju.init(jax.random.PRNGKey(0), *map(
        jnp.asarray, args), spk_id=jnp.asarray(x["spk_id"])), seed=5)
    want_c, want_h = jax.jit(lambda p, b, *a: ju.apply(
        {"params": p, "buffers": b}, *a, spk_id=jnp.asarray(x["spk_id"])))(
        params, buffers, *map(jnp.asarray, args))
    port = Unit2Control(N_UNIT, N_SPK, splits, **flags)
    sd = ddsp_state_dict({"unit2ctrl": params}, {"unit2ctrl": buffers})
    load_state(port, {k[len("unit2ctrl."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got_c, got_h = port(*map(tt, args), spk_id=torch.tensor([[2]]))
    assert rel_err(got_h, want_h) <= 1e-5
    for k in splits:
        assert rel_err(got_c[k], want_c[k]) <= 1e-5, k


@pytest.mark.parametrize("mtype,tol", [("Sins", 2e-4), ("CombSubFast", 2e-3),
                                       ("CombSub", 2e-3),
                                       ("CombSubSuperFast", 2e-3)])
def test_ddsp_model_matches(mtype, tol):
    """Each synthesiser with its noise injected (U(-1, 1) for the first
    three, N(0, 1) for CombSubSuperFast), against the jitted JAX model,
    relative to the peak, and >= 60 dB SNR. Run op by op, JAX agrees with
    the port much more closely; jitted, XLA rounds the phase arithmetic
    differently (ROADMAP C(h)), which the combtooth's sinc amplifies, hence
    2e-3 for the combtooth models; Sins' bank adds only the cycles-vs-
    radians difference (3e-5 absolute on its own,
    tests/test_torch_ddsp_ops.py), hence 2e-4."""
    x = inputs()
    jm, params, buffers, pm = build_ddsp(mtype, x)
    noise = x["normal"] if mtype == "CombSubSuperFast" else x["noise"]
    variables = {"params": params}
    if buffers is not None:
        variables["buffers"] = buffers
    want = jax.jit(lambda v, u, f, vol, n: jm.apply(
        v, u, f, vol, spk_id=jnp.asarray(x["spk_id"]), noise=n)[0])(
        variables, *map(jnp.asarray, (x["units"], x["f0"], x["volume"], noise)))
    with torch.no_grad():
        got, hidden = pm(tt(x["units"]), tt(x["f0"]), tt(x["volume"]),
                         spk_id=torch.tensor([[2]]), noise=tt(noise))
    assert got.shape == want.shape == (1, T * BLOCK)
    assert hidden.shape == (1, T, 256)
    assert rel_err(got, want) <= tol
    assert snr_db(want, got) >= 60.0


def test_sins_draws_uniform_noise_from_the_generator():
    x = inputs(t=6)
    _, _, _, pm = build_ddsp("Sins", x)
    args = (tt(x["units"]), tt(x["f0"]), tt(x["volume"]))
    with torch.no_grad():
        a, _ = pm(*args, spk_id=torch.tensor([[2]]),
                  generator=torch.Generator().manual_seed(7))
        b, _ = pm(*args, spk_id=torch.tensor([[2]]),
                  generator=torch.Generator().manual_seed(7))
        n = torch.rand((1, 6 * BLOCK), generator=torch.Generator().manual_seed(7)) * 2 - 1
        c, _ = pm(*args, spk_id=torch.tensor([[2]]), noise=n)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.fixture(scope="module")
def enhancers():
    """(JAX Enhancer, its Generator module, port Enhancer on the CPU), with
    the same randomised generator params (upsample_initial_channel 32)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvoc, "DEFAULT_NSF_CONFIG", dict(jvoc.DEFAULT_NSF_CONFIG, **VOC_CFG))
        jenh = jvoc.Enhancer("nsf-hifigan")
    jenh.vocoder.params = randomize_tree(jenh.vocoder.params, 11)
    vocoder = Vocoder(config=VOC_CFG)
    load_state(vocoder.model, generator_state_dict(jenh.vocoder.params))
    jg = JGenerator(SR, 128, **VOC_CFG)
    apply = jax.jit(lambda p, m, f, r, s: jg.apply(
        {"params": p}, m, f[:, :m.shape[1]], sine_kwargs=dict(rand_ini=r, noise=s)))
    return jenh, apply, Enhancer(device="cpu", vocoder=vocoder)


def enhancer_noise(n_samples, seed=12):
    rng = np.random.default_rng(seed)
    return {"rand_ini": np.concatenate([[0.0], rng.random(8)]).astype(np.float32)[None, None],
            "sine": rng.standard_normal((1, n_samples, 9)).astype(np.float32)}


def inject(monkeypatch, jenh, apply, noise):
    """The JAX enhancer's vocoder with the injected sine noise (the JAX
    wrapper draws its own from a key)."""
    def infer(mel, f0, key=None):
        return apply(jenh.vocoder.params, mel, f0, jnp.asarray(noise["rand_ini"]),
                     jnp.asarray(noise["sine"][:, :mel.shape[1] * BLOCK]))
    monkeypatch.setattr(jenh.vocoder, "infer", infer)


@pytest.mark.parametrize("key,silence", [(0, 0.0), (3, 0.05), ("auto", 0.0)])
def test_enhancer_matches(monkeypatch, enhancers, key, silence):
    """adaptive_key 0, +3 (with a silent prefix) and "auto" (peak f0
    ~1120 Hz -> +7 semitones): the resample up, the f0 regrid, the vocoder
    and the resample back, >= 60 dB SNR against JAX with the same sine
    noise."""
    jenh, apply, enh = enhancers
    rng = np.random.default_rng(13)
    t = 16
    audio = (0.3 * np.sin(2 * np.pi * 330 * np.arange(t * BLOCK) / SR)
             + 0.01 * rng.standard_normal(t * BLOCK)).astype(np.float32)[None]
    f0 = f0_contour(t, base=1100.0 if key == "auto" else 330.0)
    noise = enhancer_noise(2 * t * BLOCK)
    inject(monkeypatch, jenh, apply, noise)
    want, want_sr = jenh.enhance(jnp.asarray(audio), SR, jnp.asarray(f0), BLOCK,
                                 adaptive_key=key, silence_front=silence)
    got, got_sr = enh.enhance(tt(audio), SR, tt(f0), BLOCK, adaptive_key=key,
                              silence_front=silence, noise=noise)
    assert got_sr == want_sr == SR
    assert got.shape == want.shape
    if silence:
        assert float(got[:, :int(round(SR * silence / 2))].abs().max()) == 0.0
    assert snr_db(want, got) >= 60.0


def sins_args(enhancer: bool = True):
    from ddsp_svc_tpu_torch.utils.config import DotDict

    cfg = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                    "encoder_out_channels": N_UNIT},
           "model": dict(type="Sins", n_spk=N_SPK, **WIDTHS["Sins"])}
    if enhancer:
        cfg["enhancer"] = {"type": "nsf-hifigan", "ckpt": "absent.msgpack"}
    return DotDict(cfg)


def test_ddsp_slice_matches_jax_direct_path(monkeypatch, enhancers):
    """The whole slice, ``SvcPipeline.infer_features`` with Sins and the
    enhancer, against the JAX direct path (the masked jitted forward of
    ddsp_svc_tpu/infer/pipeline.py, then ``Enhancer.enhance``) with the
    same params, noise and mask: audio SNR >= 40 dB; without the enhancer,
    the masked synth alone at the model's rate."""
    from ddsp_svc_tpu.ops.interp import upsample as j_upsample
    from ddsp_svc_tpu_torch.infer.pipeline import SvcPipeline

    x = inputs()
    jm, params, buffers, pm = build_ddsp("Sins", x)
    jenh, apply, enh = enhancers
    frame_mask = np.ones(T, np.float32)
    frame_mask[T // 2:T // 2 + 4] = 0.0
    noise = dict(enhancer_noise(2 * T * BLOCK), ddsp=x["noise"])
    inject(monkeypatch, jenh, apply, noise)
    masked = jax.jit(lambda v, u, f, vol, n, m: jm.apply(
        v, u, f, vol, spk_id=jnp.asarray(x["spk_id"]), noise=n)[0]
        * j_upsample(m[None, :, None], BLOCK)[..., 0])(
        {"params": params, "buffers": buffers},
        *map(jnp.asarray, (x["units"], x["f0"], x["volume"], x["noise"], frame_mask)))
    want, want_sr = jenh.enhance(masked, SR, jnp.asarray(x["f0"]), BLOCK)

    feats = (x["units"], x["f0"], x["volume"], frame_mask)
    pipe = SvcPipeline.from_parts(pm, None, sins_args(), enh.vocoder,
                                  device="cpu", enhance=True)
    got, sr = pipe.infer_features(*feats, spk_id=2, noise=noise)
    assert sr == want_sr == SR and got.shape == want.shape
    snr = snr_db(want, got.numpy())
    print(f"DDSP slice audio SNR vs the JAX direct path: {snr:.1f} dB")
    assert snr >= 40.0

    bare = SvcPipeline.from_parts(pm, None, sins_args(enhancer=False), None,
                                  device="cpu", enhance=True)
    assert bare.enhancer is None
    got, sr = bare.infer_features(*feats, spk_id=2, noise=noise)
    assert sr == SR and snr_db(masked, got.numpy()) >= 60.0
    assert np.all(got.numpy()[:, (T // 2 + 1) * BLOCK:(T // 2 + 3) * BLOCK] == 0.0)
