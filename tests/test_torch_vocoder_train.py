"""NSF-HiFiGAN GAN training against the JAX package, at a small size (a
generator of 32 initial channels with rates (2, 2), periods (2, 3), MSD
scales 2, crops of 300 samples): the spectral norm's start vector bit for
bit against ``jax.random.normal``; the spectral norm, the period and scale
discriminators (reflect padding at a length no period divides) and the
three losses; the first discriminator step and then the first generator
step, each from the same parameters and draws (losses within 1e-5
relative, every gradient leaf within 1e-5 x max|leaf|, every parameter
after AdamW within 1e-5 x max|leaf| plus what that gradient bound allows
through AdamW's first update). The checkpoint and the CLI are
``test_torch_vocoder_cli.py``'s."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ddsp_svc_tpu.models import nn as jnn
from ddsp_svc_tpu.models import nsf_hifigan as jnsf
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JMel
from ddsp_svc_tpu.train import vocoder_solver as jsolver
from ddsp_svc_tpu_torch.io.jax_params import (load_state, vocoder_train_params,
                                              vocoder_train_state_dicts)
from ddsp_svc_tpu_torch.models import nsf_hifigan as pnsf
from ddsp_svc_tpu_torch.models.nn import spectral_normalize
from ddsp_svc_tpu_torch.ops.jax_random import normal_key0
from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
from ddsp_svc_tpu_torch.train import vocoder_solver as psolver
from torch_helpers import default_threads, randomize_tree
from torch_train_helpers import leaves

TOL = 1e-5
GEN_AUDIO_TOL = 4e-6  # abs, on audio in (-1, 1): XLA's and torch's f32 tanh
CFG = dict(sampling_rate=16000, num_mels=16, n_fft=64, win_size=64, hop_size=4,
           fmin=0, fmax=8000, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=32, resblock="1",
           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
PERIODS, MSD = (2, 3), 2
B, T = 2, 75  # 300 samples: no multiple of 3, so DiscriminatorP(3) pads


@pytest.mark.parametrize("n", [1, 128, 256, 512, 1024])
def test_start_vector_bit_for_bit(n):
    assert jax.config.jax_threefry_partitionable  # the default reproduced
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    assert np.array_equal(normal_key0(n).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(5, 1, 1, 32), (41, 4, 128), (3, 1024, 1)])
def test_spectral_norm(shape):
    """JAX ``_spectral_normalize`` on a flax kernel (the out axis last)
    against the port's on the torch layout (out first)."""
    k = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jnn._spectral_normalize(jnp.asarray(k), shape[-1]))
    perm = (shape.__len__() - 1,) + tuple(range(len(shape) - 1))
    got = spectral_normalize(torch.from_numpy(np.ascontiguousarray(k.transpose(perm))))
    back = np.moveaxis(got.numpy(), 0, -1)
    assert np.abs(back - want).max() <= TOL * np.abs(want).max()


def _generator_jax(num_mels=CFG["num_mels"]):
    return jnsf.Generator(
        CFG["sampling_rate"], num_mels=num_mels,
        upsample_rates=CFG["upsample_rates"],
        upsample_kernel_sizes=CFG["upsample_kernel_sizes"],
        upsample_initial_channel=CFG["upsample_initial_channel"],
        resblock="1", resblock_kernel_sizes=CFG["resblock_kernel_sizes"],
        resblock_dilation_sizes=CFG["resblock_dilation_sizes"])


def _setup(seed=0):
    """JAX modules and params (drawn from numpy), the port's loaded with
    them, a batch and the sine source's draws."""
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, T, CFG["num_mels"])) - 3).astype(np.float32)
    f0 = (150 + 50 * rng.random((B, T, 1))).astype(np.float32)
    f0[:, :5] = 0.0  # unvoiced frames
    audio = (0.3 * rng.standard_normal((B, T * 4))).astype(np.float32)
    sine = {"rand_ini": rng.random((1, 1, 9)).astype(np.float32),
            "noise": rng.standard_normal((B, T * 4, 9)).astype(np.float32)}
    sine["rand_ini"][..., 0] = 0.0
    jgen, jdisc = _generator_jax(), jsolver.Discriminators(PERIODS, MSD)
    gparams = randomize_tree(jax.eval_shape(lambda: jgen.init(
        {"params": jax.random.PRNGKey(0)}, mel, f0[..., 0],
        sine_kwargs={k: jnp.asarray(v) for k, v in sine.items()}))["params"], seed + 1)
    dparams = randomize_tree(jax.eval_shape(lambda: jdisc.init(
        jax.random.PRNGKey(1), audio, audio))["params"], seed + 2)
    gen = psolver_generator()
    discs = psolver.Discriminators(PERIODS, MSD)
    gsd, dsd = vocoder_train_state_dicts(
        {"generator": gparams, "discriminator": dparams}, CFG, PERIODS, MSD)
    load_state(gen, gsd)
    load_state(discs, dsd)
    batch = {"mel": mel, "f0": f0, "audio": audio}
    return jgen, jdisc, gparams, dparams, gen, discs, batch, sine


def psolver_generator():
    from ddsp_svc_tpu_torch.cli.train_vocoder import build_generator

    return build_generator(CFG)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _close_leaves(got: dict, want: dict, what: str):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)
        assert err <= TOL, (what, k, err)


def _close_params(got: dict, want: dict, grads: dict, lr: float, what: str):
    """Parameters after the first AdamW update: TOL x max|p| of the leaf,
    plus what the gradient tolerance allows through the update. The first
    update moves an element by lr g / (|g| + eps) (+ the decay), whose
    derivative in g is lr eps / (|g| + eps)^2: an element whose gradient is
    near eps (1e-8) turns a gradient error within TOL x max|g| into a
    larger step error."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        g = np.abs(grads[k])
        allowed = (TOL * np.abs(want[k]).max()
                   + lr * 1e-8 * TOL * g.max() / (g + 1e-8) ** 2)
        assert (np.abs(got[k] - want[k]) <= allowed).all(), (what, k)


def test_discriminators_and_losses():
    """Scores and every feature map of MPD + MSD (weight norm as (v, g),
    the MSD's first scale spectral-normed, the 4/2 average pool), and the
    three losses."""
    jgen, jdisc, _, dparams, _, discs, batch, _ = _setup()
    y = batch["audio"]
    y_hat = np.roll(y, 7, axis=1) * 0.7
    # jitted: one compile of the whole bundle (eager compiles op by op)
    want = jax.jit(lambda p: jdisc.apply({"params": p}, y, y_hat))(dparams)
    with torch.no_grad():
        got = discs(torch.from_numpy(y), torch.from_numpy(y_hat))
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [t for part in got for t in (part if isinstance(part[0], torch.Tensor)
                                           else [u for f in part for u in f])]
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= TOL * max(np.abs(w).max(), 1e-30)
    rs, gs, fr, fg = got
    for p, j in ((pnsf.discriminator_loss(rs, gs), jnsf.discriminator_loss(*want[:2])),
                 (pnsf.generator_loss(gs), jnsf.generator_loss(want[1])),
                 (pnsf.feature_loss(fr, fg), jnsf.feature_loss(*want[2:]))):
        assert _rel(p, j) <= TOL


def _jax_mel():
    return JMel(sr=CFG["sampling_rate"], n_mels=CFG["num_mels"], n_fft=CFG["n_fft"],
                win_size=CFG["win_size"], hop_length=CFG["hop_size"],
                fmin=CFG["fmin"], fmax=CFG["fmax"]).extract


@pytest.fixture
def torch_default_threads():
    """The gradients' 1e-5 holds with the port's sums in the order torch's
    default thread count gives them (the generator's bias gradient sums
    every sample of the batch)."""
    with default_threads():
        yield


def test_first_disc_and_gen_steps(monkeypatch, torch_default_threads):
    """The JAX recipe's first discriminator step, then its first generator
    step (the loss functions of ``train/vocoder_solver.py`` with the
    package's own modules and losses, jitted as the JAX trainer runs them,
    and ``optax.adamw(lr, b1=0.8, b2=0.99)``), against the port's
    ``disc_step`` and ``gen_step`` on the same parameters, batch and sine
    draws.

    The generator's audio is held apart, within GEN_AUDIO_TOL: XLA's f32
    tanh differs from torch's by a few ulps near +-1. The spectral-normed
    scale's first conv sees that audio, and its gradient is a sum that
    cancels to ~1e-3 of its terms' size, so those ulps move it by ~2e-3 of
    its largest element; the discriminator step is therefore held on JAX's
    audio (both sides take the same y_hat), where every leaf holds at
    1e-5."""
    lr = 2e-4
    jgen, jdisc, gparams, dparams, gen, discs, batch, sine = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jsine = {k: jnp.asarray(v) for k, v in sine.items()}
    tx = optax.adamw(lr, b1=0.8, b2=0.99)
    mel_j = _jax_mel()

    def synth(gp):
        return jgen.apply({"params": gp}, jb["mel"], jb["f0"][..., 0],
                          sine_kwargs=jsine)

    y_hat = jax.jit(synth)(gparams)  # as the JAX trainer's jitted step makes it

    # the discriminator step's audio enters as arguments: closed over, XLA
    # constant-folds the discriminators' pooling of it at length
    def d_loss(dp, audio, y):
        reals, fakes, _, _ = jdisc.apply({"params": dp}, audio,
                                         jax.lax.stop_gradient(y))
        return jnsf.discriminator_loss(reals, fakes)

    @jax.jit  # one compile of the update (eager optax compiles op by op)
    def adamw_step(grads, params):
        upd, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, upd)

    jdl, dgrads = jax.jit(jax.value_and_grad(d_loss))(dparams, jb["audio"], y_hat)
    dparams1 = adamw_step(dgrads, dparams)

    def g_loss(gp, dp, audio):
        y = synth(gp)
        _, fakes, fr, fg = jdisc.apply({"params": dp}, audio, y)
        mel_l1 = jnp.mean(jnp.abs(mel_j(y) - mel_j(audio)))
        return (jnsf.generator_loss(fakes) + jnsf.feature_loss(fr, fg)
                + 45.0 * mel_l1)

    jgl, ggrads = jax.jit(jax.value_and_grad(g_loss))(gparams, dparams1, jb["audio"])
    gparams1 = adamw_step(ggrads, gparams)

    state_g, state_d = psolver.create_states(gen, discs, lr)
    tb, ts = _t(batch), _t(sine)
    with torch.no_grad():
        y_port = psolver.synth(gen, tb, ts)
    assert np.abs(y_port.numpy() - np.asarray(y_hat)).max() <= GEN_AUDIO_TOL
    y_jax = torch.from_numpy(np.array(y_hat))
    with monkeypatch.context() as m:
        m.setattr(psolver, "synth", lambda *a, **k: y_jax.clone())
        md = psolver.disc_step(state_d, gen, tb, sine_kwargs=ts)
    assert _rel(md["disc_loss"], jdl) <= TOL
    dgot = {n: p.grad.clone().numpy() for n, p in discs.named_parameters()}
    mel_p = LogMelSpectrogram(sr=CFG["sampling_rate"], n_mels=CFG["num_mels"],
                              n_fft=CFG["n_fft"], win_size=CFG["win_size"],
                              hop_length=CFG["hop_size"], fmin=CFG["fmin"],
                              fmax=CFG["fmax"]).extract
    mg = psolver.gen_step(state_g, discs, tb, mel_p, sine_kwargs=ts)
    assert _rel(mg["gen_loss"], jgl) <= TOL
    # the generator step leaves the discriminators' gradients as they were
    assert all(np.array_equal(p.grad.numpy(), dgot[n])
               for n, p in discs.named_parameters())
    ggot = {n: p.grad.numpy() for n, p in gen.named_parameters()}
    grads = vocoder_train_params(ggot, dgot, CFG, PERIODS, MSD)
    _close_leaves(leaves(grads["discriminator"]), leaves(dgrads), "disc grads")
    _close_leaves(leaves(grads["generator"]), leaves(ggrads), "gen grads")
    params = vocoder_train_params(gen.state_dict(), discs.state_dict(), CFG,
                                  PERIODS, MSD)
    _close_params(leaves(params["discriminator"]), leaves(dparams1),
                  leaves(dgrads), lr, "disc params")
    _close_params(leaves(params["generator"]), leaves(gparams1), leaves(ggrads),
                  lr, "gen params")
