"""The port's time-sharded drivers (``ddsp_svc_tpu_torch/parallel/``) on a
gloo world of CPU ranks, for every family ``streamed_forward`` dispatches,
(a) against the JAX package's streamed driver on a mesh of the forced CPU
devices, with the same weights and the same draws (JAX's per-frame keyed
noise, injected into the port whole), at the tolerance of that family's
whole-path port-vs-JAX test, and (b) against the port's own whole-
utterance reference at JAX's contract, 2e-5 relative to the peak
(tests/test_stream_cascade.py:85). The sizes are the JAX stream tests'.

Rank 0 is this process (``mesh.World``); the helper ranks import only the
port and get each model pickled over the world, once per module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ddsp_svc_tpu.models import cascade as jcascade
from ddsp_svc_tpu.models import ddsp as jddsp
from ddsp_svc_tpu.models.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.models.pcmer import gaussian_orthogonal_random_matrix
from ddsp_svc_tpu.ops.mel import LogMelSpectrogram as JLogMel
from ddsp_svc_tpu.parallel import stream as jstream
from ddsp_svc_tpu_torch.io.jax_params import (ddsp_state_dict,
                                              generator_state_dict, load_state,
                                              reflow_state_dict,
                                              unit2mel_state_dict,
                                              unit2wav_fast_state_dict,
                                              unit2wav_state_dict)
from ddsp_svc_tpu_torch.models import cascade, ddsp
from ddsp_svc_tpu_torch.models.nsf_hifigan import Generator
from ddsp_svc_tpu_torch.ops.mel import LogMelSpectrogram
from ddsp_svc_tpu_torch.parallel import stream
from ddsp_svc_tpu_torch.parallel.mesh import World
from torch_helpers import randomize_tree, rel_err, snr_db, tt

CONTRACT = 2e-5  # streamed against whole, relative to the peak
SR, HOP, WIN = 16000, 64, 256
KEYS = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}


class Worlds:
    """One world at a time (a process joins one default group): the world
    of the size asked for, the other closed first."""

    def __init__(self):
        self.world = None

    def __getitem__(self, n):
        if self.world is not None and self.world.size != n:
            self.close()
        if self.world is None:
            self.world = World(n, device="cpu")
        return self.world

    def close(self):
        if self.world is not None:
            world, self.world = self.world, None
            world.close()


@pytest.fixture(scope="module")
def worlds():
    pool = Worlds()
    try:
        yield pool
    finally:
        pool.close()


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("time",))


def inputs(t, n_unit, seed=0, period=7.0, f0_hz=200.0):
    rng = np.random.default_rng(seed)
    f0 = f0_hz * np.exp(0.3 * np.sin(np.arange(t) / period))
    return (rng.standard_normal((1, t, n_unit)).astype(np.float32),
            f0.astype(np.float32)[None, :, None],
            np.full((1, t, 1), 0.5, np.float32))


def jax_variables(init, seed):
    """The params of ``init()``'s shapes drawn from numpy, and FAVOR+
    buffers by the JAX package's own draw (or None)."""
    shapes = jax.eval_shape(init)
    variables = {"params": randomize_tree(shapes["params"], seed)}
    if "buffers" in shapes:
        variables["buffers"] = jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.asarray(gaussian_orthogonal_random_matrix(
                jax.random.PRNGKey(seed + int(path[-3].key[-1])), *leaf.shape)),
            shapes["buffers"])
    return variables


def port_mel(m):
    return LogMelSpectrogram(sr=SR, n_mels=m, n_fft=WIN, win_size=WIN,
                             hop_length=HOP, fmin=40.0, fmax=7000.0)


def check(got, want_jax, whole, tol):
    """(a) against JAX's streamed output at ``tol``, (b) against the
    port's whole reference at the contract."""
    got = got.numpy()
    assert got.shape == np.shape(want_jax) == tuple(whole.shape)
    err_jax, err_whole = rel_err(got, want_jax), rel_err(got, whole)
    print(f"vs JAX streamed {err_jax:.2e} (tol {tol:.0e}); vs the port's "
          f"whole {err_whole:.2e}")
    assert err_jax <= tol
    assert err_whole <= CONTRACT


# (model type, widths, T, block, port noise draw, family tolerance: the
# whole-path tolerance of tests/test_torch_ddsp_models.py)
COMBSUB_CASE = ("CombSubSuperFast", dict(win_length=WIN, n_unit=32), 192, HOP)
DDSP_CASES = [
    COMBSUB_CASE + (2, 2e-3),
    ("CombSubFast", dict(n_unit=16), 128, 32, 2, 2e-3),
    ("Sins", dict(n_harmonics=16, n_mag_allpass=17, n_mag_noise=9,
                  n_unit=16), 192, 32, 2, 2e-4),
    ("CombSub", dict(n_mag_allpass=17, n_mag_harmonic=17, n_mag_noise=9,
                     n_unit=16), 128, 32, 2, 2e-3),
]


@pytest.mark.parametrize("mtype,widths,t,block,n,tol", DDSP_CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in DDSP_CASES])
def test_ddsp_streamed(worlds, mtype, widths, t, block, n, tol):
    """A DDSP synth's audio (CombSubSuperFast's SNR against JAX >= 60 dB,
    as its whole-path test)."""
    units, f0, vol = inputs(t, widths["n_unit"], period=13.0, f0_hz=220.0)
    jm = getattr(jddsp, mtype)(sampling_rate=SR, block_size=block, n_spk=1,
                               **widths)
    variables = jax_variables(lambda: jm.init(KEYS, *map(jnp.asarray, (
        units, f0, vol))), seed=3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jstream.streamed_forward(
        jm, variables, *map(jnp.asarray, (units, f0, vol)), key, mesh(n)))
    draw = (jstream.blocked_noise if mtype == "CombSubSuperFast"
            else jstream.blocked_uniform)
    noise = tt(draw(key, 1, t, block))

    pm = getattr(ddsp, mtype)(sampling_rate=SR, block_size=block, n_spk=1,
                              **widths)
    load_state(pm, ddsp_state_dict(variables["params"],
                                   variables.get("buffers"),
                                   pcmer=mtype != "CombSubSuperFast"))
    pm.eval()
    args = tuple(map(tt, (units, f0, vol)))
    got = worlds[n].call(stream.streamed_forward, pm, *args, noise=noise)
    with torch.no_grad():
        whole = pm(*args, noise=noise)[0]
    check(got, want, whole, tol)
    if mtype == "CombSubSuperFast":
        assert snr_db(want, got.numpy()) >= 60.0


CASCADE_M, CASCADE_T = 16, 192


def _cascade_pair(family):
    """(JAX model, variables, port model) at the JAX stream test's sizes."""
    units, f0, vol = inputs(CASCADE_T, 16, period=9.0)
    jmel = JLogMel(sr=SR, n_mels=CASCADE_M, n_fft=WIN, win_size=WIN,
                   hop_length=HOP, fmin=40.0, fmax=7000.0)
    widths = dict(out_dims=CASCADE_M, n_layers=2, n_chans=32)
    if family == "reflow":
        jm = jcascade.ReflowUnit2Wav(SR, HOP, WIN, 16, 1, **widths)
        pm = cascade.ReflowUnit2Wav(SR, HOP, WIN, 16, 1, **widths)
        extra = {}
    else:
        jm = jcascade.Unit2WavFast(SR, HOP, WIN, 16, 1, **widths,
                                   k_step_max=100)
        pm = cascade.Unit2WavFast(SR, HOP, WIN, 16, 1, **widths,
                                  k_step_max=100)
        extra = {"k_step": 20}
    variables = jax_variables(lambda: jm.init(
        KEYS, *map(jnp.asarray, (units, f0, vol)), mel_extract_fn=jmel.extract,
        infer=True, key=jax.random.PRNGKey(9), **extra), seed=11)
    to_sd = reflow_state_dict if family == "reflow" else unit2wav_fast_state_dict
    load_state(pm, to_sd(variables["params"], 2))
    return jm, variables, pm.eval(), jmel, (units, f0, vol)


@pytest.mark.parametrize("family,sampler", [("reflow", "euler"),
                                            ("diffusion", "ddim")])
def test_cascade_streamed(worlds, family, sampler):
    """DiffusionFast and RectifiedFlow to the refined mel (the JAX file's
    non-slow cases). JAX's streamed drivers run jitted, so the tolerance is
    the whole-path test's against the jitted JAX cascade, 5e-4
    (tests/test_torch_models.py: the jitted combtooth's rounding reaches
    the DDSP mel); both cascades share that DDSP stage and trunk (the
    reflow test's 1e-5 is against JAX run op by op)."""
    jm, variables, pm, jmel, x = _cascade_pair(family)
    kwargs = (dict(infer_step=2, sampler=sampler, t_start=0.7)
              if family == "reflow" else
              dict(infer_speedup=5, sampler=sampler, k_step=10))
    key = jax.random.PRNGKey(2)
    want = np.asarray(jstream.streamed_cascade_mel(
        jm, variables, *map(jnp.asarray, x), key, jmel, mesh=mesh(2),
        family=family, **kwargs))
    k_ddsp, k_init = jax.random.split(key)
    noise = dict(
        ddsp_noise=tt(jstream.blocked_noise(k_ddsp, 1, CASCADE_T, HOP)),
        init_noise=tt(jstream.blocked_noise_frames(k_init, 1, CASCADE_T,
                                                   CASCADE_M)))
    mel = port_mel(CASCADE_M)
    args = tuple(map(tt, x))
    got = worlds[2].call(stream.streamed_forward, pm, *args, mel=mel,
                         **noise, **kwargs)
    whole = stream.whole_cascade_reference(pm, *args, mel, **noise, **kwargs)
    check(got, want, whole, 5e-4)


def test_unit2wav_new_streamed(worlds):
    """DiffusionNew (CombSubFast with PCmer, then the WaveNet diffusion on
    its hidden) at T = 128. Its whole-path test holds 1e-5 against JAX run
    op by op (tests/test_torch_unit2mel.py); against the jitted cascade the
    DDSP stage's phase rounds differently (ROADMAP C(h)), so the jitted
    cascade's 5e-4 of tests/test_torch_models.py applies."""
    t, m = 128, 16
    units, f0, vol = inputs(t, 16, period=9.0)
    jmel = JLogMel(sr=SR, n_mels=m, n_fft=WIN, win_size=WIN, hop_length=HOP,
                   fmin=40.0, fmax=7000.0)
    jm = jcascade.Unit2Wav(SR, HOP, 16, 1, out_dims=m, n_layers=4, n_chans=32,
                           k_step_max=100)
    variables = jax_variables(lambda: jm.init(
        KEYS, *map(jnp.asarray, (units, f0, vol)), mel_extract_fn=jmel.extract,
        infer=True, k_step=10, key=jax.random.PRNGKey(3)), seed=13)
    kwargs = dict(k_step=10, infer_speedup=5, sampler="ddim")
    key = jax.random.PRNGKey(4)
    want = np.asarray(jstream.streamed_unit2wav_new_mel(
        jm, variables, *map(jnp.asarray, (units, f0, vol)), key, jmel,
        mesh=mesh(2), **kwargs))
    pm = cascade.Unit2Wav(SR, HOP, 16, 1, out_dims=m, n_layers=4, n_chans=32,
                          k_step_max=100)
    load_state(pm, unit2wav_state_dict(variables["params"],
                                       variables["buffers"], 4))
    pm.eval()
    k_ddsp, k_init = jax.random.split(key)
    noise = dict(ddsp_noise=tt(jstream.blocked_uniform(k_ddsp, 1, t, HOP)),
                 init_noise=tt(jstream.blocked_noise_frames(k_init, 1, t, m)))
    mel = port_mel(m)
    args = tuple(map(tt, (units, f0, vol)))
    got = worlds[2].call(stream.streamed_forward, pm, *args, mel=mel,
                         **noise, **kwargs)
    whole = stream.whole_cascade_reference(pm, *args, mel, **noise, **kwargs)
    check(got, want, whole, 5e-4)


def test_unit2mel_streamed(worlds):
    """Diffusion (Unit2Mel) shallow from an input mel, two speakers;
    tests/test_torch_unit2mel.py's 1e-5."""
    t, m = 128, 16
    units, f0, vol = inputs(t, 16)
    rng = np.random.default_rng(7)
    gt = (rng.standard_normal((1, t, m)) * 2.0 - 6.0).astype(np.float32)
    spk = np.array([[2]], np.int32)
    jm = jcascade.Unit2Mel(16, n_spk=2, out_dims=m, n_layers=4, n_chans=32,
                           n_hidden=24, k_step_max=100)
    variables = jax_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(1)}, *map(jnp.asarray, (units, f0, vol)),
        spk_id=jnp.asarray(spk), gt_spec=jnp.asarray(gt), infer=True,
        k_step=20, key=jax.random.PRNGKey(2)), seed=17)
    kwargs = dict(k_step=20, infer_speedup=5, sampler="ddim")
    key = jax.random.PRNGKey(6)
    want = np.asarray(jstream.streamed_unit2mel(
        jm, variables, *map(jnp.asarray, (units, f0, vol, gt)), key,
        spk_id=jnp.asarray(spk), mesh=mesh(2), **kwargs))
    pm = cascade.Unit2Mel(16, 2, out_dims=m, n_layers=4, n_chans=32,
                          n_hidden=24, k_step_max=100)
    load_state(pm, unit2mel_state_dict(variables["params"], 4))
    pm.eval()
    init = tt(jstream.blocked_noise_frames(key, 1, t, m))
    args = tuple(map(tt, (units, f0, vol)))
    spk_t = torch.tensor([[2]])
    got = worlds[2].call(stream.streamed_forward, pm, *args, gt_spec=tt(gt),
                         init_noise=init, spk_id=spk_t, **kwargs)
    with torch.no_grad():
        whole = pm(*args, spk_id=spk_t, gt_spec=tt(gt), init_noise=init,
                   **kwargs)
    check(got, want, whole, 1e-5)


def test_nsf_hifigan_streamed(worlds):
    """The vocoder with an unvoiced stretch, against JAX's streamed one
    (the generator's test bound: rtol 1e-4, atol 1e-5, >= 60 dB) and the
    port's padded whole forward."""
    t, m = 128, 8
    cfg = dict(sampling_rate=SR, num_mels=m, upsample_rates=(4, 4),
               upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((1, t, m)).astype(np.float32)
    f0 = (200.0 * np.exp(0.2 * np.sin(np.arange(t) / 11.0)))[None]
    f0[:, 40:50] = 0.0
    f0 = f0.astype(np.float32)
    jg = JGenerator(resblock="1", **cfg)
    params = randomize_tree(jax.eval_shape(lambda: jg.init(
        KEYS, jnp.asarray(mel), jnp.asarray(f0),
        key=jax.random.PRNGKey(1)))["params"], seed=19)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jstream.streamed_nsf_hifigan(
        jg, params, jnp.asarray(mel), jnp.asarray(f0), key, mesh=mesh(2)))
    halo = jstream.VOCODER_HALO
    k_ini, k_noise = jax.random.split(key)
    draws = dict(rand_ini=tt(jstream._sine_rand_ini(k_ini, 9)),
                 noise=tt(jstream._sine_noise_from_keys(
                     jax.random.split(k_noise, t + 2 * halo), 1, jg.upp, 9)))
    pg = Generator(**cfg)
    load_state(pg, generator_state_dict(params, n_upsamples=2, n_kernels=1,
                                        n_dilations=2))
    pg.eval()
    got = worlds[2].call(stream.streamed_nsf_hifigan, pg, tt(mel), tt(f0),
                         **draws)
    whole = stream.nsf_hifigan_padded_forward(pg, tt(mel), tt(f0), **draws)
    check(got, want, whole, 1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert snr_db(want, got.numpy()) >= 60.0


def test_launches_gathered_and_chain_refused(worlds):
    """Each rank's launch counters reach rank 0 (zero on the CPU, where
    the wrappers run their plain versions), and the streamed diffusion
    refuses the ancestral chain with JAX's reason."""
    counts = worlds[2].launches()
    assert len(counts) == 2 and all(set(c) >= {"combtooth", "harmonic_bank",
                                                "resblock_group"}
                                    for c in counts)
    assert all(v == 0 for c in counts for v in c.values())
    pm = cascade.Unit2Mel(16, 1, out_dims=16, n_layers=2, n_chans=16,
                          n_hidden=12, k_step_max=100)
    with pytest.raises(NotImplementedError, match="blocking-invariant"):
        stream.streamed_unit2mel(pm, None, None, None, group=None,
                                 infer_speedup=1)


def test_combsub_streamed_world_4(worlds):
    """CombSubSuperFast at world 4 (blocks of 48 frames, FRAME_HALO itself);
    last in the module, so the world of 2 closes once."""
    test_ddsp_streamed(worlds, *COMBSUB_CASE, 4, 2e-3)
