"""Multi-device batched serving on the CPU (infer/batcher.py and
infer/enc_batcher.py with ``mesh``; ``SvcPipeline.enable_batching(mesh=)``).

A mesh in the port is a sequence of devices; JAX's tests build theirs from
the host devices that tests/conftest.py forces, the port's from as many
CPU entries. Against the JAX package: ``right_sized_slots`` for every
batch size up to max_batch on meshes of 1, 2 and 4; the divisibility
error; the rows of a sharded ``BatchedSynth`` against JAX's mesh engine,
with one forward in both packages (a function of each row's inputs, seed
aside) at JAX's own rtol 2e-4, atol 2e-5, and with CombSubSuperFast's
weights in both at that model's tolerance against jitted JAX (2e-3 of the
peak, tests/test_torch_ddsp_models.py); the sharded ``BatchedEncoder``
against JAX's mesh encoder (units 1e-5 x max|out|, the encoder's
tolerance; f0 the device YIN's bound, 0.05 cents). Against the port's own
single-device engines at rtol 2e-4, atol 2e-5: the sharded synth (with and
without ``pipeline_depth`` 2), the sharded encoder, and a DiffusionFast
pipeline batched over a mesh with the encoder in the batch.
"""
import copy
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ddsp_svc_tpu.features import hubert as jh
from ddsp_svc_tpu.infer import batcher as jbatcher
from ddsp_svc_tpu.infer import enc_batcher as jenc_batcher
from ddsp_svc_tpu_torch.features import hubert as ph
from ddsp_svc_tpu_torch.infer import batcher as pbatcher
from ddsp_svc_tpu_torch.infer.batcher import BatchedSynth
from ddsp_svc_tpu_torch.infer.enc_batcher import BatchedEncoder
from test_torch_batcher import _pipeline
from test_torch_ddsp_models import BLOCK, N_UNIT, build_ddsp, inputs
from torch_helpers import randomize_tree, rel_err, snr_db

BUCKETS = (16, 32)
LENGTHS = (31, 20, 13, 27)  # frames: three rows of bucket 32, one of 16
HOP44 = 512


def jax_mesh(d: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:d]), ("data",))


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate(LENGTHS):
        f0 = (220.0 * np.exp(0.1 * rng.standard_normal((t, 1)))).astype(np.float32)
        out.append((rng.standard_normal((t, N_UNIT)).astype(np.float32), f0,
                    rng.uniform(0.1, 0.4, (t, 1)).astype(np.float32), 1 + i % 2,
                    100 + i))
    return out


def _concurrently(fns) -> list:
    out, errors = [None] * len(fns), []
    barrier = threading.Barrier(len(fns))

    def run(i):
        try:
            barrier.wait()
            out[i] = fns[i]()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors
    assert all(not th.is_alive() for th in threads)
    return out


@pytest.fixture(scope="module")
def models():
    jm, params, _, pm = build_ddsp("CombSubSuperFast", inputs())
    return jm, params, pm


@pytest.mark.parametrize("max_batch", [8, 16])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_slot_policy_matches_jax_on_a_mesh(d, max_batch):
    jmesh, pmesh = jax_mesh(d), ["cpu"] * d
    for n in range(1, max_batch + 1):
        got = pbatcher.right_sized_slots(n, max_batch, pmesh)
        assert got == jbatcher.right_sized_slots(n, max_batch, jmesh), n
        assert got % d == 0 and got >= n


def test_mesh_needs_divisible_max_batch(models):
    jm, params, pm = models
    with pytest.raises(ValueError):
        jbatcher.BatchedSynth(jm, params, buckets=(16,), max_batch=6, mesh=jax_mesh(4))
    with pytest.raises(ValueError, match="max_batch 6 not divisible by mesh size 4"):
        BatchedSynth(pm, buckets=(16,), max_batch=6, mesh=["cpu"] * 4)
    enc = ph.UnitsEncoder("tiny", device="cpu")
    with pytest.raises(ValueError, match="max_batch 6 not divisible by mesh size 4"):
        BatchedEncoder(enc, frame_buckets=(16,), max_batch=6, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="one per entry"):
        BatchedSynth(pm, buckets=(16,), max_batch=4, mesh=["cpu"] * 2,
                     forward_builder=lambda bucket, sig: None)


def _serve(eng, reqs, **kw):
    return _concurrently([lambda r=r: eng.infer(r[0], r[1], r[2], spk_id=r[3],
                                                 seed=r[4], **kw) for r in reqs])


@pytest.mark.parametrize("depth", [1, 2])
def test_sharded_synth_matches_single_device(models, depth):
    """Four concurrent requests (three of bucket 32, one of 16) through a
    2-entry mesh engine (blocks of rows on per-entry copies of the model)
    and a 4-entry one, against the single-device engine with the same
    seeds. Each row is held against the single-device engine running it
    in a batch of the block's size: the CPU's convolutions are not
    invariant to the batch size (a row alone and in a batch of four part
    by ~1e-2 here, while two and four agree bit for bit), so the 2-entry
    mesh (blocks of 2 and 1) meets the concurrent batches (4 and 1) and
    the 4-entry one (blocks of 1) meets requests run one at a time."""
    _, _, pm = models
    reqs = _requests(1)
    single = BatchedSynth(pm, buckets=BUCKETS, max_batch=4, max_wait_ms=200.0,
                          device="cpu")
    try:
        want = {2: _serve(single, reqs),
                4: [single.infer(r[0], r[1], r[2], spk_id=r[3], seed=r[4])
                    for r in reqs]}
    finally:
        single.close()
    for d in (2, 4):
        eng = BatchedSynth(pm, buckets=BUCKETS, max_batch=4, max_wait_ms=200.0,
                           mesh=["cpu"] * d, pipeline_depth=depth)
        try:
            got = _serve(eng, reqs)
            stats = eng.stats()
        finally:
            eng.close()
        assert eng._models[0] is pm and all(m is not pm for m in eng._models[1:])
        assert [b["slots"] for b in stats["recent_batches"]] in ([4, d], [d, 4])
        assert stats["requests"] == 4 and stats["compiled_signatures"] == 2
        for i, (g, w) in enumerate(zip(got, want[d])):
            assert g.shape == w.shape == (LENGTHS[i] * BLOCK,)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=f"{d} {i}")


def _row_fn_jax(units, f0, volume, spk, tframes, bucket):
    """A forward both packages compute alike (``_row_fn_torch``): a
    function of each row's own inputs (padding included), its speaker and
    its real frame count, held for BLOCK samples a frame."""
    live = (jnp.arange(bucket)[None, :] < tframes[:, None]).astype(jnp.float32)
    frame = (jnp.tanh(units.mean(-1) + 0.01 * f0[..., 0] - 2.2) * volume[..., 0] * live
             + 0.01 * spk.astype(jnp.float32) + 1e-3 * tframes[:, None].astype(jnp.float32))
    return jnp.repeat(frame, BLOCK, axis=1)


def _row_fn_torch(units, f0, volume, spk, tframes, bucket):
    live = (torch.arange(bucket)[None, :] < tframes[:, None]).float()
    frame = (torch.tanh(units.mean(-1) + 0.01 * f0[..., 0] - 2.2) * volume[..., 0] * live
             + 0.01 * spk.float() + 1e-3 * tframes[:, None].float())
    return torch.repeat_interleave(frame, BLOCK, dim=1)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_rows_land_where_jax_puts_them(models, d):
    """The same forward in both packages' mesh engines: every row, its
    padding, speaker and frame count, at JAX's tolerance."""
    jm, params, pm = models

    def jbuilder(bucket, sig):
        return lambda p, u, f, v, s, keys, tf: _row_fn_jax(u, f, v, s, tf, bucket)

    def pbuilder(bucket, sig):
        return lambda u, f, v, s, gens, tf: _row_fn_torch(u, f, v, s, tf, bucket)

    reqs = _requests(2)
    jeng = jbatcher.BatchedSynth(jm, params, buckets=BUCKETS, max_batch=4,
                                 max_wait_ms=200.0, mesh=jax_mesh(d),
                                 forward_builder=jbuilder)
    peng = BatchedSynth(pm, buckets=BUCKETS, max_batch=4, max_wait_ms=200.0,
                        mesh=["cpu"] * d, forward_builder=[pbuilder] * d)
    try:
        want = _concurrently([lambda r=r: jeng.infer(
            r[0], r[1], r[2], spk_id=r[3], key=jax.random.PRNGKey(r[4])) for r in reqs])
        got = _serve(peng, reqs)
    finally:
        jeng.close()
        peng.close()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=str(i))


def test_sharded_synth_matches_jax_mesh_engine(models):
    """CombSubSuperFast with the same weights in JAX's mesh engine and the
    port's, the noise branch fed zeros on both sides: each row within the
    model's own tolerance against jitted JAX."""
    jm, params, pm = models

    def jbuilder(bucket, sig):
        def fwd(p, u, f, v, s, keys, tf):
            audio, _, _ = jm.apply({"params": p}, u, f, v, spk_id=s, infer=True,
                                   noise=jnp.zeros((u.shape[0], bucket * BLOCK)))
            return audio
        return fwd

    def pbuilder(model):
        def build(bucket, sig):
            def fwd(u, f, v, s, gens, tf):
                return model(u, f, v, spk_id=s,
                             noise=torch.zeros((u.shape[0], bucket * BLOCK)))[0]
            return fwd
        return build

    reqs = _requests(3)
    jeng = jbatcher.BatchedSynth(jm, params, buckets=BUCKETS, max_batch=4,
                                 max_wait_ms=200.0, mesh=jax_mesh(2),
                                 forward_builder=jbuilder)
    peng = BatchedSynth(pm, buckets=BUCKETS, max_batch=4, max_wait_ms=200.0,
                        mesh=["cpu"] * 2, forward_builder=[
                            pbuilder(m) for m in (pm, copy.deepcopy(pm))])
    try:
        want = _concurrently([lambda r=r: jeng.infer(
            r[0], r[1], r[2], spk_id=r[3], key=jax.random.PRNGKey(r[4])) for r in reqs])
        got = _serve(peng, reqs)
    finally:
        jeng.close()
        peng.close()
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert rel_err(g, w) <= 2e-3, i
        assert snr_db(w, g) >= 60.0, i


@pytest.fixture(scope="module")
def encoders():
    variables = {"params": randomize_tree(
        jh.UnitsEncoder("tiny").variables["params"], seed=61)}
    # JAX's mesh engine places its encoder's variables on the mesh: its own
    return (jh.UnitsEncoder("tiny", params=variables),
            ph.UnitsEncoder("tiny", params=variables, device="cpu"))


def _voice(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f = 200.0 * (1 + 0.05 * np.sin(2 * np.pi * 4 * t)) * (1 + 0.1 * seed)
    a = 0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.01 * rng.standard_normal(n)
    return a.astype(np.float32)


def _cents(a, b) -> float:
    voiced = (a > 0) & (b > 0)
    return float(np.abs(1200 * np.log2(a[voiced] / b[voiced])).max()) if voiced.any() else 0.0


@pytest.mark.parametrize("with_f0", [False, True])
def test_sharded_encoder_matches_single_and_jax(encoders, with_f0):
    """Four concurrent requests of three lengths (one bucket) through the
    port's encoder on a 2-entry mesh, its single-device engine, and JAX's
    encoder on a 2-device mesh."""
    jenc, penc = encoders
    sr = 44100
    lengths = (31 * HOP44, 20 * HOP44 + 77, 17 * HOP44, 25 * HOP44 + 3)
    audios = [_voice(n, sr, i) for i, n in enumerate(lengths)]
    kw = dict(frame_buckets=(32,), max_batch=4, max_wait_ms=200.0, with_f0=with_f0)
    engines = {"single": BatchedEncoder(penc, **kw),
               "mesh": BatchedEncoder(penc, mesh=["cpu"] * 2, **kw),
               "jax": jenc_batcher.BatchedEncoder(jenc, mesh=jax_mesh(2), **kw)}
    out = {}
    try:
        for name, eng in engines.items():
            call = ((lambda a, e=eng: e.encode_with_f0(a, sr, HOP44, shift=2.0))
                    if with_f0 else (lambda a, e=eng: e.encode(a, sr, HOP44)))
            res = _concurrently([lambda a=a, c=call: c(a) for a in audios])
            out[name] = [tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                               for x in (r if with_f0 else (r,))) for r in res]
        assert engines["mesh"].stats()["batches"] == 1
        assert engines["mesh"]._encs[0] is penc and engines["mesh"]._encs[1] is not penc
    finally:
        for eng in engines.values():
            eng.close()
    for i, a in enumerate(audios):
        t = len(a) // HOP44 + 1
        mesh, single, jax_ = out["mesh"][i], out["single"][i], out["jax"][i]
        np.testing.assert_allclose(mesh[0], single[0], rtol=2e-4, atol=2e-5)
        assert rel_err(mesh[0][0, :t], jax_[0][0, :t]) <= 1e-5, i
        if with_f0:
            np.testing.assert_allclose(mesh[1], single[1], rtol=2e-4, atol=2e-5)
            got, want = mesh[1][0, :t, 0], jax_[1][0, :t, 0]
            assert np.array_equal(got > 0, want > 0), i
            assert _cents(got, want) < 0.05, i
            assert np.all(mesh[0][0, t:] == 0.0) and np.all(mesh[1][0, t:] == 220.0)


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_batched_over_a_mesh_matches_single_device(depth):
    """A DiffusionFast pipeline batched over a 2-entry mesh, the encoder in
    the batch: four concurrent recordings against the same requests (same
    seeds) through the same pipeline batched on one device."""
    pipe = _pipeline("DiffusionFast")
    sr, hop = int(pipe.args.data.sampling_rate), int(pipe.args.data.block_size)
    rng = np.random.default_rng(4)
    audios = [(0.3 * np.sin(2 * np.pi * (180.0 + 20 * i) * np.arange(n * hop) / sr)
               + 0.01 * rng.standard_normal(n * hop)).astype(np.float32)
              for i, n in enumerate((15, 12, 7, 14))]
    kw = dict(buckets=(8, 16), max_batch=4, max_wait_ms=200.0, batch_encoder=True,
              pipeline_depth=depth, k_step=20, speedup=10)
    out = {}
    try:
        for name, mesh in (("single", None), ("mesh", ["cpu"] * 2)):
            pipe.enable_batching(mesh=mesh, **kw)
            out[name] = _concurrently([lambda a=a, i=i: pipe.infer(
                a, sr, seed=40 + i, k_step=20, speedup=10)[0]
                for i, a in enumerate(audios)])
            if mesh is not None:
                reps = [f.__self__ for f in pipe.batcher.forward_builder]
                assert reps[0] is pipe and reps[1] is not pipe
                assert reps[1].model is not pipe.model
                assert pipe.enc_batcher.mesh == [torch.device("cpu")] * 2
    finally:
        pipe.disable_batching()
    for i, (g, w) in enumerate(zip(out["mesh"], out["single"])):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=str(i))
