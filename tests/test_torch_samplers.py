"""Each diffusion sampler of the port (models/diffusion.py) step by step
against the JAX package's ``GaussianDiffusion``: the JAX side runs its
sampler with a small flax denoiser and records every denoiser call (x, t,
eps) through an ordered debug callback; the port's ``GaussianDiffusion.
infer`` is then fed those eps values in turn and must reach each call's x
within 1e-5 x max|x|, with the same step labels, and the JAX mel at the
end. The DDPM chain gets the per-step draws the JAX chain makes from its
key."""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ddsp_svc_tpu.models.diffusion import GaussianDiffusion as JGaussianDiffusion
from ddsp_svc_tpu_torch.models.diffusion import GaussianDiffusion
from torch_helpers import rel_err, tt

K_STEP, B, T, M = 100, 2, 12, 16


class ToyDenoiser(fnn.Module):
    """eps(x, t, cond): two projections and a step offset, through tanh."""

    @fnn.compact
    def __call__(self, x, t, cond, deterministic=True):
        h = fnn.Dense(M)(x) + fnn.Dense(M)(cond) + 0.002 * t[:, None, None]
        return jnp.tanh(h)


def jax_run(sampler, speedup):
    """(JAX mel, [(x, t, eps) per denoiser call], init noise, gt mel,
    the chain's per-step draws)."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(-10.0, 1.0, (B, T, M)).astype(np.float32)
    noise = rng.standard_normal((B, T, M)).astype(np.float32)
    diff = JGaussianDiffusion(denoise_fn=ToyDenoiser(), out_dims=M, k_step=K_STEP)
    key = jax.random.PRNGKey(5)
    variables = diff.init(key, jnp.asarray(gt), gt_spec=jnp.asarray(gt),
                          infer=True, infer_speedup=50, k_step=K_STEP,
                          key=key, init_noise=jnp.asarray(noise))
    calls = []

    def record(x, t, e):
        calls.append((np.asarray(x), np.asarray(t), np.asarray(e)))

    def wrapper(eps_fn):
        def wrapped(x, t):
            e = eps_fn(x, t)
            jax.debug.callback(record, x, t, e, ordered=True)
            return e
        return wrapped

    mel = jax.jit(lambda v, g, n: diff.apply(
        v, g, gt_spec=g, infer=True, infer_speedup=speedup, sampler=sampler,
        k_step=K_STEP, key=key, init_noise=n, denoise_wrapper=wrapper))(
        variables, jnp.asarray(gt), jnp.asarray(noise))
    mel = np.asarray(mel)
    jax.effects_barrier()
    # the chain's draws: jax.random.split(key) -> (init, chain); one normal
    # per step from split(chain, K_STEP), in the order the steps run
    _, key_chain = jax.random.split(key)
    draws = np.stack([np.asarray(jax.random.normal(k, (B, T, M), jnp.float32))
                      for k in jax.random.split(key_chain, K_STEP)])
    return mel, calls, noise, gt, draws


@pytest.mark.parametrize("sampler,speedup,n_calls", [
    ("ddim", 10, 10), ("ddim", 33, 4),
    ("pndm", 10, 11), ("pndm", 25, 5),  # a Heun start: one extra call
    ("unipc", 10, 10), ("unipc", 25, 4), ("unipc", 50, 2),
    ("dpm-solver", 10, 10), ("dpm-solver", 25, 4),
    ("dpm-solver", 1, 100)])  # speedup 1: the full DDPM chain
def test_sampler_steps_match_jax(sampler, speedup, n_calls):
    want, calls, noise, gt, draws = jax_run(sampler, speedup)
    assert len(calls) == n_calls
    seen = []

    def teacher(x, t):
        i = len(seen)
        seen.append(x.clone())
        np.testing.assert_allclose(t.numpy(), calls[i][1], rtol=1e-6, atol=1e-5)
        return tt(calls[i][2])

    got = GaussianDiffusion().infer(teacher, tt(gt), K_STEP, speedup, sampler,
                                    init_noise=tt(noise), chain_noise=tt(draws))
    assert len(seen) == n_calls
    for i, x in enumerate(seen):
        assert rel_err(x, calls[i][0]) <= 1e-5, i
    assert rel_err(got, want) <= 1e-5


def test_chain_draws_from_the_generator():
    """Without injected draws the chain takes them from the generator:
    the same seed gives the same mel, another seed another."""
    gt = torch.zeros((1, 4, M))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return GaussianDiffusion().infer(lambda x, t: torch.tanh(x), gt, 20, 1,
                                         init_noise=torch.ones_like(gt),
                                         generator=gen)

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_unknown_sampler_raises():
    with pytest.raises(NotImplementedError, match="euler"):
        GaussianDiffusion().infer(lambda x, t: x, torch.zeros((1, 4, M)), 20,
                                  10, "euler")
