"""Shared parts of the f0 front end's parity tests (``test_torch_f0_*.py``).

The JAX nets' variables are drawn with numpy from the shapes of their init
(``jax.eval_shape``, no forward runs): conv and dense kernels and biases
U(-1/sqrt(fan_in), +), BatchNorm scales U(0.8, 1.2), biases and means
U(-0.1, 0.1), variances U(0.5, 1.5), a weight-normed Dense's gain the norm
of its direction (as flax inits it). ``peak`` raises the output layer's
bias by ``PEAK`` at the bin of ``PEAK_HZ``: at random init the 360
saliences sit near-tied around one value, so an argmax flips on a 1e-7
difference and the decoded f0 jumps by octaves; with the peak the decoded
f0 is decisive on both sides.
"""
import math

import numpy as np

import jax
import jax.numpy as jnp

import torch_helpers  # noqa: F401  (torch's threads under xdist)

PEAK = 4.0
PEAK_HZ = 220.0


def _draw(path: str, shape, rng, fan_in: dict) -> np.ndarray:
    leaf = path.rsplit("/", 1)[-1]
    scope = path.rsplit("/", 1)[0]
    if leaf in ("kernel", "kernel_v"):
        bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
        fan_in[scope] = bound
        return rng.uniform(-bound, bound, shape)
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "bias" and scope in fan_in:
        return rng.uniform(-fan_in[scope], fan_in[scope], shape)
    return rng.uniform(-0.1, 0.1, shape)


def draw_variables(shapes, seed: int) -> dict:
    """A flax variables tree of numpy float32 leaves drawn for ``shapes``
    (a tree of ``ShapeDtypeStruct``), in sorted path order."""
    rng = np.random.default_rng(seed)
    fan_in: dict = {}

    def walk(node, prefix):
        out = {}
        # a scope's bias after its kernel, whose fan-in bounds it
        for k in sorted(node, key=lambda k: (k == "bias", k)):
            v = node[k]
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(dict(v), path)
            else:
                out[k] = _draw(path, v.shape, rng, fan_in).astype(np.float32)
        return out

    tree = walk(dict(shapes), "")
    _fold_gains(tree)
    return tree


def _fold_gains(node) -> None:
    for k, v in node.items():
        if isinstance(v, dict):
            if "kernel_g" in v and "kernel_v" in v:
                v["kernel_g"] = np.linalg.norm(v["kernel_v"], axis=0).astype(
                    np.float32)
            _fold_gains(v)


def peak_bin(kind: str) -> int:
    """The output bin nearest ``PEAK_HZ`` in ``kind``'s cents grid."""
    cents = 1200.0 * math.log2(PEAK_HZ / 10.0)
    if kind == "fcpe":
        from ddsp_svc_tpu.features.fcpe import cent_table

        return int(np.argmin(np.abs(cent_table() - cents)))
    return int(round((cents - 1997.3794084376191) / 20.0))


OUTPUT_LAYER = {"rmvpe": "fc", "crepe": "classifier", "fcpe": "output_proj"}


def with_peak(kind: str, variables: dict) -> dict:
    """``variables`` with the output layer's bias raised by ``PEAK`` at the
    bin of ``PEAK_HZ``."""
    bias = variables["params"][OUTPUT_LAYER[kind]]["bias"]
    bias = bias.copy()
    bias[peak_bin(kind)] += PEAK
    variables["params"][OUTPUT_LAYER[kind]]["bias"] = bias
    return variables


def jax_net(kind: str, **cfg):
    """(JAX module, its init's input) for ``kind`` at ``cfg``'s width."""
    if kind == "rmvpe":
        from ddsp_svc_tpu.features.rmvpe import E2E0

        return E2E0(**cfg), jnp.zeros((1, 32, 128))
    if kind == "crepe":
        from ddsp_svc_tpu.features.crepe import Crepe

        return Crepe(), jnp.zeros((1, 1024))
    from ddsp_svc_tpu.features.fcpe import CFNaiveMelPE

    return CFNaiveMelPE(**cfg), jnp.zeros((1, 8, 128))


def net_variables(kind: str, seed: int, peak: bool = False, **cfg) -> dict:
    """Numpy variables for the JAX net ``kind`` at ``cfg``'s width."""
    net, x = jax_net(kind, **cfg)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x))
    variables = draw_variables(shapes, seed)
    return with_peak(kind, variables) if peak else variables


def voice(seconds: float, sr: int, seed: int, f0: float = PEAK_HZ) -> np.ndarray:
    """A harmonic voice-like tone with vibrato and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    inst = f0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    x = 0.3 * x / np.max(np.abs(x)) + 0.003 * rng.standard_normal(len(t))
    return x.astype(np.float32)
