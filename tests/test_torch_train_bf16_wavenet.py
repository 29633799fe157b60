"""bf16 mixed-precision training of the WaveNet cascades against the JAX
package (``dtype=bfloat16`` on both sides): one step of Unit2Mel
(Diffusion) and Unit2Wav (DiffusionNew) against JAX's config-built bf16
models, held by the gate of ``torch_bf16_helpers``; the two planted faults
(the bias added before a bf16 conv's rounding; the WaveNet left in
float32) each fail it."""
import pytest

import torch_bf16_helpers as h


@pytest.mark.parametrize("mtype", ["Diffusion", "DiffusionNew"])
def test_bf16_wavenet_step(mtype, monkeypatch):
    args, jmodel, variables, port, (x, noise, probe), key = h.setup(mtype)
    jres = h.jax_step(mtype, jmodel, variables, x, noise, probe, key)
    pres = h.port_step(mtype, port, x, noise, probe, key)
    g = h.gate(mtype, jres, pres)
    print(mtype, "bf16 step against JAX:", g)
    assert g["ok"], (mtype, g)

    with monkeypatch.context() as m:
        h.bias_before_rounding(m)
        fault = h.gate(mtype, jres, h.port_step(mtype, port, x, noise, probe, key))
    print(mtype, "bias before rounding:", fault)
    assert not fault["ok"], ("bias fault passes", mtype, fault)
    h.f32_stage(mtype, port)
    fault = h.gate(mtype, jres, h.port_step(mtype, port, x, noise, probe, key))
    print(mtype, "a stage left in f32:", fault)
    assert not fault["ok"], ("f32 stage passes", mtype, fault)
