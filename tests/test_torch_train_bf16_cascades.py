"""bf16 mixed-precision training of the NaiveV2Diff cascades against the
JAX package (``dtype=bfloat16`` on both sides): one step of DiffusionFast
and RectifiedFlow against JAX cascades built with ``trunk_pallas=True``
(the fused layer, B5's class, in interpret mode), held by the gate of
``torch_bf16_helpers``; the two planted faults (the bias added before a
bf16 conv's rounding; the trunk left in float32) each fail it. Unit2Mel
and Unit2Wav are ``test_torch_train_bf16_wavenet.py``'s."""
import pytest

import torch_bf16_helpers as h
from ddsp_svc_tpu.ops import pallas_conformer as jpc


@pytest.mark.parametrize("mtype", ["DiffusionFast", "RectifiedFlow"])
def test_bf16_cascade_step(mtype, monkeypatch):
    monkeypatch.setattr(jpc, "fused_conformer_layer", h.fused_conformer_layer)
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
