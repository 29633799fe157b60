"""bf16 mixed-precision training of the DDSP synths against the JAX package
(``dtype=bfloat16`` on both sides): one step of Sins, CombSub, CombSubFast
and CombSubSuperFast held by the gate of ``torch_bf16_helpers`` (module
outputs' dtypes, the first bf16 layer's elements, the loss terms and the
gradients), and the two planted faults -- the bias added before a bf16
conv's rounding, and Unit2Control left in float32 -- each failing it."""
import pytest

import torch_bf16_helpers as h
from ddsp_svc_tpu.models import ddsp as jddsp


@pytest.mark.parametrize("mtype", ["Sins", "CombSub", "CombSubFast",
                                   "CombSubSuperFast"])
def test_bf16_synth_step(mtype, monkeypatch):
    args, jmodel, variables, port, (x, noise, probe), key = h.setup(mtype)
    jres = h.jax_step(mtype, jmodel, variables, x, noise, probe, key)
    g = h.gate(mtype, jres, h.port_step(mtype, port, x, noise, probe, key))
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
    if mtype == "Sins":  # the bank patched to upsample in f32, reported
        monkeypatch.setattr(jddsp, "sins_harmonic_bank", h.k4_class_bank)
        patched = h.jax_step(mtype, jmodel, variables, x, noise, probe, key)
        print("Sins, JAX's bank with the amplitudes widened first against "
              "its own (loss, gradients):", h.distance(patched, jres))
