"""The plain reference of the served conversion: float32 PyTorch with no
kernel, cache or batcher of the port, and nothing imported from it.

It follows upstream DDSP-SVC (yxlllc/DDSP-SVC: contentvec768l12 units, YIN
f0, CombSubSuperFast, the NaiveV2Diff denoiser under DPM-Solver++ or the
rectified flow under Euler, NSF-HiFiGAN) as the port states its arithmetic,
a frozen copy of the port's plain functions written out again. Every
parameter comes from a dict keyed by the port's state-dict names
(``params.spec``), which the benchmark fills from the seed and hands to both
sides. ``request`` holds one request's front end and a served batch's
synthesis, with the batcher's padding and row slicing.
"""
