"""ONNX export for the external apps (MoeVoiceStudio etc.), the port's
counterpart of ddsp_svc_tpu/onnx/.

The reference ships diffusion/onnx_export.py + diffusion_onnx.py, which
emit four ONNX graphs from a trained Unit2Mel ('Diffusion') checkpoint:
encoder / denoise / pred / after. This package writes them from a
JAX-format checkpoint loaded into the port:

- ``mirrors``: the four graph modules over the loaded model's own
  submodules, in the NCW layout the apps expect (no weight is copied, so
  the JAX package's ``reverse`` has no counterpart here);
- ``shim``: makes torch's C++ ONNX serializer usable without the ``onnx``
  wheel;
- ``export``: the function emitting the four graphs;
- ``reader``: a pure-python ONNX protobuf parser (no onnx wheel);
- ``runtime``: a numpy evaluator for the exported op subset;
- ``validate``: drives the four graphs through the external app's PNDM
  loop and compares them with the port's eager model.
"""

from .export import export_onnx  # noqa: F401
