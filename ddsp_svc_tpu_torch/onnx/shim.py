"""torch.onnx export without the ``onnx`` wheel (the port's copy of
ddsp_svc_tpu/onnx/shim.py:22-47).

The TorchScript exporter serializes the ModelProto in C++; the only place
it imports the python ``onnx`` package on the default path is
``onnx_proto_utils._add_onnxscript_fn``, which re-parses the serialized
bytes to collect onnxscript custom functions. The four graphs contain none
(standard opset ops only), so when the wheel is absent that scan is
patched to the identity for the duration of the export call.

The module is private to torch. Where a torch build does not have it, the
export raises and names it: it never falls back to another exporter.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util

PROTO_UTILS = "torch.onnx._internal.torchscript_exporter.onnx_proto_utils"


def _onnx_wheel_available() -> bool:
    return importlib.util.find_spec("onnx") is not None


@contextlib.contextmanager
def onnx_export_context():
    """Context manager under which ``torch.onnx.export(dynamo=False)`` works
    with or without the ``onnx`` python package installed."""
    if _onnx_wheel_available():
        yield
        return
    try:
        proto_utils = importlib.import_module(PROTO_UTILS)
        orig = proto_utils._add_onnxscript_fn
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            f"this torch build has no {PROTO_UTILS}._add_onnxscript_fn, which "
            "the ONNX export patches to run without the onnx wheel") from e
    proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        yield
    finally:
        proto_utils._add_onnxscript_fn = orig


def torch_onnx_export(module, args, path, **kwargs):
    """torch.onnx.export via the TorchScript exporter, wheel-optional."""
    import warnings

    import torch

    with onnx_export_context(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.onnx.export(module, args, path, dynamo=False, **kwargs)
