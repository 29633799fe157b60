"""Numpy evaluator for the exported ONNX op subset, opset 13-17 forms (the
port's copy of ddsp_svc_tpu/onnx/runtime.py).

Executes a reader.Graph on concrete inputs: enough to validate exported
artifacts end to end without onnxruntime and to drive the external app's
PNDM loop in validate.py. Not a general ONNX runtime: it implements
exactly the ops torch's exporter emits for the four graphs, and raises on
anything else.
"""
from __future__ import annotations

import numpy as np

from .reader import TENSOR_DTYPES, Graph, Model, Node


def _conv(x, w, b, attrs):
    """ONNX Conv, 1-D only (N, C, L). Supports pads/dilations/strides/group."""
    if x.ndim != 3:
        raise NotImplementedError(f"Conv rank {x.ndim}")
    pads = attrs.get("pads", [0, 0])
    strides = attrs.get("strides", [1])
    dilations = attrs.get("dilations", [1])
    group = attrs.get("group", 1)
    stride, dil = strides[0], dilations[0]
    pl, pr = pads[0], pads[-1]
    if pl or pr:
        x = np.pad(x, ((0, 0), (0, 0), (pl, pr)))
    n, cin, length = x.shape
    cout, cin_g, k = w.shape
    out_len = (length - dil * (k - 1) - 1) // stride + 1
    out = np.zeros((n, cout, out_len), dtype=np.result_type(x, w))
    for g in range(group):
        xg = x[:, g * cin_g : (g + 1) * cin_g]
        wg = w[g * (cout // group) : (g + 1) * (cout // group)]
        acc = np.zeros((n, cout // group, out_len), dtype=out.dtype)
        for tap in range(k):
            sl = xg[:, :, tap * dil : tap * dil + (out_len - 1) * stride + 1 : stride]
            acc += np.einsum("ncl,oc->nol", sl, wg[:, :, tap])
        out[:, g * (cout // group) : (g + 1) * (cout // group)] = acc
    if b is not None:
        out += b[None, :, None]
    return out


def _pad(data, pads, value=0.0, mode=b"constant"):
    if mode not in (b"constant", "constant"):
        raise NotImplementedError(f"Pad mode {mode}")
    r = data.ndim
    widths = [(int(pads[i]), int(pads[i + r])) for i in range(r)]
    return np.pad(data, widths, constant_values=value)


def _slice(data, starts, ends, axes=None, steps=None):
    r = data.ndim
    axes = list(range(r)) if axes is None else [int(a) % r for a in axes]
    steps = [1] * len(starts) if steps is None else [int(s) for s in steps]
    sl = [slice(None)] * r
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax] = slice(int(st), int(en), sp)
    return data[tuple(sl)]


def _reshape(data, shape, allowzero=0):
    shape = [int(s) for s in shape]
    if not allowzero:
        shape = [data.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return data.reshape(shape)


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _eval_node(node: Node, env: dict) -> None:
    op = node.op_type
    ins = [env[i] if i else None for i in node.inputs]
    a = node.attributes

    def out(*vals):
        for name, v in zip(node.outputs, vals):
            env[name] = v

    if op == "Constant":
        t = a.get("value")
        if t is None:
            raise NotImplementedError("Constant without tensor value")
        out(t.array)
    elif op == "Shape":
        out(np.asarray(ins[0].shape, dtype=np.int64))
    elif op == "ConstantOfShape":
        shape = [int(s) for s in ins[0]]
        t = a.get("value")
        if t is None:
            out(np.zeros(shape, dtype=np.float32))
        else:
            out(np.full(shape, t.array.reshape(-1)[0], dtype=t.array.dtype))
    elif op == "Cast":
        out(ins[0].astype(TENSOR_DTYPES[a["to"]]))
    elif op == "Add":
        out(ins[0] + ins[1])
    elif op == "Sub":
        out(ins[0] - ins[1])
    elif op == "Mul":
        out(ins[0] * ins[1])
    elif op == "Div":
        x, y = ins
        if np.issubdtype(np.asarray(x).dtype, np.integer) and np.issubdtype(
            np.asarray(y).dtype, np.integer
        ):
            out(x // y)
        else:
            out(x / y)
    elif op == "Reciprocal":
        out(1.0 / ins[0])
    elif op == "Sqrt":
        out(np.sqrt(ins[0]))
    elif op == "Log":
        out(np.log(ins[0]))
    elif op == "Exp":
        out(np.exp(ins[0]))
    elif op == "Sin":
        out(np.sin(ins[0]))
    elif op == "Cos":
        out(np.cos(ins[0]))
    elif op == "Tanh":
        out(np.tanh(ins[0]))
    elif op == "Sigmoid":
        x = ins[0]
        out(np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                     np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x)))).astype(x.dtype))
    elif op == "Relu":
        out(np.maximum(ins[0], 0))
    elif op == "Softplus":
        out(_softplus(ins[0]).astype(ins[0].dtype))
    elif op == "Neg":
        out(-ins[0])
    elif op == "Pow":
        out(np.power(ins[0], ins[1]))
    elif op == "MatMul":
        out(np.matmul(ins[0], ins[1]))
    elif op == "Gemm":
        x, w = ins[0], ins[1]
        if a.get("transA", 0):
            x = x.T
        if a.get("transB", 0):
            w = w.T
        y = a.get("alpha", 1.0) * (x @ w)
        if len(ins) > 2 and ins[2] is not None:
            y = y + a.get("beta", 1.0) * ins[2]
        out(y)
    elif op == "Conv":
        out(_conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None, a))
    elif op == "Concat":
        out(np.concatenate(ins, axis=a["axis"]))
    elif op == "Split":
        axis = a.get("axis", 0)
        if len(ins) > 1 and ins[1] is not None:
            sizes = [int(s) for s in ins[1]]
            idx = np.cumsum(sizes)[:-1]
            out(*np.split(ins[0], idx, axis=axis))
        else:
            out(*np.split(ins[0], len(node.outputs), axis=axis))
    elif op == "Squeeze":
        axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
        if axes is None:
            out(np.squeeze(ins[0]))
        else:
            out(np.squeeze(ins[0], axis=tuple(int(x) for x in np.atleast_1d(axes))))
    elif op == "Unsqueeze":
        axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
        y = ins[0]
        for ax in sorted(int(x) for x in np.atleast_1d(axes)):
            y = np.expand_dims(y, ax if ax >= 0 else ax + y.ndim + 1)
        out(y)
    elif op == "Reshape":
        out(_reshape(ins[0], ins[1], a.get("allowzero", 0)))
    elif op == "Transpose":
        out(np.transpose(ins[0], a.get("perm")))
    elif op == "Slice":
        out(_slice(ins[0], ins[1], ins[2],
                   ins[3] if len(ins) > 3 else None,
                   ins[4] if len(ins) > 4 else None))
    elif op == "Pad":
        value = ins[2].reshape(-1)[0] if len(ins) > 2 and ins[2] is not None else 0.0
        out(_pad(ins[0], ins[1], value, a.get("mode", b"constant")))
    elif op == "Gather":
        out(np.take(ins[0], ins[1].astype(np.int64), axis=a.get("axis", 0)))
    elif op == "GatherElements":
        out(np.take_along_axis(ins[0], ins[1].astype(np.int64), axis=a.get("axis", 0)))
    elif op == "Expand":
        target = np.broadcast_shapes(ins[0].shape, tuple(int(s) for s in ins[1]))
        out(np.broadcast_to(ins[0], target))
    elif op == "Tile":
        out(np.tile(ins[0], [int(r) for r in ins[1]]))
    elif op == "Identity":
        out(ins[0])
    elif op == "Where":
        out(np.where(ins[0], ins[1], ins[2]))
    elif op == "Equal":
        out(ins[0] == ins[1])
    elif op == "Greater":
        out(ins[0] > ins[1])
    elif op == "Range":
        out(np.arange(ins[0].item(), ins[1].item(), ins[2].item(),
                      dtype=np.asarray(ins[0]).dtype))
    elif op == "ReduceSum":
        axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
        kd = bool(a.get("keepdims", 1))
        ax = tuple(int(x) for x in np.atleast_1d(axes)) if axes is not None else None
        out(np.sum(ins[0], axis=ax, keepdims=kd))
    elif op == "ReduceMean":
        axes = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("axes")
        kd = bool(a.get("keepdims", 1))
        ax = tuple(int(x) for x in np.atleast_1d(axes)) if axes is not None else None
        out(np.mean(ins[0], axis=ax, keepdims=kd))
    else:
        raise NotImplementedError(f"op {op}")


def run_graph(graph: Graph, inputs: dict) -> dict:
    """Execute graph on {input_name: ndarray}; returns {output_name: ndarray}."""
    env = dict(graph.initializers)
    for vi in graph.inputs:
        if vi.name not in inputs and vi.name not in env:
            raise KeyError(f"missing input {vi.name!r}")
    env.update({k: np.asarray(v) for k, v in inputs.items()})
    for node in graph.nodes:
        _eval_node(node, env)
    return {vi.name: env[vi.name] for vi in graph.outputs}


def run_model(model: Model, inputs: dict) -> dict:
    return run_graph(model.graph, inputs)
