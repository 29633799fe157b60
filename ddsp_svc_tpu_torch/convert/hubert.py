"""HuBERT / ContentVec torch checkpoints -> the port's ``HubertModel``
(mirrors ddsp_svc_tpu/convert/hubert.py). Three upstream layouts:

  - bshall HuBERT-Soft (encoder/hubert/model.py:19-80): a packed
    ``self_attn.in_proj_weight``, the positional conv weight-normed on
    dim 2;
  - fairseq HuBERT-Base/Large and ContentVec: separate q/k/v projections,
    ``feature_extractor.conv_layers.N.0`` convs (biased, with a LayerNorm
    each, in the 'layer_norm' extractor mode of HuBERT-Large),
    ``post_extract_proj``, ``encoder.pos_conv.0``;
  - Hugging Face transformers (chinese-hubert-base, CNHubertSoftFish under
    ``model.`` with a ``proj.1`` head), its positional conv's weight norm
    kept as ``weight_g`` / ``weight_v`` or, since torch 2.1, as
    ``parametrizations.weight.original0`` / ``original1``.

The positional conv's weight norm is folded in numpy as the JAX converter
folds it. The encoder configs are the port's ``features/hubert.py``
``ENCODER_CONFIGS``.
"""
from __future__ import annotations

from ..features.hubert import ENCODER_CONFIGS, HubertConfig
from ..io.jax_params import hubert_variables
from .common import fold_weight_norm, load_state_dict, write_tree


def _attention(out: dict, name: str, q, k, v, o) -> None:
    """(weight, bias) of the q, k, v and out projections -> the port's
    ``attn.{query,key,value,out}``."""
    for proj, (w, b) in zip(("query", "key", "value", "out"), (q, k, v, o)):
        out[f"{name}.{proj}.weight"] = w
        out[f"{name}.{proj}.bias"] = b


def _pair(sd: dict, pre: str) -> tuple:
    return sd[pre + ".weight"], sd[pre + ".bias"]


def _layer(sd: dict, out: dict, i: int, layout: str) -> None:
    pre, n = f"encoder.layers.{i}.", f"layers.{i}"
    if layout == "bshall":
        w, b = sd[pre + "self_attn.in_proj_weight"], sd[pre + "self_attn.in_proj_bias"]
        d = w.shape[1]
        qkv = [(w[j * d:(j + 1) * d], b[j * d:(j + 1) * d]) for j in range(3)]
        _attention(out, f"{n}.attn", *qkv, _pair(sd, pre + "self_attn.out_proj"))
        parts = {"fc1": "linear1", "fc2": "linear2", "norm1": "norm1",
                 "norm2": "norm2"}
    else:
        attn = pre + ("attention." if layout == "hf" else "self_attn.")
        _attention(out, f"{n}.attn",
                   *(_pair(sd, attn + f"{p}_proj") for p in ("q", "k", "v", "out")))
        parts = ({"fc1": "feed_forward.intermediate_dense",
                  "fc2": "feed_forward.output_dense", "norm1": "layer_norm",
                  "norm2": "final_layer_norm"} if layout == "hf" else
                 {"fc1": "fc1", "fc2": "fc2", "norm1": "self_attn_layer_norm",
                  "norm2": "final_layer_norm"})
    for port, up in parts.items():
        out[f"{n}.{port}.weight"], out[f"{n}.{port}.bias"] = _pair(sd, pre + up)


def _layout(sd: dict) -> str:
    if any("pos_conv_embed" in k for k in sd):
        return "hf"
    if any(k.startswith("feature_extractor.conv_layers") for k in sd):
        return "fairseq"
    return "bshall"


def convert_state_dict(sd: dict, config: HubertConfig) -> tuple[dict, dict]:
    """{upstream name: array} -> (the port's state dict for ``config``,
    the upstream leaves the port's model has no place for but the JAX
    converter writes: the final ``norm`` of a pre-LN encoder with an early
    exit)."""
    # CNHubertSoftFish wraps the HF model under 'model.' (ddsp/vocoder.py:330-364)
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    layout = _layout(sd)
    out: dict = {}
    fe = "feature_extractor."
    ln_mode = "feature_extractor.conv_layers.0.2.1.weight" in sd
    for i in range(7):
        conv = {"bshall": f"{fe}conv{i}", "fairseq": f"{fe}conv_layers.{i}.0",
                "hf": f"{fe}conv_layers.{i}.conv"}[layout]
        out[f"{fe}convs.{i}.weight"] = sd[conv + ".weight"]
        if layout == "fairseq" and ln_mode:
            out[f"{fe}convs.{i}.bias"] = sd[conv + ".bias"]
            (out[f"{fe}norms.{i}.weight"],
             out[f"{fe}norms.{i}.bias"]) = _pair(sd, f"{fe}conv_layers.{i}.2.1")
    if not ln_mode:
        norm0 = {"bshall": f"{fe}norm0", "fairseq": f"{fe}conv_layers.0.2",
                 "hf": f"{fe}conv_layers.0.layer_norm"}[layout]
        out[f"{fe}norms.0.weight"], out[f"{fe}norms.0.bias"] = _pair(sd, norm0)
    fp_norm, fp_proj, pos, norm = {
        "bshall": ("feature_projection.norm", "feature_projection.projection",
                   "positional_embedding.conv.", "norm"),
        "fairseq": ("layer_norm", "post_extract_proj", "encoder.pos_conv.0.",
                    "encoder.layer_norm"),
        "hf": ("feature_projection.layer_norm", "feature_projection.projection",
               "encoder.pos_conv_embed.conv.", "encoder.layer_norm"),
    }[layout]
    out["fp_norm.weight"], out["fp_norm.bias"] = _pair(sd, fp_norm)
    out["fp_proj.weight"], out["fp_proj.bias"] = _pair(sd, fp_proj)
    if pos + "weight_v" in sd:
        g, v = sd[pos + "weight_g"], sd[pos + "weight_v"]
    else:  # torch >= 2.1 parametrized weight norm
        g = sd[pos + "parametrizations.weight.original0"]
        v = sd[pos + "parametrizations.weight.original1"]
    out["pos_conv.conv.weight"] = fold_weight_norm(g, v, dim=2)
    out["pos_conv.conv.bias"] = sd[pos + "bias"]
    kept = {}
    if config.final_norm:
        out["norm.weight"], out["norm.bias"] = _pair(sd, norm)
    else:
        kept["norm"] = dict(zip(("scale", "bias"), _pair(sd, norm)))
    for i in range(config.layers_run):
        _layer(sd, out, i, layout)
    if config.proj_dim:
        head = {"bshall": "proj", "fairseq": "final_proj", "hf": "proj.1"}[layout]
        if head + ".weight" not in sd and layout == "fairseq":
            head = "proj"
        if head + ".weight" in sd:
            out["proj.weight"], out["proj.bias"] = _pair(sd, head)
    return out, kept


def hubert_tree(state: dict, kept: dict, config: HubertConfig) -> dict:
    """The JAX variables the JAX converter writes: the port's state dict
    through ``io/jax_params.hubert_variables``, with the kept leaves."""
    variables = hubert_variables(state, config)
    variables["params"].update(kept)
    return variables


def convert_hubert(ckpt_path: str, encoder: str, out_path: str) -> dict:
    """Convert an upstream checkpoint for the encoder named ``encoder``;
    write its JAX variables to ``out_path`` and return the port's state
    dict."""
    config = ENCODER_CONFIGS[encoder]
    state, kept = convert_state_dict(load_state_dict(ckpt_path), config)
    write_tree(out_path, hubert_tree(state, kept, config))
    print(f" [*] {encoder}: {ckpt_path} -> {out_path}")
    return state
