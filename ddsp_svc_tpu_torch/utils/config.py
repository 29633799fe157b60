"""Config access (mirrors ddsp_svc_tpu/utils/config.py: DotDict,
load_config, save_config, traverse_dir), with a YAML reader and writer in
the standard library for the subset the configs use.

The subset: block maps of ``key: value`` nested by indentation, block
sequences of ``- item`` lines (nested ones too), flow lists ``[a, [b, c]]`` and flow maps ``{a: 1,
b: x}`` (which may continue on more-indented lines), plain, 'single' and
"double" quoted scalars, and ``#`` comments.
Plain scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1:
ints, floats with a dot, yes/no/on/off/true/false, ~/null). Anything else
(anchors, multi-line strings, documents) raises.
"""
from __future__ import annotations

import math
import os
import re
from typing import Any


class DotDict(dict):
    """dict with attribute access; nested dicts are wrapped lazily.
    Missing keys return None, which the config schema relies on (e.g. an
    optional ``model.use_pitch_aug``)."""

    def __getattr__(*args):
        val = dict.get(*args)
        return DotDict(val) if type(val) is dict else val

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)


def _plain_scalar(text: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (outside quotes)."""
    quote, escaped = None, False
    for i, ch in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif ch == "\\" and quote == '"':
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Scanner:
    """Flow-context and single-line scalars of one value text."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str):
        return ValueError(f"{self.where}: {msg} in {self.s!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, flow: bool):
        self.skip()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            self.i += 1
            items = []
            self.skip()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return items
            while True:
                items.append(self.value(flow=True))
                self.skip()
                if self.s[self.i:self.i + 1] == ",":
                    self.i += 1
                elif self.s[self.i:self.i + 1] == "]":
                    self.i += 1
                    return items
                else:
                    raise self.error("expected ',' or ']'")
        if ch == "{":
            self.i += 1
            out = {}
            self.skip()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            while True:
                self.skip()
                m = re.compile(r"([^,\[\]{}:]+?)\s*:(\s|(?=[,}]))").match(
                    self.s, self.i)
                if not m:
                    raise self.error("expected 'key: value' in a flow map")
                self.i = m.end()
                out[_plain_scalar(m.group(1).strip())] = self.value(flow=True)
                self.skip()
                if self.s[self.i:self.i + 1] == ",":
                    self.i += 1
                elif self.s[self.i:self.i + 1] == "}":
                    self.i += 1
                    return out
                else:
                    raise self.error("expected ',' or '}'")
        if ch == "'":
            out, self.i = [], self.i + 1
            while True:
                j = self.s.find("'", self.i)
                if j < 0:
                    raise self.error("unterminated quote")
                out.append(self.s[self.i:j])
                if self.s[j + 1:j + 2] == "'":
                    out.append("'")
                    self.i = j + 2
                else:
                    self.i = j + 1
                    return "".join(out)
        if ch == '"':
            j, out = self.i + 1, []
            escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
                       "0": "\0", "r": "\r"}
            while j < len(self.s) and self.s[j] != '"':
                if self.s[j] == "\\":
                    if self.s[j + 1] not in escapes:
                        raise self.error("unsupported escape")
                    out.append(escapes[self.s[j + 1]])
                    j += 2
                else:
                    out.append(self.s[j])
                    j += 1
            if j >= len(self.s):
                raise self.error("unterminated quote")
            self.i = j + 1
            return "".join(out)
        if ch in "&*!|>%@`":
            raise self.error(f"unsupported YAML ({ch!r})")
        stop = ",]}" if flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop:
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return _plain_scalar(text)

    def whole(self):
        v = self.value(flow=False)
        self.skip()
        if self.i != len(self.s):
            raise self.error("unexpected text after the value")
        return v


def _split_key(text: str, where: str):
    """'key: value' -> (key, value text) or None when the line is no
    mapping entry."""
    if text[:1] in "'\"":
        key = _Scanner(text, where)
        k = key.value(flow=True)
        rest = text[key.i:]
        if not rest.startswith(":"):
            return None
        return k, rest[1:]
    m = re.match(r"^([^:#\[\]{},'\"]+?)\s*:(\s|$)", text)
    if not m:
        return None
    return _plain_scalar(m.group(1)), text[m.end():]


def loads(text: str, where: str = "<yaml>"):
    """The YAML subset of the configs -> Python objects, as ``safe_load``."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("---", "..."):
            raise ValueError(f"{where}:{n}: document markers are not supported")
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in body[:len(body) - len(body.lstrip())]:
                raise ValueError(f"{where}:{n}: tab indentation")
            lines.append((len(body) - len(body.lstrip()), body.strip(), n))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0], where)
    if pos != len(lines):
        raise ValueError(f"{where}:{lines[pos][2]}: unexpected indentation")
    return value


def _depth(text: str) -> int:
    """Open flow brackets at the end of ``text`` (outside quotes)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _block(lines, pos, indent, where):
    """The block node whose lines start at ``pos`` with ``indent``."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            _, text, n = lines[pos]
            item = text[1:].strip()
            if not item:
                raise ValueError(f"{where}:{n}: empty block items are not "
                                 "supported")
            if item.startswith("- ") or _split_key(item, where) is not None:
                # "- - x" or "- key: v": a nested block starting at the item
                off = len(text) - len(item)
                lines[pos] = (indent + off, item, n)
                value, pos = _block(lines, pos, indent + off, where)
                out.append(value)
                continue
            out.append(_Scanner(item, f"{where}:{n}").whole())
            pos += 1
        return out, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        ind, text, n = lines[pos]
        kv = _split_key(text, f"{where}:{n}")
        if kv is None:
            raise ValueError(f"{where}:{n}: expected 'key: value', got {text!r}")
        key, rest = kv
        pos += 1
        # a flow collection may continue on more-indented lines
        while _depth(rest) > 0 and pos < len(lines) and lines[pos][0] > indent:
            rest = rest + " " + lines[pos][1]
            pos += 1
        if rest.strip():
            out[key] = _Scanner(rest, f"{where}:{n}").whole()
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("-"))):
            out[key], pos = _block(lines, pos, lines[pos][0], where)
        else:
            out[key] = None
    return out, pos


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text:  # 1e-05 -> 1.0e-05, as YAML 1.1 wants
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _flow(v) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_flow(x)}"
                               for k, x in v.items()) + "}"
    return _scalar_text(v)


def dumps(tree: dict) -> str:
    """A tree of dicts, lists and scalars -> YAML that ``loads`` and
    ``yaml.safe_load`` read back to the same tree: block maps in key order,
    lists in flow style, strings single-quoted."""
    out: list[str] = []

    def emit(node: dict, indent: int):
        for k, v in node.items():
            key = k if isinstance(k, str) and re.match(r"^[A-Za-z_][\w.\-]*$", k) \
                and _plain_scalar(k) == k else _scalar_text(k)
            if isinstance(v, dict) and v:
                out.append(" " * indent + f"{key}:")
                emit(v, indent + 2)
            else:
                out.append(" " * indent + f"{key}: {_flow(v)}")

    emit(tree, 0)
    return "\n".join(out) + "\n"


def load_config(path_config: str | os.PathLike) -> DotDict:
    """Load a config (the reference schema, configs/*.yaml)."""
    with open(path_config, "r") as f:
        return DotDict(loads(f.read(), str(path_config)))


def save_config(path_config: str | os.PathLike, config: dict) -> None:
    """Write a config snapshot (as the JAX saver's ``config.yaml``)."""
    with open(path_config, "w") as f:
        f.write(dumps(_plain(config)))


def _plain(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def traverse_dir(root_dir: str, extensions: list[str], is_pure: bool = False,
                 is_sort: bool = False) -> list[str]:
    """Files under ``root_dir`` ending in '.<ext>' (the port's copy of the
    JAX ``traverse_dir`` for the arguments the data pipeline passes);
    ``is_pure`` gives paths relative to ``root_dir``."""
    file_list = []
    for root, _, files in os.walk(root_dir):
        for file in files:
            if any(file.endswith(f".{ext.lstrip('.')}") for ext in extensions):
                path = os.path.join(root, file)
                file_list.append(path[len(root_dir) + 1:] if is_pure else path)
    if is_sort:
        file_list.sort()
    return file_list
