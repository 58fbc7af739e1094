"""Hydra-style composition of the YAML config tree, with a YAML-subset reader.

The composition semantics are those of ``breaching_tpu/config/loader.py``:
``defaults:`` lists (``- data: CIFAR10``, ``- _self_``, same-group
inheritance), group swaps (``attack=deepleakage``, ``case/data=CIFAR100``),
dotted leaf overrides (``case.user.num_data_points=4``) and attribute access on
the composed config.

The port depends on nothing beyond torch, numpy and the standard library, so the
tree is parsed by :func:`parse_yaml`, a reader of the YAML subset the tree uses:
block mappings and sequences, single-line flow sequences, plain and quoted
scalars resolved as YAML 1.1 does it (``24_000`` is an int, ``1.0e-4`` a float,
``~`` and an empty value are null, ``True``/``yes``/``off`` are bools), and
``#`` comments. Anything outside that subset raises ``ValueError``.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Iterable

CONFIG_ROOT = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------------------------------------- YAML subset

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _plain_scalar(text: str) -> Any:
    """Resolve an unquoted scalar with YAML 1.1's implicit types."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign, body = (-1, text[1:]) if text[0] == "-" else (1, text.lstrip("+"))
        body = body.replace("_", "")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        lowered = text.replace("_", "").lower()
        if lowered.endswith("inf"):
            return float("-inf") if lowered.startswith("-") else float("inf")
        if lowered.endswith("nan"):
            return float("nan")
        return float(lowered)
    return text


def _quoted_scalar(text: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    out, i, body = [], 0, text[1:-1]
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}
    while i < len(body):
        if body[i] == "\\":
            if body[i + 1] not in escapes:
                raise ValueError(f"Unsupported escape in YAML string {text!r}.")
            out.append(escapes[body[i + 1]])
            i += 2
        else:
            out.append(body[i])
            i += 1
    return "".join(out)


def _split_flow(body: str) -> list[str]:
    """Split the inside of a flow sequence on top-level commas."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            escaped = quote == '"' and i > 0 and body[i - 1] == "\\"
            quote = None if ch == quote and not escaped else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    return [p.strip() for p in parts]


def _scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [] if not inner else [_scalar(p) for p in _split_flow(inner)]
    if text[:1] in ("{", "&", "*", "!", "|", ">"):
        raise ValueError(f"YAML feature outside the supported subset: {text!r}.")
    if len(text) >= 2 and text[0] in "'\"" and text[-1] == text[0]:
        return _quoted_scalar(text)
    return _plain_scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            escaped = quote == '"' and line[i - 1] == "\\"
            quote = None if ch == quote and not escaped else quote
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """Return (key, rest) if ``text`` is a mapping entry ``key: rest``, else None."""
    quote, depth = None, 0
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return _scalar(text[:i]), text[i + 1:].strip()
    return None


class _Reader:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError("Tabs in YAML indentation are not supported.")
            line = _strip_comment(raw)
            if line.strip() and line.strip() not in ("---", "..."):
                self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else (-1, "")

    def block(self, indent: int) -> Any:
        ind, text = self.peek()
        if ind != indent:
            raise ValueError(f"Bad YAML indentation at {text!r}.")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def value_after_key(self, rest: str, indent: int) -> Any:
        if rest:
            return _scalar(rest)
        ind, text = self.peek()
        if ind > indent:
            return self.block(ind)
        if ind == indent and (text == "-" or text.startswith("- ")):
            return self.sequence(indent)  # a sequence may sit at its key's indentation
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            ind, text = self.peek()
            if ind != indent or text == "-" or text.startswith("- "):
                if ind > indent:
                    raise ValueError(f"Bad YAML indentation at {text!r}.")
                return out
            self.pos += 1
            entry = _split_key(text)
            if entry is None:
                raise ValueError(f"Expected 'key: value' in YAML, got {text!r}.")
            key, rest = entry
            out[key] = self.value_after_key(rest, indent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            ind, text = self.peek()
            if ind != indent or not (text == "-" or text.startswith("- ")):
                return out
            self.pos += 1
            item = text[1:].strip()
            if not item:
                nxt = self.peek()[0]
                out.append(self.block(nxt) if nxt > indent else None)
            elif item == "-" or item.startswith("- ") or _split_key(item) is not None:
                # `- key: value` or `- - x` opens a block aligned with the item's first character
                self.pos -= 1
                self.lines[self.pos] = (indent + len(text) - len(item), item)
                out.append(self.block(indent + len(text) - len(item)))
            else:
                out.append(_scalar(item))


def parse_yaml(text: str) -> Any:
    """Parse a YAML document of the subset described in the module docstring."""
    reader = _Reader(text)
    if not reader.lines:
        return None
    first_indent, first = reader.peek()
    if len(reader.lines) == 1 and _split_key(first) is None and not first.startswith("- "):
        return _scalar(first)
    result = reader.block(first_indent)
    if reader.pos != len(reader.lines):
        raise ValueError(f"Could not parse YAML from line {reader.peek()[1]!r} on.")
    return result


# ----------------------------------------------------------------------------- composition


class ConfigNode(dict):
    """A dict with attribute access, used for all composed configs.

    Missing attribute access raises AttributeError so typos fail loudly.
    """

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Config key '{key}' not found; present keys: {list(self.keys())}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            return x

        return conv(self)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _deep_merge(base: Any, incoming: Any) -> Any:
    """Merge ``incoming`` on top of ``base`` (hydra-style: dicts merge by key)."""
    if isinstance(base, dict) and isinstance(incoming, dict):
        out = ConfigNode(base)
        for k, v in incoming.items():
            out[k] = _deep_merge(base[k], v) if k in base else _wrap(v)
        return out
    return _wrap(incoming)


def load_yaml(path: str) -> dict:
    with open(path) as fh:
        data = parse_yaml(fh.read())
    return data if data is not None else {}


def _resolve_file(group_dir: str, name: str) -> str:
    path = os.path.join(CONFIG_ROOT, group_dir, f"{name}.yaml")
    if not os.path.exists(path):
        group = group_dir if group_dir else "<root>"
        available = sorted(
            f[:-5]
            for f in os.listdir(os.path.join(CONFIG_ROOT, group_dir))
            if f.endswith(".yaml")
        )
        raise FileNotFoundError(f"No config '{name}' in group '{group}'. Available: {available}")
    return path


def _compose_file(group_dir: str, name: str, group_overrides: dict[str, str]) -> ConfigNode:
    """Compose one YAML file, resolving its defaults list recursively.

    ``group_overrides`` maps group paths relative to this file's directory
    (e.g. ``data`` or ``server``) to replacement config names.
    """
    raw = load_yaml(_resolve_file(group_dir, name))
    defaults = raw.pop("defaults", [])
    self_body = _wrap(raw)

    merged: ConfigNode = ConfigNode()
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, self_body)
            self_seen = True
        elif isinstance(entry, str):
            # Same-group inheritance, e.g. `- _default_optimization_attack`.
            parent = _compose_file(group_dir, entry, group_overrides)
            merged = _deep_merge(merged, parent)
        elif isinstance(entry, dict):
            (sub_group, sub_name), = entry.items()
            sub_name = group_overrides.get(sub_group, sub_name)
            if sub_name is None:
                continue
            sub_dir = os.path.join(group_dir, sub_group) if group_dir else sub_group
            # Strip overrides one level down: `data/db=LMDB` seen from `case` becomes `db=LMDB` inside data.
            nested = {
                k[len(sub_group) + 1:]: v
                for k, v in group_overrides.items()
                if k.startswith(sub_group + "/")
            }
            child = _compose_file(sub_dir, sub_name, nested)
            merged = _deep_merge(merged, {sub_group: child})
        else:
            raise ValueError(f"Unsupported defaults entry {entry!r} in {group_dir}/{name}.yaml")
    if not self_seen:
        merged = _deep_merge(merged, self_body)
    return merged


def _parse_value(text: str) -> Any:
    if text == "" or text.lower() in ("null", "none", "~"):
        return None
    if text.lower() == "true":
        return True
    if text.lower() == "false":
        return False
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _set_dotted(cfg: ConfigNode, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        if key not in node or not isinstance(node[key], dict):
            node[key] = ConfigNode()
        node = node[key]
    node[keys[-1]] = _wrap(value)


def compose(config_name: str = "cfg", overrides: Iterable[str] | None = None) -> ConfigNode:
    """Compose the global config, hydra-style.

    Overrides support three forms:
    - ``group=name``      (e.g. ``attack=deepleakage``, top-level group swap)
    - ``group/sub=name``  (e.g. ``case/data=CIFAR100``, nested group swap)
    - ``a.b.c=value``     (dotted leaf override, applied after composition)
    """
    overrides = list(overrides or [])
    group_swaps: dict[str, str] = {}
    dotted: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' is not of the form key=value")
        key, _, val = ov.partition("=")
        key = key.strip()
        if "." not in key and (
            "/" in key or os.path.isdir(os.path.join(CONFIG_ROOT, key))
        ):
            group_swaps[key] = val.strip()
        else:
            dotted.append((key, _parse_value(val.strip())))

    cfg = _compose_file("", config_name, group_swaps)
    for key, val in dotted:
        _set_dotted(cfg, key, val)
    return cfg
