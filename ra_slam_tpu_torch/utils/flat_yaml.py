"""A reader and writer for flat YAML mappings (`camera_config.yaml`),
without PyYAML.

The JAX package writes a folder's `camera_config.yaml` with
`yaml.safe_dump` and reads it with `yaml.safe_load`. That file is one
flat mapping: scalar values (`Camera.fx: 320.0`) and, optionally,
`Extrinsics` as a block list of scalars. This module reads such a
mapping as `yaml.safe_load` does: int, float, bool, null and string
scalars (plain or quoted, resolved with YAML 1.1's rules as PyYAML
does), block lists (`- 1.0`, one item per line) and flow lists
(`[1.0, 2.0]`) of scalars, comments and blank lines. A nested mapping, a
list of lists or any other structure raises and names the line.
`dump_flat_yaml` writes what `yaml.safe_dump` writes for a flat mapping
of plain keys to numbers and lists of numbers.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List

_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|^\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_INT_BASE = re.compile(r"^([-+]?)(0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


class FlatYamlError(ValueError):
    """Input that is not a flat mapping of scalars and lists of scalars."""


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at the start or after a
    blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, lineno: int) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return bytes(s[1:-1], "utf-8").decode("unicode_escape")
    if s[:1] in ("{", "[", "&", "*", "!", "|", ">") or s.startswith("- ") or s == "-":
        raise FlatYamlError(f"line {lineno}: {s!r} is not a scalar (nested or tagged values are not read)")
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    m = _INT_BASE.match(s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        body = m.group(2).replace("_", "")
        base = 2 if body.startswith("0b") else 16 if body.startswith("0x") else 8
        return sign * int(body[2:] if base != 8 else body, base)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    return s


def _flow_list(text: str, lineno: int) -> List[Any]:
    body = text.strip()[1:-1].strip()
    if any(ch in body for ch in "[]{}"):
        raise FlatYamlError(f"line {lineno}: nested flow collections are not read")
    return [] if not body else [_scalar(item, lineno) for item in body.split(",")]


def load_flat_yaml(text: str) -> Dict[str, Any]:
    """The mapping a flat YAML document holds, as `yaml.safe_load` reads
    it (an empty document gives {})."""
    out: Dict[str, Any] = {}
    bare = set()  # keys written `key:` with no value on their line
    list_key = None  # key whose block list the following `-` lines extend
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body == "-" or body.startswith("- "):
            if list_key is None:
                raise FlatYamlError(f"line {lineno}: list item outside a key's block list")
            item = body[1:].strip()
            if item.startswith("[") or item == "-" or item.startswith("- ") or re.match(r"^[^'\"]*:(\s|$)", item):
                raise FlatYamlError(f"line {lineno}: nested list or mapping in a block list")
            out[list_key].append(_scalar(item, lineno))
            continue
        if indent:
            raise FlatYamlError(f"line {lineno}: indented mapping (nested mappings are not read)")
        m = re.match(r"^((?:'[^']*'|\"[^\"]*\"|[^'\"\s:][^:]*?)):(?:\s+(.*))?$", body)
        if not m:
            raise FlatYamlError(f"line {lineno}: {body!r} is not `key: value`")
        key = _scalar(m.group(1), lineno)
        if not isinstance(key, str):
            key = str(key) if key is not None else "null"
        value = (m.group(2) or "").strip()
        if key in out:
            raise FlatYamlError(f"line {lineno}: duplicate key {key!r}")
        list_key = None
        if not value:
            out[key] = []  # a block list follows, or the value is null
            list_key = key
            bare.add(key)
        elif value.startswith("[") and value.endswith("]"):
            out[key] = _flow_list(value, lineno)
        else:
            out[key] = _scalar(value, lineno)
    # `key:` with no list item under it is null, as in YAML
    return {k: None if k in bare and v == [] else v for k, v in out.items()}


def _dump_scalar(v: Any) -> str:
    if isinstance(v, bool) or v is None:
        return {True: "true", False: "false", None: "null"}[v]
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:  # PyYAML writes 1e-05 as 1.0e-05
            s = s.replace("e", ".0e", 1)
        return s
    raise TypeError(f"cannot write {type(v).__name__} as a flat YAML value (numbers, bools, null)")


def dump_flat_yaml(mapping: Dict[str, Any]) -> str:
    """`yaml.safe_dump(mapping)` for a flat mapping of plain keys to
    numbers, bools, null and lists of them: keys sorted, lists as block
    lists at the key's indentation."""
    lines = []
    for key in sorted(mapping):
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.]*", key):
            raise ValueError(f"key {key!r} would need quoting")
        v = mapping[key]
        if isinstance(v, (list, tuple)):
            lines.append(f"{key}:" if v else f"{key}: []")
            lines.extend(f"- {_dump_scalar(item)}" for item in v)
        else:
            lines.append(f"{key}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
