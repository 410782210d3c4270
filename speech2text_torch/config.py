"""Config loading: the port's own copy of speech2text_tpu/config.py.

The machine that serves the port may not have PyYAML, so `load_config`
reads the subset of YAML that the repo's config files use: nested block
mappings, block lists (`- item`) and flow lists (`[a, b]`) of scalars,
`{}`, quoted strings, comments, and PyYAML's (YAML 1.1) implicit scalars
for null, bool, int and float. tests/test_torch_rnnt_serve.py holds the
reader against `yaml.safe_load` on every file under configs/. `dumps`
writes a config tree in that subset (the training entry's config
backup).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple, Type, TypeVar

T = TypeVar("T")

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def parse_scalar(text: str) -> Any:
    """One plain or quoted YAML scalar, resolved as PyYAML's safe loader
    resolves it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else \
            body.encode().decode("unicode_escape")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [parse_scalar(v) for v in inner.split(",")] if inner else []
    if s == "{}":
        return {}
    return parse_scalar(s)


def _parse_block(lines: List[Tuple[int, str]], i: int, indent: int):
    """Parse the block starting at lines[i] whose items sit at `indent`;
    returns (value, next index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out_list = []
        while i < len(lines) and lines[i][0] == indent \
                and (lines[i][1].startswith("- ") or lines[i][1] == "-"):
            out_list.append(_value(lines[i][1][1:]))
            i += 1
        return out_list, i
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep:
            raise ValueError(f"cannot parse config line {lines[i][1]!r}")
        key = parse_scalar(key)
        i += 1
        if rest.strip():
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def loads(text: str) -> Dict[str, Any]:
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"cannot parse config line {lines[i][1]!r}")
    return value


_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")


def _dump_scalar(v: Any) -> str:
    """A scalar as text that `parse_scalar` reads back as `v`."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        if "\n" in v or "," in v:
            raise ValueError(f"cannot write the string {v!r}")
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot write {type(v).__name__} {v!r}")


def _dump_key(k: Any) -> str:
    if ":" in str(k):
        raise ValueError(f"cannot write the key {k!r}")
    if isinstance(k, str) and _PLAIN_KEY.match(k) and parse_scalar(k) == k:
        return k
    return _dump_scalar(k)


def dumps(cfg: Dict[str, Any]) -> str:
    """A config tree as the YAML subset that `loads` reads back equal:
    block mappings, flow lists of scalars, quoted strings."""
    lines: List[str] = []

    def block(node: Dict[str, Any], indent: int) -> None:
        pad = " " * indent
        for k, v in node.items():
            key = _dump_key(k)
            if isinstance(v, dict):
                if v:
                    lines.append(f"{pad}{key}:")
                    block(v, indent + 2)
                else:
                    lines.append(f"{pad}{key}: {{}}")
            elif isinstance(v, (list, tuple)):
                if any(isinstance(x, (dict, list, tuple)) for x in v):
                    raise ValueError(f"cannot write nested list at {k!r}")
                lines.append(f"{pad}{key}: [" + ", ".join(
                    _dump_scalar(x) for x in v) + "]")
            else:
                lines.append(f"{pad}{key}: {_dump_scalar(v)}")

    block(cfg, 0)
    return "\n".join(lines) + "\n"


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict tree."""
    with open(path, "r") as f:
        return loads(f.read())


def from_dict(cls: Type[T], cfg: Dict[str, Any] | None) -> T:
    """Build a dataclass from a config dict, erroring on unknown keys."""
    cfg = dict(cfg or {})
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - names
    if unknown:
        raise ValueError(
            f"{cls.__name__}: unknown config keys {sorted(unknown)}; "
            f"valid keys: {sorted(names)}")
    return cls(**cfg)


def override(cfg: Dict[str, Any], dotted_key: str, value: Any) -> None:
    """In-place override `a.b.c=value` for CLI-style overrides."""
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = _value(str(value))
