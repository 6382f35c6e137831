"""A reader for the YAML the repo's configs are written in, so that
:func:`csts_torch.config.load_config` needs no PyYAML (the card's machine has
none).

The subset, resolved as PyYAML's ``safe_load`` resolves it (YAML 1.1):

* block maps nested by indentation, with plain keys (``TRAIN:``, ``BASE_LR:``);
* scalars: null (``~``, ``null``, nothing), bool (``True``/``False`` and
  YAML 1.1's ``yes``/``no``/``on``/``off`` spellings), decimal int, float
  with a dot (``0.05``, ``1.0e-6``, ``.5``), ``.inf``/``.nan``, and strings,
  quoted or bare; ``1e-6`` has no dot and stays the string ``'1e-6'``, as
  under PyYAML (the config's coercion makes it a float);
* flow lists on one line, nested: ``[[1, 2.0], [3, 2.0]]``;
* ``#`` comments on their own line or after a value.

Anything else (block sequences, flow maps, anchors, tags, multi-line
scalars, hex/octal/sexagesimal ints, timestamps, duplicate keys, tabs)
raises :class:`YamlSubsetError` with the line number rather than being
read some other way.

:func:`dump` writes a dict in the same subset (sorted keys, block maps, flow
lists, each scalar in a form that both this reader and PyYAML read back as
the same value), for ``python -m csts_torch.config``.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# what YAML 1.1 resolves to types outside the subset: other int bases,
# sexagesimal numbers, timestamps, the merge and value keys
_OTHER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*$")
_INDICATORS = set("[]{},&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    """Input outside the subset this reader takes (the message names the line)."""


def _fail(lineno: int, msg: str):
    raise YamlSubsetError(f"line {lineno}: {msg}")


def _strip_comment(text: str, lineno: int) -> str:
    """The line without its comment: a ``#`` at the start or after a blank,
    outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        _fail(lineno, "unterminated quoted string")
    return text.rstrip()


def _plain(token: str, lineno: int, flow: bool) -> Any:
    """A plain (unquoted) scalar, resolved as YAML 1.1 resolves it."""
    if token in _NULL:
        return None
    if token in _TRUE:
        return True
    if token in _FALSE:
        return False
    if _INT.match(token):
        return int(token.replace("_", ""))
    if _FLOAT.match(token):
        return float(token.replace("_", ""))
    m = _INF.match(token)
    if m:
        return float(f"{m.group(1)}inf")
    if _NAN.match(token):
        return float("nan")
    if _OTHER.match(token):
        _fail(lineno, f"{token!r} resolves to a YAML 1.1 type outside the subset")
    if token[0] in _INDICATORS or token.startswith(("- ", "? ")) or token in ("-", "?"):
        _fail(lineno, f"{token!r} starts with a YAML indicator outside the subset")
    if ": " in token or token.endswith(":") or (flow and any(c in token for c in ",[]{}")):
        _fail(lineno, f"{token!r} is not a plain scalar")
    return token


def _quoted(text: str, pos: int, lineno: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[pos]`` and the index after it."""
    quote = text[pos]
    out: List[str] = []
    i = pos + 1
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e not in escapes:
                _fail(lineno, f"escape \\{e} outside the subset")
            out.append(escapes[e])
            i += 2
            continue
        out.append(c)
        i += 1
    _fail(lineno, "unterminated quoted string")


def _flow_list(text: str, pos: int, lineno: int) -> Tuple[list, int]:
    """The flow list starting at ``text[pos] == '['`` and the index after it."""
    out: list = []
    i = pos + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            _fail(lineno, "a flow list must close on its own line")
        c = text[i]
        if c == "]":
            if expect_item and out:
                _fail(lineno, "trailing comma in a flow list")
            return out, i + 1
        if not expect_item:
            if c != ",":
                _fail(lineno, f"expected ',' or ']' at column {i + 1}")
            expect_item = True
            i += 1
            continue
        if c == "[":
            item, i = _flow_list(text, i, lineno)
        elif c in "'\"":
            item, i = _quoted(text, i, lineno)
        elif c == "{":
            _fail(lineno, "flow maps are outside the subset")
        elif c == ",":
            _fail(lineno, "empty item in a flow list")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            item = _plain(text[i:j].strip(), lineno, flow=True)
            i = j
        out.append(item)
        expect_item = False


def _value(text: str, lineno: int) -> Any:
    """A map value written on the key's line."""
    if text.startswith("["):
        value, end = _flow_list(text, 0, lineno)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0, lineno)
    else:
        return _plain(text, lineno, flow=False)
    if text[end:].strip():
        _fail(lineno, f"unexpected text after the value: {text[end:].strip()!r}")
    return value


def _lines(source: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of every line that holds something."""
    out = []
    for lineno, raw in enumerate(source.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            _fail(lineno, "tab in indentation")
        body = _strip_comment(raw, lineno)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        content = body.strip()
        if content in ("---", "...") or content.startswith("%"):
            _fail(lineno, "documents and directives are outside the subset")
        out.append((lineno, indent, content))
    return out


def _block_map(lines, start: int, indent: int) -> Tuple[dict, int]:
    """The map whose keys sit at ``indent`` from ``lines[start]``; returns it
    and the index of the first line after it."""
    out: dict = {}
    i = start
    while i < len(lines):
        lineno, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, "unexpected indentation")
        if content.startswith("- ") or content == "-":
            _fail(lineno, "block sequences are outside the subset")
        key, sep, rest = content.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            _fail(lineno, f"expected 'KEY: value', got {content!r}")
        key = key.strip()
        if not _KEY.match(key) or _plain(key, lineno, flow=False) != key:
            _fail(lineno, f"key {key!r} is outside the subset (plain string keys only)")
        if key in out:
            _fail(lineno, f"duplicate key {key!r}")
        rest = rest.strip()
        i += 1
        if rest:
            out[key] = _value(rest, lineno)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block_map(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def load(source: str) -> Optional[dict]:
    """The document in ``source`` as PyYAML's ``safe_load`` gives it (None
    for an empty document)."""
    lines = _lines(source)
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], "the document must start at column 1")
    out, end = _block_map(lines, 0, 0)
    if end != len(lines):
        _fail(lines[end][0], "unexpected indentation")
    return out


def load_file(path: str) -> Optional[dict]:
    with open(path, "r") as f:
        return load(f.read())


def _scalar(value: Any, flow: bool) -> str:
    """``value`` written so that it reads back equal (in a flow list when
    ``flow``)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        text = str(value)
    elif isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            text = f"{mantissa}.0{e}{exp}"
    elif isinstance(value, str):
        text = value
    else:
        raise YamlSubsetError(f"{type(value).__name__} {value!r} is outside the subset")
    if not _reads_back(text, value, flow):
        if not isinstance(value, str) or "\n" in value:
            raise YamlSubsetError(f"{value!r} has no form in the subset")
        text = "'" + value.replace("'", "''") + "'"
    return text


def _reads_back(text: str, value: Any, flow: bool) -> bool:
    try:
        got = load(f"k: [{text}]" if flow else f"k: {text}")
    except YamlSubsetError:
        return False
    got = got["k"]
    if flow:
        if len(got) != 1:
            return False
        got = got[0]
    return type(got) is type(value) and got == value


def _flow(value: list) -> str:
    return "[" + ", ".join(_flow(v) if isinstance(v, (list, tuple)) else _scalar(v, True)
                           for v in value) + "]"


def dump(data: dict, indent: int = 0) -> str:
    """``data`` (nested dicts of scalars and lists, string keys) as YAML in
    the subset, keys sorted, two spaces an indent level. A value outside the
    subset (an empty dict, a dict in a list, another type) raises."""
    lines = []
    for key in sorted(data):
        value = data[key]
        if not isinstance(key, str) or not _KEY.match(key):
            raise YamlSubsetError(f"key {key!r} is outside the subset")
        pad = " " * indent
        if isinstance(value, dict):
            if not value:
                raise YamlSubsetError(f"{key}: an empty map has no form in the subset")
            lines.append(f"{pad}{key}:\n" + dump(value, indent + 2))
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: {_flow(value)}\n")
        else:
            lines.append(f"{pad}{key}: {_scalar(value, False)}\n")
    return "".join(lines)
