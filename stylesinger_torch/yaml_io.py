"""A reader and a writer for the YAML of the recipe files, without PyYAML.

:func:`loads` reads the subset of YAML that ``egs/`` and PyYAML's
``safe_dump`` of a config use:

- block mappings (nested by indentation) and block sequences, also a
  sequence at its key's indentation and compact nested items (``- - 1``,
  ``- key: value``);
- flow sequences and mappings (``[8, 8, 2, 2]``, ``{data: -1, model:
  1}``), nested;
- plain, single- and double-quoted scalars, a plain or quoted scalar folded
  over more-indented lines, and comments;
- scalars resolved as PyYAML's ``SafeLoader`` resolves them (YAML 1.1):
  ``true``/``yes``/``on`` and their negations, ``null``/``~``, decimal,
  octal, hex and binary integers, floats with a dot (``1e-5`` without one
  stays a string), ``.inf`` and ``.nan``.

Anchors, aliases, tags, block scalars (``|``, ``>``) and multiple documents
raise.  :func:`dumps` writes a mapping that both this reader and PyYAML read
back equal (tuples as lists): one sorted ``key: value`` line per key, every
value in flow style, strings double-quoted.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_BIN = re.compile(r"[-+]?0b[01_]+$")
_FLOAT = re.compile(r"([-+]?([0-9][0-9_]*)\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


class YamlError(ValueError):
    pass


def _int(text: str, base: int, prefix: int) -> int:
    sign = -1 if text[0] == "-" else 1
    digits = text.lstrip("+-")[prefix:].replace("_", "")
    return sign * int(digits, base)


def resolve(text: str) -> Any:
    """A plain scalar's value, as PyYAML's ``SafeLoader`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _OCT.match(text):
        return _int(text, 8, 1)
    if _HEX.match(text):
        return _int(text, 16, 2)
    if _BIN.match(text):
        return _int(text, 2, 2)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlError(f"unsupported YAML syntax: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """The line without a comment: a ``#`` at its start or after white
    space, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` and the index after it."""
    q = text[i]
    j = i + 1
    if q == "'":
        out = []
        while True:
            k = text.find("'", j)
            if k < 0:
                raise YamlError(f"unterminated string: {text[i:]!r}")
            out.append(text[j:k])
            if text[k + 1:k + 2] == "'":
                out.append("'")
                j = k + 2
                continue
            return "".join(out), k + 1
    while j < len(text):
        if text[j] == "\\":
            j += 2
            continue
        if text[j] == '"':
            return json.loads(text[i:j + 1]), j + 1
        j += 1
    raise YamlError(f"unterminated string: {text[i:]!r}")


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow value starting at ``text[i]`` (after blanks) and the index
    after it."""
    while i < len(text) and text[i] == " ":
        i += 1
    ch = text[i:i + 1]
    if ch in ("[", "{"):
        close = "]" if ch == "[" else "}"
        items: List[Any] = []
        i += 1
        while True:
            while i < len(text) and text[i] in " ,":
                i += 1
            if text[i:i + 1] == close:
                break
            if ch == "[":
                v, i = _flow(text, i)
                items.append(v)
            else:
                k, i = _flow(text, i)
                while text[i:i + 1] == " ":
                    i += 1
                if text[i:i + 1] != ":":
                    raise YamlError(f"expected ':' in {text!r}")
                v, i = _flow(text, i + 1)
                items.append((k, v))
            while i < len(text) and text[i] == " ":
                i += 1
            if text[i:i + 1] not in (",", close):
                raise YamlError(f"unexpected {text[i:]!r} in {text!r}")
        return (items if ch == "[" else dict(items)), i + 1
    if ch in ("'", '"'):
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and text[j + 1:j + 2] in (" ", "")):
        j += 1
    return resolve(text[i:j].strip()), j


def _scalar(text: str) -> Any:
    """A value written on one line: a flow collection, a quoted or a plain
    scalar."""
    text = text.strip()
    if text[:1] in ("[", "{", "'", '"'):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise YamlError(f"trailing text after {text[:end]!r}")
        return value
    return resolve(text)


def _split_key(text: str):
    """(key, rest) of a ``key: rest`` line, or None."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        if rest[:1] == ":" and rest[1:2] in (" ", ""):
            return key, rest[1:].strip()
        return None
    m = re.match(r"([^\s:#\[\]{},][^:#]*?|[^\s:#\[\]{},]):(\s|$)", text)
    if m is None or text[:2] == "- " or text == "-":
        return None
    return m.group(1).strip(), text[m.end():].strip()


class _Lines:
    def __init__(self, source: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in source.splitlines():
            if raw.strip() in ("---", "...") and not raw[0].isspace():
                if self.lines:
                    raise YamlError("more than one YAML document")
                continue
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlError("tab indentation")
            text = _strip_comment(raw)
            if text.strip():
                self.lines.append((len(text) - len(text.lstrip(" ")),
                                   text.strip()))

    def value_text(self, i: int, text: str, indent: int) -> Tuple[str, int]:
        """``text`` joined with the lines after line ``i`` that continue it:
        more indented than ``indent`` (a folded scalar), or any line until
        an open flow collection closes."""
        j = i + 1
        depth = _depth(text)
        while j < len(self.lines):
            ind, nxt = self.lines[j]
            if depth <= 0 and (ind <= indent or _split_key(nxt) is not None
                               or nxt.startswith("- ") or nxt == "-"):
                break
            text = f"{text} {nxt}"
            depth = _depth(text)
            j += 1
        return text, j


def _depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _block(ls: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at ``i`` with indentation
    ``indent``; returns it and the index of the first line after it."""
    first = ls.lines[i][1]
    if first.startswith("- ") or first == "-":
        return _sequence(ls, i, indent)
    if _split_key(first) is not None:
        return _mapping(ls, i, indent)
    text, j = ls.value_text(i, first, indent - 1)
    return _scalar(text), j


def _nested(ls: _Lines, i: int, indent: int, seq_at_indent: bool):
    """The value of a key or an item whose text is empty: the block on the
    next lines (a sequence may sit at the key's own indentation)."""
    if i < len(ls.lines):
        ind, text = ls.lines[i]
        if ind > indent or (seq_at_indent and ind == indent and (
                text.startswith("- ") or text == "-")):
            return _block(ls, i, ind)
    return None, i


def _mapping(ls: _Lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(ls.lines):
        ind, text = ls.lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"unexpected indentation: {text!r}")
        kv = _split_key(text)
        if kv is None:
            break
        key, rest = kv
        key = resolve(key) if isinstance(key, str) and text[:1] not in "'\"" \
            else key
        if rest:
            rest, i = ls.value_text(i, rest, indent)
            out[key] = _scalar(rest)
        else:
            out[key], i = _nested(ls, i + 1, indent, True)
    return out, i


def _sequence(ls: _Lines, i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    while i < len(ls.lines):
        ind, text = ls.lines[i]
        if ind != indent or not (text.startswith("- ") or text == "-"):
            break
        rest = text[1:].strip()
        if not rest:
            value, i = _nested(ls, i + 1, indent, False)
        else:
            # the item's text stands at column indent + 2, as if on a line
            # of its own
            col = indent + len(text) - len(text[1:].lstrip())
            ls.lines[i] = (col, rest)
            if rest.startswith("- ") or rest == "-" or \
                    _split_key(rest) is not None:
                value, i = _block(ls, i, col)
            else:
                joined, i = ls.value_text(i, rest, indent)
                value = _scalar(joined)
        out.append(value)
    return out, i


def loads(source: str) -> Any:
    """The value of a YAML document (see the module docstring for the
    subset); an empty document is None."""
    ls = _Lines(source)
    if not ls.lines:
        return None
    value, i = _block(ls, 0, ls.lines[0][0])
    if i != len(ls.lines):
        raise YamlError(f"cannot parse line: {ls.lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


def _float(x: float) -> str:
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    s = repr(float(x))
    mant, _, exp = s.partition("e")
    if "." not in mant:
        mant += ".0"
    return mant + ("e" + exp if exp else "")


def _flow_value(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if hasattr(v, "item") and not isinstance(v, (list, tuple, dict)):
        v = v.item()   # a numpy scalar
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float(v)
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_flow_value(str(k))}: {_flow_value(x)}"
                               for k, x in v.items()) + "}"
    raise YamlError(f"cannot write a {type(v).__name__}: {v!r}")


def dumps(mapping: dict) -> str:
    """``mapping`` as YAML, one sorted ``key: <flow value>`` line a key."""
    lines = []
    for k in sorted(mapping):
        key = k if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(k)) and \
            isinstance(resolve(str(k)), str) else json.dumps(str(k))
        lines.append(f"{key}: {_flow_value(mapping[k])}")
    return "\n".join(lines) + "\n"
