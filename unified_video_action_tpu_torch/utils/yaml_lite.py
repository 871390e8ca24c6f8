"""A YAML reader for the run configs under ``config/yaml/`` (the card's
machine has no PyYAML).

It reads the subset those files use, as ``yaml.safe_load`` reads it:

* block mappings by indentation, and block sequences (``- item``, an item a
  scalar, a flow collection or a one-line ``key: value`` mapping);
* flow mappings ``{a: 1, b: [2, 3]}`` and flow lists ``[1, 2]``, nested;
* plain scalars resolved as PyYAML's YAML 1.1 resolver does: ``null``,
  ``~`` and the empty value; ``true``/``false`` (also ``yes``/``no``,
  ``on``/``off``, any of their three casings); decimal integers; floats
  with a dot (``1e-4`` has none and stays a string, as in PyYAML), and
  ``.inf``/``.nan``; everything else a string;
* single- and double-quoted strings (``''`` inside single quotes, the
  backslash escapes of double quotes);
* comments: ``#`` at a line's start or after a blank, outside quotes.

Anchors, aliases, tags, multi-line scalars and several documents are not
read: :func:`loads` raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_BASE = ((re.compile(r"[-+]?0b[0-1_]+$"), 2), (re.compile(r"[-+]?0x[0-9a-fA-F_]+$"), 16),
             (re.compile(r"[-+]?0[0-7_]+$"), 8))
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\", "/": "/", " ": " "}


def scalar(text: str) -> Any:
    """A plain (unquoted) scalar, resolved as PyYAML's safe loader does."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    for pattern, base in _INT_BASE:
        if pattern.match(s):
            sign = -1 if s.startswith("-") else 1
            digits = s.lstrip("+-").replace("_", "")
            return sign * int(digits[2:] if base != 8 else digits, base)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after a blank,
    outside quotes)."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """A cursor over one line's flow text: quoted strings, flow collections
    and plain scalars."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def fail(self, what: str):
        raise ValueError(f"yaml_lite: {what} at column {self.i} of {self.where}: {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                    continue
                if esc in ("x", "u"):
                    width = 2 if esc == "x" else 4
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + width], 16)))
                    self.i += 2 + width
                    continue
                self.fail(f"escape \\{esc}")
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1
        self.fail("an unterminated quoted string")

    def plain(self, stops: str) -> str:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t,]}"):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def node(self, stops: str = ",]}") -> Any:
        ch = self.peek()
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.mapping()
        if ch in ("'", '"'):
            return self.quoted()
        if ch and ch in "&*!|>":
            self.fail(f"unsupported YAML ({ch!r})")
        return scalar(self.plain(stops))

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() == ",":
                self.fail("an empty entry of a flow list")
            out.append(self.node())
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "]":
                self.fail("',' or ']' expected")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.node(",:]}")
            if self.peek() == ":":
                self.i += 1
                value = self.node()
            else:
                value = None
            out[key] = value
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "}":
                self.fail("',' or '}' expected")

    def end(self) -> None:
        if self.peek():
            self.fail("text after the value")


def _value(text: str, where: str) -> Any:
    """A whole inline value: a flow collection, a quoted string or a plain
    scalar."""
    flow = _Flow(text, where)
    ch = flow.peek()
    if ch and ch in "[{'\"&*!|>":
        value = flow.node()
        flow.end()
        return value
    if re.search(r":(\s|$)", text):
        raise ValueError(f"yaml_lite: a mapping inside a plain scalar at {where}: {text!r}")
    return scalar(text)


def _split_key(text: str, where: str) -> Tuple[Any, str]:
    """``key: rest`` -> (key, rest); ValueError if ``text`` is no mapping entry."""
    flow = _Flow(text, where)
    if flow.peek() in ("'", '"'):
        key = flow.quoted()
    else:
        key = scalar(flow.plain(""))
    if flow.peek() != ":":
        flow.fail("a mapping key expected")
    flow.i += 1
    return key, flow.s[flow.i:].strip()


def _is_entry(text: str) -> bool:
    """Whether ``text`` (a line without its indentation) is ``key:`` or
    ``key: value`` (a colon outside quotes and brackets, then a blank or
    the end)."""
    if text[:1] in ("[", "{"):
        return False
    try:
        _split_key(text, "")
        return True
    except ValueError:
        return False


def loads(text: str) -> Any:
    """The document ``text`` as dicts, lists and scalars (``{}`` for an
    empty document, as ``yaml.safe_load(...) or {}``)."""
    lines: List[Tuple[int, str, int]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"yaml_lite: a tab in the indentation of line {n}")
        body = _strip_comment(raw)
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), n))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"yaml_lite: unexpected indentation at line {lines[pos][2]}")
    return value


def _block(lines, pos: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at ``pos`` with ``indent``."""
    first = lines[pos][1]
    if first == "-" or first.startswith("- "):
        return _block_seq(lines, pos, indent)
    if _is_entry(first):
        return _block_map(lines, pos, indent)
    if pos + 1 < len(lines) and lines[pos + 1][0] >= indent:
        raise ValueError(f"yaml_lite: multi-line scalars are not read (line {lines[pos][2]})")
    return _value(first, f"line {lines[pos][2]}"), pos + 1


def _nested(lines, pos: int, indent: int, rest: str, where: str, seq_ok: bool):
    """The value after ``key:`` or ``-``: inline, or the block below."""
    if rest:
        return _value(rest, where), pos
    if pos < len(lines):
        child = lines[pos][0]
        text = lines[pos][1]
        if child > indent or (seq_ok and child == indent and (text == "-" or text.startswith("- "))):
            return _block(lines, pos, child)
    return None, pos


def _block_map(lines, pos: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _, text, n = lines[pos]
        if text == "-" or text.startswith("- "):
            break
        where = f"line {n}"
        key, rest = _split_key(text, where)
        if key in out:
            # PyYAML keeps the last of repeated keys
            del out[key]
        out[key], pos = _nested(lines, pos + 1, indent, rest, where, seq_ok=True)
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"yaml_lite: unexpected indentation at line {lines[pos][2]}")
    return out, pos


def _block_seq(lines, pos: int, indent: int) -> Tuple[list, int]:
    out: list = []
    while pos < len(lines) and lines[pos][0] == indent:
        _, text, n = lines[pos]
        if not (text == "-" or text.startswith("- ")):
            break
        where = f"line {n}"
        rest = text[1:].strip()
        if rest and _is_entry(rest):
            # "- key: value": a mapping whose first entry sits on the dash's line
            item_indent = indent + (len(text) - len(rest))
            sub = [(item_indent, rest, n)]
            pos += 1
            while pos < len(lines) and lines[pos][0] > indent:
                sub.append(lines[pos])
                pos += 1
            item, used = _block_map(sub, 0, item_indent)
            if used != len(sub):
                raise ValueError(f"yaml_lite: unexpected indentation at line {sub[used][2]}")
            out.append(item)
        else:
            item, pos = _nested(lines, pos + 1, indent, rest, where, seq_ok=False)
            out.append(item)
    return out, pos


def load(path: str) -> Any:
    """The YAML file at ``path``, as :func:`loads` reads it."""
    with open(path) as f:
        return loads(f.read())
