"""A reader for the subset of YAML that Cluster Serving's configs use.

The serving config (``config.yaml``, written by ``zoo-serving init``) is
read with PyYAML's ``safe_load`` in the JAX package. The machines the
port runs on need not have PyYAML, so the port carries this reader of
the same subset, as ``serving/wire.py`` carries msgpack's format. It is
not a new format: on every document it accepts, :func:`safe_load` gives
what ``yaml.safe_load`` gives. It reads

- block mappings nested by indentation, with plain or quoted keys;
- block sequences, also at the indentation of their parent key (as
  ``yaml.safe_dump`` writes them), whose items are scalars, flow
  sequences, nested sequences or mappings (``- name: latency``);
- flow sequences ``[a, b, [c]]`` of scalars, and the empty ``[]`` and
  ``{}``;
- plain, single-quoted and double-quoted scalars on one line;
- comments, whole-line and after a value;
- YAML 1.1's implicit types as PyYAML resolves them: ``true/false/yes/
  no/on/off`` (any of three casings), ints (decimal, ``0b``, ``0x``,
  octal ``0…``, ``_`` separators, sexagesimal ``1:30``), floats (with a
  dot, an exponent with a sign, ``.inf``, ``.nan``), ``null``/``~``/
  empty; anything else is a string, so ``3, 224, 224`` stays one.

Anything outside the subset raises :class:`YamlSubsetError` naming the
line: block scalars (``|``, ``>``), scalars continued over lines,
anchors, aliases, tags, directives and documents markers, complex keys,
flow mappings that are not empty, timestamps, tabs in indentation. It
never guesses.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

__all__ = ["safe_load", "YamlSubsetError"]


class YamlSubsetError(ValueError):
    """Text outside the subset this reader accepts, or not YAML at all."""

    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


# -- scalar resolution (PyYAML's YAML 1.1 implicit resolvers) ------------

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_FLOW_PLAIN = re.compile(r"[^,\[\]{}]*")


def _sexagesimal(value: str, num) -> Any:
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += num(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _resolve_plain(text: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text):
        raise YamlSubsetError(lineno, f"timestamp {text!r} is outside the "
                                      f"subset; quote it")
    if text in ("<<", "="):
        raise YamlSubsetError(lineno, f"{text!r} (merge/value key) is "
                                      f"outside the subset")
    return text


# -- scanning one line ------------------------------------------------------

_DQ_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these (YAML 1.1 indicators)
_PLAIN_BAD_START = set("[]{},#&*!|>'\"%@`")


def _read_quoted(s: str, i: int, lineno: int) -> Tuple[str, int]:
    """Scalar quoted at ``s[i]``; returns (value, index after the quote)."""
    q = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'":
            if c == "'":
                if s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(c)
            j += 1
            continue
        if c == '"':
            return "".join(out), j + 1
        if c == "\\":
            e = s[j + 1:j + 2]
            if e in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[e])
                j += 2
            elif e in _DQ_HEX:
                n = _DQ_HEX[e]
                digits = s[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                        digits):
                    raise YamlSubsetError(lineno, "bad escape in a "
                                                  "double-quoted scalar")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise YamlSubsetError(lineno, f"escape \\{e} is outside "
                                              f"the subset")
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(lineno, "quoted scalar continues past its line; "
                                  "multi-line scalars are outside the subset")


def _nothing_after(s: str, j: int, lineno: int):
    """Only spaces may follow a closed scalar (comments are gone)."""
    rest = s[j:].strip(" ")
    if rest:
        raise YamlSubsetError(lineno, f"unexpected {rest!r} after a "
                                      f"quoted scalar or flow sequence")


def _quote_may_open(prefix: str) -> bool:
    """True when a quote after ``prefix`` starts a quoted scalar: at the
    start of a node, after ``key: ``, after ``- `` items, or inside a
    flow sequence."""
    ps = prefix.rstrip(" ")
    if not ps or ps[-1] in "[,":
        return True
    if len(ps) < len(prefix) and ps[-1] == ":":
        return True
    return len(ps) < len(prefix) and re.fullmatch(r"(- *)*-", ps) is not None


def _strip_comment(s: str) -> str:
    """Drop a ``#`` comment (one at the start or after a space) outside
    quotes, and trailing spaces."""
    quote = None
    j = 0
    while j < len(s):
        c = s[j]
        if quote:
            if c == "\\" and quote == '"':
                j += 1
            elif c == quote:
                if quote == "'" and s[j + 1:j + 2] == "'":
                    j += 1
                else:
                    quote = None
        elif c in "'\"" and _quote_may_open(s[:j]):
            quote = c
        elif c == "#" and (j == 0 or s[j - 1] == " "):
            return s[:j].rstrip(" ")
        j += 1
    return s.rstrip(" ")


def _split_key(s: str, lineno: int) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (key, rest); None when the text is no mapping
    entry."""
    if s[:1] in "'\"":
        key, j = _read_quoted(s, 0, lineno)
        rest = s[j:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:].strip(" ")
        return None
    if s.startswith("? ") or s == "?":
        raise YamlSubsetError(lineno, "complex keys are outside the subset")
    m = re.search(r":( |$)", s)
    if m is None:
        return None
    key_text = s[:m.start()].rstrip(" ")
    if not key_text:
        raise YamlSubsetError(lineno, "empty keys are outside the subset")
    if key_text[:1] in ("[", "{"):
        raise YamlSubsetError(lineno, "flow-collection keys are outside "
                                      "the subset")
    _check_plain(key_text, lineno)
    return _resolve_plain(key_text, lineno), s[m.end():].strip(" ")


def _check_plain(text: str, lineno: int):
    if text and text[0] in _PLAIN_BAD_START:
        raise YamlSubsetError(lineno, f"{text!r}: anchors, aliases, tags, "
                                      f"block scalars and directives are "
                                      f"outside the subset")
    if text[:2] in ("- ", "? ", ": ") or text in ("-", "?", ":"):
        raise YamlSubsetError(lineno, f"unexpected indicator in {text!r}")
    if ": " in text or text.endswith(":"):
        raise YamlSubsetError(lineno, f"mapping values are not allowed "
                                      f"inside the scalar {text!r}")


def _flow_seq(s: str, i: int, lineno: int) -> Tuple[list, int]:
    """Flow sequence opening at ``s[i]``; returns (list, index after)."""
    out: list = []
    j = i + 1
    expect_item = True
    while j < len(s):
        c = s[j]
        if c == " ":
            j += 1
        elif c == "]":
            return out, j + 1
        elif c == ",":
            if expect_item:
                raise YamlSubsetError(lineno, "empty flow sequence entry")
            expect_item = True
            j += 1
        elif not expect_item:
            raise YamlSubsetError(lineno, "expected ',' or ']' in a flow "
                                          "sequence")
        elif c == "[":
            item, j = _flow_seq(s, j, lineno)
            out.append(item)
            expect_item = False
        elif c in "'\"":
            item, j = _read_quoted(s, j, lineno)
            out.append(item)
            expect_item = False
        elif c == "{":
            raise YamlSubsetError(lineno, "flow mappings inside a flow "
                                          "sequence are outside the subset")
        else:
            m = _FLOW_PLAIN.match(s, j)
            text = m.group(0).rstrip(" ")
            if re.search(r":( |$)", text) or text.startswith("? "):
                raise YamlSubsetError(lineno, "mappings inside a flow "
                                              "sequence are outside the "
                                              "subset")
            _check_plain(text, lineno)
            out.append(_resolve_plain(text, lineno))
            j = m.end()
            expect_item = False
    raise YamlSubsetError(lineno, "flow sequence continues past its line; "
                                  "multi-line flow collections are outside "
                                  "the subset")


def _inline_value(s: str, lineno: int) -> Any:
    """The value written on a line after ``key:`` or ``- ``."""
    if s.startswith("["):
        value, j = _flow_seq(s, 0, lineno)
        _nothing_after(s, j, lineno)
        return value
    if s.startswith("{"):
        if re.fullmatch(r"\{ *\}", s):
            return {}
        raise YamlSubsetError(lineno, "flow mappings other than {} are "
                                      "outside the subset")
    if s[:1] in "'\"":
        value, j = _read_quoted(s, 0, lineno)
        _nothing_after(s, j, lineno)
        return value
    _check_plain(s, lineno)
    return _resolve_plain(s, lineno)


# -- block structure ----------------------------------------------------------

class _Lines:
    """The document's content lines as (indent, text, lineno), comments
    and blank lines dropped; ``push`` puts a line back in front."""

    def __init__(self, text: str):
        self.items: List[Tuple[int, str, int]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if not body.strip(" \t") or body.lstrip(" \t").startswith("#"):
                continue
            if body.startswith("\t"):
                raise YamlSubsetError(n, "tabs in indentation are outside "
                                         "the subset")
            text_ = _strip_comment(body)
            if len(raw) - len(body) == 0 and (text_.startswith("%") or
                                              text_ in ("---", "...") or
                                              text_.startswith("--- ")):
                raise YamlSubsetError(n, "directives and document markers "
                                         "are outside the subset")
            self.items.append((len(raw) - len(body), text_, n))
        self.pos = 0

    def peek(self) -> Optional[Tuple[int, str, int]]:
        return self.items[self.pos] if self.pos < len(self.items) else None

    def take(self) -> Tuple[int, str, int]:
        item = self.items[self.pos]
        self.pos += 1
        return item

    def push(self, item: Tuple[int, str, int]):
        self.items.insert(self.pos, item)


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _node(lines: _Lines, indent: int) -> Any:
    """The block node whose first line sits at ``indent``."""
    _ind, text, _n = lines.peek()
    if _is_seq_item(text):
        return _block_seq(lines, indent)
    if _split_key(text, _n) is not None:
        return _block_map(lines, indent)
    lines.take()
    value = _inline_value(text, _n)
    nxt = lines.peek()
    if nxt is not None and nxt[0] >= indent:
        raise YamlSubsetError(nxt[2], "a scalar continued over lines is "
                                      "outside the subset")
    return value


def _child(lines: _Lines, parent_indent: int, lineno: int,
           seq_at_parent: bool) -> Any:
    """The nested value of ``key:`` or ``-`` with nothing after it: a
    more-indented node, a sequence at the key's own indent (mapping
    values only), or null."""
    nxt = lines.peek()
    if nxt is None:
        return None
    ind, text, _n = nxt
    if ind > parent_indent:
        return _node(lines, ind)
    if seq_at_parent and ind == parent_indent and _is_seq_item(text):
        return _block_seq(lines, ind)
    return None


def _block_map(lines: _Lines, indent: int) -> dict:
    out: dict = {}
    while True:
        nxt = lines.peek()
        if nxt is None or nxt[0] < indent:
            return out
        ind, text, n = nxt
        if ind > indent:
            raise YamlSubsetError(n, "unexpected indentation")
        if _is_seq_item(text):
            return out          # an indentless sequence ends its parent
        kv = _split_key(text, n)
        if kv is None:
            raise YamlSubsetError(n, f"expected 'key: value', got {text!r}")
        lines.take()
        key, rest = kv
        if rest:
            value = _inline_value(rest, n)
            after = lines.peek()
            if after is not None and after[0] > indent:
                raise YamlSubsetError(after[2], "a value continued over "
                                                "lines is outside the "
                                                "subset")
        else:
            value = _child(lines, indent, n, seq_at_parent=True)
        out[key] = value


def _block_seq(lines: _Lines, indent: int) -> list:
    out: list = []
    while True:
        nxt = lines.peek()
        if nxt is None or nxt[0] != indent or not _is_seq_item(nxt[1]):
            if nxt is not None and nxt[0] > indent:
                raise YamlSubsetError(nxt[2], "unexpected indentation")
            return out
        ind, text, n = lines.take()
        rest = text[1:].lstrip(" ")
        if not rest:
            out.append(_child(lines, indent, n, seq_at_parent=False))
            continue
        # the item's content starts at its own column: put it back as a
        # line of its own there, so a `- key: v` item's later keys (at
        # the same column) join its mapping
        col = ind + (len(text) - len(rest))
        lines.push((col, rest, n))
        out.append(_node(lines, col))


def safe_load(stream) -> Any:
    """Parse one YAML document of the subset (a ``str``, ``bytes`` or a
    readable text file) as ``yaml.safe_load`` would."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    value = _node(lines, lines.peek()[0])
    left = lines.peek()
    if left is not None:
        raise YamlSubsetError(left[2], "unexpected content after the "
                                       "document's top node")
    return value
