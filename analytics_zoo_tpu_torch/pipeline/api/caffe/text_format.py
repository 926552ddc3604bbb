"""Protobuf text-format parser for ``.prototxt`` network definitions; a
copy of ``analytics_zoo_tpu/pipeline/api/caffe/text_format.py``.

The reference reads prototxt through ``TextFormat.merge``
(``CaffeLoader.scala`` ``loadCaffe``/``parseText``). This is the ~150-line
equivalent: a tokenizer + recursive-descent parser producing the same
``Msg`` dicts as the binary decoder in ``proto.py``, so the loader consumes
one representation regardless of source. Enum literals (``MAX``, ``SUM``,
``TRAIN``...) are mapped to their wire integers; unknown fields parse and
drop (forward compatibility, matching protobuf semantics loosely).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from ..onnx.proto import Msg
from .proto import SCHEMAS

_TOKEN_RE = re.compile(r"""
    \s+
  | \#[^\n]*
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}:<>\[\],;])
  | (?P<atom>[^\s{}:<>\[\],;#]+)
""", re.VERBOSE)

# Enum literals are FIELD-scoped in protobuf text format — the same name
# can carry different wire values per enum type (PoolMethod.MAX=0 but
# EltwiseOp.MAX=2), so resolution is keyed by (schema, field) first.
_FIELD_ENUMS = {
    ("PoolingParameter", "pool"): {"MAX": 0, "AVE": 1, "STOCHASTIC": 2},
    ("PoolingParameter", "round_mode"): {"CEIL": 0, "FLOOR": 1},
    ("EltwiseParameter", "operation"): {"PROD": 0, "SUM": 1, "MAX": 2},
    ("LRNParameter", "norm_region"): {"ACROSS_CHANNELS": 0,
                                      "WITHIN_CHANNEL": 1},
    ("NetStateRule", "phase"): {"TRAIN": 0, "TEST": 1},
    ("LayerParameter", "phase"): {"TRAIN": 0, "TEST": 1},
}

_ENUMS = {
    # booleans + phase literals that appear outside schema-known fields
    "TRAIN": 0, "TEST": 1,
    "true": 1, "false": 0,
}


def _tokenize(text: str) -> List[str]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt parse error at offset {pos}: "
                             f"{text[pos:pos + 40]!r}")
        pos = m.end()
        for group in ("string", "punct", "atom"):
            val = m.group(group)
            if val is not None:
                tokens.append(val)
                break
    return tokens


def _coerce(atom: str) -> Any:
    if atom and (atom[0] in "\"'"):
        return atom[1:-1].encode().decode("unicode_escape")
    if atom in _ENUMS:
        return _ENUMS[atom]
    try:
        return int(atom)
    except ValueError:
        pass
    try:
        return float(atom)
    except ValueError:
        return atom


class _Parser:
    def __init__(self, tokens: List[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def parse_message(self, schema: Optional[str],
                      stop_at_brace: bool) -> Msg:
        fields = SCHEMAS.get(schema, {}) if schema else {}
        by_name = {name: (kind, rep) for _, (name, kind, rep)
                   in fields.items()}
        out = Msg()
        for name, (kind, rep) in by_name.items():
            if rep:
                out[name] = []
        while True:
            tok = self.peek()
            if tok is None:
                if stop_at_brace:
                    raise ValueError("unexpected EOF in message")
                return out
            if tok in ("}", ">"):
                self.next()
                return out
            name = self.next()
            kind, rep = by_name.get(name, (None, None))
            tok = self.peek()
            if tok == ":":
                self.next()
                tok = self.peek()
            if tok in ("{", "<"):
                self.next()
                value: Any = self.parse_message(
                    kind if kind in SCHEMAS else None, True)
            else:
                raw = self.next()
                field_enums = _FIELD_ENUMS.get((schema, name))
                if field_enums and raw in field_enums:
                    value = field_enums[raw]
                else:
                    value = _coerce(raw)
                if kind in ("int", "bool") and isinstance(value, float):
                    value = int(value)
                if kind in ("float32", "float64"):
                    value = float(value)
            if name not in by_name:
                continue                      # unknown field: parse + drop
            if rep:
                out[name].append(value)
            else:
                out[name] = value
        return out


def parse_prototxt(text: str) -> Msg:
    """Parse a deploy prototxt into a NetParameter ``Msg``."""
    return _Parser(_tokenize(text)).parse_message("NetParameter", False)
