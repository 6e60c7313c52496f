"""Schema-free protobuf text-format parser (the prototxt dialect).

The port's own copy of `deepcut_tpu.proto.text_format` (jax-free; held against the original
by tests/test_torch_data.py).

The reference consumes model/solver definitions as protobuf text files
(src/caffe/util/io.cpp ReadProtoFromTextFile); we parse the same files into a
lightweight `PbNode` tree without requiring compiled protobuf schemas. Typing
is resolved lazily by the consumers (`netparam.py`), which know which fields
are ints/floats/enums — exactly the information `caffe.proto` encodes.

Grammar handled: `key: value` scalars (int/float/string/bool/enum ident),
`key { ... }` / `key: { ... }` messages, repeated keys, `#` comments,
single/double-quoted strings with escapes, and `key: [v1, v2]` short lists.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union


class PbNode:
    """One message instance: an ordered multimap of field -> scalars/subnodes."""

    __slots__ = ("fields",)

    def __init__(self) -> None:
        self.fields: Dict[str, List[Any]] = {}

    def add(self, key: str, value: Any) -> None:
        self.fields.setdefault(key, []).append(value)

    # -- accessors ---------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        vals = self.fields.get(key)
        return vals[0] if vals else default

    def get_list(self, key: str) -> List[Any]:
        return self.fields.get(key, [])

    def has(self, key: str) -> bool:
        return key in self.fields

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: Optional[bool] = None) -> Optional[bool]:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def get_str(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self.get(key)
        return default if v is None else str(v)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"PbNode({list(self.fields)})"


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}:\[\],;])
  | (?P<atom>[^\s{}:\[\],;#]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> Iterator[str]:
    for m in _TOKEN_RE.finditer(text):
        if m.lastgroup == "comment":
            continue
        yield m.group(0)


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'", "0": "\0"}


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?((\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?|inf|nan)$")


def _coerce(tok: str) -> Any:
    if tok == "true":
        return True
    if tok == "false":
        return False
    if _INT_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok):
        return float(tok)
    return tok  # enum identifier or unquoted string


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def parse_message(self, top: bool = False) -> PbNode:
        node = PbNode()
        while True:
            tok = self.peek()
            if tok is None:
                if top:
                    return node
                raise ValueError("unexpected EOF inside message")
            if tok == "}":
                self.next()
                return node
            key = self.next()
            sep = self.peek()
            if sep == ":":
                self.next()
                nxt = self.peek()
                if nxt == "{":
                    self.next()
                    node.add(key, self.parse_message())
                elif nxt == "[":
                    self.next()
                    for v in self._parse_list():
                        node.add(key, v)
                else:
                    node.add(key, self._parse_scalar())
            elif sep == "{":
                self.next()
                node.add(key, self.parse_message())
            else:
                raise ValueError(f"expected ':' or '{{' after {key!r}, got {sep!r}")
            while self.peek() in (";", ","):
                self.next()

    def _parse_scalar(self) -> Any:
        tok = self.next()
        if tok and tok[0] in "\"'":
            val = _unquote(tok)
            # Text format concatenates adjacent string literals.
            while self.peek() and self.peek()[0] in "\"'":
                val += _unquote(self.next())
            return val
        return _coerce(tok)

    def _parse_list(self) -> List[Any]:
        vals: List[Any] = []
        while True:
            tok = self.peek()
            if tok == "]":
                self.next()
                return vals
            if tok == ",":
                self.next()
                continue
            vals.append(self._parse_scalar())


def parse(text: str) -> PbNode:
    return _Parser(list(_tokenize(text))).parse_message(top=True)


def parse_file(path: str) -> PbNode:
    with open(path, "r") as f:
        return parse(f.read())


def dump(node: PbNode, indent: int = 0) -> str:
    """Serialise back to prototxt text (round-trip for net_spec / tooling)."""
    pad = "  " * indent
    lines: List[str] = []
    for key, vals in node.fields.items():
        for v in vals:
            if isinstance(v, PbNode):
                lines.append(f"{pad}{key} {{")
                lines.append(dump(v, indent + 1))
                lines.append(f"{pad}}}")
            elif isinstance(v, bool):
                lines.append(f"{pad}{key}: {'true' if v else 'false'}")
            elif isinstance(v, str) and not _is_enum_like(v):
                esc = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
                lines.append(f'{pad}{key}: "{esc}"')
            else:
                lines.append(f"{pad}{key}: {v}")
    return "\n".join(l for l in lines if l != "")


_ENUM_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _is_enum_like(s: str) -> bool:
    return bool(_ENUM_RE.match(s))
