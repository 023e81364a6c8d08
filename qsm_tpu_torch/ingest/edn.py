"""Minimal EDN-map-line tokenizer/renderer for the ingest adapters.

Jepsen/Knossos histories and porcupine's test corpora are streams of
one-flat-EDN-map-per-line events (``{:process 0, :type :invoke,
:f :write, :value 1}``).  This module parses exactly that subset —
keywords, integers, nil, strings, and flat vectors of those — and
renders it back CANONICALLY (one space after commas, no trailing
separators, keys in the order the adapter specifies), so
``emit(parse(text)) == text`` for canonical files: the byte-stable
round-trip the golden-log tests pin.  It is deliberately NOT a general
EDN reader; anything outside the subset is refused loudly with the
line number (an ingest adapter must never guess at a trace).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

Value = Union[int, str, None, List["Value"]]


class EdnError(ValueError):
    """Unparsable event line — refused with position context."""


class _Cursor:
    __slots__ = ("s", "i")

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def skip_ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t,":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c


def _parse_value(c: _Cursor) -> Value:
    c.skip_ws()
    ch = c.peek()
    if ch == ":":
        c.take()
        start = c.i
        while c.peek() and c.peek() not in " \t,{}[]":
            c.take()
        return ":" + c.s[start:c.i]
    if ch == "[":
        c.take()
        out: List[Value] = []
        while True:
            c.skip_ws()
            if c.peek() == "]":
                c.take()
                return out
            if not c.peek():
                raise EdnError("unterminated vector")
            out.append(_parse_value(c))
    if ch == '"':
        c.take()
        start = c.i
        while c.peek() and c.peek() != '"':
            c.take()
        if c.peek() != '"':
            raise EdnError("unterminated string")
        s = c.s[start:c.i]
        c.take()
        return s
    start = c.i
    while c.peek() and c.peek() not in " \t,{}[]":
        c.take()
    tok = c.s[start:c.i]
    if not tok:
        raise EdnError(f"empty token at column {c.i}")
    if tok == "nil":
        return None
    try:
        return int(tok)
    except ValueError:
        raise EdnError(f"unsupported token {tok!r} (int/nil/:kw/"
                       "[...]/\"str\" only)") from None


def parse_map_line(line: str) -> dict:
    """One flat EDN map line → ``{keyword-without-colon: value}``."""
    c = _Cursor(line.strip())
    if c.take() != "{":
        raise EdnError("event line must be one EDN map ({...})")
    out: dict = {}
    while True:
        c.skip_ws()
        if c.peek() == "}":
            c.take()
            c.skip_ws()
            if c.peek():
                raise EdnError(f"trailing content {c.s[c.i:]!r}")
            return out
        if not c.peek():
            raise EdnError("unterminated map")
        k = _parse_value(c)
        if not isinstance(k, str) or not k.startswith(":"):
            raise EdnError(f"map key must be a keyword, got {k!r}")
        out[k[1:]] = _parse_value(c)


def render_value(v: Value) -> str:
    if v is None:
        return "nil"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return v if v.startswith(":") else f'"{v}"'
    return "[" + " ".join(render_value(x) for x in v) + "]"


def render_map_line(pairs: List[Tuple[str, Value]]) -> str:
    """``[(key, value), ...]`` → the canonical one-line map (key order
    preserved — the adapter owns it, so emits are deterministic)."""
    inner = ", ".join(f":{k} {render_value(v)}" for k, v in pairs)
    return "{" + inner + "}"


def parse_lines(text: str):
    """Yield ``(line_no, doc)`` for each nonempty line; EdnError gains
    the line number."""
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith(";"):
            continue
        try:
            yield i, parse_map_line(line)
        except EdnError as e:
            raise EdnError(f"line {i}: {e}") from None
