"""Whitespace tokenizer for the reference's scene/config text grammar
(counterpart of craytracer_tpu/io/tokenizer.py:1-63, which is
framework-free and carried over verbatim): '#'-to-EOL comments are
stripped the way loadSceneFile does (buildscene.h:401-404), and `atof`
keeps C semantics for malformed floats such as `548.8.0`."""

from __future__ import annotations

import re

_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def tokenize(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        for tok in line.split():
            if tok.startswith("#"):
                break  # comment to end of line
            out.append(tok)
    return out


def atof(tok: str) -> float:
    """C `atof` semantics: parse the longest valid leading float, else 0.
    The shipped scenes contain malformed numbers like `548.8.0`
    (cornell_box.txt backwall HEIGHT) that atof reads as 548.8."""
    m = _FLOAT_RE.match(tok)
    return float(m.group(0)) if m else 0.0


def atoi(tok: str) -> int:
    m = re.match(r"^[+-]?\d+", tok)
    return int(m.group(0)) if m else 0


class TokenStream:
    def __init__(self, tokens: list[str]):
        self.tokens = tokens
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.tokens)

    def peek(self) -> str | None:
        return self.tokens[self.pos] if not self.eof() else None

    def next(self) -> str | None:
        t = self.peek()
        if t is not None:
            self.pos += 1
        return t

    def next_float(self) -> float:
        return atof(self.next() or "")

    def next_int(self) -> int:
        return atoi(self.next() or "")

    def next_vec3(self):
        return (self.next_float(), self.next_float(), self.next_float())
