"""TQL lexer: regex tokenizer, case-insensitive keywords."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "ORDER", "ARRANGE", "SAMPLE", "GROUP", "BY",
    "AS", "LIMIT", "OFFSET", "VERSION", "ASC", "DESC", "AND", "OR", "NOT",
    "TRUE", "FALSE", "NULL", "REPLACE", "IN",
}

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<COMMENT>--[^\n]*)
  | (?P<NUMBER>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<STRING>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<IDENT>[A-Za-z_][A-Za-z_0-9]*(?:/[A-Za-z_0-9]+)*)
  | (?P<OP>==|!=|<>|>=|<=|[-+*/%(),\[\]:><.])
""", re.VERBOSE)


@dataclass
class Token:
    kind: str   # KEYWORD | IDENT | NUMBER | STRING | OP | EOF
    value: str
    pos: int


class TQLSyntaxError(ValueError):
    pass


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise TQLSyntaxError(f"bad character {text[pos]!r} at {pos}")
        kind = m.lastgroup
        val = m.group()
        pos = m.end()
        if kind in ("WS", "COMMENT"):
            continue
        if kind == "IDENT" and val.upper() in KEYWORDS:
            out.append(Token("KEYWORD", val.upper(), m.start()))
        elif kind == "STRING":
            body = val[1:-1]
            body = body.replace('\\"', '"').replace("\\'", "'").replace("\\\\", "\\")
            out.append(Token("STRING", body, m.start()))
        elif kind == "OP" and val == "<>":
            out.append(Token("OP", "!=", m.start()))
        else:
            out.append(Token(kind, val, m.start()))
    out.append(Token("EOF", "", len(text)))
    return out
