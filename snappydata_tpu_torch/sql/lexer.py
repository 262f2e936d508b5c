"""SQL tokenizer (hand-rolled; the reference rolls its own grammar too —
parboiled2 PEG, core/.../SnappyBaseParser.scala:26)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


class SQLSyntaxError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str   # KW, IDENT, NUM, STR, OP, EOF
    value: str
    pos: int


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "distinct", "all",
    "join", "inner", "left", "right", "full", "outer", "cross", "semi",
    "anti", "natural", "on", "using", "union", "intersect",
    "except", "minus", "asc", "desc", "nulls",
    "first", "last", "exists", "create", "table", "drop", "truncate",
    "insert", "put", "overwrite", "into", "values", "update", "set",
    "delete", "if", "temporary", "view", "replace", "show", "tables",
    "describe", "interval", "date", "timestamp", "true", "false",
    "primary", "key", "options", "external", "sample", "stream", "policy",
    "index", "alter", "add", "column", "deploy", "undeploy", "grant",
    "revoke", "with", "to", "exec", "scala", "over", "explain",
    "function", "returns", "materialized", "refresh",
}

_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||"}


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SQLSyntaxError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    seen_exp = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            out.append(Token("NUM", sql[i:j], i))
            i = j
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise SQLSyntaxError(f"unterminated string at {i}")
            out.append(Token("STR", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":  # quoted identifier
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise SQLSyntaxError(f"unterminated identifier at {i}")
            out.append(Token("IDENT", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            kind = "KW" if word.lower() in KEYWORDS else "IDENT"
            out.append(Token(kind, word, i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR_OPS:
            out.append(Token("OP", two, i))
            i += 2
            continue
        if c in "+-*/%(),.=<>?;[]:":
            out.append(Token("OP", c, i))
            i += 1
            continue
        raise SQLSyntaxError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", "", n))
    return out
