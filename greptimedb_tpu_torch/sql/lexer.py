"""SQL tokenizer."""

from __future__ import annotations

import re

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "asc", "desc", "and", "or", "not", "in", "between", "like",
    "is", "null", "true", "false", "as", "distinct", "create", "table",
    "database", "schema", "if", "exists", "primary", "key", "time", "index",
    "engine", "with", "insert", "into", "values", "delete", "drop", "show",
    "tables", "databases", "describe", "desc", "explain", "analyze", "use",
    "interval", "cast", "case", "when", "then", "else", "end", "truncate",
    "alter", "add", "column", "rename", "to", "tql", "eval", "evaluate",
    "align", "range", "fill", "partition", "on", "nulls", "first", "last",
    "admin", "verbose", "copy", "default", "flow", "flows", "sink", "set",
    "external",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*|/\*.*?\*/)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|!=|<>|=~|!~|\|\||::|[-+*/%(),.=<>;@\[\]{}~:])
    """,
    re.VERBOSE | re.DOTALL,
)


class Token:
    """__slots__ class, not a frozen dataclass: tokenization is on the
    per-statement hot path (a 500-row INSERT is ~13k tokens) and frozen
    dataclass __init__ costs ~3x a plain __init__."""

    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind  # keyword | ident | number | string | op | eof
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value}"


class SqlError(Exception):
    pass


def tokenize(sql: str) -> list[Token]:
    # one finditer sweep instead of per-token .match calls; gaps between
    # consecutive matches are exactly the "unexpected character" cases
    tokens: list[Token] = []
    append = tokens.append
    keywords = KEYWORDS
    last = 0
    for m in _TOKEN_RE.finditer(sql):
        start = m.start()
        if start != last:
            raise SqlError(
                f"unexpected character {sql[last]!r} at {last}")
        last = m.end()
        kind = m.lastgroup
        if kind == "ws" or kind == "comment":
            continue
        text = m.group()
        if kind == "ident":
            low = text.lower()
            if low in keywords:
                append(Token("keyword", low, start))
            else:
                append(Token("ident", text, start))
        elif kind == "qident":
            q = text[0]
            append(Token("ident", text[1:-1].replace(q * 2, q), start))
        elif kind == "string":
            append(Token("string", text[1:-1].replace("''", "'"), start))
        elif kind == "number":
            append(Token("number", text, start))
        else:
            append(Token("op", text, start))
    if last != len(sql):
        raise SqlError(f"unexpected character {sql[last]!r} at {last}")
    append(Token("eof", "", len(sql)))
    return tokens
