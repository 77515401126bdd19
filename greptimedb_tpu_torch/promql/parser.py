"""PromQL parser (the reference links the promql-parser crate; here a
hand-written tokenizer + pratt parser covering the language surface the
reference's planner handles: selectors with matchers, range vectors,
offset, binary ops with bool/on/ignoring/group_left modifiers,
aggregations with by/without, functions, subqueries `expr[range:step]`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

DEFAULT_LOOKBACK_S = 300.0  # 5m, reference InstantManipulate lookback


class PromqlError(Exception):
    pass


# ---- AST -------------------------------------------------------------------


@dataclass(frozen=True)
class Matcher:
    label: str
    op: str  # = != =~ !~
    value: str


@dataclass(frozen=True)
class VectorSelector:
    metric: Optional[str]
    matchers: tuple[Matcher, ...] = ()
    range_s: Optional[float] = None  # set -> range vector
    offset_s: float = 0.0
    at_s: Optional[float] = None


@dataclass(frozen=True)
class NumberLiteral:
    value: float


@dataclass(frozen=True)
class StringLiteral:
    value: str


@dataclass(frozen=True)
class Call:
    func: str
    args: tuple = ()


@dataclass(frozen=True)
class Aggregate:
    op: str  # sum avg min max count topk bottomk quantile stddev stdvar count_values group
    expr: object
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()
    grouping: bool = False  # True if by/without present
    param: object = None  # k for topk, q for quantile


@dataclass(frozen=True)
class Binary:
    op: str
    lhs: object
    rhs: object
    bool_mod: bool = False
    on: Optional[tuple[str, ...]] = None
    ignoring: Optional[tuple[str, ...]] = None
    group_left: bool = False
    group_right: bool = False


@dataclass(frozen=True)
class Unary:
    op: str
    expr: object


@dataclass(frozen=True)
class Subquery:
    """`expr[range:step]` — inner expr evaluated on its own grid, then
    consumed like a range vector (reference planner subquery support)."""

    expr: object
    range_s: float
    step_s: Optional[float] = None  # None -> outer eval step
    offset_s: float = 0.0


AGG_OPS = {"sum", "avg", "min", "max", "count", "topk", "bottomk", "quantile",
           "stddev", "stdvar", "group", "count_values"}

# ---- lexer -----------------------------------------------------------------

_TOK = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<duration>\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y)(?:\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y))*)
  | (?P<number>0x[0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[iI][nN][fF](?![a-zA-Z0-9_:.])|[nN][aA][nN](?![a-zA-Z0-9_:.]))
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<ident>[a-zA-Z_:][a-zA-Z0-9_:.]*)
  | (?P<op>=~|!~|!=|==|<=|>=|[-+*/%^(){}\[\],=<>@])
    """,
    re.VERBOSE,
)

_DUR_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
              "d": 86400.0, "w": 604800.0, "y": 31536000.0}
_DUR_PART = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)")


def parse_duration_s(text: str) -> float:
    total = 0.0
    pos = 0
    for m in _DUR_PART.finditer(text):
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text) or total == 0 and text not in ("0s", "0ms"):
        if pos != len(text):
            raise PromqlError(f"bad duration {text!r}")
    return total


@dataclass
class Tok:
    kind: str
    value: str


def _tokenize(q: str) -> list[Tok]:
    out = []
    pos = 0
    while pos < len(q):
        m = _TOK.match(q, pos)
        if not m:
            raise PromqlError(f"unexpected character {q[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "string":
            text = _unescape(text[1:-1])
        out.append(Tok(kind, text))
    out.append(Tok("eof", ""))
    return out


def _unescape(s: str) -> str:
    return s.encode().decode("unicode_escape")


# ---- parser ----------------------------------------------------------------

_PRECEDENCE = {
    "or": 1, "unless": 2, "and": 2,
    "==": 3, "!=": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "+": 4, "-": 4, "*": 5, "/": 5, "%": 5, "^": 6,
}


class _Parser:
    def __init__(self, q: str):
        self.toks = _tokenize(q)
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def eat(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            self.next()
            return True
        return False

    def expect(self, kind: str, value: Optional[str] = None) -> Tok:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise PromqlError(f"expected {value or kind}, got {t.kind}:{t.value}")
        return t

    def parse(self):
        e = self.parse_expr(0)
        if self.peek().kind != "eof":
            t = self.peek()
            raise PromqlError(f"unexpected trailing {t.kind}:{t.value}")
        return e

    def parse_expr(self, min_prec: int):
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            op = t.value if t.kind in ("op", "ident") else None
            if op not in _PRECEDENCE or _PRECEDENCE[op] < min_prec:
                return lhs
            self.next()
            bool_mod = False
            on = ignoring = None
            gl = gr = False
            if self.peek().kind == "ident" and self.peek().value == "bool":
                self.next()
                bool_mod = True
            if self.peek().kind == "ident" and self.peek().value in ("on", "ignoring"):
                kw = self.next().value
                labels = self._label_list()
                if kw == "on":
                    on = labels
                else:
                    ignoring = labels
                if self.peek().kind == "ident" and self.peek().value in ("group_left", "group_right"):
                    kw2 = self.next().value
                    if self.eat("op", "("):
                        while not self.eat("op", ")"):
                            self.next()
                    gl, gr = kw2 == "group_left", kw2 == "group_right"
            prec = _PRECEDENCE[op]
            # ^ is right-associative
            rhs = self.parse_expr(prec if op == "^" else prec + 1)
            lhs = Binary(op, lhs, rhs, bool_mod, on, ignoring, gl, gr)

    def parse_unary(self):
        if self.eat("op", "-"):
            return Unary("-", self.parse_unary())
        if self.eat("op", "+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == "[":
                self.next()
                dur = self.expect("duration").value
                step = self._subquery_step()
                self.expect("op", "]")
                if step is not None:
                    e = Subquery(e, parse_duration_s(dur), step[0])
                else:
                    if not isinstance(e, VectorSelector) or e.range_s is not None:
                        raise PromqlError("range modifier on non-selector")
                    e = VectorSelector(e.metric, e.matchers, parse_duration_s(dur),
                                       e.offset_s, e.at_s)
            elif t.kind == "ident" and t.value == "offset":
                self.next()
                neg = self.eat("op", "-")
                dur = parse_duration_s(self.expect("duration").value)
                if isinstance(e, Subquery):
                    e = Subquery(e.expr, e.range_s, e.step_s,
                                 (-dur if neg else dur))
                elif isinstance(e, VectorSelector):
                    e = VectorSelector(e.metric, e.matchers, e.range_s,
                                       (-dur if neg else dur), e.at_s)
                else:
                    raise PromqlError("offset on non-selector")
            elif t.kind == "op" and t.value == "@":
                self.next()
                if not isinstance(e, VectorSelector):
                    raise PromqlError(
                        "@ modifier is only supported on selectors "
                        "(not subqueries)")
                nt = self.peek()
                if nt.kind == "ident" and nt.value in ("start", "end"):
                    # @ start() / @ end() resolve to the query range's
                    # boundaries at eval time (Prometheus preprocessors)
                    self.next()
                    self.expect("op", "(")
                    self.expect("op", ")")
                    at = f"__{nt.value}__"
                else:
                    neg = self.eat("op", "-")
                    tok = self.expect("number").value.lower()
                    if tok.startswith("0x") or tok in ("inf", "nan"):
                        raise PromqlError(
                            f"@ needs a decimal timestamp, got {tok!r}")
                    at = float(tok) * (-1.0 if neg else 1.0)
                e = VectorSelector(e.metric, e.matchers, e.range_s, e.offset_s, at)
            else:
                return e

    def parse_primary(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = t.value.lower()
            if v.startswith("0x"):
                return NumberLiteral(float(int(v, 16)))
            if v == "inf":
                return NumberLiteral(float("inf"))
            if v == "nan":
                return NumberLiteral(float("nan"))
            return NumberLiteral(float(t.value))
        if t.kind == "duration":
            self.next()
            return NumberLiteral(parse_duration_s(t.value))
        if t.kind == "string":
            self.next()
            return StringLiteral(t.value)
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.parse_expr(0)
            self.expect("op", ")")
            return e
        if t.kind == "op" and t.value == "{":
            return self._selector(None)
        if t.kind == "ident":
            name = self.next().value
            if name in AGG_OPS:
                return self._aggregate(name)
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                args = []
                while not self.eat("op", ")"):
                    args.append(self.parse_expr(0))
                    self.eat("op", ",")
                return Call(name, tuple(args))
            return self._selector(name)
        raise PromqlError(f"unexpected token {t.kind}:{t.value}")

    def _subquery_step(self):
        """Inside `[dur ...`: detect the subquery `:step` part. The
        tokenizer folds a leading ':' into an ident (metric names may
        contain ':'), so ':1m' or ':' arrive as idents. Returns None when
        this is a plain range vector, else a 1-tuple holding the step
        (None = default resolution)."""
        t = self.peek()
        if t.kind != "ident" or not t.value.startswith(":"):
            return None
        self.next()
        rest = t.value[1:]
        if rest:
            return (parse_duration_s(rest),)
        if self.peek().kind == "duration":
            return (parse_duration_s(self.next().value),)
        return (None,)

    def _selector(self, metric: Optional[str]) -> VectorSelector:
        matchers: list[Matcher] = []
        if self.peek().kind == "op" and self.peek().value == "{":
            self.next()
            while not self.eat("op", "}"):
                label = self.expect("ident").value
                op_t = self.next()
                if op_t.value not in ("=", "!=", "=~", "!~"):
                    raise PromqlError(f"bad matcher op {op_t.value}")
                val = self.expect("string").value
                matchers.append(Matcher(label, op_t.value, val))
                self.eat("op", ",")
        if metric is None and not matchers:
            raise PromqlError("empty selector")
        return VectorSelector(metric, tuple(matchers))

    def _label_list(self) -> tuple[str, ...]:
        self.expect("op", "(")
        labels = []
        while not self.eat("op", ")"):
            labels.append(self.expect("ident").value)
            self.eat("op", ",")
        return tuple(labels)

    def _aggregate(self, op: str) -> Aggregate:
        by: tuple[str, ...] = ()
        without: tuple[str, ...] = ()
        grouping = False
        if self.peek().kind == "ident" and self.peek().value in ("by", "without"):
            kw = self.next().value
            labels = self._label_list()
            grouping = True
            if kw == "by":
                by = labels
            else:
                without = labels
        self.expect("op", "(")
        args = [self.parse_expr(0)]
        while self.eat("op", ","):
            args.append(self.parse_expr(0))
        self.expect("op", ")")
        if self.peek().kind == "ident" and self.peek().value in ("by", "without"):
            kw = self.next().value
            labels = self._label_list()
            grouping = True
            if kw == "by":
                by = labels
            else:
                without = labels
        param = None
        expr = args[-1]
        if len(args) == 2:
            param = args[0]
        elif len(args) > 2:
            raise PromqlError(f"{op} takes at most 2 args")
        return Aggregate(op, expr, by, without, grouping, param)


def parse_promql(q: str):
    return _Parser(q).parse()
