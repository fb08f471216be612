"""SQL tokenizer + recursive-descent parser for the SELECT dialect (the
port's own copy of the reference package's `sql/parser.py`, stdlib only).

Reference analog: Calcite's parser/validator as driven by
sql/src/main/java/org/apache/druid/sql/calcite/planner/DruidPlanner.java.
This is a from-scratch implementation of the subset Druid SQL exercises:
SELECT [DISTINCT] items FROM table [WHERE] [GROUP BY] [HAVING] [ORDER BY]
[LIMIT] [OFFSET], with CASE/CAST/EXTRACT/FLOOR..TO/SUBSTRING/TRIM syntax,
aggregate FILTER (WHERE ...) clauses, COUNT(DISTINCT x), TIMESTAMP/DATE/
INTERVAL literals, and ? parameter placeholders (Avatica-style).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Lit:
    value: object                 # str | int | float | bool | None
    type: str = "unknown"         # string | long | double | bool | null | timestamp | interval

    def __str__(self):
        return repr(self.value)


@dataclass(frozen=True)
class Col:
    name: str

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Star:
    def __str__(self):
        return "*"


@dataclass(frozen=True)
class Fn:
    name: str                    # upper-cased
    args: Tuple[object, ...] = ()
    distinct: bool = False
    filter: Optional[object] = None   # FILTER (WHERE <expr>)
    extra: Optional[str] = None       # e.g. FLOOR(x TO DAY) unit, EXTRACT field

    def __str__(self):
        a = ", ".join(str(x) for x in self.args)
        d = "DISTINCT " if self.distinct else ""
        e = f" TO {self.extra}" if self.extra else ""
        return f"{self.name}({d}{a}{e})"


@dataclass(frozen=True)
class Bin:
    op: str
    left: object
    right: object

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class Un:
    op: str                      # NOT | -
    operand: object

    def __str__(self):
        return f"{self.op}({self.operand})"


@dataclass(frozen=True)
class InExpr:
    operand: object
    values: Tuple[object, ...]
    negated: bool = False
    #: `IN (SELECT ...)` semi-join form — the executor materializes the
    #: inner query's single output column into `values` before planning
    #: (reference: sql/.../calcite/rel/DruidSemiJoin.java)
    subquery: Optional["Select"] = None


@dataclass(frozen=True)
class LikeExpr:
    operand: object
    pattern: object
    negated: bool = False


@dataclass(frozen=True)
class BetweenExpr:
    operand: object
    low: object
    high: object
    negated: bool = False


@dataclass(frozen=True)
class IsNullExpr:
    operand: object
    negated: bool = False


@dataclass(frozen=True)
class Case:
    whens: Tuple[Tuple[object, object], ...]
    else_: Optional[object] = None


@dataclass(frozen=True)
class Cast:
    operand: object
    to_type: str


@dataclass(frozen=True)
class SelectItem:
    expr: object
    alias: Optional[str] = None


@dataclass(frozen=True)
class OrderItem:
    expr: object
    descending: bool = False


@dataclass(frozen=True)
class Select:
    items: Tuple[SelectItem, ...]
    table: Optional[str] = None
    schema: Optional[str] = None        # e.g. INFORMATION_SCHEMA
    subquery: Optional["Select"] = None  # FROM (SELECT ...) [alias]
    where: Optional[object] = None
    group_by: Tuple[object, ...] = ()
    having: Optional[object] = None
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    explain: bool = False


@dataclass(frozen=True)
class Union:
    """`SELECT ... UNION ALL SELECT ... [ORDER BY] [LIMIT] [OFFSET]` — arms
    execute independently and concatenate; ORDER BY/LIMIT bind to the whole
    union (reference: sql/.../calcite/rel/DruidUnionRel.java). Column names
    come from the first arm."""
    arms: Tuple[Select, ...]
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0
    explain: bool = False


class SqlParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||[=<>+\-*/%(),.?])
""", re.VERBOSE)

_KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER",
    "LIMIT", "OFFSET", "AS", "AND", "OR", "NOT", "IN", "LIKE", "BETWEEN",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "EXTRACT", "ASC", "DESC", "FILTER", "TIMESTAMP", "DATE",
    "INTERVAL", "TO", "FOR", "EXPLAIN", "PLAN", "SUBSTRING", "TRIM",
    "LEADING", "TRAILING", "BOTH", "UNION", "ALL",
}


@dataclass(frozen=True)
class _Tok:
    kind: str      # num | str | id | qid | op | kw | eof
    text: str
    pos: int


def _tokenize(sql: str) -> List[_Tok]:
    out, i = [], 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlParseError(f"cannot tokenize at {sql[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "id" and text.upper() in _KEYWORDS:
            out.append(_Tok("kw", text.upper(), m.start()))
        else:
            out.append(_Tok(kind, text, m.start()))
    out.append(_Tok("eof", "", len(sql)))
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_AGG_FNS = {"COUNT", "SUM", "MIN", "MAX", "AVG", "APPROX_COUNT_DISTINCT",
            "APPROX_QUANTILE", "STDDEV", "STDDEV_POP", "STDDEV_SAMP",
            "VARIANCE", "VAR_POP", "VAR_SAMP", "EARLIEST", "LATEST",
            "DS_THETA", "DS_QUANTILES_SKETCH", "BLOOM_FILTER"}


class _P:
    def __init__(self, tokens: List[_Tok], params: Sequence[object] = ()):
        self.toks = tokens
        self.i = 0
        self.params = list(params)
        self.param_i = 0

    # -- token helpers
    def peek(self, k: int = 0) -> _Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.text in kws:
            self.i += 1
            return t.text
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlParseError(f"expected {kw}, got {self.peek().text!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.text == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlParseError(f"expected {op!r}, got {self.peek().text!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "id":
            self.i += 1
            return t.text
        if t.kind == "qid":
            self.i += 1
            return t.text[1:-1].replace('""', '"')
        # soft keywords usable as identifiers
        if t.kind == "kw" and t.text in ("PLAN", "TIMESTAMP", "DATE", "TO"):
            self.i += 1
            return t.text
        raise SqlParseError(f"expected identifier, got {t.text!r}")

    # -- entry
    def statement(self):
        """Top-level: a Select or a `UNION ALL` chain (Union)."""
        first = self.select(top_level=False)
        if not self.accept_kw("UNION"):
            if self.peek().kind != "eof":
                raise SqlParseError(
                    f"unexpected trailing {self.peek().text!r}")
            return first
        if first.order_by or first.limit is not None or first.offset:
            raise SqlParseError(
                "ORDER BY/LIMIT/OFFSET before UNION ALL bind to the whole "
                "union — move them after the last arm")
        self.expect_kw("ALL")
        arms = [first, self.select(top_level=False, allow_order=False)]
        while self.accept_kw("UNION"):
            self.expect_kw("ALL")
            arms.append(self.select(top_level=False, allow_order=False))
        order_by, limit, offset = self._order_limit_offset()
        if self.peek().kind != "eof":
            raise SqlParseError(f"unexpected trailing {self.peek().text!r}")
        return Union(tuple(arms), tuple(order_by), limit, offset,
                     first.explain)

    def _order_limit_offset(self):
        order_by: List[OrderItem] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.order_item())
            while self.accept_op(","):
                order_by.append(self.order_item())
        limit = None
        if self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind != "num":
                raise SqlParseError(f"LIMIT expects a number, got {t.text!r}")
            limit = int(t.text)
        offset = 0
        if self.accept_kw("OFFSET"):
            t = self.next()
            if t.kind != "num":
                raise SqlParseError(f"OFFSET expects a number, got {t.text!r}")
            offset = int(t.text)
        return order_by, limit, offset

    def select(self, top_level: bool = True,
               allow_order: bool = True) -> Select:
        explain = False
        if self.accept_kw("EXPLAIN"):
            self.expect_kw("PLAN")
            self.expect_kw("FOR")
            explain = True
        self.expect_kw("SELECT")
        distinct = bool(self.accept_kw("DISTINCT"))
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        table = schema = None
        subquery = None
        if self.accept_kw("FROM"):
            if self.accept_op("("):
                # FROM (SELECT ...) [alias] — nested query datasource
                subquery = self.select(top_level=False)
                self.expect_op(")")
                if self.peek().kind in ("id", "qid") or \
                        (self.peek().kind == "kw"
                         and self.peek().text == "AS"):
                    self.accept_kw("AS")
                    self.ident()   # alias accepted, unused (one subquery)
                table = "__subquery__"
            else:
                name = self.ident()
                if self.accept_op("."):
                    schema, table = name, self.ident()
                else:
                    table = name
        where = self.expr() if self.accept_kw("WHERE") else None
        group_by: List[object] = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.expr())
            while self.accept_op(","):
                group_by.append(self.expr())
        having = self.expr() if self.accept_kw("HAVING") else None
        if allow_order:
            order_by, limit, offset = self._order_limit_offset()
        else:
            order_by, limit, offset = [], None, 0
        if top_level and self.peek().kind != "eof":
            raise SqlParseError(f"unexpected trailing {self.peek().text!r}")
        return Select(tuple(items), table, schema, subquery, where,
                      tuple(group_by), having, tuple(order_by), limit,
                      offset, distinct, explain)

    def select_item(self) -> SelectItem:
        if self.peek().kind == "op" and self.peek().text == "*":
            self.next()
            return SelectItem(Star())
        e = self.expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in ("id", "qid"):
            alias = self.ident()
        return SelectItem(e, alias)

    def order_item(self) -> OrderItem:
        e = self.expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        return OrderItem(e, desc)

    # -- expression precedence climb
    def expr(self) -> object:
        return self.or_expr()

    def or_expr(self) -> object:
        left = self.and_expr()
        while self.accept_kw("OR"):
            left = Bin("OR", left, self.and_expr())
        return left

    def and_expr(self) -> object:
        left = self.not_expr()
        while self.accept_kw("AND"):
            left = Bin("AND", left, self.not_expr())
        return left

    def not_expr(self) -> object:
        if self.accept_kw("NOT"):
            return Un("NOT", self.not_expr())
        return self.comparison()

    def comparison(self) -> object:
        left = self.additive()
        t = self.peek()
        if t.kind == "op" and t.text in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = "<>" if t.text == "!=" else t.text
            return Bin(op, left, self.additive())
        if t.kind == "kw" and t.text == "IS":
            self.next()
            neg = bool(self.accept_kw("NOT"))
            self.expect_kw("NULL")
            return IsNullExpr(left, neg)
        neg = bool(self.accept_kw("NOT"))
        if self.accept_kw("IN"):
            self.expect_op("(")
            if self.peek().kind == "kw" and self.peek().text == "SELECT":
                sub = self.select(top_level=False)
                self.expect_op(")")
                return InExpr(left, (), neg, sub)
            vals = [self.expr()]
            while self.accept_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            return InExpr(left, tuple(vals), neg)
        if self.accept_kw("LIKE"):
            return LikeExpr(left, self.additive(), neg)
        if self.accept_kw("BETWEEN"):
            low = self.additive()
            self.expect_kw("AND")
            return BetweenExpr(left, low, self.additive(), neg)
        if neg:
            raise SqlParseError("NOT must precede IN/LIKE/BETWEEN here")
        return left

    def additive(self) -> object:
        left = self.multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-", "||"):
                self.next()
                left = Bin(t.text, left, self.multiplicative())
            else:
                return left

    def multiplicative(self) -> object:
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                left = Bin(t.text, left, self.unary())
            else:
                return left

    def unary(self) -> object:
        if self.accept_op("-"):
            operand = self.unary()
            if isinstance(operand, Lit) and operand.type in ("long", "double"):
                return Lit(-operand.value, operand.type)
            return Un("-", operand)
        self.accept_op("+")
        return self.primary()

    def primary(self) -> object:
        t = self.peek()
        if t.kind == "num":
            self.next()
            if re.search(r"[.eE]", t.text):
                return Lit(float(t.text), "double")
            return Lit(int(t.text), "long")
        if t.kind == "str":
            self.next()
            return Lit(t.text[1:-1].replace("''", "'"), "string")
        if t.kind == "op" and t.text == "?":
            self.next()
            if self.param_i >= len(self.params):
                raise SqlParseError("not enough parameters for ? placeholders")
            v = self.params[self.param_i]
            self.param_i += 1
            if v is None:
                return Lit(None, "null")
            if isinstance(v, bool):
                return Lit(v, "bool")
            if isinstance(v, int):
                return Lit(v, "long")
            if isinstance(v, float):
                return Lit(v, "double")
            return Lit(str(v), "string")
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "kw":
            return self.kw_primary(t)
        if t.kind in ("id", "qid"):
            name = self.ident()
            if self.accept_op("("):
                return self.call(name.upper())
            return Col(name)
        raise SqlParseError(f"unexpected {t.text!r}")

    def kw_primary(self, t: _Tok) -> object:
        if self.accept_kw("TRUE"):
            return Lit(True, "bool")
        if self.accept_kw("FALSE"):
            return Lit(False, "bool")
        if self.accept_kw("NULL"):
            return Lit(None, "null")
        if self.accept_kw("TIMESTAMP"):
            s = self.next()
            if s.kind != "str":
                raise SqlParseError("expected string after TIMESTAMP")
            return Lit(s.text[1:-1], "timestamp")
        if self.accept_kw("DATE"):
            s = self.next()
            if s.kind != "str":
                raise SqlParseError("expected string after DATE")
            return Lit(s.text[1:-1], "timestamp")
        if self.accept_kw("INTERVAL"):
            s = self.next()
            if s.kind != "str":
                raise SqlParseError("expected string after INTERVAL")
            unit = self.ident().upper()
            return Lit((s.text[1:-1], unit), "interval")
        if self.accept_kw("CASE"):
            whens = []
            while self.accept_kw("WHEN"):
                c = self.expr()
                self.expect_kw("THEN")
                whens.append((c, self.expr()))
            else_ = self.expr() if self.accept_kw("ELSE") else None
            self.expect_kw("END")
            return Case(tuple(whens), else_)
        if self.accept_kw("CAST"):
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("AS")
            ty = self.ident().upper()
            self.expect_op(")")
            return Cast(e, ty)
        if self.accept_kw("EXTRACT"):
            self.expect_op("(")
            unit = self.ident().upper()
            # FROM is not a soft keyword here
            if not (self.peek().kind == "kw" and self.peek().text == "FROM"):
                raise SqlParseError("expected FROM in EXTRACT")
            self.next()
            e = self.expr()
            self.expect_op(")")
            return Fn("EXTRACT", (e,), extra=unit)
        if self.accept_kw("SUBSTRING"):
            self.expect_op("(")
            e = self.expr()
            if self.accept_op(","):
                start = self.expr()
                length = self.expr() if self.accept_op(",") else None
            elif self.peek().kind == "kw" and self.peek().text == "FROM":
                self.next()
                start = self.expr()
                length = self.expr() if self.accept_kw("FOR") else None
            else:
                raise SqlParseError("malformed SUBSTRING")
            self.expect_op(")")
            args = (e, start) if length is None else (e, start, length)
            return Fn("SUBSTRING", args)
        if self.accept_kw("TRIM"):
            self.expect_op("(")
            self.accept_kw("LEADING") or self.accept_kw("TRAILING") \
                or self.accept_kw("BOTH")
            e = self.expr()
            self.expect_op(")")
            return Fn("TRIM", (e,))
        raise SqlParseError(f"unexpected keyword {t.text!r}")

    def call(self, name: str) -> Fn:
        distinct = False
        args: Tuple[object, ...] = ()
        extra = None
        if self.peek().kind == "op" and self.peek().text == "*" \
                and name == "COUNT":
            self.next()
            self.expect_op(")")
        elif self.accept_op(")"):
            pass
        else:
            distinct = bool(self.accept_kw("DISTINCT"))
            arglist = [self.expr()]
            # FLOOR(x TO DAY) / CEIL(x TO DAY)
            if name in ("FLOOR", "CEIL") and self.accept_kw("TO"):
                extra = self.ident().upper()
            while self.accept_op(","):
                arglist.append(self.expr())
            self.expect_op(")")
            args = tuple(arglist)
        flt = None
        if name in _AGG_FNS and self.accept_kw("FILTER"):
            self.expect_op("(")
            self.expect_kw("WHERE")
            flt = self.expr()
            self.expect_op(")")
        return Fn(name, args, distinct, flt, extra)


def parse_sql(sql: str, parameters: Sequence[object] = ()):
    """Parse one statement → Select, or Union for `UNION ALL` chains."""
    return _P(_tokenize(sql), parameters).statement()
