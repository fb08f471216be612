"""Druid-style scalar expression language: parser + vectorized evaluator.

The port's copy of the reference package's `utils/expression.py` (the
reference's math expression language: Parser.java, Expr.java,
Function.java), used by expression virtual columns, the expression filter
and expression dimensions. An expression evaluates over whole columns at
once: numpy arrays on the host (expression dimensions), or torch tensors on
the query's device (virtual columns and the expression filter), where it
runs as eager elementwise tensor ops.

On tensors the evaluator follows the reference's dtypes (JAX with 64-bit
types on), not torch's defaults: a Python float against an integer or bool
tensor promotes to float64 (torch would take float32), true division of
integers gives float32 for int32 and float64 for int64 operands, and so do
the transcendental functions. `%` by an integer zero gives 0, as the
reference's does on the CPU; `/`, `div()`, `mod()` and `safe_divide()`
guard their zero divisors as the reference does.

Grammar (precedence low→high):
  || ; && ; ==, != ; <, <=, >, >= ; +, - ; *, /, % ; ^ ; unary -, ! ;
  literals (long, double, 'string'), identifiers, function calls.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
    | (?P<int>\d+)
    | (?P<str>'(?:[^'\\]|\\.)*')
    | (?P<id>[A-Za-z_][A-Za-z0-9_.$]*)
    | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%^()!<>,])
    )""", re.VERBOSE)


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"bad token at {s[pos:]!r}")
        pos = m.end()
        for kind in ("num", "int", "str", "id", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    out.append(("eof", ""))
    return out


class Expr:
    def evaluate(self, bindings: Dict[str, object]):
        raise NotImplementedError

    def required_columns(self) -> set:
        return set()


@dataclass(frozen=True)
class Literal(Expr):
    value: object

    def evaluate(self, bindings):
        return self.value


@dataclass(frozen=True)
class Identifier(Expr):
    name: str

    def evaluate(self, bindings):
        if self.name not in bindings:
            raise KeyError(f"unbound identifier {self.name!r}")
        return bindings[self.name]

    def required_columns(self):
        return {self.name}


# ---------------------------------------------------------------------------
# torch operands with the reference's dtypes
# ---------------------------------------------------------------------------

def _is_t(v) -> bool:
    return isinstance(v, torch.Tensor)


def _is_int_t(v) -> bool:
    return _is_t(v) and not v.dtype.is_floating_point


def _dtype(*vals) -> torch.dtype:
    """The reference's result dtype for `vals`, at least one a tensor: the
    tensors' promoted dtype, widened to float64 by a Python float against
    integers/bools and to int64 by a Python int against bools (a Python
    scalar is weakly typed)."""
    ts = [v for v in vals if _is_t(v)]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    scal = [v for v in vals if not _is_t(v)]
    if any(isinstance(v, float) for v in scal) and not dt.is_floating_point:
        return torch.float64
    if any(isinstance(v, int) and not isinstance(v, bool) for v in scal) \
            and dt == torch.bool:
        return torch.int64
    return dt


def _scalar_dtype(v) -> torch.dtype:
    if isinstance(v, bool):
        return torch.bool
    return torch.float64 if isinstance(v, float) else torch.int64


def _coerce(*vals):
    """`vals` with every tensor cast to their common reference dtype (the
    Python scalars stay scalars: torch then keeps the tensor's dtype)."""
    if not any(_is_t(v) for v in vals):
        return vals
    dt = _dtype(*vals)
    return tuple(v.to(dt) if _is_t(v) and v.dtype != dt else v
                 for v in vals)


def _inexact(dt: torch.dtype) -> torch.dtype:
    """The float dtype the reference computes an integer operand in."""
    if dt.is_floating_point:
        return dt
    return torch.float64 if dt == torch.int64 else torch.float32


def _tensors(*vals):
    """Every value as a tensor of the common reference dtype, on the first
    tensor's device."""
    ref = next(v for v in vals if _is_t(v))
    dt = _dtype(*vals)
    return tuple(v.to(dt) if _is_t(v) else
                 torch.tensor(v, dtype=dt, device=ref.device) for v in vals)


class _TorchNS:
    """The numpy spellings the evaluator uses, over torch tensors with the
    reference's dtypes."""

    @staticmethod
    def where(cond, a, b):
        if not _is_t(cond):
            dev = next((v.device for v in (a, b) if _is_t(v)), None)
            cond = torch.tensor(bool(cond), device=dev)
        if not (_is_t(a) or _is_t(b)):
            dt = torch.promote_types(_scalar_dtype(a), _scalar_dtype(b))
            a = torch.tensor(a, dtype=dt, device=cond.device)
            b = torch.tensor(b, dtype=dt, device=cond.device)
        else:
            a, b = _tensors(a, b)
        return torch.where(cond.to(torch.bool), a, b)

    @staticmethod
    def _unary_float(fn):
        def f(x):
            return fn(x.to(_inexact(x.dtype)))
        return f

    @staticmethod
    def floor_divide(a, b):
        a, b = _coerce(a, b)
        return torch.floor_divide(a, b)

    @staticmethod
    def fmod(a, b):
        a, b = _coerce(a, b)
        return torch.fmod(a, b)

    @staticmethod
    def power(a, b):
        a, b = _coerce(a, b)
        return torch.pow(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(*_tensors(a, b))

    @staticmethod
    def maximum(a, b):
        return torch.maximum(*_tensors(a, b))

    @staticmethod
    def logical_and(a, b):
        a, b = (v if _is_t(v) else torch.tensor(bool(v)) for v in (a, b))
        return torch.logical_and(a, b)

    @staticmethod
    def logical_or(a, b):
        a, b = (v if _is_t(v) else torch.tensor(bool(v)) for v in (a, b))
        return torch.logical_or(a, b)

    @staticmethod
    def logical_not(x):
        return torch.logical_not(x)

    @staticmethod
    def asarray(x, dtype=None):
        return x.to(torch.bool) if dtype is bool else x

    @staticmethod
    def arctan2(y, x):
        y, x = _tensors(y, x)
        dt = _inexact(y.dtype)
        return torch.atan2(y.to(dt), x.to(dt))

    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)
    trunc = staticmethod(torch.trunc)
    floor = staticmethod(torch.floor)
    ceil = staticmethod(torch.ceil)


for _name, _fn in (("exp", torch.exp), ("log", torch.log),
                   ("log10", torch.log10), ("sqrt", torch.sqrt),
                   ("sin", torch.sin), ("cos", torch.cos),
                   ("tan", torch.tan), ("arcsin", torch.asin),
                   ("arccos", torch.acos), ("arctan", torch.atan),
                   ("degrees", torch.rad2deg), ("radians", torch.deg2rad)):
    setattr(_TorchNS, _name, staticmethod(_TorchNS._unary_float(_fn)))

_TORCH_NS = _TorchNS()


def _xp(*vals):
    """Pick the array module: the torch namespace if any input is a torch
    tensor, else numpy."""
    for v in vals:
        if _is_t(v):
            return _TORCH_NS
    return np


def _is_integer(x) -> bool:
    """Whether an array operand holds integers (numpy or torch)."""
    if _is_t(x):
        return _is_int_t(x) and x.dtype != torch.bool
    return np.issubdtype(getattr(x, "dtype", np.float64), np.integer)


def _int_operands(a, b) -> bool:
    """The reference's test for the exact integer path of mod()/div(): an
    operand without a dtype counts as float64 on the left and as int64 on
    the right."""
    return (hasattr(a, "dtype") and _is_integer(a)) \
        and (not hasattr(b, "dtype") or _is_integer(b))


def _as_int64(x):
    return x.to(torch.int64) if _is_t(x) else x.astype("int64")


def _to_num(v):
    if isinstance(v, bool):
        return int(v)
    return v


def _true_div(l, r):
    """`l / r` in the reference's dtype: integer operands divide in float32
    (int32) or float64 (int64)."""
    if _is_t(l) or _is_t(r):
        l, r = _coerce(l, r)
        dt = _dtype(l, r)
        if not dt.is_floating_point:
            dt = _inexact(dt if dt != torch.bool else torch.int32)
            l = l.to(dt) if _is_t(l) else l
            r = r.to(dt) if _is_t(r) else r
    return l / r


def _int_mod(l, r):
    """Python's floored `%`; an integer tensor by zero gives 0."""
    l, r = _coerce(l, r)
    if (_is_t(l) or _is_t(r)) and not _dtype(l, r).is_floating_point:
        if _is_t(r):
            zero = r == 0
            return torch.where(zero, torch.zeros((), dtype=_dtype(l, r),
                                                 device=r.device),
                               l % torch.where(zero, 1, r))
        if r == 0:
            return l * 0
    return l % r


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str
    left: Expr
    right: Expr

    def evaluate(self, b):
        l = _to_num(self.left.evaluate(b))
        r = _to_num(self.right.evaluate(b))
        op = self.op
        if op in ("+", "-", "*", "==", "!=", "<", "<=", ">", ">=") \
                and (_is_t(l) or _is_t(r)):
            l, r = _coerce(l, r)
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            xp = _xp(l, r)
            if isinstance(l, (int, np.integer)) and isinstance(r, (int, np.integer)):
                return l // r if r else 0
            if not np.isscalar(r) or hasattr(r, "shape"):
                return xp.where(r != 0, _true_div(l, xp.where(r != 0, r, 1)),
                                0.0)
            return _true_div(l, r) if r else 0.0
        if op == "%":
            return _int_mod(l, r)
        if op == "^":
            xp = _xp(l, r)
            return xp.power(l, r) if hasattr(l, "shape") or hasattr(r, "shape") \
                else l ** r
        if op == "==":
            return l == r
        if op == "!=":
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "&&":
            xp = _xp(l, r)
            return xp.logical_and(xp.asarray(l, dtype=bool) if hasattr(l, "shape") else bool(l),
                                  xp.asarray(r, dtype=bool) if hasattr(r, "shape") else bool(r))
        if op == "||":
            xp = _xp(l, r)
            return xp.logical_or(xp.asarray(l, dtype=bool) if hasattr(l, "shape") else bool(l),
                                 xp.asarray(r, dtype=bool) if hasattr(r, "shape") else bool(r))
        raise ValueError(op)

    def required_columns(self):
        return self.left.required_columns() | self.right.required_columns()


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str
    operand: Expr

    def evaluate(self, b):
        v = _to_num(self.operand.evaluate(b))
        if self.op == "-":
            return -v
        xp = _xp(v)
        return xp.logical_not(v) if hasattr(v, "shape") else (not v)

    def required_columns(self):
        return self.operand.required_columns()


def _str_fn_err(name: str):
    raise ValueError(
        f"{name}() over a non-dictionary operand is not expressible on "
        "the device path — apply it to a string dimension (LUT rewrite) "
        "or a string literal")


def _fn_if(cond, a, b):
    xp = _xp(cond, a, b)
    if hasattr(cond, "shape"):
        return xp.where(cond, a, b)
    return a if cond else b


_MS_DAY = 86_400_000


def _fdiv(a, b):
    """Floor division for numpy arrays, torch tensors and Python ints."""
    xp = _xp(a, b)
    if hasattr(a, "shape") or hasattr(b, "shape"):
        return xp.floor_divide(a, b)
    return a // b


def _civil(t_ms):
    """(year, month, day, days-since-epoch) from epoch millis — Hinnant's
    civil-from-days in pure integer arithmetic (elementwise ops, no host
    calendar lookups)."""
    days = _fdiv(t_ms, _MS_DAY)
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + _where_num(mp < 10, 3, -9)
    y = y + _where_num(m <= 2, 1, 0)
    return y, m, d, days


def _days_from_civil(y, m, d):
    ya = y - _where_num(m <= 2, 1, 0)
    era = _fdiv(ya, 400)
    yoe = ya - era * 400
    doy = _fdiv(153 * (m + _where_num(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _where_num(cond, a, b):
    return _fn_if(cond, a, b)


#: units _fn_timestamp_extract understands
EXTRACT_UNITS = frozenset({
    "EPOCH", "MILLISECOND", "SECOND", "MINUTE", "HOUR", "DAY", "DOW",
    "DOY", "MONTH", "QUARTER", "YEAR"})


def _fn_timestamp_extract(t, unit):
    """EXTRACT unit from epoch millis (the reference's
    TimestampExtractExprMacro semantics; DOW ISO 1=Mon..7=Sun)."""
    u = str(unit).upper()
    msod = t - _fdiv(t, _MS_DAY) * _MS_DAY
    if u == "EPOCH":
        return _fdiv(t, 1000)
    if u == "MILLISECOND":
        return msod % 1000
    if u == "SECOND":
        return _fdiv(msod, 1000) % 60
    if u == "MINUTE":
        return _fdiv(msod, 60_000) % 60
    if u == "HOUR":
        return _fdiv(msod, 3_600_000)
    y, m, d, days = _civil(t)
    if u == "YEAR":
        return y
    if u == "QUARTER":
        return _fdiv(m + 2, 3)
    if u == "MONTH":
        return m
    if u == "DAY":
        return d
    if u == "DOW":
        return (days + 3) % 7 + 1
    if u == "DOY":
        return days - _days_from_civil(y, 1, 0)
    raise ValueError(f"unknown EXTRACT unit {unit!r}")


def _fn_timestamp_floor(t, period_ms, origin=0):
    return _fdiv(t - origin, period_ms) * period_ms + origin


def _fn_greatest(*vals):
    out = vals[0]
    for v in vals[1:]:
        out = _FUNCTIONS["max"](out, v)
    return out


def _fn_least(*vals):
    out = vals[0]
    for v in vals[1:]:
        out = _FUNCTIONS["min"](out, v)
    return out


def _fn_safe_div(a, b):
    xp = _xp(a, b)
    if hasattr(a, "shape") or hasattr(b, "shape"):
        return xp.where(b != 0, _true_div(a, xp.where(b != 0, b, 1)), 0.0)
    return a / b if b else 0.0


def _trunc_div_ints(a, b):
    """Exact truncated integer division (no float64 round-trip — longs
    above 2^53 must divide exactly)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fn_mod(a, b):
    """Truncated modulo — sign of the DIVIDEND, matching Druid/Calcite
    (Java %), not Python's floored modulo. Exact for integers."""
    xp = _xp(a, b)
    if hasattr(a, "shape") or hasattr(b, "shape"):
        if _int_operands(a, b):
            # integer-exact: a - trunc(a/b)*b in pure int arithmetic
            bb = xp.where(b != 0, b, 1)
            q = xp.where(b != 0, abs(a) // abs(bb), 0)
            q = xp.where((a >= 0) == (bb >= 0), q, -q)
            return a - q * bb
        return xp.fmod(a, b)
    if isinstance(a, int) and isinstance(b, int):
        return a - _trunc_div_ints(a, b) * b if b else a
    return math.fmod(a, b)


def _fn_int_div(a, b):
    """Druid expression div(): integer (long) division truncated toward
    zero; division by zero yields 0. Exact for integers (no float64
    round-trip)."""
    xp = _xp(a, b)
    if hasattr(a, "shape") or hasattr(b, "shape"):
        if _int_operands(a, b):
            bb = xp.where(b != 0, b, 1)
            q = xp.where(b != 0, abs(a) // abs(bb), 0)
            return _as_int64(xp.where((a >= 0) == (bb >= 0), q, -q))
        q = xp.where(b != 0, _true_div(a, xp.where(b != 0, b, 1)), 0)
        return _as_int64(xp.trunc(q))
    if not b:
        return 0
    if isinstance(a, int) and isinstance(b, int):
        return _trunc_div_ints(a, b)
    return int(a / b)


def _fn_round(x, n=0):
    """ROUND half-AWAY-FROM-ZERO with optional decimal places (Druid
    semantics; numpy/Python's default is banker's rounding). Integers with
    n >= 0 return unchanged — a float64 round-trip would corrupt longs
    above 2^53."""
    xp = _xp(x)
    n = int(n)
    scale = 10 ** n if n >= 0 else 0
    if hasattr(x, "shape"):
        if _is_integer(x):
            if n >= 0:
                return x
            s = 10 ** (-n)   # exact integer rounding to tens/hundreds/...
            q = (abs(x) + s // 2) // s * s
            out = xp.where(x >= 0, q, -q)
            return out.to(x.dtype) if _is_t(x) else out.astype(x.dtype)
        if n < 0:
            s = 10 ** (-n)
            return xp.sign(x) * xp.floor(xp.abs(x) / s + 0.5) * s
        return xp.sign(x) * xp.floor(xp.abs(x) * scale + 0.5) / scale
    if isinstance(x, int):
        if n >= 0:
            return x
        s = 10 ** (-n)
        q = (abs(x) + s // 2) // s * s
        return q if x >= 0 else -q
    if n < 0:
        s = 10 ** (-n)
        return math.copysign(math.floor(abs(x) / s + 0.5), x) * s
    return math.copysign(math.floor(abs(x) * scale + 0.5), x) / scale


_FUNCTIONS: Dict[str, Callable] = {
    "abs": lambda x: _xp(x).abs(x) if hasattr(x, "shape") else abs(x),
    "ceil": lambda x: _xp(x).ceil(x) if hasattr(x, "shape") else math.ceil(x),
    "floor": lambda x: _xp(x).floor(x) if hasattr(x, "shape") else math.floor(x),
    "exp": lambda x: _xp(x).exp(x) if hasattr(x, "shape") else math.exp(x),
    "log": lambda x: _xp(x).log(x) if hasattr(x, "shape") else math.log(x),
    "sqrt": lambda x: _xp(x).sqrt(x) if hasattr(x, "shape") else math.sqrt(x),
    "sin": lambda x: _xp(x).sin(x) if hasattr(x, "shape") else math.sin(x),
    "cos": lambda x: _xp(x).cos(x) if hasattr(x, "shape") else math.cos(x),
    "tan": lambda x: _xp(x).tan(x) if hasattr(x, "shape") else math.tan(x),
    "asin": lambda x: _xp(x).arcsin(x) if hasattr(x, "shape")
        else math.asin(x),
    "acos": lambda x: _xp(x).arccos(x) if hasattr(x, "shape")
        else math.acos(x),
    "atan": lambda x: _xp(x).arctan(x) if hasattr(x, "shape")
        else math.atan(x),
    "atan2": lambda y, x: _xp(y, x).arctan2(y, x)
        if hasattr(y, "shape") or hasattr(x, "shape") else math.atan2(y, x),
    "cot": lambda x: (1.0 / _xp(x).tan(x)) if hasattr(x, "shape")
        else (1.0 / math.tan(x)),
    "log10": lambda x: _xp(x).log10(x) if hasattr(x, "shape")
        else math.log10(x),
    "degrees": lambda x: _xp(x).degrees(x) if hasattr(x, "shape")
        else math.degrees(x),
    "radians": lambda x: _xp(x).radians(x) if hasattr(x, "shape")
        else math.radians(x),
    "pi": lambda: math.pi,
    # string fns evaluate host-side over Python strings (literals); over a
    # string DIMENSION they are rewritten to LUT gathers BEFORE eval
    # (rewrite_string_sites) — reaching here with an array means the
    # rewrite did not apply
    "strlen": lambda x: len(x) if isinstance(x, str) else _str_fn_err(
        "strlen"),
    "strpos": lambda x, y: (x.find(y) if isinstance(x, str)
                            and isinstance(y, str)
                            else _str_fn_err("strpos")),
    "min": lambda a, b: _xp(a, b).minimum(a, b)
        if hasattr(a, "shape") or hasattr(b, "shape") else min(a, b),
    "max": lambda a, b: _xp(a, b).maximum(a, b)
        if hasattr(a, "shape") or hasattr(b, "shape") else max(a, b),
    "pow": lambda a, b: _xp(a, b).power(a, b)
        if hasattr(a, "shape") or hasattr(b, "shape") else a ** b,
    "if": _fn_if,
    "nvl": lambda a, b: b if a is None else a,
    "cast": lambda x, t: x,  # typing handled by output column dtype
    "round": _fn_round,
    "sign": lambda x: _xp(x).sign(x) if hasattr(x, "shape")
        else (0 if x == 0 else (1 if x > 0 else -1)),
    "trunc": lambda x: _xp(x).trunc(x) if hasattr(x, "shape")
        else math.trunc(x),
    "mod": _fn_mod,
    "greatest": _fn_greatest,
    "least": _fn_least,
    "div": _fn_int_div,
    "safe_divide": _fn_safe_div,
    "timestamp_floor": _fn_timestamp_floor,
    "timestamp_shift": lambda t, period_ms, n: t + period_ms * n,
    "timestamp_extract": _fn_timestamp_extract,
}


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str
    args: Tuple[Expr, ...]

    def evaluate(self, b):
        fn = _FUNCTIONS.get(self.name)
        if fn is None:
            raise ValueError(f"unknown function {self.name!r}")
        return fn(*[a.evaluate(b) for a in self.args])

    def required_columns(self):
        out = set()
        for a in self.args:
            out |= a.required_columns()
        return out


@dataclass(frozen=True)
class DimLut(Expr):
    """A comparison over a STRING dimension, precomputed at plan time as a
    per-dictionary-id LUT: evaluation is one gather `lut[ids]`, so the
    device only ever sees integer ids; every string computation happens on
    the host over the (small) dictionary."""
    dim: str
    index: int          # position in the bindings["__luts"] sequence

    def evaluate(self, b):
        return b["__luts"][self.index][b[self.dim]]

    def required_columns(self):
        return {self.dim}


_STR_CMP_FLIP = {"==": "==", "!=": "!=", "<": ">", "<=": ">=",
                 ">": "<", ">=": "<="}

#: string→NUMERIC per-dictionary-value functions: like comparisons, they
#: precompute one numeric LUT per site and evaluation gathers `lut[ids]`
_STR_NUM_FNS = {
    "strlen": lambda vals, _lit: np.asarray(
        [0 if v is None else len(v) for v in vals], dtype=np.int32),
    # Druid-native semantics: 0-based index, -1 when absent
    "strpos": lambda vals, lit: np.asarray(
        [-1 if v is None else v.find(lit) for v in vals],
        dtype=np.int32),
}
_STR_NUM_ARITY = {"strlen": 1, "strpos": 2}


def rewrite_string_sites(expr: Expr, string_dims) -> Tuple[Expr, List[tuple]]:
    """Replace (string dim ⋄ string literal) comparisons with DimLut
    gathers. Returns (rewritten expr, sites) where sites[i] = (dim, op,
    literal) defines LUT i; `lut_for_site` computes its contents from a
    concrete dictionary. Any OTHER use of a string dim in the expression
    raises — silently comparing dictionary ids would be wrong."""
    sites: List[tuple] = []

    def walk(e: Expr) -> Expr:
        if isinstance(e, BinaryOp):
            l, r = e.left, e.right
            if e.op in _STR_CMP_FLIP:
                if (isinstance(l, Identifier) and l.name in string_dims
                        and isinstance(r, Literal)
                        and isinstance(r.value, str)):
                    sites.append((l.name, e.op, r.value))
                    return DimLut(l.name, len(sites) - 1)
                if (isinstance(r, Identifier) and r.name in string_dims
                        and isinstance(l, Literal)
                        and isinstance(l.value, str)):
                    sites.append((r.name, _STR_CMP_FLIP[e.op], l.value))
                    return DimLut(r.name, len(sites) - 1)
            return BinaryOp(e.op, walk(l), walk(r))
        if isinstance(e, UnaryOp):
            return UnaryOp(e.op, walk(e.operand))
        if isinstance(e, FunctionCall):
            if e.name in _STR_NUM_FNS \
                    and len(e.args) == _STR_NUM_ARITY[e.name] \
                    and isinstance(e.args[0], Identifier) \
                    and e.args[0].name in string_dims \
                    and all(isinstance(a, Literal) and isinstance(a.value,
                                                                  str)
                            for a in e.args[1:]):
                lit = e.args[1].value if len(e.args) > 1 else None
                sites.append((e.args[0].name, e.name, lit))
                return DimLut(e.args[0].name, len(sites) - 1)
            return FunctionCall(e.name, tuple(walk(a) for a in e.args))
        if isinstance(e, Identifier) and e.name in string_dims:
            raise ValueError(
                f"string dimension {e.name!r} used outside a "
                f"string-literal comparison — not expressible as a device "
                f"expression (wrap it in a LUT-able comparison)")
        return e

    return walk(expr), sites


def lut_for_site(site: tuple, values) -> np.ndarray:
    """Per-dictionary-id LUT for one rewrite site: BOOLEAN for comparison
    sites (lexicographic ordering), INT32 for string→numeric function sites
    (strlen/strpos)."""
    dim, op, lit = site
    if op in _STR_NUM_FNS:
        return _STR_NUM_FNS[op](list(values), lit)
    vals = np.asarray(list(values), dtype=object)
    if op == "==":
        out = vals == lit
    elif op == "!=":
        out = vals != lit
    elif op == "<":
        out = vals < lit
    elif op == "<=":
        out = vals <= lit
    elif op == ">":
        out = vals > lit
    else:
        out = vals >= lit
    return np.asarray(out, dtype=bool)


class _Parser:
    _BINARY = [
        {"||"}, {"&&"}, {"==", "!="}, {"<", "<=", ">", ">="},
        {"+", "-"}, {"*", "/", "%"}, {"^"},
    ]

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ValueError(f"expected {op!r}, got {v!r}")

    def parse(self) -> Expr:
        e = self.parse_level(0)
        if self.peek()[0] != "eof":
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def parse_level(self, level) -> Expr:
        if level >= len(self._BINARY):
            return self.parse_unary()
        left = self.parse_level(level + 1)
        while True:
            k, v = self.peek()
            if k == "op" and v in self._BINARY[level]:
                self.next()
                right = self.parse_level(level + 1)
                left = BinaryOp(v, left, right)
            else:
                return left

    def parse_unary(self) -> Expr:
        k, v = self.peek()
        if k == "op" and v in ("-", "!"):
            self.next()
            return UnaryOp(v, self.parse_unary())
        return self.parse_atom()

    def parse_atom(self) -> Expr:
        k, v = self.next()
        if k == "int":
            return Literal(int(v))
        if k == "num":
            return Literal(float(v))
        if k == "str":
            return Literal(v[1:-1].replace("\\'", "'"))
        if k == "id":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_level(0))
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_level(0))
                self.expect(")")
                return FunctionCall(v, tuple(args))
            return Identifier(v)
        if k == "op" and v == "(":
            e = self.parse_level(0)
            self.expect(")")
            return e
        raise ValueError(f"unexpected token {v!r}")


_CACHE: Dict[str, Expr] = {}


def parse_expression(s: str) -> Expr:
    e = _CACHE.get(s)
    if e is None:
        e = _Parser(_tokenize(s)).parse()
        _CACHE[s] = e
    return e
