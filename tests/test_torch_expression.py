"""The port's expression evaluator against the reference's, expression by
expression.

The same seeded numpy columns (int32 and int64 with negatives, float32 with
a NaN, float64, absolute `__time` millis and a string dimension's ids) go
through the reference's `Expr.evaluate` as jnp arrays and through the port's
as torch tensors on the CPU. String-dimension sites are rewritten to
dictionary LUTs by each package's `rewrite_string_sites`. Integers and
booleans must be equal, floats within 1e-6 relative (NaN where the
reference has NaN), and every result's dtype must be the reference's.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import jax.numpy as jnp
from druid_tpu.utils import expression as ref_expr

from druid_tpu_torch.utils import expression as port_expr

torch.set_num_threads(1)

N = 2048
DICT = [f"v{i}" for i in range(12)]


def _columns():
    rng = np.random.default_rng(8)
    f32 = rng.normal(10.0, 400.0, N).astype(np.float32)
    f32[5] = np.nan
    return {
        "l32": rng.integers(-500, 9_000, N).astype(np.int32),
        "l64": rng.integers(-(2**40), 2**40, N).astype(np.int64),
        "f32": f32,
        "f64": rng.normal(0.0, 1e6, N),
        "__time": (1_782_864_000_000
                   + rng.integers(0, 400 * 86_400_000, N)).astype(np.int64),
        "s": rng.integers(0, len(DICT), N).astype(np.int32),
    }


COLS = _columns()

EXPRESSIONS = [
    # arithmetic and promotion
    "l32 + l64", "l32 * 2", "l32 * 0.5", "l32 * 0.01", "l64 * 0.01",
    "l64 - f32", "f32 * 2.5 + l32", "f32 * 2 + l32", "f64 / 3", "l32 / 7",
    "l64 / l32", "l64 / 1000", "7 / 2", "7.0 / 2", "-l32", "-f32",
    # division by zero
    "l32 / 0", "l64 / (l32 - l32)", "f32 / 0", "f64 / (f64 - f64)",
    "safe_divide(l32, l64)", "safe_divide(f32, 0)",
    "safe_divide(l64, l32 - l32)",
    # modulo and integer division
    "l32 % 7", "l64 % -3", "f32 % 3", "l32 % (l32 - l32)", "l64 % l32",
    "mod(l32, 7)", "mod(l64, -3)", "mod(f32, 3)", "mod(l32, 0)",
    "mod(l64, l32)", "div(l64, 100)", "div(l32, -7)", "div(f64, 3)",
    "div(l32, 0)", "div(l64, l32)",
    # powers, rounding, sign
    "l32 ^ 2", "f32 ^ 2", "pow(l32, 2.0)", "pow(f64, 0.5)", "round(f64)",
    "round(f32, 1)", "round(l64, -2)", "round(l32, -1)", "round(f64, -1)",
    "round(f64 / 100)", "trunc(f32)", "trunc(l32)", "sign(l32)",
    "sign(f64)", "abs(l32)", "abs(f32)", "floor(f32)", "ceil(l32)",
    "sqrt(abs(f64))", "exp(l32 / 10000)", "log(abs(f32) + 1)",
    "log10(abs(l64) + 1)", "sin(l32)", "atan2(l32, l64)",
    # conditionals
    "if(l32 > 0, l64, f32)", "if(l32 > 0, 1, 2.5)", "if(l32, 1, 2)",
    "nvl(l32, 0)", "greatest(l32, l64, 5)", "least(f32, l32)",
    "max(l32, 2.5)", "min(l64, l32)", "cast(l32, 'DOUBLE')",
    # time
    "timestamp_floor(__time, 3600000)", "timestamp_shift(__time, 86400000, -1)",
    "timestamp_extract(__time, 'EPOCH')", "timestamp_extract(__time, 'SECOND')",
    "timestamp_extract(__time, 'MINUTE')", "timestamp_extract(__time, 'HOUR')",
    "timestamp_extract(__time, 'DAY')", "timestamp_extract(__time, 'DOW')",
    "timestamp_extract(__time, 'DOY')", "timestamp_extract(__time, 'MONTH')",
    "timestamp_extract(__time, 'QUARTER')", "timestamp_extract(__time, 'YEAR')",
    "__time / 1000", "__time > 1790000000000",
    # comparisons and logic
    "l32 > 100", "f32 <= l64", "l32 == 3", "l32 != l64", "l32 < 1.5",
    "l32 > 0 && f32 < 50", "l32 < 0 || !(l64 > 0)", "!l32", "l32 && f32",
    # string sites
    "s == 'v3'", "s > 'v5'", "'v2' <= s", "s != 'v1' && l32 > 0",
    "strlen(s) + l32", "strpos(s, '1')", "strlen(s) * 0.5",
]


def _evaluate(mod, expr_s, to_array):
    expr, sites = mod.rewrite_string_sites(mod.parse_expression(expr_s),
                                           frozenset({"s"}))
    bindings = {k: to_array(v) for k, v in COLS.items()}
    bindings["__luts"] = [to_array(mod.lut_for_site(site, DICT))
                          for site in sites]
    return expr.evaluate(bindings)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy(), str(v.dtype).replace("torch.", "")
    if hasattr(v, "dtype"):
        a = np.asarray(v)
        return a, str(a.dtype)
    return np.asarray(v), type(v).__name__


@pytest.mark.parametrize("expr_s", EXPRESSIONS)
def test_expression_matches_reference(expr_s):
    ref, ref_dt = _host(_evaluate(ref_expr, expr_s, jnp.asarray))
    got, got_dt = _host(_evaluate(port_expr, expr_s, torch.from_numpy))
    assert got_dt == ref_dt, expr_s
    ref = np.broadcast_to(ref, (N,))
    got = np.broadcast_to(got, (N,))
    if np.issubdtype(ref.dtype, np.floating):
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6, atol=0)
    else:
        assert np.array_equal(got, ref)


def test_python_scalars_keep_python_semantics():
    for s in ("7 / 2", "7 / 0", "7.5 / 0", "7 % 3", "-7 % 3", "mod(-7, 3)",
              "div(-7, 2)", "round(2.5)", "round(-2.5)", "round(1250, -2)",
              "2 ^ 10", "greatest(1, 3, 2)", "strlen('abc')",
              "strpos('abc', 'c')"):
        assert port_expr.parse_expression(s).evaluate({}) \
            == ref_expr.parse_expression(s).evaluate({}), s


def test_string_dimension_outside_a_comparison_raises():
    for s in ("s + 1", "if(s, 1, 0)", "s == l32"):
        for mod in (ref_expr, port_expr):
            with pytest.raises(ValueError, match="string dimension"):
                mod.rewrite_string_sites(mod.parse_expression(s),
                                         frozenset({"s"}))


def test_parser_errors_match():
    for s in ("1 +", "(1", "1 $ 2", "f(1,"):
        for mod in (ref_expr, port_expr):
            with pytest.raises(ValueError):
                mod.parse_expression(s)
