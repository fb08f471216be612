"""A divergence from the reference reached through SQL, pinned: a grouped
`SUM(CASE WHEN ... THEN 1 ELSE 0 END)`. SQL plans it as a DOUBLE
virtual-column sum. The reference's strategy selection treats the virtual
column as missing, so where the group space is mm's (65 to 2048 groups) it
selects the one-hot matmul and raises "mm strategy selected but kernels
have no mm plan at trace time". The port selects with the column's
computed dtype and answers with numpy's rows (ROADMAP §C; the native form
is tests/test_torch_virtual_columns.py's REF_FAILS). Both packages plan
the same native query."""
import numpy as np
import pytest
import torch

from tests.test_torch_sql import sql_pair

torch.set_num_threads(1)

STATEMENTS = {
    "by_dim_b": ("SELECT dimB, SUM(CASE WHEN metLong > 50 THEN 1 ELSE 0 "
                 "END) hi FROM test GROUP BY dimB", ("dimB",)),
    "by_dim_a_b": ("SELECT dimA, dimB, SUM(CASE WHEN metLong > 50 THEN 1 "
                   "ELSE 0 END) hi, COUNT(*) n FROM test GROUP BY dimA, dimB",
                   ("dimA", "dimB")),
}


def _numpy_rows(segments, dims):
    """{group values: (rows with metLong > 50, rows)} over the segments."""
    out = {}
    for s in segments:
        cols = [np.asarray(s.dims[d].dictionary.values, dtype=object)[
            s.dims[d].ids] for d in dims]
        hi = s.metrics["metLong"].values > 50
        for i in range(s.n_rows):
            key = tuple(c[i] for c in cols)
            a, b = out.get(key, (0, 0))
            out[key] = (a + int(hi[i]), b + 1)
    return out


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_grouped_case_sum_on_mm(segments, name):
    sql, dims = STATEMENTS[name]
    ref, port = sql_pair(segments)
    assert port.explain(sql) == ref.explain(sql)
    with pytest.raises(AssertionError,
                       match="mm strategy selected but kernels have no mm "
                             "plan at trace time"):
        ref.execute(sql)
    _, rows = port.execute(sql)
    want = _numpy_rows(segments, dims)
    assert len(rows) == len(want)
    for row in rows:
        key = tuple(row[:len(dims)])
        assert row[len(dims)] == want[key][0]
        assert isinstance(row[len(dims)], float)
        if len(row) > len(dims) + 1:
            assert row[len(dims) + 1] == want[key][1]
