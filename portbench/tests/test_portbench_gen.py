"""The generators: the same seed gives the same columns, another seed
other columns, and the layout holds every row once."""
import pytest
import torch

from portbench import reference, registry
from portbench.gen import common


def _columns(cfg, seed, index, device="cpu"):
    gen = reference.generator_module(cfg)
    return gen.generate(cfg, seed, common.layout(cfg)[index], device)


def _same(a, b):
    return torch.equal(a.time_day, b.time_day) and all(
        torch.equal(a.dims[k], b.dims[k]) for k in a.dims) and all(
        torch.equal(a.metrics[k][1], b.metrics[k][1]) for k in a.metrics)


@pytest.mark.parametrize("name", registry.configs())
def test_same_seed_same_columns(name, tiny):
    cfg = tiny(name)
    big = 2 ** 31 + 12345                 # seeds pass 32 signed bits
    assert _same(_columns(cfg, big, 3), _columns(cfg, big, 3))
    assert not _same(_columns(cfg, big, 3), _columns(cfg, big + 1, 3))


@pytest.mark.parametrize("name", registry.configs())
def test_segment_streams_are_independent(name, tiny):
    cfg = tiny(name)
    a = _columns(cfg, 7, 5)
    _columns(cfg, 7, 4)
    assert _same(a, _columns(cfg, 7, 5))


@pytest.mark.parametrize("name", registry.configs())
def test_layout_and_ranges(name, tiny):
    cfg = tiny(name)
    gen = reference.generator_module(cfg)
    values = gen.value_lists()
    specs = common.layout(cfg)
    assert specs[0].day0 == common.day_of(cfg["first_day"])
    assert specs[-1].day1 == common.day_of(cfg["last_day"]) + 1
    assert all(a.day1 == b.day0 for a, b in zip(specs, specs[1:]))
    assert all(s.end_ms - s.start_ms == 7 * common.DAY_MS for s in specs)
    n = 0
    for s in specs[:20]:
        c = gen.generate(cfg, 11, s, "cpu")
        n += c.n_rows
        for d, ids in c.dims.items():
            assert 0 <= int(ids.min()) and int(ids.max()) < len(values[d])
    assert common.total_rows(cfg) == sum(
        (s.day1 - s.day0) for s in specs) * common.rows_per_day(cfg)


def test_ssb_derivations(tiny):
    cfg = tiny("ssb-sf20")
    c = _columns(cfg, 5, 10)
    m = {k: v for k, (_, v) in c.metrics.items()}
    assert int(m["lo_quantity"].min()) >= 1 and int(m["lo_quantity"].max()) <= 50
    assert int(m["lo_discount"].max()) <= 10
    assert torch.equal(m["lo_revenue"],
                       m["lo_extendedprice"] * (100 - m["lo_discount"]) // 100)
    assert torch.equal(c.dims["p_mfgr"], c.dims["p_brand1"] // 200)
    assert torch.equal(c.dims["c_nation"], c.dims["c_city"] // 10)


@pytest.mark.chip
def test_card_streams_repeat(cuda, tiny):
    cfg = tiny("tpch-sf50")
    assert _same(_columns(cfg, 99, 2, cuda), _columns(cfg, 99, 2, cuda))
