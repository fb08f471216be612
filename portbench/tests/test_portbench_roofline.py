"""The logical input bytes of a query, worked by hand."""
from portbench import reference, registry, roofline
from portbench.gen import common


def test_worked_query_bytes():
    cfg = registry.config("ssb-sf20")
    width = {"lo_extendedprice": 8, "lo_discount": 8, "lo_quantity": 8,
             "lo_revenue": 8, "c_region": 4, "p_brand1": 4}
    q11 = registry.mix("ssb-flights")["queries"][0]["query"]
    ivs = reference.intervals_ms(q11)
    # 1993 is 365 days at 49,875 rows a day (SF20 over 2,406 days)
    assert common.rows_per_day(cfg) == 49_875
    rows = 365 * 49_875
    assert common.rows_in_intervals(cfg, ivs) == rows
    # Q1.1 reads extendedprice and discount (its virtual column and its
    # filter) and quantity: 24 B; 1993 cuts the weeks at both of its ends,
    # so __time counts: 8 B
    assert roofline.columns_read(q11, width) == {
        "lo_extendedprice", "lo_discount", "lo_quantity"}
    assert roofline.logical_bytes(q11, cfg, width, ivs) == rows * 32


def test_whole_range_needs_no_time():
    cfg = registry.config("tpch-sf50")
    q = registry.mix("tpch-timeseries")["queries"][1]["query"]   # sum_price
    ivs = reference.intervals_ms(q)
    width = {"l_extendedprice": 4}
    assert common.rows_in_intervals(cfg, ivs) == common.total_rows(cfg)
    assert roofline.logical_bytes(q, cfg, width, ivs) == \
        common.total_rows(cfg) * 4
