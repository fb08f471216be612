"""TPC-H's `lineitem` as Druid's own TPC-H benchmark loads it
(druid-io/druid-benchmark; the Druid whitepaper's section 6.1), with
`__time` = l_shipdate.

Per row, as TPC-H's dbgen draws them: the ship date uniform over the
range (here: the same number of rows each day), l_quantity uniform
1..50, a part key uniform over the SF's parts, l_extendedprice =
quantity x the part's retail price (dollars), l_discount uniform
0.00..0.10, l_tax uniform 0.00..0.08, l_shipmode uniform over 7 modes,
and l_commitdate = the order date + 30..90 days, where the order date is
the ship date - 1..121 days (drawn back from the ship date, so the
earliest order dates fall before 1992). Metrics other than l_quantity are FLOAT, as
Druid 0.6 stored them.
"""
from __future__ import annotations

import torch

from portbench.gen import common

SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
# l_commitdate's values: every day a ship date - 1..121 + 30..90 can reach
COMMIT_FIRST = "1991-10-03"
COMMIT_LAST = "1999-02-28"


def value_lists():
    d0, d1 = common.day_of(COMMIT_FIRST), common.day_of(COMMIT_LAST)
    return {"l_shipmode": SHIPMODES,
            "l_commitdate": [common.iso_of(d) for d in range(d0, d1 + 1)]}


def generate(cfg: dict, seed: int, spec: common.SegmentSpec,
             device) -> common.Columns:
    per_day = common.rows_per_day(cfg)
    g = common.generator(seed, spec.index, device)
    day = common.day_rows(spec, per_day, device)
    n = day.numel()
    quantity = common.randint(g, 1, 51, n, device)
    partkey = common.randint(g, 1, int(200_000 * cfg["scale_factor"]) + 2,
                             n, device)
    discount = common.randint(g, 0, 11, n, device)
    tax = common.randint(g, 0, 9, n, device)
    shipmode = common.randint(g, 0, len(SHIPMODES), n, device)
    order_day = day - common.randint(g, 1, 122, n, device)
    commit_day = order_day + common.randint(g, 30, 91, n, device)
    commit = commit_day - common.day_of(COMMIT_FIRST)
    extended = (quantity * common.retail_cents(partkey)).to(
        torch.float64) / 100.0
    return common.Columns(
        spec=spec, time_day=day,
        dims={"l_shipmode": shipmode, "l_commitdate": commit},
        metrics={"l_quantity": ("long", quantity),
                 "l_extendedprice": ("float", extended.to(torch.float32)),
                 "l_discount": ("float",
                                (discount.to(torch.float64) / 100.0)
                                .to(torch.float32)),
                 "l_tax": ("float", (tax.to(torch.float64) / 100.0)
                           .to(torch.float32))})
