"""The Star Schema Benchmark's `lineorder`, flattened with its customer,
supplier, part and date dimensions as Druid runs SSB (O'Neil, O'Neil,
Chen, "Star Schema Benchmark", revision 3, 2009).

Per row, as SSB's dbgen draws them: the order date uniform over the
range (here: the same number of rows each day), lo_quantity uniform
1..50, lo_discount uniform 0..10, a part key uniform over the SF's parts,
lo_extendedprice = quantity x the part's retail price (cents),
lo_revenue = extendedprice (100 - discount) / 100, lo_supplycost =
6 x retail price / 10; a customer and a supplier city uniform over the
250 cities (10 a nation, 5 nations a region). The part's mfgr, category
and brand follow from its key by a fixed scramble (dbgen draws them once
a part; the scramble keeps them fixed per part and uniform).
"""
from __future__ import annotations

import math

import torch

from portbench.gen import common

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# TPC-H's 25 nations with their regions (dbgen's nation.tbl order)
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]


def _city_names():
    # SSB: the first 9 letters of the nation, padded, then a digit
    return [f"{name[:9]:<9}{d}" for name, _ in NATIONS for d in range(10)]


def value_lists():
    """Each dimension's values in id order (the schema's lists)."""
    cities = _city_names()
    return {
        "c_region": REGIONS, "s_region": REGIONS,
        "c_nation": [n for n, _ in NATIONS],
        "s_nation": [n for n, _ in NATIONS],
        "c_city": cities, "s_city": cities,
        "p_mfgr": [f"MFGR#{m}" for m in range(1, 6)],
        "p_category": [f"MFGR#{m}{c}" for m in range(1, 6)
                       for c in range(1, 6)],
        "p_brand1": [f"MFGR#{m}{c}{b}" for m in range(1, 6)
                     for c in range(1, 6) for b in range(1, 41)],
    }


def parts(cfg: dict) -> int:
    """SSB's part count: 200,000 x floor(1 + log2 SF)."""
    sf = cfg["scale_factor"]
    return 200_000 * int(math.floor(1 + math.log2(sf))) if sf >= 1 \
        else max(1000, int(200_000 * sf))


def generate(cfg: dict, seed: int, spec: common.SegmentSpec,
             device) -> common.Columns:
    per_day = common.rows_per_day(cfg)
    g = common.generator(seed, spec.index, device)
    day = common.day_rows(spec, per_day, device)
    n = day.numel()
    quantity = common.randint(g, 1, 51, n, device)
    discount = common.randint(g, 0, 11, n, device)
    partkey = common.randint(g, 1, parts(cfg) + 1, n, device)
    c_city = common.randint(g, 0, 250, n, device)
    s_city = common.randint(g, 0, 250, n, device)
    retail = common.retail_cents(partkey)
    extended = quantity * retail
    revenue = extended * (100 - discount) // 100
    supplycost = 6 * retail // 10
    brand = common.mix32(partkey) % 1000          # MFGR#mcb, 40 a category
    region_of = torch.tensor([r for _, r in NATIONS], device=device,
                             dtype=torch.int64)
    c_nation, s_nation = c_city // 10, s_city // 10
    return common.Columns(
        spec=spec, time_day=day,
        dims={"c_region": region_of[c_nation], "c_nation": c_nation,
              "c_city": c_city, "s_region": region_of[s_nation],
              "s_nation": s_nation, "s_city": s_city,
              "p_mfgr": brand // 200, "p_category": brand // 40,
              "p_brand1": brand},
        metrics={"lo_quantity": ("long", quantity),
                 "lo_discount": ("long", discount),
                 "lo_extendedprice": ("long", extended),
                 "lo_revenue": ("long", revenue),
                 "lo_supplycost": ("long", supplycost)})
