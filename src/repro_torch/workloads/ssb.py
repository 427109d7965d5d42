"""Star-Schema-Benchmark-style synthetic data + query set (paper §7.3).

The port's own copy of ``load_ssb`` and ``SSB_QUERIES`` from the JAX
package's ``benchmarks/ssb.py`` (same seed, same columns, so both packages
load identical tables), plus ``KERNEL_QUERIES``: every SSB aggregate is a
SUM over a DOUBLE column that float32 does not hold, so the executor's gate
keeps SSB's own queries off the grouped-aggregation kernels; these two star
queries over the same tables reach them.

One fact table (lineorder) + 4 dimensions (date, customer, supplier, part)
and 13 queries across 4 flights that join, aggregate and place tight
dimensional filters — the workload shape of both the paper's Fig. 7 (TPC-DS)
and Fig. 8 (SSB) experiments.
"""
from __future__ import annotations

import numpy as np

from ..core.acid import AcidTable
from ..core.runtime.vector import VectorBatch


def load_ssb(wh, scale_rows: int = 60_000, seed: int = 42):
    s = wh.session()
    hms = wh.hms
    s.execute("""CREATE TABLE date_dim (d_datekey INT, d_year INT, d_month INT,
        d_weeknum INT, d_yearmonthnum INT)""")
    s.execute("""CREATE TABLE customer (c_custkey INT, c_region STRING,
        c_nation STRING, c_city STRING)""")
    s.execute("""CREATE TABLE supplier (s_suppkey INT, s_region STRING,
        s_nation STRING, s_city STRING)""")
    s.execute("""CREATE TABLE part (p_partkey INT, p_mfgr STRING,
        p_category STRING, p_brand STRING)""")
    s.execute("""CREATE TABLE lineorder (lo_orderkey INT, lo_custkey INT,
        lo_partkey INT, lo_suppkey INT, lo_orderdate INT, lo_quantity INT,
        lo_extendedprice DOUBLE, lo_discount DOUBLE, lo_revenue DOUBLE,
        lo_supplycost DOUBLE)""")

    rng = np.random.default_rng(seed)
    n_dates, n_cust, n_supp, n_part = 2556, 1000, 200, 400
    regions = np.array(["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"])
    nations = np.array([f"NATION_{i}" for i in range(25)])
    cities = np.array([f"CITY_{i}" for i in range(50)])

    tx = hms.open_txn()
    AcidTable(hms.get_table("date_dim"), hms).insert(tx, VectorBatch({
        "d_datekey": np.arange(n_dates),
        "d_year": 1992 + np.arange(n_dates) // 365,
        "d_month": (np.arange(n_dates) // 30) % 12 + 1,
        "d_weeknum": (np.arange(n_dates) // 7) % 52 + 1,
        "d_yearmonthnum": (1992 + np.arange(n_dates) // 365) * 100
        + ((np.arange(n_dates) // 30) % 12 + 1),
    }))
    AcidTable(hms.get_table("customer"), hms).insert(tx, VectorBatch({
        "c_custkey": np.arange(n_cust),
        "c_region": regions[rng.integers(0, 5, n_cust)],
        "c_nation": nations[rng.integers(0, 25, n_cust)],
        "c_city": cities[rng.integers(0, 50, n_cust)],
    }))
    AcidTable(hms.get_table("supplier"), hms).insert(tx, VectorBatch({
        "s_suppkey": np.arange(n_supp),
        "s_region": regions[rng.integers(0, 5, n_supp)],
        "s_nation": nations[rng.integers(0, 25, n_supp)],
        "s_city": cities[rng.integers(0, 50, n_supp)],
    }))
    AcidTable(hms.get_table("part"), hms).insert(tx, VectorBatch({
        "p_partkey": np.arange(n_part),
        "p_mfgr": np.array([f"MFGR_{i % 5}" for i in range(n_part)]),
        "p_category": np.array([f"CAT_{i % 25}" for i in range(n_part)]),
        "p_brand": np.array([f"BRAND_{i % 40}" for i in range(n_part)]),
    }))
    n = scale_rows
    price = rng.uniform(100, 10_000, n).round(2)
    disc = rng.uniform(0, 0.1, n).round(3)
    AcidTable(hms.get_table("lineorder"), hms).insert(tx, VectorBatch({
        "lo_orderkey": np.arange(n),
        "lo_custkey": rng.integers(0, n_cust, n),
        "lo_partkey": rng.integers(0, n_part, n),
        "lo_suppkey": rng.integers(0, n_supp, n),
        "lo_orderdate": rng.integers(0, n_dates, n),
        "lo_quantity": rng.integers(1, 50, n),
        "lo_extendedprice": price,
        "lo_discount": disc,
        "lo_revenue": (price * (1 - disc)).round(2),
        "lo_supplycost": rng.uniform(50, 5000, n).round(2),
    }))
    hms.commit_txn(tx)


SSB_QUERIES = {
    # flight 1: single-dim filters
    "q1.1": """SELECT SUM(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder, date_dim WHERE lo_orderdate = d_datekey
        AND d_year = 1993 AND lo_discount BETWEEN 0.01 AND 0.03
        AND lo_quantity < 25""",
    "q1.2": """SELECT SUM(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder, date_dim WHERE lo_orderdate = d_datekey
        AND d_yearmonthnum = 199401 AND lo_discount BETWEEN 0.04 AND 0.06
        AND lo_quantity BETWEEN 26 AND 35""",
    "q1.3": """SELECT SUM(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder, date_dim WHERE lo_orderdate = d_datekey
        AND d_weeknum = 6 AND d_year = 1994
        AND lo_discount BETWEEN 0.05 AND 0.07 AND lo_quantity BETWEEN 26 AND 35""",
    # flight 2: part x supplier
    "q2.1": """SELECT d_year, p_brand, SUM(lo_revenue) AS revenue
        FROM lineorder, date_dim, part, supplier
        WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
        AND lo_suppkey = s_suppkey AND p_category = 'CAT_12'
        AND s_region = 'AMERICA' GROUP BY d_year, p_brand
        ORDER BY d_year, p_brand""",
    "q2.2": """SELECT d_year, p_brand, SUM(lo_revenue) AS revenue
        FROM lineorder, date_dim, part, supplier
        WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
        AND lo_suppkey = s_suppkey AND p_brand = 'BRAND_22'
        AND s_region = 'ASIA' GROUP BY d_year, p_brand ORDER BY d_year""",
    "q2.3": """SELECT d_year, p_brand, SUM(lo_revenue) AS revenue
        FROM lineorder, date_dim, part, supplier
        WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
        AND lo_suppkey = s_suppkey AND p_brand = 'BRAND_3'
        AND s_region = 'EUROPE' GROUP BY d_year, p_brand ORDER BY d_year""",
    # flight 3: customer x supplier geography
    "q3.1": """SELECT c_nation, s_nation, d_year, SUM(lo_revenue) AS revenue
        FROM lineorder, customer, supplier, date_dim
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_orderdate = d_datekey AND c_region = 'ASIA'
        AND s_region = 'ASIA' AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_nation, s_nation, d_year ORDER BY d_year, revenue DESC""",
    "q3.2": """SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue
        FROM lineorder, customer, supplier, date_dim
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_orderdate = d_datekey AND c_nation = 'NATION_3'
        AND s_nation = 'NATION_3' AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year ORDER BY d_year, revenue DESC""",
    "q3.3": """SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue
        FROM lineorder, customer, supplier, date_dim
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_orderdate = d_datekey AND c_city = 'CITY_10'
        AND s_city = 'CITY_10' AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year ORDER BY d_year, revenue DESC""",
    "q3.4": """SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue
        FROM lineorder, customer, supplier, date_dim
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_orderdate = d_datekey AND c_city = 'CITY_10'
        AND s_city = 'CITY_11' AND d_yearmonthnum = 199712
        GROUP BY c_city, s_city, d_year ORDER BY revenue DESC""",
    # flight 4: profit drill-downs
    "q4.1": """SELECT d_year, c_nation,
        SUM(lo_revenue - lo_supplycost) AS profit
        FROM lineorder, date_dim, customer, supplier, part
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
        AND c_region = 'AMERICA' AND s_region = 'AMERICA'
        GROUP BY d_year, c_nation ORDER BY d_year, c_nation""",
    "q4.2": """SELECT d_year, s_nation, p_category,
        SUM(lo_revenue - lo_supplycost) AS profit
        FROM lineorder, date_dim, customer, supplier, part
        WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
        AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
        AND c_region = 'AMERICA' AND s_region = 'AMERICA'
        AND d_year IN (1997, 1998)
        GROUP BY d_year, s_nation, p_category ORDER BY d_year, s_nation""",
    "q4.3": """SELECT d_year, s_city, p_brand,
        SUM(lo_revenue - lo_supplycost) AS profit
        FROM lineorder, date_dim, supplier, part
        WHERE lo_suppkey = s_suppkey AND lo_partkey = p_partkey
        AND lo_orderdate = d_datekey AND s_nation = 'NATION_24'
        AND d_year IN (1997, 1998)
        GROUP BY d_year, s_city, p_brand ORDER BY d_year, s_city""",
}


KERNEL_QUERIES = {
    # aggregation fed straight by a native scan (benchmarks/run.py pr5)
    "scan_agg": "SELECT lo_custkey, SUM(lo_revenue) AS a,"
                " MIN(lo_revenue) AS b, MAX(lo_revenue) AS c,"
                " SUM(lo_quantity) AS d, COUNT(*) AS e,"
                " AVG(lo_extendedprice) AS f"
                " FROM lineorder GROUP BY lo_custkey",
    # integer aggregates over a star join: float32-exact, so they take
    # filter_eval, key_lookup, hash_group and hash_group_minmax
    "k.int_agg": """SELECT d_year, SUM(lo_quantity) AS q,
        COUNT(lo_orderkey) AS n, MIN(lo_quantity) AS lo,
        MAX(lo_quantity) AS hi FROM lineorder, date_dim
        WHERE lo_orderdate = d_datekey AND lo_quantity < 25
        GROUP BY d_year ORDER BY d_year""",
}
