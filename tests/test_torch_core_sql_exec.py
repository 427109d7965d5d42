"""End-to-end SQL execution correctness vs numpy references (paper §3.1)."""
from _torch_core import session, star_schema  # noqa: F401
import collections

import numpy as np
import pytest
from _hypothesis_compat import HealthCheck, given, settings, st


def q(session, sql):
    return session.execute(sql)


def test_join_agg_orderby(star_schema):
    s = star_schema.session(engine="auto")
    r = q(s, """SELECT i_category, SUM(ss_price * ss_qty) AS rev, COUNT(*) c
                FROM store_sales, item WHERE ss_item_sk = i_item_sk
                GROUP BY i_category ORDER BY rev DESC""")
    # numpy oracle
    hms = star_schema.hms
    from repro_torch.core.acid import AcidTable
    snap = hms.get_snapshot()
    ss = AcidTable(hms.get_table("store_sales"), hms).read_all(
        hms.writeid_list("store_sales", snap))
    it = AcidTable(hms.get_table("item"), hms).read_all(
        hms.writeid_list("item", snap))
    cat = dict(zip(it.cols["i_item_sk"].tolist(), it.cols["i_category"].tolist()))
    rev, cnt = collections.defaultdict(float), collections.Counter()
    for k, p, n in zip(ss.cols["ss_item_sk"], ss.cols["ss_price"], ss.cols["ss_qty"]):
        rev[cat[k]] += p * n
        cnt[cat[k]] += 1
    exp = sorted(((c, v, cnt[c]) for c, v in rev.items()), key=lambda t: -t[1])
    got = [(a, round(b, 6), c) for a, b, c in r.rows]
    assert got == [(a, round(b, 6), c) for a, b, c in exp]


def test_correlated_scalar_subquery(star_schema):
    s = star_schema.session(engine="auto")
    r = q(s, """SELECT i.i_item_sk,
                (SELECT MAX(ss_price) FROM store_sales ss
                 WHERE ss.ss_item_sk = i.i_item_sk) mx
                FROM item i ORDER BY i.i_item_sk LIMIT 10""")
    hms = star_schema.hms
    from repro_torch.core.acid import AcidTable
    snap = hms.get_snapshot()
    ss = AcidTable(hms.get_table("store_sales"), hms).read_all(
        hms.writeid_list("store_sales", snap))
    mx = collections.defaultdict(float)
    for k, p in zip(ss.cols["ss_item_sk"], ss.cols["ss_price"]):
        mx[k] = max(mx[k], p)
    for k, v in r.rows:
        if not np.isnan(v):
            assert abs(v - mx[k]) < 1e-9


def test_exists_and_in_subqueries(star_schema):
    s = star_schema.session(engine="auto")
    r1 = q(s, """SELECT COUNT(*) FROM item WHERE EXISTS
                 (SELECT 1 FROM store_sales WHERE ss_item_sk = i_item_sk
                  AND ss_price > 99)""")
    r2 = q(s, """SELECT COUNT(*) FROM item WHERE i_item_sk IN
                 (SELECT ss_item_sk FROM store_sales WHERE ss_price > 99)""")
    assert r1.rows == r2.rows


def test_set_operations(star_schema):
    s = star_schema.session(engine="auto")
    a = q(s, "SELECT i_category FROM item WHERE i_price > 50 "
             "INTERSECT SELECT i_category FROM item WHERE i_price <= 50")
    b = q(s, "SELECT DISTINCT i_category FROM item")
    assert 0 < a.num_rows <= b.num_rows
    c = q(s, "SELECT i_category FROM item UNION SELECT i_category FROM item")
    assert c.num_rows == b.num_rows


def test_window_functions(star_schema):
    s = star_schema.session(engine="auto")
    r = q(s, """SELECT i_category, i_price,
                rank() OVER (PARTITION BY i_category ORDER BY i_price DESC) rk
                FROM item""")
    by_cat = collections.defaultdict(list)
    for cat, price, rk in r.rows:
        by_cat[cat].append((price, rk))
    for cat, vals in by_cat.items():
        vals.sort(key=lambda t: -t[0])
        assert vals[0][1] == 1
        for (p1, r1_), (p2, r2_) in zip(vals, vals[1:]):
            assert r2_ >= r1_


def test_grouping_sets(star_schema):
    s = star_schema.session(engine="auto")
    r = q(s, """SELECT i_category, d_year, SUM(ss_price) s
                FROM store_sales, item, date_dim
                WHERE ss_item_sk = i_item_sk AND ss_date_sk = d_date_sk
                GROUP BY GROUPING SETS ((i_category, d_year), (i_category), ())""")
    fine = [row for row in r.rows if row[0] != "" and not _isnan(row[1])]
    cat_rows = [row for row in r.rows if row[0] != "" and _isnan(row[1])]
    total_rows = [row for row in r.rows if row[0] == ""]
    assert len(total_rows) == 1
    assert abs(sum(x[2] for x in fine) - total_rows[0][2]) < 1e-6
    assert abs(sum(x[2] for x in cat_rows) - total_rows[0][2]) < 1e-6


def _isnan(x):
    try:
        return np.isnan(x)
    except TypeError:
        return False


def test_update_delete_merge_roundtrip(star_schema):
    s = star_schema.session(engine="auto")
    before = q(s, "SELECT SUM(i_price) FROM item").rows[0][0]
    s.execute("UPDATE item SET i_price = i_price + 10 WHERE i_category = 'Books'")
    n_books = q(s, "SELECT COUNT(*) FROM item WHERE i_category = 'Books'").rows[0][0]
    after = q(s, "SELECT SUM(i_price) FROM item").rows[0][0]
    assert abs(after - before - 10 * n_books) < 1e-6
    s.execute("DELETE FROM item WHERE i_category = 'Toys'")
    assert q(s, "SELECT COUNT(*) FROM item WHERE i_category = 'Toys'").rows[0][0] == 0
    s.execute("CREATE TABLE updates (k INT, price DOUBLE)")
    s.execute("INSERT INTO updates VALUES (0, 1.5), (1, 2.5), (9999, 3.5)")
    r = s.execute("""MERGE INTO item USING updates ON i_item_sk = k
                     WHEN MATCHED THEN UPDATE SET i_price = price
                     WHEN NOT MATCHED THEN INSERT (i_item_sk, i_category, i_price)
                     VALUES (k, 'New', price)""")
    assert r.info["updated"] == 2 and r.info["inserted"] == 1
    assert q(s, "SELECT i_price FROM item WHERE i_item_sk = 0").rows[0][0] == 1.5
    assert q(s, "SELECT i_category FROM item WHERE i_item_sk = 9999").rows[0][0] == "New"


def test_multi_table_write_single_txn(star_schema):
    """Writing two tables under one transaction (multi-insert, §3.2)."""
    wh = star_schema
    hms = wh.hms
    from repro_torch.core.acid import AcidTable
    from repro_torch.core.runtime.vector import VectorBatch

    hms.create_table("t1", [("a", "INT")])
    hms.create_table("t2", [("a", "INT")])
    tx = hms.open_txn()
    AcidTable(hms.get_table("t1"), hms).insert(tx, VectorBatch({"a": np.array([1])}))
    AcidTable(hms.get_table("t2"), hms).insert(tx, VectorBatch({"a": np.array([2])}))
    hms.commit_txn(tx)
    s = wh.session(engine="auto")
    assert q(s, "SELECT COUNT(*) FROM t1").rows[0][0] == 1
    assert q(s, "SELECT COUNT(*) FROM t2").rows[0][0] == 1


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    data=st.lists(st.tuples(st.integers(0, 20), st.integers(-50, 50)),
                  min_size=1, max_size=60),
    threshold=st.integers(-40, 40),
)
def test_property_filter_group_matches_numpy(tmp_path_factory, data, threshold):
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path_factory.mktemp("wh")))
    s = wh.session(engine="auto")
    s.execute("CREATE TABLE r (g INT, x INT)")
    values = ", ".join(f"({g}, {x})" for g, x in data)
    s.execute(f"INSERT INTO r VALUES {values}")
    r = s.execute(
        f"SELECT g, SUM(x) s, COUNT(*) c FROM r WHERE x > {threshold}"
        " GROUP BY g ORDER BY g")
    agg = collections.defaultdict(lambda: [0, 0])
    for g, x in data:
        if x > threshold:
            agg[g][0] += x
            agg[g][1] += 1
    exp = [(g, v[0], v[1]) for g, v in sorted(agg.items())]
    got = [(g, int(sv), c) if not _isnan(sv) else None
           for g, sv, c in r.rows]
    assert got == exp
