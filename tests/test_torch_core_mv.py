"""Materialized views: rewriting, staleness, incremental maintenance (§4.4)."""
from _torch_core import star_schema  # noqa: F401
import numpy as np
import pytest


MV_SQL = """CREATE MATERIALIZED VIEW mv1 AS
SELECT d_year, d_moy, SUM(ss_price) AS sum_sales
FROM store_sales, date_dim WHERE ss_date_sk = d_date_sk AND d_year > 2017
GROUP BY d_year, d_moy"""


@pytest.fixture()
def with_mv(star_schema):
    s = star_schema.session(engine="auto")
    s.execute(MV_SQL)
    return star_schema


def _pair(wh, sql):
    on = wh.session(result_cache=False, engine="auto").execute(sql)
    off = wh.session(mv_rewriting=False, result_cache=False, engine="auto").execute(sql)
    return on, off


def test_full_containment_rewrite(with_mv):
    sql = ("SELECT SUM(ss_price) AS s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year = 2018 AND d_moy IN (1,2,3)")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") == "mv1"
    assert on.info.get("mv_mode") == "full"
    assert abs(on.rows[0][0] - off.rows[0][0]) < 1e-6


def test_rollup_rewrite(with_mv):
    sql = ("SELECT d_year, SUM(ss_price) s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year > 2017 GROUP BY d_year")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") == "mv1"
    assert sorted((a, round(b, 6)) for a, b in on.rows) == \
        sorted((a, round(b, 6)) for a, b in off.rows)


def test_partial_containment_union_rewrite(with_mv):
    sql = ("SELECT d_year, SUM(ss_price) s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year > 2016 GROUP BY d_year")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_mode") == "partial"
    assert sorted((a, round(b, 6)) for a, b in on.rows) == \
        sorted((a, round(b, 6)) for a, b in off.rows)


def test_no_rewrite_when_not_contained(with_mv):
    # filter on a column the MV neither exposes nor constrains identically
    sql = ("SELECT SUM(ss_price) s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year > 2017 AND ss_qty > 5")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") is None
    assert abs(on.rows[0][0] - off.rows[0][0]) < 1e-6


def test_stale_mv_not_used_then_incremental_rebuild(with_mv):
    s = with_mv.session(result_cache=False, engine="auto")
    s.execute("INSERT INTO store_sales VALUES (5, 30, 7, 2, 42.5)")  # d_year 2018
    sql = ("SELECT SUM(ss_price) AS s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year = 2018 AND d_moy IN (1,2,3)")
    r = s.execute(sql)
    assert r.info.get("mv_used") is None  # stale -> skipped
    rr = s.execute("ALTER MATERIALIZED VIEW mv1 REBUILD")
    assert rr.info["rebuild_mode"] == "incremental"
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") == "mv1"
    assert abs(on.rows[0][0] - off.rows[0][0]) < 1e-6


def test_delete_forces_full_rebuild(with_mv):
    s = with_mv.session(result_cache=False, engine="auto")
    s.execute("DELETE FROM store_sales WHERE ss_qty = 3")
    rr = s.execute("ALTER MATERIALIZED VIEW mv1 REBUILD")
    assert rr.info["rebuild_mode"] == "full"
    sql = ("SELECT d_year, SUM(ss_price) s FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk AND d_year > 2017 GROUP BY d_year")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") == "mv1"
    assert sorted((a, round(b, 6)) for a, b in on.rows) == \
        sorted((a, round(b, 6)) for a, b in off.rows)


def test_avg_rewrites_via_sum_count(with_mv):
    s = with_mv.session(result_cache=False, engine="auto")
    s.execute("""CREATE MATERIALIZED VIEW mv_avg AS
      SELECT d_year, SUM(ss_price) AS s, COUNT(ss_price) AS c
      FROM store_sales, date_dim WHERE ss_date_sk = d_date_sk
      GROUP BY d_year""")
    sql = ("SELECT d_year, AVG(ss_price) a FROM store_sales, date_dim"
           " WHERE ss_date_sk = d_date_sk GROUP BY d_year")
    on, off = _pair(with_mv, sql)
    assert on.info.get("mv_used") == "mv_avg"
    assert sorted((a, round(b, 9)) for a, b in on.rows) == \
        sorted((a, round(b, 9)) for a, b in off.rows)
