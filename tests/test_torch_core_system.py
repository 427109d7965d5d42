"""End-to-end system behaviour: a BI-style workload exercising every paper
axis at once — ACID writes, optimizer, LLAP, result cache, MV, federation."""
import numpy as np
import pytest


def test_end_to_end_warehouse_scenario(tmp_path):
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"))
    s = wh.session(engine="auto")

    # -- DDL with partitioning (paper §3.1 / Figure 3)
    s.execute("""CREATE TABLE store_sales (
        ss_item_sk INT, ss_customer_sk INT, ss_qty INT,
        ss_price DECIMAL(7,2), ss_sold_date_sk INT
    ) PARTITIONED BY (ss_sold_date_sk INT)""")
    s.execute("CREATE TABLE item (i_item_sk INT, i_category STRING)")

    rng = np.random.default_rng(11)
    rows = ", ".join(
        f"({rng.integers(0, 40)}, {rng.integers(0, 100)}, {rng.integers(1, 9)},"
        f" {rng.uniform(1, 50):.2f}, {d})"
        for d in range(10) for _ in range(200)
    )
    s.execute(f"INSERT INTO store_sales VALUES {rows}")
    items = ", ".join(
        f"({i}, '{['Sports', 'Books', 'Home', 'Toys'][i % 4]}')" for i in range(40)
    )
    s.execute(f"INSERT INTO item VALUES {items}")

    # partition directories exist on disk (physical layout, Figure 3)
    parts = wh.hms.list_partitions("store_sales")
    assert len(parts) == 10

    # -- interactive query with every optimization on
    sql = """SELECT i_category, SUM(ss_price * ss_qty) AS rev
             FROM store_sales, item
             WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk BETWEEN 2 AND 5
             GROUP BY i_category ORDER BY rev DESC"""
    r1 = s.execute(sql)
    assert r1.num_rows == 4 and r1.info["cache_hit"] is False
    r2 = s.execute(sql)
    assert r2.info["cache_hit"] is True

    # -- ACID update flows through and invalidates the cache
    s.execute("UPDATE store_sales SET ss_qty = ss_qty + 1 WHERE ss_item_sk = 0")
    r3 = s.execute(sql)
    assert r3.info["cache_hit"] is False
    assert r3.rows != r1.rows  # totals changed

    # -- snapshot isolation survived the partitioned update
    total = s.execute("SELECT COUNT(*) FROM store_sales").rows[0][0]
    assert total == 2000

    # -- MV accelerates a rollup and survives incremental rebuild
    s.execute("""CREATE MATERIALIZED VIEW cat_daily AS
        SELECT ss_sold_date_sk, i_category, SUM(ss_price) AS s
        FROM store_sales, item WHERE ss_item_sk = i_item_sk
        GROUP BY ss_sold_date_sk, i_category""")
    q_mv = ("SELECT i_category, SUM(ss_price) s FROM store_sales, item"
            " WHERE ss_item_sk = i_item_sk GROUP BY i_category")
    r4 = s.execute(q_mv)
    assert r4.info.get("mv_used") == "cat_daily"
    ref = wh.session(mv_rewriting=False, result_cache=False, engine="auto").execute(q_mv)
    assert sorted((a, round(b, 6)) for a, b in r4.rows) == \
        sorted((a, round(b, 6)) for a, b in ref.rows)

    # -- EXPLAIN shows a DAG with data-movement edges
    text = s.explain(sql)
    assert "Scan[store_sales" in text and "DAG edges" in text

    # -- LLAP counters moved
    assert wh.llap.counters["cache_hits"] + wh.llap.counters["cache_misses"] > 0


def test_acid_at_par_after_compaction(tmp_path):
    """§8: post-compaction ACID read cost ~ non-ACID (single base, no merge)."""
    from repro_torch.core.acid import AcidTable, list_stores
    from repro_torch.core.compaction import compact_partition
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"))
    s = wh.session(compaction_enabled=False, engine="auto")
    s.execute("CREATE TABLE t (k INT, v DOUBLE)")
    for i in range(8):
        vals = ", ".join(f"({j}, {j * 0.5})" for j in range(i * 50, (i + 1) * 50))
        s.execute(f"INSERT INTO t VALUES {vals}")
    s.execute("DELETE FROM t WHERE k < 20")
    tbl = AcidTable(wh.hms.get_table("t"), wh.hms)
    assert len(list_stores(tbl.desc.location)) >= 9  # many deltas pre-compaction
    before = s.execute("SELECT COUNT(*), SUM(v) FROM t").rows
    compact_partition(tbl, tbl.desc.location, "major", wh.hms)
    stores = list_stores(tbl.desc.location)
    assert [x.kind for x in stores] == ["base"]  # history folded away
    after = wh.session(result_cache=False, engine="auto").execute(
        "SELECT COUNT(*), SUM(v) FROM t").rows
    assert before == after
