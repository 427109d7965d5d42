"""Optimizer behaviour: pushdown, pruning, join order, semijoin, shared work
(paper §4.1, §4.5, §4.6)."""
from _torch_core import star_schema  # noqa: F401
import numpy as np
import pytest

from repro_torch.core.optimizer import plan as P
from repro_torch.core.optimizer.rules import Optimizer, OptimizerConfig
from repro_torch.core.optimizer.semijoin import insert_semijoin_reducers
from repro_torch.core.optimizer.shared_work import find_shared_subplans
from repro_torch.core.sql.binder import Binder
from repro_torch.core.sql.parser import parse


def _optimized(wh, sql, **cfg):
    plan = Binder(wh.hms).bind(parse(sql))
    opt = Optimizer(wh.hms, OptimizerConfig(**cfg))
    return opt.optimize(plan), opt


def test_filter_pushdown_reaches_scan(star_schema):
    plan, _ = _optimized(
        star_schema,
        "SELECT ss_price FROM store_sales, item WHERE ss_item_sk = i_item_sk"
        " AND i_price > 50 AND ss_qty > 3",
    )
    scans = {s.alias: s for s in P.find_scans(plan)}
    assert scans["item"].pushed_filter is not None
    assert scans["store_sales"].pushed_filter is not None
    assert "i_price" in scans["item"].pushed_filter.key()


def test_cross_join_becomes_inner(star_schema):
    plan, _ = _optimized(
        star_schema,
        "SELECT ss_price FROM store_sales, item WHERE ss_item_sk = i_item_sk",
    )
    joins = [n for n in P.walk_plan(plan) if isinstance(n, P.Join)]
    assert joins and all(j.kind == "inner" and j.left_keys for j in joins)


def test_column_pruning_narrows_scan(star_schema):
    plan, _ = _optimized(star_schema, "SELECT SUM(ss_price) FROM store_sales")
    scan = P.find_scans(plan)[0]
    assert scan.columns == ["ss_price"]


def test_count_star_keeps_one_column(star_schema):
    plan, _ = _optimized(star_schema, "SELECT COUNT(*) FROM store_sales")
    scan = P.find_scans(plan)[0]
    assert len(scan.columns) == 1


def test_join_reorder_puts_selective_first(star_schema):
    plan, opt = _optimized(
        star_schema,
        "SELECT SUM(ss_price) FROM store_sales, item, date_dim"
        " WHERE ss_item_sk = i_item_sk AND ss_date_sk = d_date_sk"
        " AND i_category = 'Sports'",
    )
    joins = [n for n in P.walk_plan(plan) if isinstance(n, P.Join)]
    assert all(j.strategy in ("broadcast", "shuffle") for j in joins)
    # the build (right) side of every join must be the smaller side
    for j in joins:
        lr = opt.cost_model.estimate(j.left).rows
        rr = opt.cost_model.estimate(j.right).rows
        assert rr <= lr * 1.5


def test_transitive_inference_derives_filters(star_schema):
    plan, _ = _optimized(
        star_schema,
        "SELECT SUM(ss_price) FROM store_sales, item"
        " WHERE ss_item_sk = i_item_sk AND ss_item_sk = 7",
    )
    scans = {s.alias: s for s in P.find_scans(plan)}
    # filter on ss_item_sk must be propagated to item.i_item_sk
    assert scans["item"].pushed_filter is not None


def test_partition_pruning(tmp_path):
    from repro_torch.core.session import Warehouse

    wh = Warehouse(str(tmp_path / "wh"))
    s = wh.session(engine="auto")
    s.execute("CREATE TABLE pt (v DOUBLE, d INT) PARTITIONED BY (d INT)")
    s.execute("INSERT INTO pt VALUES (1.0, 1), (2.0, 2), (3.0, 3)")
    plan, _ = _optimized(wh, "SELECT SUM(v) FROM pt WHERE d = 2")
    scan = P.find_scans(plan)[0]
    assert scan.partition_filter is not None
    r = s.execute("SELECT SUM(v) FROM pt WHERE d = 2")
    assert r.rows[0][0] == 2.0


def test_semijoin_reduction_inserted_and_correct(star_schema):
    plan, opt = _optimized(
        star_schema,
        "SELECT SUM(ss_price) FROM store_sales, item"
        " WHERE ss_item_sk = i_item_sk AND i_category = 'Sports'",
    )
    n = insert_semijoin_reducers(plan, opt.cost_model)
    assert n >= 1
    scans = {s.alias: s for s in P.find_scans(plan)}
    assert scans["store_sales"].runtime_filters
    # execution with reducers matches execution without
    s_on = star_schema.session(semijoin_reduction=True, result_cache=False, engine="auto")
    s_off = star_schema.session(semijoin_reduction=False, result_cache=False, engine="auto")
    sql = ("SELECT SUM(ss_price) FROM store_sales, item"
           " WHERE ss_item_sk = i_item_sk AND i_category = 'Sports'")
    assert abs(s_on.execute(sql).rows[0][0] - s_off.execute(sql).rows[0][0]) < 1e-6


def test_shared_work_detection(star_schema):
    sql = """SELECT a.c1, b.c2 FROM
      (SELECT i_category c1, COUNT(*) n FROM store_sales, item
       WHERE ss_item_sk = i_item_sk GROUP BY i_category) a,
      (SELECT i_category c2, SUM(ss_price) s FROM store_sales, item
       WHERE ss_item_sk = i_item_sk GROUP BY i_category) b
      WHERE a.c1 = b.c2"""
    plan, _ = _optimized(star_schema, sql)
    shared = find_shared_subplans(plan)
    assert shared  # the identical join subtree is detected once
    s = star_schema.session(result_cache=False, engine="auto")
    r = s.execute(sql)
    assert r.num_rows == 5
    assert r.info["shared_subplans"] >= 1


def test_cost_model_uses_hll_ndv(star_schema):
    from repro_torch.core.optimizer.cost import CostModel

    cm = CostModel(star_schema.hms)
    stats = star_schema.hms.get_stats("item")
    assert 50 <= stats.columns["i_item_sk"].ndv <= 70  # HLL++ approximate
    plan = Binder(star_schema.hms).bind(
        parse("SELECT i_price FROM item WHERE i_item_sk = 3"))
    opt = Optimizer(star_schema.hms)
    plan = opt.optimize(plan)
    est = cm.estimate(plan)
    assert est.rows == pytest.approx(1.0, rel=1.0)  # 1/ndv selectivity
