"""Typed schema contract (repro_torch.core.schema) + static schema-flow checker
(repro_torch.analysis.schema_check, SCH001..SCH006) + runtime batch sanitizer.

Covers: ColumnType/Schema semantics, dtype-preservation end-to-end (float32
through scans, shuffles, aggregate folds and federated merges), UNION ALL
promotion parity with numpy, one seeded violation per SCH rule, the
``REPRO_CHECK_BATCHES`` exchange sanitizer, schema-carrying empty batches,
and ``schema:`` lines in EXPLAIN output.
"""
from _torch_core import warehouse, session  # noqa: F401
import numpy as np
import pytest

from repro_torch.analysis.schema_check import (validate_dag_schemas,
                                         validate_plan_schema)
from repro_torch.core.metastore import TableDesc
from repro_torch.core.optimizer import plan as P
from repro_torch.core.runtime.dag import MaterializedNode, TaskDAG, Vertex
from repro_torch.core.runtime.exchange import Exchange, ExchangeConfig
from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.core.schema import (ANY, FLOAT64, INT64, STR, ColumnType, Schema,
                               SchemaMismatchError, agg_result_type,
                               annotate_plan, infer_plan)
from repro_torch.core.sql import ast as A


def _desc(name, cols):
    return TableDesc(name=name, schema=cols, partition_cols=[],
                     location="", props={})


def _scan(name, cols, alias=None):
    return P.Scan(_desc(name, cols), alias or name)


# ===========================================================================
# ColumnType / Schema semantics
# ===========================================================================
class TestColumnType:
    def test_sql_type_mapping(self):
        assert ColumnType.of_sql("BIGINT").token == "int64"
        assert ColumnType.of_sql("DOUBLE").token == "float64"
        assert ColumnType.of_sql("FLOAT").token == "float32"  # single prec.
        assert ColumnType.of_sql("STRING").token == "str"
        assert ColumnType.of_sql("BOOLEAN").token == "bool"
        assert ColumnType.of_sql("GEOMETRY").token == "any"  # unknown -> any

    def test_promotion_follows_numpy(self):
        assert INT64.promote(FLOAT64).token == "float64"
        f32 = ColumnType("float32")
        assert f32.promote(f32).token == "float32"
        assert INT64.promote(f32).token == "float64"  # numpy int64+float32
        assert ANY.promote(STR).token == "str"

    def test_str_numeric_promotion_is_a_contradiction(self):
        with pytest.raises(SchemaMismatchError):
            STR.promote(INT64)

    def test_accepts_nan_null_representation(self):
        # int64/bool columns travel as float64 once NULLs (NaN) pad them
        assert INT64.accepts(np.dtype(np.float64))
        assert not INT64.accepts(np.dtype("U8"))
        assert STR.accepts(np.dtype("U64"))
        assert ANY.accepts(np.dtype(np.float64))

    def test_agg_result_types(self):
        assert agg_result_type("count", STR).token == "int64"
        assert agg_result_type("sum", INT64).token == "int64"
        assert agg_result_type("avg", INT64).token == "float64"
        f32 = ColumnType("float32")
        assert agg_result_type("min", f32).token == "float32"
        assert agg_result_type("sum", f32).token == "float64"

    def test_schema_resolve_mirrors_lookup(self):
        s = Schema([("t.a", INT64), ("t.b", FLOAT64)])
        assert s.resolve("a").token == "int64"          # unique suffix
        assert s.resolve("t.a").token == "int64"        # exact
        assert s.resolve("b", table="t").token == "float64"
        from repro_torch.core.schema import UnresolvedColumnError
        with pytest.raises(UnresolvedColumnError):
            s.resolve("zzz")

    def test_check_batch(self):
        s = Schema([("a", INT64), ("b", STR)])
        s.check_batch(VectorBatch({"a": np.arange(3),
                                   "b": np.array(["x", "y", "z"]),
                                   "__rowid__": np.arange(3)}))
        with pytest.raises(SchemaMismatchError, match="missing"):
            s.check_batch(VectorBatch({"a": np.arange(3)}))
        with pytest.raises(SchemaMismatchError, match="undeclared"):
            s.check_batch(VectorBatch({"a": np.arange(3),
                                       "b": np.array(["x", "y", "z"]),
                                       "extra": np.arange(3)}))


# ===========================================================================
# inference over plans
# ===========================================================================
class TestInference:
    def test_scan_types_from_catalog(self):
        sc = _scan("t", [("a", "BIGINT"), ("b", "DOUBLE"), ("c", "STRING")])
        s = infer_plan(sc)
        assert s.describe() == "t.a:int64, t.b:float64, t.c:str"

    def test_outer_join_nullable_padding(self):
        l = _scan("l", [("k", "BIGINT"), ("v", "BIGINT")])
        r = _scan("r", [("k", "BIGINT"), ("w", "BIGINT")])
        j = P.Join(l, r, "left", ["l.k"], ["r.k"])
        s = infer_plan(j)
        # padded right side widens to float64 (NaN-null), left unchanged
        assert s.get("l.v").token == "int64"
        assert s.get("r.w").token == "float64"
        assert s.get("r.w").nullable

    def test_union_promotes_positionally(self):
        a = _scan("a", [("x", "BIGINT")])
        b = _scan("b", [("y", "DOUBLE")])
        s = infer_plan(P.Union([a, b], all=True))
        assert s.names() == ["a.x"]
        assert s.get("a.x").token == "float64"


# ===========================================================================
# seeded violations: one per SCH rule
# ===========================================================================
class TestSeededViolations:
    def test_sch001_unresolved_column(self):
        sc = _scan("t", [("a", "BIGINT")])
        bad = P.Project(sc, [(A.Col("missing", "t"), "m")])
        findings = validate_plan_schema(bad)
        assert len(findings) == 1 and findings[0].startswith("SCH001")

    def test_sch002_union_branch_mismatch(self):
        a = _scan("a", [("x", "BIGINT")])
        b = _scan("b", [("y", "STRING")])  # str vs numeric: no promotion
        findings = validate_plan_schema(P.Union([a, b], all=True))
        assert len(findings) == 1 and findings[0].startswith("SCH002")

    def test_sch003_merge_fold_changes_state_dtype(self):
        # a float32 MIN partial re-folded through SUM (the shape a split /
        # collapse or federated-merge rewrite emits) widens the state
        mn = MaterializedNode(["g", "m"], "v2",
                              schema=Schema([("g", INT64),
                                             ("m", ColumnType("float32"))]))
        merge = P.Aggregate(mn, ["g"], [
            P.AggSpec("sum", A.Col("m"), False, "m")])
        findings = validate_plan_schema(merge)
        assert any(f.startswith("SCH003") for f in findings)
        # the correct merge fold (MIN partials re-MINed) is clean
        ok = P.Aggregate(mn, ["g"], [P.AggSpec("min", A.Col("m"), False, "m")])
        assert validate_plan_schema(ok) == []

    def test_sch004_join_key_family_mismatch(self):
        l = _scan("l", [("k", "STRING"), ("v", "BIGINT")])
        r = _scan("r", [("k", "BIGINT")])
        findings = validate_plan_schema(
            P.Join(l, r, "inner", ["l.k"], ["r.k"]))
        assert len(findings) == 1 and findings[0].startswith("SCH004")

    def test_sch005_residual_over_dropped_column(self):
        from repro_torch.core.federation.datasource import ScanSpec

        desc = TableDesc(name="m.t", schema=[("a", "BIGINT"), ("b", "DOUBLE")],
                         partition_cols=[], location="", props={},
                         handler="memtable")
        fed = P.FederatedScan(desc, "t", ["a", "b"],
                              spec=ScanSpec(projection=["a"]),
                              output_cols=["t.a"])
        bad = P.Filter(fed, A.BinOp(">", A.Col("b", "t"), A.Lit(0)))
        findings = validate_plan_schema(bad)
        assert len(findings) == 1 and findings[0].startswith("SCH005")

    def test_sch006_placeholder_producer_disagreement(self):
        producer = _scan("t", [("a", "BIGINT"), ("b", "DOUBLE")])
        mn = MaterializedNode(["t.a", "t.zzz"], "v2")  # wrong column set
        dag = TaskDAG(vertices={
            "v2": Vertex("v2", producer),
            "v1": Vertex("v1", mn, deps=["v2"]),
        }, root="v1")
        findings = validate_dag_schemas(dag)
        assert len(findings) == 1 and findings[0].startswith("SCH006")

    def test_clean_dag_has_no_findings(self):
        producer = _scan("t", [("a", "BIGINT"), ("b", "DOUBLE")])
        mn = MaterializedNode(["t.a", "t.b"], "v2")
        dag = TaskDAG(vertices={
            "v2": Vertex("v2", producer),
            "v1": Vertex("v1", mn, deps=["v2"]),
        }, root="v1")
        assert validate_dag_schemas(dag) == []


# ===========================================================================
# runtime batch sanitizer (REPRO_CHECK_BATCHES / debug.check_batches)
# ===========================================================================
class TestBatchSanitizer:
    def test_put_rejects_nonconforming_morsel(self):
        cfg = ExchangeConfig({"debug.check_batches": True})
        ex = Exchange("v9", cfg)
        ex.declare_schema(Schema([("a", INT64), ("b", STR)]))
        ex.put(VectorBatch({"a": np.arange(2), "b": np.array(["x", "y"])}))
        with pytest.raises(SchemaMismatchError, match="exchange v9"):
            ex.put(VectorBatch({"a": np.arange(2)}))

    def test_sanitizer_off_means_no_verification(self, monkeypatch):
        monkeypatch.delenv("REPRO_CHECK_BATCHES", raising=False)
        cfg = ExchangeConfig({})
        ex = Exchange("v9", cfg)
        ex.declare_schema(Schema([("a", INT64)]))
        assert ex._verify is None  # put() pays one attribute test only
        ex.put(VectorBatch({"weird": np.arange(2)}))  # not checked

    def test_read_all_keeps_schema_on_empty(self):
        cfg = ExchangeConfig({})
        ex = Exchange("v1", cfg)
        ex.declare_schema(Schema([("a", INT64), ("b", STR)]))
        ex.close()
        out = ex.read_all()
        assert out.num_rows == 0
        assert out.column_names == ["a", "b"]
        assert out.cols["a"].dtype == np.int64


# ===========================================================================
# VectorBatch.concat schema preservation
# ===========================================================================
class TestConcat:
    def test_schemaless_placeholders_are_dropped(self):
        full = VectorBatch({"a": np.arange(3)})
        out = VectorBatch.concat([VectorBatch({}), full, VectorBatch({})])
        assert out.column_names == ["a"] and out.num_rows == 3

    def test_all_schemaless_stays_empty(self):
        out = VectorBatch.concat([VectorBatch({}), VectorBatch({})])
        assert out.num_rows == 0 and out.column_names == []

    def test_mismatch_names_the_edge(self):
        a = VectorBatch({"a": np.arange(2)})
        b = VectorBatch({"b": np.arange(2)})
        with pytest.raises(SchemaMismatchError, match="exchange v7"):
            VectorBatch.concat([a, b], context="exchange v7")


# ===========================================================================
# end-to-end: dtype preservation through the engine
# ===========================================================================
@pytest.fixture()
def session(warehouse):
    return warehouse.session(engine="auto")


class TestEndToEnd:
    def test_union_all_promotion_parity_with_numpy(self, session):
        session.execute("CREATE TABLE ints (x BIGINT)")
        session.execute("CREATE TABLE dbls (x DOUBLE)")
        session.execute("INSERT INTO ints VALUES (1), (2), (3)")
        session.execute("INSERT INTO dbls VALUES (0.5), (1.5)")
        r = session.execute(
            "SELECT x FROM ints UNION ALL SELECT x FROM dbls")
        col = r.batch.cols[r.batch.column_names[0]]
        want = np.promote_types(np.int64, np.float64)
        assert col.dtype == want
        assert sorted(col.tolist()) == [0.5, 1.0, 1.5, 2.0, 3.0]

    def test_float_column_is_single_precision(self, session):
        session.execute("CREATE TABLE f32 (k BIGINT, v FLOAT)")
        session.execute("INSERT INTO f32 VALUES (1, 1.5), (1, 2.5), (2, 0.25)")
        r = session.execute("SELECT v FROM f32")
        assert r.batch.cols[r.batch.column_names[0]].dtype == np.float32

    def test_float32_survives_min_max_group_by(self, session):
        session.execute("CREATE TABLE f32g (k BIGINT, v FLOAT)")
        session.execute(
            "INSERT INTO f32g VALUES (1, 1.5), (1, 2.5), (2, 0.25)")
        r = session.execute(
            "SELECT k, MIN(v) AS lo, MAX(v) AS hi FROM f32g GROUP BY k"
            " ORDER BY k")
        names = r.batch.column_names
        assert r.batch.cols[names[1]].dtype == np.float32
        assert r.batch.cols[names[2]].dtype == np.float32
        assert r.rows == [(1, 1.5, 2.5), (2, 0.25, 0.25)]

    def test_cast_as_float_is_single_precision(self, session):
        session.execute("CREATE TABLE c1 (x BIGINT)")
        session.execute("INSERT INTO c1 VALUES (1), (2)")
        r = session.execute("SELECT CAST(x AS FLOAT) AS f FROM c1")
        assert r.batch.cols[r.batch.column_names[0]].dtype == np.float32

    def test_float32_through_shuffled_group_by(self, warehouse):
        # force a partitioned shuffle so lanes + fold merges carry float32
        s = warehouse.session(**{"shuffle.partitions": 4}, engine="auto")
        s.execute("CREATE TABLE big32 (k BIGINT, v FLOAT)")
        rows = ", ".join(f"({i % 13}, {i * 0.25})" for i in range(400))
        s.execute(f"INSERT INTO big32 VALUES {rows}")
        r = s.execute("SELECT k, MIN(v) AS lo FROM big32 GROUP BY k"
                      " ORDER BY k")
        assert r.batch.cols[r.batch.column_names[1]].dtype == np.float32
        lo = {k: v for k, v in r.rows}
        assert lo[0] == 0.0 and len(lo) == 13

    def test_float32_memtable_federated_min(self, warehouse):
        s = warehouse.session(engine="auto")
        s.execute("CREATE CATALOG m32 USING memtable")
        h = warehouse.catalogs.get("m32").handler
        h.load("t", VectorBatch({
            "g": np.arange(100) % 5,
            "v": (np.arange(100) * 0.5).astype(np.float32),
        }))
        assert dict(h.discover(None, "t"))["v"] == "FLOAT"  # f4 -> FLOAT
        r = s.execute("SELECT g, MIN(v) AS lo FROM m32.default.t GROUP BY g"
                      " ORDER BY g")
        assert r.batch.cols[r.batch.column_names[1]].dtype == np.float32
        assert r.rows[0] == (0, 0.0)

    def test_explain_carries_schema_lines(self, session):
        session.execute("CREATE TABLE e (a BIGINT, b DOUBLE)")
        out = session.explain("SELECT a, SUM(b) AS s FROM e GROUP BY a")
        assert "schema:" in out
        assert "s:float64?" in out

    def test_tolerant_annotation_never_raises(self):
        # annotate_plan degrades to schema=None on inference failures
        sc = _scan("t", [("a", "BIGINT")])
        bad = P.Project(sc, [(A.Col("missing", "t"), "m")])
        annotate_plan(bad)
        assert bad.schema is None
        assert sc.schema is not None
