"""The yardstick's arithmetic: each SQL kernel's bytes and operations on
hand-counted shapes (the path shapes whose bound PERF.md's kernel table
gives, in ms), and the trace readers on observations made by hand."""
import math

import pytest

from warehouse_bench import kernels_cost
from warehouse_bench.cell import reader
from warehouse_bench.generator import Record, Statement
from warehouse_bench.metrics import _device_profile

# (kernel, shape, bytes counted by hand, the table's bound in ms)
PATH_SHAPES = [
    ("filter_eval", {"n": 1024, "k": 2}, 1024 * 2 * 4 + 1024, 0.0000028),
    ("key_lookup", {"n": 1024, "g": 2556}, 2556 * 4 + 1024 * 4 + 1024 * 4,
     0.0000055),
    ("hash_group", {"n": 1024, "g": 7}, 1024 * 8 + 2 * 7 * 4, 0.0000025),
    ("hash_group_minmax", {"n": 1024, "g": 7}, 1024 * 8 + 2 * 7 * 4,
     0.0000025),
    ("hash_partition", {"n": 1024, "k": 1}, 1024 * 4 + 1024 * 4, 0.0000024),
    ("bloom_probe", {"n": 8192, "words": 16, "hashes": 6},
     8192 * 8 + 16 * 4 + 8192, 0.0000220),
]


@pytest.mark.parametrize("kernel,shape,nbytes,bound_ms", PATH_SHAPES,
                         ids=[k for k, *_ in PATH_SHAPES])
def test_bytes_and_bound(kernel, shape, nbytes, bound_ms):
    ops, got = kernels_cost.COST[kernel](**shape)
    assert got == nbytes
    assert ops / kernels_cost.FP32_OPS_PER_S < \
        nbytes / kernels_cost.HBM_BYTES_PER_S
    assert round(kernels_cost.bound_s(kernel, shape) * 1e3, 7) == bound_ms


def test_operations():
    assert kernels_cost.key_lookup(1024, 2556)[0] == 1024 * 12
    assert kernels_cost.filter_eval(10, 3)[0] == 50
    assert kernels_cost.bloom_probe(10, 4, 6)[0] == 120


def _obs(**kw):
    st = Statement("q1.1", "SELECT 1", {})
    recs = [Record(st, 0.0, 0.5, [], {"cache_hit": True,
                                         "stage_times_ms": {
                                             "parse": 1.0, "execute": 9.0}},
                   None, None),
            Record(st, 0.5, 2.0, None, {}, "Error: x", None)]
    obs = {"records": recs, "window_s": 2.0, "t_open": 0.0, "t_close": 2.0,
           "setup_s": 3.0, "lineorder_rows": 1000, "launches": {},
           "clocks": None, "profile": None}
    obs.update(kw)
    return obs


def test_end_to_end_readers():
    obs = _obs()
    assert reader("power_rows_per_s")(obs) == 500.0
    assert reader("dash_qps")(obs) == 0.5
    # 2 queries, one failed: the failure is the slowest, so p95 is none
    assert reader("dash_p95_ms")(obs) is None
    st = Statement("q1.1", "SELECT 1", {})
    many = [Record(st, 0.0, (i + 1) / 1e3, [], {}, None, None)
            for i in range(100)]
    assert reader("dash_p95_ms")(_obs(records=many)) == pytest.approx(95.0)
    assert reader("setup_s")(obs) == 3.0


def test_layer_readers():
    obs = _obs(launches={"key_lookup": 6, "hash_group.morsel": 5},
               clocks={"trip_s": 0.004, "trips": 4,
                       "probe": {"key_lookup": {"calls": 2, "call_s": 0.010,
                                                "trip_s": 0.004},
                                 "bloom_probe": {"calls": 0, "call_s": 0.0,
                                                 "trip_s": 0.0}},
                       "launches": [("key_lookup", {"n": 1024, "g": 2556})]},
               profile={"window_s": 2.0, "spans": [
                   (0.5, 0.5 + 1e-5, "void key_lookup_kernel<1, true>()"),
                   (1.0, 1.5, "Memcpy HtoD (Pinned -> Device)")]})
    assert reader("plan_ms.power")(obs) == 1.0
    assert reader("cache_hit_share.dash")(obs) == 0.5
    assert reader("launches_per_query.power")(obs) == 3.0
    assert reader("trip_ms.power")(obs) == pytest.approx(2.0)
    assert reader("probe_host_ms.power")(obs) == pytest.approx(3.0)
    assert reader("device_idle_share.power")(obs) == pytest.approx(
        1 - (0.5 + 1e-5) / 2.0)
    assert reader("kernel_roofline.power")(obs) == pytest.approx(
        100 * kernels_cost.bound_s("key_lookup", {"n": 1024, "g": 2556})
        / 1e-5)
    assert reader("wlm_wait_ms.dash")(obs) is None


def test_busy_gaps_and_names():
    spans = [(1.0, 2.0, "a"), (1.5, 3.0, "b"), (4.0, 4.5, "a")]
    busy, gaps = _device_profile.busy_and_gaps(spans, 0.0, 5.0)
    assert busy == pytest.approx(2.5)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (4.5, 5.0)]
    named = _device_profile.name_gaps(
        gaps, [(0.0, 5.0, "q stage:execute"), (2.9, 4.1, "q v1:compute")])
    assert named[:2] == [["q stage:execute", 1.0], ["q v1:compute", 1.0]]
    assert _device_profile.by_name(spans)[0] == ["a", 1.5]
    assert math.isclose(named[2][1], 0.5)
