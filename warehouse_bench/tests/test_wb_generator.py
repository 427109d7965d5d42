"""The frozen generator and the traffic: SSB's filter factor of every
template, its hierarchies and value ranges, and the streams' rules (same
seed, same statements; no statement of the power stream twice; the
dashboards' repeat share; warm-up statements never in the window)."""
import json
from fractions import Fraction

import numpy as np
import pytest

import _small
from warehouse_bench import cell, generator
from warehouse_bench.cell import HERE
from warehouse_bench.reference import ssbgen, star

TEMPLATES = sorted(p.stem for p in (HERE / "queries").glob("*.json"))
# SF1's dimensions, so that a city or a brand holds enough rows
SIZES = {"lineorder": 200_000, "customer": 30_000, "supplier": 2_000,
         "part": 200_000, "date_dim": 2556}
DRAWS = 40


@pytest.fixture(scope="module")
def data():
    return ssbgen.generate(SIZES, 21)


def expected(text: str) -> float:
    return float(np.prod([Fraction(t.strip()) for t in text.split("*")]))


def measured(data, spec, params) -> float:
    """The product over the tables of the share of each table's rows that
    pass its predicates (SSB's filter factor of the query)."""
    per = {}
    for column, op, *args in spec["where"]:
        table = star._owner(data, column)
        hit = star._predicate(data[table][column], op,
                              [a.format(**params) for a in args])
        per[table] = per[table] & hit if table in per else hit
    return float(np.prod([m.mean() for m in per.values()]))


@pytest.mark.parametrize("name", TEMPLATES)
def test_filter_factor(data, name):
    tpl = json.loads((HERE / "queries" / f"{name}.json").read_text())
    rng = ssbgen.rng_for(4, name)
    got = np.mean([measured(data, tpl["spec"], generator.draw_params(
        tpl["params"], rng, ssbgen.domains())) for _ in range(DRAWS)])
    assert got == pytest.approx(expected(tpl["filter_factor"]), rel=0.15)


def test_hierarchies_and_ranges(data):
    c, p, lo = data["customer"], data["part"], data["lineorder"]
    region_of = {n: ssbgen.REGIONS[r] for n, r in ssbgen.NATIONS}
    assert all(region_of[n] == r for n, r in zip(c["c_nation"],
                                                 c["c_region"]))
    assert all(city.startswith(f"{n[:9]:<9}") for n, city in
               zip(c["c_nation"][:2000], c["c_city"][:2000]))
    assert all(b.startswith(cat) and cat.startswith(m) for m, cat, b in
               zip(p["p_mfgr"], p["p_category"], p["p_brand1"]))
    assert len(set(p["p_brand1"])) == 1000
    assert lo["lo_quantity"].min() == 1 and lo["lo_quantity"].max() == 50
    assert lo["lo_discount"].min() == 0 and lo["lo_discount"].max() == 10
    price = ssbgen.retail_cents(lo["lo_partkey"])
    np.testing.assert_array_equal(
        np.round(lo["lo_extendedprice"] * 100).astype(np.int64),
        lo["lo_quantity"] * price)
    np.testing.assert_array_equal(
        np.round(lo["lo_revenue"] * 100).astype(np.int64),
        lo["lo_quantity"] * price * (100 - lo["lo_discount"]) // 100)
    assert len(set(data["date_dim"]["d_year"])) == 7


def test_same_seed_same_data():
    a = ssbgen.generate(_small.SIZES, 2**40 + 1)
    b = ssbgen.generate(_small.SIZES, 2**40 + 1)
    for t in a:
        for col in a[t]:
            np.testing.assert_array_equal(a[t][col], b[t][col])


def _stream(workload: str, seed: int):
    spec = cell.cell_spec(_small.bench(), workload)
    return spec, generator.StatementStream(spec["mix"], spec["templates"],
                                           seed)


@pytest.mark.parametrize("workload", _small.WORKLOADS)
def test_stream_is_the_seeds(workload):
    spec, a = _stream(workload, 123456789012)
    _, b = _stream(workload, 123456789012)
    assert a.warmup() == b.warmup()
    assert [a.next() for _ in range(300)] == [b.next() for _ in range(300)]


def test_power_never_repeats_and_skips_warmup():
    spec, s = _stream("ssb_mart.power", 99)
    warm = {st.sql for st in s.warmup()}
    sent = [s.next() for _ in range(13 * 20)]
    assert len({st.sql for st in sent}) == len(sent)
    assert not warm & {st.sql for st in sent}
    assert [st.template for st in sent[:13]] == spec["mix"]["templates"]
    assert s.reused == 0


def test_dashboards_repeat_share():
    """3 sends in 5 re-send one of the last 16 distinct statements sent,
    answered or not; fresh sends take every template once a round."""
    spec, s = _stream("ssb_mart.dashboards", 5)
    warm = {st.sql for st in s.warmup()}
    # about twice a window's sends at 10 queries/s (H100 host)
    last, repeats, fresh = {}, 0, []
    for i in range(1000):
        st = s.next()
        if st.sql in last:
            repeats += 1
            # fewer than 16 distinct statements were sent since its last send
            assert len({q for q, at in last.items() if at > last[st.sql]}) \
                < 16
        else:
            fresh.append(st.template)
        last[st.sql] = i
    assert s.reused == 0
    # 3 in 5, less a repeat due before the first send
    assert 599 <= repeats <= 600
    assert not warm & set(last)
    n = len(spec["mix"]["templates"])
    for k in range(0, len(fresh) - n + 1, n):
        assert sorted(fresh[k:k + n]) == sorted(spec["mix"]["templates"])


def test_repeats_need_no_answer():
    """A statement can come again before any answer: a repeat of a query
    still in flight, as users of a shared dashboard send it."""
    _, s = _stream("ssb_mart.dashboards", 6)
    sent = [s.next() for _ in range(50)]
    assert 25 <= 50 - len({st.sql for st in sent}) <= 30


def test_every_column_of_ssb(data):
    for table, cols in ssbgen.SCHEMA.items():
        assert list(data[table]) == [c for c, _ in cols]
        assert len({v.size for v in data[table].values()}) == 1
    assert sum(len(c) for c in ssbgen.SCHEMA.values()) == 58


def test_dates_and_orders(data):
    d, lo = data["date_dim"], data["lineorder"]
    key = d["d_datekey"]
    assert key[0] == 19920101 and key[-1] == 19981230
    assert np.all(key // 10000 == d["d_year"])
    assert np.all(key // 100 == d["d_yearmonthnum"])
    assert np.all(key % 100 == d["d_daynuminmonth"])
    assert d["d_dayofweek"][0] == "Wednesday" and d["d_daynuminweek"][0] == 4
    assert d["d_date"][365] == "December 31, 1992"
    assert d["d_lastdayinmonthfl"].sum() == 12 * 7 - 1
    assert set(lo["lo_orderdate"]) <= set(key)
    gap = (np.array([np.datetime64(f"{k // 10000}-{k // 100 % 100:02d}-"
                                   f"{k % 100:02d}") for k in
                     lo["lo_commitdate"][:500].tolist()], dtype="datetime64[D]")
           - np.array([np.datetime64(f"{k // 10000}-{k // 100 % 100:02d}-"
                                     f"{k % 100:02d}") for k in
                       lo["lo_orderdate"][:500].tolist()],
                      dtype="datetime64[D]")).astype(int)
    assert gap.min() >= 30 and gap.max() <= 90
    order = lo["lo_orderkey"]
    new = np.flatnonzero(np.diff(order)) + 1
    assert np.all(lo["lo_linenumber"][new] == 1)
    assert lo["lo_linenumber"].max() == 7
    for col in ("lo_orderdate", "lo_orderpriority", "lo_ordtotalprice"):
        assert np.all(lo[col][new - 1][order[new - 1] == order[new - 2]]
                      == lo[col][new - 2][order[new - 1] == order[new - 2]])
    first = order == 1
    cents = (lo["lo_extendedprice"][first] * 100).round().astype(np.int64)
    total = (cents * (100 + lo["lo_tax"][first]) // 100
             * (100 - lo["lo_discount"][first]) // 100).sum()
    assert lo["lo_ordtotalprice"][0] == total / 100.0


def test_text_columns(data):
    c, s, p = data["customer"], data["supplier"], data["part"]
    assert c["c_name"][0] == "Customer#000000001"
    assert s["s_name"][-1] == f"Supplier#{len(s['s_name']):09d}"
    lens = np.char.str_len(c["c_address"])
    assert lens.min() == 10 and lens.max() == 25
    nation = {n: i for i, (n, _) in enumerate(ssbgen.NATIONS)}
    assert all(ph.startswith(f"{nation[n] + 10}-") and len(ph) == 15
               for n, ph in zip(c["c_nation"][:500], c["c_phone"][:500]))
    assert set(c["c_mktsegment"]) == set(ssbgen.SEGMENTS)
    assert len(set(p["p_type"])) == 150 and len(set(p["p_container"])) == 40
    assert all(len(n.split()) == 2 for n in p["p_name"][:500])
    assert p["p_size"].min() == 1 and p["p_size"].max() == 50
