"""The plain reference against the port on the benchmark's generator, at a
few thousand rows on the CPU: every template under ``engine: auto`` (numpy
host paths) and ``ref`` (the kernels' plain torch versions), and whole runs
of each cell's mix, whose check must come out correct."""
import json

import pytest

import _small
from warehouse_bench import check, generator
from warehouse_bench.cell import HERE, load
from warehouse_bench.reference import ssbgen, star

TEMPLATES = sorted(p.stem for p in (HERE / "queries").glob("*.json"))
SIZES = dict(_small.SIZES, lineorder=20000)
DRAWS = 3


def template(name: str) -> dict:
    return json.loads((HERE / "queries" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    from repro_torch.core.session import Warehouse

    data = ssbgen.generate(SIZES, 5)
    wh = Warehouse(str(tmp_path_factory.mktemp("wh")))
    load(wh, data)
    yield wh, data
    wh.close()


@pytest.mark.parametrize("engine", ["auto", "ref"])
@pytest.mark.parametrize("name", TEMPLATES)
def test_template_matches_reference(warehouse, name, engine):
    import repro_torch.api as api

    wh, data = warehouse
    tpl = template(name)
    rng = ssbgen.rng_for(9, name)
    with api.connect(warehouse=wh, engine=engine,
                     result_cache=False) as conn:
        for _ in range(DRAWS):
            params = generator.draw_params(tpl["params"], rng,
                                           ssbgen.domains())
            rows = conn.execute(tpl["sql"].format(**params)).fetchall()
            ref = star.evaluate(data, tpl["spec"], params)
            right, gap = check.compare(rows, ref, tpl["spec"])
            assert right, (tpl["sql"].format(**params), rows[:3], ref[:3])
            assert gap < 1e-12


@pytest.mark.parametrize("engine", ["auto", "ref"])
@pytest.mark.parametrize("workload", _small.WORKLOADS)
def test_run_is_correct(workload, engine):
    out = _small.run(workload, 2**31 + 7, engine)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def test_reference_semantics():
    """Empty input: no groups when grouped, one NULL row when not; the
    ORDER BY helper sorts as the spec says."""
    data = ssbgen.generate(dict(_small.SIZES, lineorder=500), 3)
    q11 = template("q1.1")["spec"]
    none = {"year": 1800, "disc": 1, "disc_hi": 3}
    assert star.evaluate(data, q11, none) == [(None,)]
    q21 = template("q2.1")["spec"]
    assert star.evaluate(data, q21, {"cat": "MFGR#99",
                                     "region": "ASIA"}) == []
    tile = template("tile.year")["spec"]
    rows = star.evaluate(data, tile, {"qty": 1, "qty_hi": 25, "disc": 0,
                                      "disc_hi": 2})
    assert check.in_order(star.ordered(rows[::-1], tile), tile["order"],
                          tile["select"])
    assert sum(r[1] for r in rows) == int(
        ((data["lineorder"]["lo_quantity"] <= 25)
         & (data["lineorder"]["lo_discount"] <= 2)).sum())
