"""``BENCHMARK.json`` against the benchmark's static rules:
names and units, keys of each entry, lengths, which cells report which
metric, files under ``paths``, and a reader for every metric."""
import json
import re

import pytest

from warehouse_bench.cell import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(line(w)
                                               for w in BENCH["command"])
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               for p in BENCH["paths"])
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check of 24 cells fits its time
    assert 2 * 24 * 90 + (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        for k in ("why", "source", "layer"):
            if k in e:
                assert line(e[k])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        if "bound" in e:
            assert 0.01 <= e["bound"] <= 0.25


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(
        m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_a_reader(metric):
    from warehouse_bench.cell import reader

    assert callable(reader(metric))
    if metric.split(".")[0].endswith("_roofline"):
        assert next(m for m in METRICS if m["name"] == metric)["unit"] == "%"
