"""The check has to fail what is wrong.  The control (the reference in
float32 in the program's place) comes out not correct on every cell; and
whole runs with the program broken underneath the timed path come out not
correct: an answer altered where it is produced, half the rows of every
scan left out, a query answered with the previous query's rows (the state
left unchanged).  A cell on one card has no exchange between chips."""
import numpy as np
import pytest

import _small
from warehouse_bench import cell, check, control

SEEDS = (11, 2**31 + 3, 4_000_000_123)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", _small.WORKLOADS)
def test_control_is_not_correct(workload, seed):
    spec = cell.cell_spec(_small.bench(), workload)
    numbers = control.control(spec, seed, 40,
                              dict(_small.SIZES, lineorder=100000))
    correct, compared = check.verdict(numbers, spec["config"]["limits"])
    assert not correct, compared
    assert numbers["max_rel_gap"] > 10 * spec["config"]["limits"][
        "max_rel_gap"]


def _altered(monkeypatch):
    from repro_torch.core.runtime import exec as ex

    plain = ex._agg_column

    def altered(spec, vals, codes, ng):
        out = plain(spec, vals, codes, ng)
        if spec.fn == "sum" and len(out):
            out = out.copy()
            out[0] = out[0] + 1 if out.dtype.kind in "iu" else \
                out[0] * (1 + 1e-6)
        return out

    monkeypatch.setattr(ex, "_agg_column", altered)


def _half_rows(monkeypatch):
    from repro_torch.core.runtime import exec as ex

    plain = ex.Executor._stream_scan

    def half(self, node):
        for i, batch in enumerate(plain(self, node)):
            if i % 2 == 0:
                yield batch

    monkeypatch.setattr(ex.Executor, "_stream_scan", half)


def _unchanged(monkeypatch):
    from repro_torch.api import cursor

    plain = cursor.Cursor.fetchall
    last = []

    def stale(self):
        rows = plain(self)
        if last:
            rows, last[0] = last[0], rows
        else:
            last.append(rows)
        return rows

    monkeypatch.setattr(cursor.Cursor, "fetchall", stale)


FAULTS = {"answer altered": _altered, "half the rows": _half_rows,
          "state unchanged": _unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", _small.WORKLOADS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _small.run(workload, 77, "auto",
                     sizes=dict(_small.SIZES, lineorder=20000))
    assert not out["correct"], out["compared"]


def test_gap_and_nulls():
    spec = {"select": ["k", {"agg": "sum", "expr": "v"},
                       {"agg": "count", "expr": "v"}],
            "order": [["k", "asc"]]}
    ref = [(1, 100.0, 3), (2, None, 0)]
    assert check.compare([(1, 100.0, 3), (2, np.nan, 0)], ref, spec) == \
        (True, 0.0)
    right, gap = check.compare([(1, 100.0 + 1e-7, 3), (2, None, 0)], ref,
                               spec)
    assert right and gap == pytest.approx(1e-9)
    assert not check.compare([(1, 100.0, 4), (2, None, 0)], ref, spec)[0]
    assert not check.compare([(2, None, 0), (1, 100.0, 3)], ref, spec)[0]
    assert not check.compare([(1, 100.0, 3), (2, 5.0, 0)], ref, spec)[0]
    assert not check.compare([(1, 100.0, 3)], ref, spec)[0]
    assert not check.compare([(1, 100.0, 3), (1, 100.0, 3)], ref, spec)[0]
    assert not check.compare([(1, 100.0), (2, None)], ref, spec)[0]
