"""One short run of each cell on the card, through the benchmark's
command; skips without an NVIDIA card."""
import json
import subprocess
import sys

import pytest

import _small
from warehouse_bench.cell import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", _small.WORKLOADS)
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    done = subprocess.run(
        [sys.executable, str(ROOT / "warehouse_bench" / "run.py"),
         "--workload", workload, "--seed", "12345", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=340,
        cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
