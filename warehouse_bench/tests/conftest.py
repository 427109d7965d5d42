"""The benchmark's own tests: ``python -m pytest -q warehouse_bench/tests``
from the repository's root (CPU; tests marked ``card`` skip without an
NVIDIA card and run on one)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU of compute capability >= 9.0")
