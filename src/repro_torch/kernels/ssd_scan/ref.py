"""Plain torch version of the SSD chunk scan (the oracle)."""
from __future__ import annotations

from ...models.mamba2 import ssd_reference


def ssd_scan_ref(x, dA, Bm, Cm, chunk: int):
    y, _final = ssd_reference(x, dA, Bm, Cm, chunk)
    return y
