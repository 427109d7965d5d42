"""Column statistics for the metastore (paper §4.1 "Statistics").

Hive stores per-column statistics in HMS so that they can be combined in an
*additive* fashion: inserts and per-partition stats merge onto existing stats
without rescanning.  Range/cardinality merge trivially; the number of distinct
values uses a HyperLogLog++ sketch [Heule et al., EDBT'13], which merges
without losing approximation accuracy.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import math
import struct
from typing import Any, Optional

import numpy as np

__all__ = ["HyperLogLogPP", "ColumnStats", "TableStats", "compute_column_stats"]


def _hash64(value: Any) -> int:
    """Stable 64-bit hash (python hash() is salted per-process)."""
    if isinstance(value, float) and value.is_integer():
        value = int(value)  # 3.0 and 3 hash alike
    data = repr(value).encode("utf-8")
    return struct.unpack("<Q", hashlib.blake2b(data, digest_size=8).digest())[0]


class HyperLogLogPP:
    """HyperLogLog++ distinct-value sketch (dense representation).

    64-bit hashing (no large-range correction needed) with the standard bias
    correction for small cardinalities.  Registers merge by element-wise max,
    which is what makes NDV stats additive across partitions and inserts.
    """

    def __init__(self, p: int = 12, registers: Optional[np.ndarray] = None):
        if not 4 <= p <= 18:
            raise ValueError(f"HLL precision must be in [4,18], got {p}")
        self.p = p
        self.m = 1 << p
        self.registers = (
            registers.astype(np.uint8)
            if registers is not None
            else np.zeros(self.m, dtype=np.uint8)
        )

    # -- construction -------------------------------------------------------
    def add(self, value: Any) -> None:
        h = _hash64(value)
        idx = h & (self.m - 1)
        rest = h >> self.p
        # rank = leading position of first set bit in the remaining 64-p bits
        rank = (64 - self.p) - rest.bit_length() + 1 if rest else (64 - self.p) + 1
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def add_array(self, values: np.ndarray) -> None:
        for v in np.unique(values[: 1 << 20]):  # pre-unique: sketch only needs distinct
            self.add(v.item() if hasattr(v, "item") else v)

    # -- estimation ----------------------------------------------------------
    @property
    def _alpha(self) -> float:
        m = self.m
        if m == 16:
            return 0.673
        if m == 32:
            return 0.697
        if m == 64:
            return 0.709
        return 0.7213 / (1.0 + 1.079 / m)

    def cardinality(self) -> int:
        regs = self.registers.astype(np.float64)
        est = self._alpha * self.m * self.m / np.sum(np.exp2(-regs))
        if est <= 2.5 * self.m:  # small-range (linear counting) correction
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                est = self.m * math.log(self.m / zeros)
        return int(round(est))

    # -- additivity ----------------------------------------------------------
    def merge(self, other: "HyperLogLogPP") -> "HyperLogLogPP":
        if self.p != other.p:
            raise ValueError("cannot merge HLL sketches of different precision")
        return HyperLogLogPP(self.p, np.maximum(self.registers, other.registers))

    # -- persistence (HMS stores the sketch bytes) ---------------------------
    def serialize(self) -> str:
        return f"{self.p}:" + base64.b64encode(self.registers.tobytes()).decode()

    @classmethod
    def deserialize(cls, s: str) -> "HyperLogLogPP":
        p_str, payload = s.split(":", 1)
        regs = np.frombuffer(base64.b64decode(payload), dtype=np.uint8).copy()
        return cls(int(p_str), regs)


@dataclasses.dataclass
class ColumnStats:
    """Additive per-column statistics (paper §4.1)."""

    count: int = 0
    null_count: int = 0
    min_value: Optional[Any] = None
    max_value: Optional[Any] = None
    hll: Optional[HyperLogLogPP] = None

    @property
    def ndv(self) -> int:
        return self.hll.cardinality() if self.hll is not None else 0

    def merge(self, other: "ColumnStats") -> "ColumnStats":
        def _mrg(a, b, fn):
            if a is None:
                return b
            if b is None:
                return a
            return fn(a, b)

        return ColumnStats(
            count=self.count + other.count,
            null_count=self.null_count + other.null_count,
            min_value=_mrg(self.min_value, other.min_value, min),
            max_value=_mrg(self.max_value, other.max_value, max),
            hll=_mrg(self.hll, other.hll, lambda a, b: a.merge(b)),
        )

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "null_count": self.null_count,
            "min": self.min_value,
            "max": self.max_value,
            "hll": self.hll.serialize() if self.hll else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnStats":
        return cls(
            count=d["count"],
            null_count=d["null_count"],
            min_value=d["min"],
            max_value=d["max"],
            hll=HyperLogLogPP.deserialize(d["hll"]) if d.get("hll") else None,
        )


@dataclasses.dataclass
class TableStats:
    row_count: int = 0
    columns: dict = dataclasses.field(default_factory=dict)  # name -> ColumnStats

    def merge(self, other: "TableStats") -> "TableStats":
        cols = dict(self.columns)
        for name, cs in other.columns.items():
            cols[name] = cols[name].merge(cs) if name in cols else cs
        return TableStats(self.row_count + other.row_count, cols)


def compute_column_stats(values: np.ndarray, hll_p: int = 12) -> ColumnStats:
    """Build stats for one column vector (invoked at write time)."""
    n = len(values)
    if values.dtype.kind == "f":
        nulls = int(np.count_nonzero(np.isnan(values)))
        valid = values[~np.isnan(values)]
    elif values.dtype.kind in ("U", "S", "O"):
        mask = values == None  # noqa: E711  (object-array null compare)
        nulls = int(np.count_nonzero(mask))
        valid = values[~mask]
    else:
        nulls, valid = 0, values
    hll = HyperLogLogPP(hll_p)
    hll.add_array(valid)
    mn = mx = None
    if len(valid):
        if valid.dtype.kind in ("U", "S", "O"):
            s = np.sort(valid.astype(str))
            mn, mx = str(s[0]), str(s[-1])
        else:
            mn, mx = valid.min().item(), valid.max().item()
    return ColumnStats(count=n, null_count=nulls, min_value=mn, max_value=mx, hll=hll)
