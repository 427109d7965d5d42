"""Columnar vectorized batches (paper §5 / [39]).

All physical operators in Tahoe exchange `VectorBatch`es: dictionaries of
equal-length column vectors.  This is the in-memory analogue of Hive's
vectorized row-batch representation; LLAP's I/O elevator produces the same
format so that I/O, cache and execution share one layout (paper §5.1).

Hidden ACID columns (`__writeid__`, `__rowid__`) ride along like ordinary
columns; operators that don't know about them simply carry them through.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

WRITEID_COL = "__writeid__"
ROWID_COL = "__rowid__"
ACID_COLS = (WRITEID_COL, ROWID_COL)

# Default number of rows per vectorized batch.  1024 mirrors Hive's
# VectorizedRowBatch; large enough to amortize dispatch, small enough to sit
# in cache/VMEM tiles.
DEFAULT_BATCH_ROWS = 1024


@dataclasses.dataclass
class VectorBatch:
    cols: Dict[str, np.ndarray]

    # -- construction --------------------------------------------------------
    @classmethod
    def empty(cls, schema) -> "VectorBatch":
        """Zero-row batch carrying a schema: either ``(name, dtype)`` pairs
        or a :class:`repro_torch.core.schema.Schema` — so empty results and empty
        spill-replay morsels keep correct column names/dtypes instead of
        collapsing to ``{}``."""
        pairs = schema.to_pairs() if hasattr(schema, "to_pairs") else schema
        return cls({name: np.empty(0, dtype=dtype) for name, dtype in pairs})

    @classmethod
    def concat(cls, batches: Iterable["VectorBatch"],
               context: Optional[str] = None) -> "VectorBatch":
        """Concatenate morsels.  Zero-row schemaless placeholders (``{}``)
        are dropped when schema-carrying batches exist; a genuine column-set
        mismatch raises :class:`~repro_torch.core.schema.SchemaMismatchError`
        naming the offending edge instead of a bare ``KeyError``."""
        batches = [b for b in batches if b is not None]
        if not batches:
            return cls({})
        typed = [b for b in batches if b.cols]
        if not typed:
            return batches[0]
        keys = typed[0].cols.keys()
        for b in typed[1:]:
            if b.cols.keys() != keys:
                from ..schema import SchemaMismatchError

                raise SchemaMismatchError(
                    f"cannot concat batches with mismatched columns: "
                    f"{list(keys)[:12]} vs {list(b.cols)[:12]}", context)
        return cls({k: np.concatenate([b.cols[k] for b in typed])
                    for k in keys})

    # -- basic properties ----------------------------------------------------
    @property
    def num_rows(self) -> int:
        for v in self.cols.values():
            return len(v)
        return 0

    @property
    def column_names(self) -> List[str]:
        return list(self.cols.keys())

    def __len__(self) -> int:
        return self.num_rows

    # -- transforms (all return new batches; columns are immutable) ----------
    def select(self, mask: np.ndarray) -> "VectorBatch":
        return VectorBatch({k: v[mask] for k, v in self.cols.items()})

    def take(self, idx: np.ndarray) -> "VectorBatch":
        return VectorBatch({k: v[idx] for k, v in self.cols.items()})

    def project(self, names: Sequence[str]) -> "VectorBatch":
        return VectorBatch({n: self.cols[n] for n in names})

    def rename(self, mapping: Dict[str, str]) -> "VectorBatch":
        return VectorBatch({mapping.get(k, k): v for k, v in self.cols.items()})

    def with_column(self, name: str, values: np.ndarray) -> "VectorBatch":
        cols = dict(self.cols)
        cols[name] = values
        return VectorBatch(cols)

    def drop(self, names: Sequence[str]) -> "VectorBatch":
        return VectorBatch({k: v for k, v in self.cols.items() if k not in names})

    def drop_acid_cols(self) -> "VectorBatch":
        return self.drop(ACID_COLS)

    def slice(self, start: int, stop: int) -> "VectorBatch":
        return VectorBatch({k: v[start:stop] for k, v in self.cols.items()})

    def iter_chunks(self, rows: int = DEFAULT_BATCH_ROWS):
        n = self.num_rows
        for start in range(0, n, rows):
            yield self.slice(start, min(start + rows, n))

    # -- misc -----------------------------------------------------------------
    def to_rows(self) -> List[tuple]:
        names = self.column_names
        return list(zip(*[self.cols[n].tolist() for n in names])) if names else []

    def sort_by(self, keys: Sequence[str], descending: Sequence[bool]) -> "VectorBatch":
        if not keys or self.num_rows == 0:
            return self
        # lexsort: last key is primary
        order = None
        for key, desc in reversed(list(zip(keys, descending))):
            col = self.cols[key]
            if order is None:
                order = np.argsort(col, kind="stable")
                if desc:
                    order = order[::-1]
            else:
                sub = col[order]
                reorder = np.argsort(sub, kind="stable")
                if desc:
                    reorder = reorder[::-1]
                order = order[reorder]
        return self.take(order)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"VectorBatch({self.num_rows} rows, cols={self.column_names})"


def row_key_array(batch: VectorBatch, keys: Sequence[str]) -> np.ndarray:
    """Stable composite-key encoding used by joins/aggregations.

    Returns an int64 array of group codes (dictionary-encoded composite key).
    """
    if len(keys) == 1:
        col = batch.cols[keys[0]]
        _, codes = np.unique(col, return_inverse=True)
        return codes.astype(np.int64)
    views = [batch.cols[k] for k in keys]
    rec = np.rec.fromarrays(views)
    _, codes = np.unique(rec, return_inverse=True)
    return codes.astype(np.int64)
