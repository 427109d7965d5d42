"""ORC-like columnar stripe files (paper §2 "Data storage", §5.1 I/O elevator).

Each data file is a zip of column arrays organized in *stripes* (row groups)
plus a JSON footer with per-stripe, per-column min/max statistics and optional
bloom filters.  This gives the scan path the two structures the paper's I/O
elevator pushes down: sargable predicates (min/max seek) and bloom filters
(paper §4.6, §5.1).

Files are immutable once written (HDFS/object-store semantics).  Every file
carries a content-derived ``file_id`` which plays the role of the HDFS unique
file id / S3 ETag that LLAP uses for cache validity (paper §5.1).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bloomfilter import BloomFilter
from .runtime.vector import VectorBatch

DEFAULT_STRIPE_ROWS = 8192
_META_KEY = "_tahoe_meta.json"


@dataclass
class StripeMeta:
    rows: int
    # col -> {"min": x, "max": x} (present when the column is orderable)
    ranges: Dict[str, dict] = field(default_factory=dict)
    blooms: Dict[str, dict] = field(default_factory=dict)  # col -> BloomFilter dict


@dataclass
class FileMeta:
    file_id: str
    num_rows: int
    columns: List[str]
    dtypes: Dict[str, str]
    stripes: List[StripeMeta]
    writeid: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "file_id": self.file_id,
                "num_rows": self.num_rows,
                "columns": self.columns,
                "dtypes": self.dtypes,
                "writeid": self.writeid,
                "stripes": [
                    {"rows": s.rows, "ranges": s.ranges, "blooms": s.blooms}
                    for s in self.stripes
                ],
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "FileMeta":
        d = json.loads(s)
        return cls(
            file_id=d["file_id"],
            num_rows=d["num_rows"],
            columns=d["columns"],
            dtypes=d["dtypes"],
            writeid=d.get("writeid", 0),
            stripes=[
                StripeMeta(x["rows"], x.get("ranges", {}), x.get("blooms", {}))
                for x in d["stripes"]
            ],
        )


def _col_range(values: np.ndarray) -> Optional[dict]:
    if len(values) == 0:
        return None
    if values.dtype.kind in ("i", "u", "f"):
        if values.dtype.kind == "f":
            valid = values[~np.isnan(values)]
            if len(valid) == 0:
                return None
            return {"min": float(valid.min()), "max": float(valid.max())}
        return {"min": int(values.min()), "max": int(values.max())}
    if values.dtype.kind in ("U", "S"):
        s = np.sort(values)  # np.min lacks a unicode ufunc loop
        return {"min": str(s[0]), "max": str(s[-1])}
    return None


def write_stripe_file(
    path: str,
    batch: VectorBatch,
    *,
    writeid: int = 0,
    stripe_rows: int = DEFAULT_STRIPE_ROWS,
    bloom_columns: Sequence[str] = (),
) -> FileMeta:
    """Write a batch as an immutable stripe file; returns its metadata."""
    columns = batch.column_names
    n = batch.num_rows
    stripes: List[StripeMeta] = []
    hasher = hashlib.blake2b(digest_size=10)

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for si, start in enumerate(range(0, max(n, 1), stripe_rows)):
            chunk = batch.slice(start, min(start + stripe_rows, n))
            if chunk.num_rows == 0 and n > 0:
                break
            meta = StripeMeta(rows=chunk.num_rows)
            for col in columns:
                values = chunk.cols[col]
                arr_buf = io.BytesIO()
                np.save(arr_buf, values, allow_pickle=False)
                payload = arr_buf.getvalue()
                hasher.update(payload)
                zf.writestr(f"s{si}/{col}.npy", payload)
                rng = _col_range(values)
                if rng is not None:
                    meta.ranges[col] = rng
                if col in bloom_columns and len(values):
                    bf = BloomFilter.for_expected(len(values))
                    bf.add(values)
                    meta.blooms[col] = bf.to_dict()
            stripes.append(meta)
            if n == 0:
                break
        fmeta = FileMeta(
            file_id=hasher.hexdigest(),
            num_rows=n,
            columns=columns,
            dtypes={c: str(batch.cols[c].dtype) for c in columns},
            stripes=stripes,
            writeid=writeid,
        )
        zf.writestr(_META_KEY, fmeta.to_json())

    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic publish, mimicking HDFS rename semantics
    return fmeta


def read_file_meta(path: str) -> FileMeta:
    """Footer-only read — this is what LLAP's bulk metadata cache loads."""
    with zipfile.ZipFile(path) as zf:
        return FileMeta.from_json(zf.read(_META_KEY).decode())


def read_stripe_column(path: str, stripe: int, column: str) -> np.ndarray:
    with zipfile.ZipFile(path) as zf:
        with zf.open(f"s{stripe}/{column}.npy") as f:
            return np.load(io.BytesIO(f.read()), allow_pickle=False)


# --------------------------------------------------------------------------
# Sargable predicates: (column, op, literal) triples the I/O elevator can use
# against stripe min/max ranges and bloom filters to skip row groups.
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SargPredicate:
    column: str
    op: str  # one of <, <=, >, >=, =, in
    value: object


def stripe_may_match(meta: StripeMeta, preds: Sequence[SargPredicate]) -> bool:
    for p in preds:
        rng = meta.ranges.get(p.column)
        if rng is not None:
            lo, hi = rng["min"], rng["max"]
            if p.op == "=" and not (lo <= p.value <= hi):
                return False
            if p.op == "<" and not (lo < p.value):
                return False
            if p.op == "<=" and not (lo <= p.value):
                return False
            if p.op == ">" and not (hi > p.value):
                return False
            if p.op == ">=" and not (hi >= p.value):
                return False
            if p.op == "in" and not any(lo <= v <= hi for v in p.value):
                return False
        bloom_d = meta.blooms.get(p.column)
        if bloom_d is not None and p.op == "=":
            bf = BloomFilter.from_dict(bloom_d)
            if not bool(bf.might_contain(np.asarray([p.value]))[0]):
                return False
    return True
