"""Bloom filters for index semijoins and ORC-style stripe skipping (paper §4.6).

The numpy implementation here is the *reference* / host-side path; the
device probe (``bloom_probe``) is not ported to CUDA yet (ROADMAP B6), so
under a kernel engine a runtime bloom filter raises instead of probing.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np

# Two independent 64-bit mixers -> k hashes via double hashing (Kirsch-Mitzenmacher).
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= _M1
        x ^= x >> np.uint64(33)
        x *= _M2
        x ^= x >> np.uint64(33)
    return x


def hash_values(values: np.ndarray) -> np.ndarray:
    """Hash arbitrary column values to uint64 (strings via FNV-1a per char block)."""
    if values.dtype.kind in ("U", "S", "O"):
        out = np.empty(len(values), dtype=np.uint64)
        for i, v in enumerate(values):
            h = np.uint64(14695981039346656037)
            for ch in str(v).encode("utf-8"):
                with np.errstate(over="ignore"):
                    h = np.uint64((int(h) ^ ch) * 1099511628211 & 0xFFFFFFFFFFFFFFFF)
            out[i] = h
        return _mix64(out)
    if values.dtype.kind == "f":
        values = values.astype(np.float64).view(np.uint64)
    return _mix64(values.astype(np.uint64))


class BloomFilter:
    """Standard k-hash bloom filter over a power-of-two bitset."""

    def __init__(self, num_bits: int, num_hashes: int, bits: np.ndarray | None = None):
        num_bits = 1 << int(math.ceil(math.log2(max(num_bits, 64))))
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.bits = bits if bits is not None else np.zeros(num_bits // 64, dtype=np.uint64)

    @classmethod
    def for_expected(cls, n: int, fpp: float = 0.02) -> "BloomFilter":
        n = max(n, 1)
        num_bits = int(-n * math.log(fpp) / (math.log(2) ** 2))
        k = max(1, round(num_bits / n * math.log(2)))
        return cls(num_bits, min(k, 8))

    def _positions(self, values: np.ndarray) -> np.ndarray:
        h = hash_values(np.asarray(values))
        h1 = h & np.uint64(0xFFFFFFFF)
        h2 = h >> np.uint64(32)
        ks = np.arange(self.num_hashes, dtype=np.uint64)[:, None]
        with np.errstate(over="ignore"):
            pos = (h1[None, :] + ks * h2[None, :]) & np.uint64(self.num_bits - 1)
        return pos  # (k, n)

    def add(self, values: Iterable) -> None:
        pos = self._positions(np.asarray(list(values) if not isinstance(values, np.ndarray) else values))
        word, bit = pos >> np.uint64(6), pos & np.uint64(63)
        np.bitwise_or.at(self.bits, word.ravel(), np.uint64(1) << bit.ravel())

    def might_contain(self, values: np.ndarray) -> np.ndarray:
        pos = self._positions(values)
        word, bit = pos >> np.uint64(6), pos & np.uint64(63)
        hits = (self.bits[word] >> bit) & np.uint64(1)
        return np.all(hits.astype(bool), axis=0)

    # persistence (stored in stripe footers / shipped to scan operators)
    def to_dict(self) -> dict:
        import base64

        return {
            "num_bits": self.num_bits,
            "num_hashes": self.num_hashes,
            "bits": base64.b64encode(self.bits.tobytes()).decode(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BloomFilter":
        import base64

        bits = np.frombuffer(base64.b64decode(d["bits"]), dtype=np.uint64).copy()
        return cls(d["num_bits"], d["num_hashes"], bits)
