"""Public wrapper + host-side bridge for the bloom-probe kernel.

The CUDA kernel is ``csrc/bloom_probe.cu``; it replaces the TPU kernel
``bloom_probe_pallas`` of the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.bloomfilter import BloomFilter, hash_values
from .. import _build
from ..registry import (count_launch, engine_device, host_call, register,
                        register_trip, resolve, trip)
from .ref import bloom_probe_ref

MAX_HASHES = 8  # BloomFilter.for_expected caps k here


def _check(h1_shape, h2_shape, bits_shape, num_bits: int) -> None:
    """The shapes both the wrapper and the trip take."""
    if len(h1_shape) != 1 or h1_shape != h2_shape:
        raise ValueError("h1 and h2 must be 1-D of one length")
    if num_bits < 32 or num_bits > 1 << 32 or num_bits & (num_bits - 1):
        raise ValueError(f"num_bits must be a power of two in [32, 2**32], "
                         f"got {num_bits}")
    if bits_shape != (num_bits // 32,):
        raise ValueError(f"bits must hold num_bits/32 = {num_bits // 32} "
                         f"uint32 words, got shape {bits_shape}")


def _check_kernel(num_hashes: int) -> None:
    if not 1 <= num_hashes <= MAX_HASHES:
        raise ValueError(f"bloom_probe kernel takes 1 to {MAX_HASHES} "
                         f"hashes, got {num_hashes}")


@register("bloom_probe", "cuda")
def bloom_probe_cuda(h1, h2, bits, num_hashes: int, num_bits: int):
    """h1/h2: (N,) uint32 hash halves; bits: (num_bits/32,) uint32 words of
    a power-of-two bitset.  Returns the (N,) bool "might contain" mask.

    CPU tensors and empty inputs take the plain version; CUDA tensors
    launch the kernel."""
    _check(tuple(h1.shape), tuple(h2.shape), tuple(bits.shape), num_bits)
    n = h1.shape[0]
    if not _build.takes_kernel(h1, h2, bits) or n == 0:
        return bloom_probe_ref(h1, h2, bits, num_hashes, num_bits)
    _check_kernel(num_hashes)
    if any(t.dtype != torch.uint32 for t in (h1, h2, bits)):
        raise ValueError("bloom_probe kernel takes uint32 hashes and words")
    h1, h2, bits = (t.contiguous() for t in (h1, h2, bits))
    if bits.data_ptr() % 16:  # the kernel stages it by 16-byte bulk copies
        bits = bits.clone()
    out = torch.empty(n, dtype=torch.bool, device=h1.device)
    err = _build.library().bloom_probe_launch(
        h1.data_ptr(), h2.data_ptr(), bits.data_ptr(), num_bits // 32,
        num_hashes, num_bits - 1, n, out.data_ptr(), _build.stream(out))
    _build.check(err, "bloom_probe")
    count_launch("bloom_probe")
    return out


def bloom_probe_trip(device, h1, h2, bits, num_hashes: int, num_bits: int):
    """The executor's call on the card in one trip (registry.trip): the
    hash halves as numpy uint32, the words as a uint32 tensor on the card
    (a runtime filter's, made once by registry.upload) or a numpy array;
    returns bloom_probe_cuda's mask as a numpy bool array."""
    _check(h1.shape, h2.shape, tuple(bits.shape), num_bits)
    n = h1.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    _check_kernel(num_hashes)
    word = np.uint32 if isinstance(bits, np.ndarray) else torch.uint32
    if h1.dtype != np.uint32 or h2.dtype != np.uint32 or bits.dtype != word:
        raise ValueError("bloom_probe kernel takes uint32 hashes and words")
    (out,) = trip("bloom_probe", device, [h1, h2, bits], [(np.bool_, (n,))],
                  lambda i, o: (i[0], i[1], i[2], num_bits // 32, num_hashes,
                                num_bits - 1, n, o[0]),
                  shape={"n": n, "words": num_bits // 32,
                         "hashes": num_hashes})
    count_launch("bloom_probe")
    return out


register_trip(bloom_probe_cuda, bloom_probe_trip)
register("bloom_probe", "ref", bloom_probe_ref)


def bloom_probe(h1, h2, bits, num_hashes: int, num_bits: int,
                engine: str = "cuda"):
    return resolve("bloom_probe", engine)(h1, h2, bits, num_hashes, num_bits)


def probe_bloom_filter(bf: BloomFilter, values: np.ndarray,
                       engine: str = "cuda",
                       device: Optional[torch.device] = None,
                       bits: Optional[torch.Tensor] = None) -> np.ndarray:
    """Probe a ``core.bloomfilter.BloomFilter`` through the kernel path:
    hash on the host, split each 64-bit hash into its uint32 halves, and
    run the kernel on ``device`` (the engine's device by default) against
    the bitset's uint32 words: ``bits``, the words already on ``device``
    (``registry.upload``, made once per filter), or else a view of
    ``bf.bits`` that goes up with the call; returns a numpy bool mask."""
    h = hash_values(np.asarray(values))
    h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h2 = (h >> np.uint64(32)).astype(np.uint32)
    probe = host_call(resolve("bloom_probe", engine),
                      engine_device(engine) if device is None else device)
    return probe(h1, h2, bf.bits.view(np.uint32) if bits is None else bits,
                 bf.num_hashes, bf.num_bits)
