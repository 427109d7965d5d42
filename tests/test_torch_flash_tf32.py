"""flash_attention's float32 route on the tensor cores
(csrc/flash_attention_tf32.cu), emulated in plain torch on the CPU.

The kernel runs Q K^T and P V as wgmma TF32 products, each operand split
into hi = rna(x) and lo = rna(x - hi) and each product summed as lo*hi +
hi*lo + hi*hi (``terms=3``; ``terms=1`` multiplies hi by hi alone), with the
online softmax of the other routes over key tiles of 64 (32 at d > 64).
:func:`emulate` repeats that arithmetic, with ``tf32_rna`` and ``product``
from test_torch_ssd_passes.py, and runs P V over the keys in the order the
kernel stores V^T (slot t of an 8-key block holds key 2t, slot t + 4 key
2t + 1), so that P's A fragments are the S accumulator's registers.

It is held to the JAX package's ``flash_attention`` (the Pallas kernel in
interpret mode, its own CPU route) on the float32 sweep and at a reduced
path shape, at the sweep's atol 3e-5: one TF32 term leaves it at every
case, three keep it.  The index tests mirror the kernel's fragment and
shared-memory layouts and check that the two permutations (keys inside an
8-key block, d columns across V^T's rows) are bijections that the kernel
undoes where it must.  The kernel itself runs in test_torch_cuda.py.
"""
import functools
import importlib.util
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda, route
from test_torch_ssd_passes import product

ATOL = 3e-5  # the JAX package's float32 sweep
# the JAX sweep (B, H, S, d) and zamba2-1.2b's path head (d 64) at S 512
SWEEP = [(1, 1, 64, 16), (2, 3, 128, 32), (2, 2, 256, 64), (1, 4, 96, 8)]
PATH = (1, 2, 512, 64)
CASES = [(s, c) for s in SWEEP + [PATH] for c in (True, False)]
# key of each slot of an 8-key block in the kernel's V^T tile
KEY_OF_SLOT = (0, 2, 4, 6, 1, 3, 5, 7)


def key_tile(d: int) -> int:
    """Keys a K/V tile of the kernel: 64 up to d = 64, 32 above."""
    return 64 if d <= 64 else 32


def slot_order(n: int) -> torch.Tensor:
    """The keys of an n-key tile in V^T's slot order."""
    return torch.tensor([8 * (i // 8) + KEY_OF_SLOT[i % 8] for i in range(n)
                         if 8 * (i // 8) + KEY_OF_SLOT[i % 8] < n])


def emulate(q, k, v, causal: bool, terms=3):
    """The kernel's arithmetic on float32 CPU tensors (B, H, S, d)."""
    S, d = q.shape[-2:]
    bn = key_tile(d)
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    rows = torch.arange(S)[:, None]
    for j0 in range(0, S, bn):
        kt, vt = k[:, :, j0:j0 + bn], v[:, :, j0:j0 + bn]
        s = product(q, kt.transpose(-1, -2), terms)
        if causal:
            s = s.masked_fill(torch.arange(j0, j0 + kt.shape[2]) > rows,
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        p = torch.exp2(s * c - m_new)
        alpha = torch.exp2(m - m_new)
        perm = slot_order(kt.shape[2])
        acc = acc * alpha + product(p[..., perm], vt[:, :, perm], terms)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return acc / l.clamp(min=1e-30)


def _inputs(shape):
    rng = np.random.default_rng(shape[2] + shape[3])
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    block = 32 if shape[2] <= 256 else 128
    out = jx_flash(*[jnp.asarray(a) for a in _inputs(shape)], causal=causal,
                   block_q=block, block_k=block)
    return torch.from_numpy(np.array(out, np.float32))


def _error(shape, causal, terms):
    q, k, v = (torch.from_numpy(a) for a in _inputs(shape))
    return float((emulate(q, k, v, causal, terms) -
                  _jax_out(shape, causal)).abs().max())


@pytest.mark.parametrize("shape,causal", CASES)
def test_three_tf32_terms_hold_the_float32_tolerance(shape, causal):
    assert route(torch.float32, shape[3]) == "tf32x3"
    assert _error(shape, causal, 3) <= ATOL


@pytest.mark.parametrize("shape,causal", CASES)
def test_one_tf32_term_breaks_it(shape, causal):
    assert _error(shape, causal, 1) > ATOL


@pytest.mark.parametrize("shape", SWEEP)
def test_emulation_with_float32_products_is_the_plain_version(shape):
    """The emulation's tile loop and key order, with exact float32
    products, give the plain version (which the wrapper returns for CPU
    tensors), so only the TF32 terms set the errors above."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(shape))
    got = flash_attention_cuda(q, k, v, causal=True, block_q=shape[2],
                               block_k=shape[2])
    np.testing.assert_allclose(
        got.numpy(), emulate(q, k, v, True, "float32").numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the kernel's layouts, mirrored: lane (g, t) = (lane / 4, lane % 4)
# ---------------------------------------------------------------------------
def _acc_pos(g, t, i):
    """(row, column) of accumulator register i of a warp's m16 slice."""
    return g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def _a_pos(g, t, r):
    """(row, k slot) of register r of a tf32 m16 x k8 A fragment."""
    return g + 8 * (r & 1), t + 4 * (r >> 1)


@pytest.mark.parametrize("bn", [32, 64])
def test_p_fragments_are_s_registers_renamed(bn):
    """softmax() in the kernel takes s[4j], s[4j + 2], s[4j + 1], s[4j + 3]
    as P's A fragment of k step j; each must be P at the key that V^T's
    slot holds."""
    pick = (0, 2, 1, 3)
    for g in range(8):
        for t in range(4):
            for j in range(bn // 8):
                for r in range(4):
                    row, col = _acc_pos(g, t, 4 * j + pick[r])
                    arow, slot = _a_pos(g, t, r)
                    assert (row, col) == (arow, 8 * j + KEY_OF_SLOT[slot])


def _swz(rows, r, c):
    """swz<ROWS>(r, c): byte offset of 16-byte chunk c of row r."""
    return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4)


@pytest.mark.parametrize("dp,bn", [(32, 64), (64, 64), (128, 32)])
def test_vt_tile_layout(dp, bn):
    """Share::store: thread (g, par, c) writes, for d column 4c + j, the
    keys 8g + par + {0, 2, 4, 6} into one 16-byte chunk of V^T's row
    32 (c / 8) + 8 j + c % 8.  Every (row, slot) is written once, with the
    key the slot order names; the epilogue's column map inverts the row
    map; and the eight lanes of a quarter warp store to distinct 16-byte
    bank groups (for K's tile too)."""
    chunks = dp // 4
    units = bn // 8 * 2 * chunks
    seen = {}
    for tid in range(units):
        c, par, g = tid % chunks, (tid // chunks) & 1, tid // (2 * chunks)
        for j in range(4):
            rho = 32 * (c >> 3) + 8 * j + (c & 7)
            for i in range(4):
                slot = 4 * (2 * g + par) + i
                assert (rho, slot) not in seen
                seen[rho, slot] = (4 * c + j, 8 * g + par + 2 * i)
    assert len(seen) == dp * bn
    for (rho, slot), (col, key) in seen.items():
        assert key == 8 * (slot // 8) + KEY_OF_SLOT[slot % 8]
        # the epilogue: accumulator column rho holds d column col
        assert 32 * (rho >> 5) + 4 * (rho & 7) + ((rho >> 3) & 3) == col
    for warp in range(units // 32):
        for quarter in range(4):
            lanes = [32 * warp + 8 * quarter + x for x in range(8)]
            for j in range(4):
                banks = {(_swz(dp, 32 * ((t % chunks) >> 3) + 8 * j +
                               (t % chunks & 7),
                               2 * (t // (2 * chunks)) +
                               ((t // chunks) & 1)) % 128) // 16
                         for t in lanes}
                assert len(banks) == 8
            for i in range(4):
                banks = {(_swz(bn, 8 * (t // (2 * chunks)) +
                               ((t // chunks) & 1) + 2 * i,
                               t % chunks) % 128) // 16 for t in lanes}
                assert len(banks) == 8


@pytest.mark.parametrize("d", [8, 16, 24, 64, 72, 120, 128])
def test_tf32x3_takes_float32_multiples_of_8_up_to_128(d):
    assert route(torch.float32, d) == "tf32x3"
    assert route(torch.bfloat16, d) == ("wgmma" if d % 16 == 0 else "simt")


def test_chip_smoke_bound_counts_the_kernels_terms():
    """chip_smoke.py's 3xTF32 bound takes the kernel's terms: each k step
    of issue_qk and of issue_pv issues that many wgmma products."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(
            repo, "src/repro_torch/csrc/flash_attention_tf32.cu")) as f:
        src = f.read()
    for fn, op in (("issue_qk", "wgmma_ss"), ("issue_pv", "wgmma_rs")):
        body = src.split(f"void {fn}(", 1)[1].split("\n}\n", 1)[0]
        assert len(re.findall(rf"\b{op}<", body)) == smoke.TF32_TERMS == 3
