"""How the port's wrappers pick a kernel, and the plain versions they are held
to, against the JAX package's.

- ``flash_attention``: :func:`route` sends bfloat16 with d a multiple of 16
  up to 128 to the bfloat16 tensor-core kernel (``wgmma``), float32 with d
  a multiple of 8 up to 128 to the TF32 one (``tf32x3``, emulated in
  test_torch_flash_tf32.py) and everything else to the CUDA-core kernel
  (``simt``).  The bfloat16 tensor-core kernel carries P as two
  bfloat16 terms; an emulation of its tile loop here shows why one term
  would not do.
- ``hash_group_minmax``: :func:`minmax_path` sends up to ``ONE_BLOCK_ROWS``
  rows in at most ``SMEM_MAX_GROUPS`` groups to the one-launch path.

The same numpy inputs, made from a seed, go through the JAX package (the
Pallas kernel in interpret mode and the plain version) and the port's plain
version.  Tolerances: attention in bfloat16 at 3e-2 and in float32 at 3e-5,
the JAX sweep's; MIN/MAX exact (values; -0.0 and +0.0 compare equal, as the
scatter folds them in no fixed order).  The kernels themselves run in
test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_attention_ref
from repro.kernels.hash_group.ops import hash_group_minmax as jx_minmax
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda, route
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hash_group.ops import (ONE_BLOCK_ROWS,
                                                SMEM_MAX_GROUPS,
                                                hash_group_minmax_cuda,
                                                minmax_path)
from repro_torch.kernels.hash_group.ref import hash_group_minmax_ref

# the card's bfloat16 tolerance for the kernels against the plain version
# (chip_smoke.py FLASH_TOL): one bfloat16 step of the output beside float32
# noise
FLASH_TOL = {"atol": 1e-4, "rtol": 2 ** -7}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_route(dtype, d):
    if dtype == torch.bfloat16 and d in (16, 32, 64, 128):
        want = "wgmma"
    elif dtype == torch.float32 and d <= 128:
        want = "tf32x3"
    else:
        want = "simt"
    assert route(dtype, d) == want


def test_flash_route_needs_multiples_of_16():
    """bfloat16 takes the tensor cores at multiples of 16, float32 at
    multiples of 8, each up to 128."""
    assert [route(torch.bfloat16, d) for d in (24, 48, 80, 96, 112, 120)] == \
        ["simt", "wgmma", "wgmma", "wgmma", "wgmma", "simt"]
    assert [route(torch.float32, d) for d in (4, 12, 24, 40, 120, 136)] == \
        ["simt", "simt", "tf32x3", "tf32x3", "tf32x3", "simt"]


@pytest.mark.parametrize("shape", [(1, 2, 128, 128), (2, 2, 96, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax(shape, dtype, causal):
    """The plain version at the tensor-core route's widest head and at a
    ragged length (96 is no multiple of its 64- or 128-row tiles)."""
    rng = np.random.default_rng(shape[2] + shape[3])
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    tdt = getattr(torch, dtype)
    port = attention_ref(*[_t(a).to(tdt) for a in arrs], causal=causal)
    wrap = flash_attention_cuda(*[_t(a).to(tdt) for a in arrs], causal=causal,
                                block_q=32, block_k=32)
    assert port.dtype == tdt and torch.equal(wrap, port)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    atol = 3e-5 if dtype == "float32" else 3e-2
    for jx in (jx_flash(*jargs, causal=causal, block_q=32, block_k=32),
               jx_attention_ref(*jargs, causal=causal)):
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(jx, np.float32), atol=atol)


def _emulate_tiles(q, k, v, causal, split, bn=64):
    """The tensor-core kernel's arithmetic on the CPU: key tiles of ``bn``,
    running max in the log2 domain, p = 2^(s c - m) summed in float32, P V
    from P rounded to bfloat16 (``split``: plus the rounding's remainder,
    rounded again), out rounded once."""
    S, d = q.shape[-2:]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    rows = torch.arange(S)[:, None]
    for j0 in range(0, S, bn):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j0:j0 + bn])
        if causal:
            s = s.masked_fill(torch.arange(j0, min(j0 + bn, S)) > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        p = torch.exp2(s * c - m_new)
        alpha = torch.exp2(m - m_new)
        hi = p.bfloat16().float()
        pv = hi if not split else hi + (p - hi).bfloat16().float()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", pv,
                                         vf[:, :, j0:j0 + bn])
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp(min=1e-30)).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_p_in_two_bf16_terms_keeps_the_tolerance(causal):
    """With P rounded once to bfloat16 the tiled result leaves FLASH_TOL
    against the plain version; carried as hi + lo it stays inside."""
    rng = np.random.default_rng(11)
    q, k, v = (_t(rng.normal(size=(2, 2, 256, 64)).astype(np.float32))
               .bfloat16() for _ in range(3))
    exp = attention_ref(q, k, v, causal=causal).float()
    lim = FLASH_TOL["atol"] + FLASH_TOL["rtol"] * exp.abs()
    one = (_emulate_tiles(q, k, v, causal, split=False).float() - exp).abs()
    two = (_emulate_tiles(q, k, v, causal, split=True).float() - exp).abs()
    assert int((one > lim).sum()) > 0
    assert int((two > lim).sum()) == 0


# ---------------------------------------------------------------------------
# hash_group_minmax
# ---------------------------------------------------------------------------
def test_minmax_path_limits():
    assert minmax_path(1, 7) == "one_block"
    assert minmax_path(1024, 7) == "one_block"
    assert minmax_path(ONE_BLOCK_ROWS, SMEM_MAX_GROUPS) == "one_block"
    assert minmax_path(ONE_BLOCK_ROWS + 1, 7) == "multi_block"
    assert minmax_path(1024, SMEM_MAX_GROUPS + 1) == "multi_block"
    # the private copy of the order keys fills 48 KB of shared memory
    assert 2 * 4 * SMEM_MAX_GROUPS == 48 * 1024


def _minmax_inputs(n, g, kind, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, g, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32) * 100
    if kind == "masked":
        codes[:] = -1
    elif kind == "specials":
        for v in (-0.0, 0.0, np.inf, -np.inf):
            vals[rng.integers(0, n, max(1, n // 16))] = v
    return codes, vals


@pytest.mark.parametrize("n", [1, 1023, 1024, ONE_BLOCK_ROWS,
                               ONE_BLOCK_ROWS + 1])
@pytest.mark.parametrize("kind", ["random", "masked", "specials"])
def test_minmax_ref_matches_jax_around_the_limit(n, kind):
    g = 7
    codes, vals = _minmax_inputs(n, g, kind, seed=n)
    mins, maxs = (x.numpy() for x in hash_group_minmax_ref(_t(codes),
                                                           _t(vals), g))
    wm, wx = (x.numpy() for x in hash_group_minmax_cuda(_t(codes), _t(vals),
                                                        g))
    assert np.array_equal(wm, mins) and np.array_equal(wx, maxs)
    if kind == "masked":
        assert np.all(mins == np.inf) and np.all(maxs == -np.inf)
    for eng in ("pallas", "ref"):
        jm, jx = jx_minmax(codes, vals, g, engine=eng)
        assert np.array_equal(mins, np.asarray(jm)), eng
        assert np.array_equal(maxs, np.asarray(jx)), eng
