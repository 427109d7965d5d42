"""The port's LM kernels (ssd_scan, flash_attention) against the JAX
package's.

The same numpy inputs, made from a seed, go through the JAX entry point
(the Pallas kernel in interpret mode on the CPU, as the JAX package's own
tests run it) and its plain version, and through the port's plain torch
version and wrapper; on the CPU the wrapper takes the plain version because
its tensors lie there.  The CUDA kernels are tested in test_torch_cuda.py.

Tolerances: ssd_scan atol 5e-5 and rtol 1e-3, the JAX sweep's own (float32
sums in another order); flash_attention atol 3e-5 in float32 and 3e-2 in
bfloat16 (the output's rounding), as there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jx_flash
from repro.kernels.flash_attention.ref import attention_ref as jx_attention_ref
from repro.kernels.ssd_scan.ops import ssd_scan as jx_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jx_ssd_scan_ref
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.mamba2 import ssd_decode_step, ssd_reference
from test_torch_cuda import FLASH_SHAPES, SSD_CASES, ssd_inputs

SSD_TOL = dict(atol=5e-5, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cfg", SSD_CASES)
def test_ssd_scan_matches_jax(cfg):
    B, S, H, P, N, Q = cfg
    arrs = ssd_inputs(B, S, H, P, N)
    port = ssd_scan_ref(*map(_t, arrs), chunk=Q).numpy()
    wrap, none = ssd_scan_cuda(*map(_t, arrs), chunk=Q)
    assert none is None and np.array_equal(wrap.numpy(), port)
    jx, _ = jx_ssd_scan(*map(jnp.asarray, arrs), chunk=Q)  # Pallas, interpret
    np.testing.assert_allclose(port, np.asarray(jx), **SSD_TOL)
    jref = jx_ssd_scan_ref(*map(jnp.asarray, arrs), chunk=Q)
    np.testing.assert_allclose(port, np.asarray(jref), **SSD_TOL)


def test_ssd_scan_chunk_invariance():
    """Same result whatever the chunking: the invariant behind SSD."""
    arrs = [_t(a) for a in ssd_inputs(1, 64, 2, 8, 4, seed=0)]
    y8, _ = ssd_scan(*arrs, chunk=8, engine="ref")
    y32, _ = ssd_scan(*arrs, chunk=32, engine="cuda")  # CPU: plain version
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), atol=5e-5)


def test_ssd_reference_equals_the_recurrence_under_strong_decay():
    """The chunked scan equals the token-by-token recurrence of decode,
    also at mamba2-130m's decays (dA near -6 a step, cum near -1500 in a
    chunk of 256), where a factored exp(cum_i) * exp(-cum_j) overflows.
    The scan computes in float32, the recurrence in float64."""
    x, dA, Bm, Cm = map(_t, ssd_inputs(1, 512, 2, 4, 8, seed=3, decay=6.0))
    y, final = ssd_reference(x, dA, Bm, Cm, chunk=256)
    assert torch.isfinite(y).all()
    state = torch.zeros(1, 2, 4, 8, dtype=torch.float64)
    ys = []
    for t in range(512):
        yt, state = ssd_decode_step(state, x[:, t].double(),
                                    dA[:, t].double(), Bm[:, t].double(),
                                    Cm[:, t].double())
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(final.numpy(), state.numpy(), **SSD_TOL)


def test_ssd_scan_wrapper_checks():
    x, dA, Bm, Cm = map(_t, ssd_inputs(1, 48, 2, 8, 4))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_cuda(x, dA, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan_cuda(x, dA[:, :, :1], Bm, Cm, chunk=16)
    y, _ = ssd_scan_cuda(x[:, :0], dA[:, :0], Bm[:, :0], Cm[:, :0])
    assert y.shape == (1, 0, 2, 8) and y.dtype == torch.float32


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(shape, dtype):
    rng = np.random.default_rng(shape[2])
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    tdt = getattr(torch, dtype)
    port = attention_ref(*[_t(a).to(tdt) for a in arrs])
    bq = 32 if shape[2] % 32 == 0 else shape[2]
    wrap = flash_attention_cuda(*[_t(a).to(tdt) for a in arrs], block_q=bq,
                                block_k=bq)
    assert port.dtype == tdt and torch.equal(wrap, port)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    jx = jx_flash(*jargs, block_q=bq, block_k=bq)  # Pallas, interpret
    atol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jx, np.float32), atol=atol)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jx_attention_ref(*jargs), np.float32),
                               atol=atol)


def test_flash_attention_full_matches_jax():
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=(2, 3, 64, 16)).astype(np.float32)
            for _ in range(3)]
    port = flash_attention(*map(_t, arrs), causal=False, engine="ref")
    jx = jx_flash(*map(jnp.asarray, arrs), causal=False, block_q=32,
                  block_k=32)
    np.testing.assert_allclose(port.numpy(), np.asarray(jx), atol=3e-5)


def test_flash_attention_blocks_must_divide():
    q = torch.zeros(1, 1, 96, 8)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_cuda(q, q, q.double())


def test_lm_kernels_on_cpu_never_launch():
    before = registry.launch_counts()
    ssd_scan_cuda(*map(_t, ssd_inputs(1, 32, 2, 8, 4)), chunk=8)
    q = torch.zeros(1, 1, 64, 16)
    flash_attention_cuda(q, q, q)
    assert registry.launch_counts() == before
