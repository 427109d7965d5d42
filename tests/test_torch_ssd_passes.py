"""The ssd_scan kernel's four passes (csrc/ssd_scan.cu), emulated in plain
torch on the CPU in the kernel's order and at its products' precision.

The emulation runs chunk states -> state passing -> C B^T once per (b,
chunk) -> chunk scan, with the kernel's scratch layouts, and a switch for
the products: ``"float32"``, or TF32 terms as the tensor cores take them
(``cvt.rna.tf32.f32`` emulated on the float32 bits: round half away from
zero to 10 mantissa bits).  One term multiplies hi(a) hi(b); three add
lo(a) hi(b) + hi(a) lo(b) first, with lo = rna(a - hi).  Each TF32 product
is exact in float32 and the sums are float32, as in the tensor cores.

It is held to the JAX package's scan (the Pallas kernel in interpret mode)
and plain version on the sweep, and to the port's ``ssd_reference`` at the
path's head width and on a mamba2-130m block's own scan inputs, at the
tolerances chip_smoke.py holds the kernel to: SSD_TOL (the JAX sweep's) and
SSD_MODEL_TOL (1e-3 of the layer's largest |y|).  One TF32 term breaks
SSD_TOL on the sweep and at path width; three hold it with room to spare,
so the kernel takes three (``mma_split`` in csrc/lm_common.cuh), and
chip_smoke.py counts the bound of its products from three.

The card tests (test_torch_cuda.py) launch each pass on its own and compare
it with :func:`emulate_passes`'s intermediate; they import this module, so
JAX is imported only inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

from repro_torch.models.mamba2 import (init_mamba2, mamba2_scan_inputs,
                                       ssd_reference)
from test_torch_cuda import SSD_CASES, ssd_inputs

SSD_TOL = dict(atol=5e-5, rtol=1e-3)
SSD_MODEL_TOL = {"atol_of_max": 1e-3, "rtol": 1e-3}
KERNEL_TERMS = 3  # TF32 products of each product in csrc/ssd_scan.cu
# the path's heads (mamba2-130m: P 64, N 128, chunk 256), a few of them
PATH_WIDTH = (1, 1024, 3, 64, 128, 256)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to the nearest value with 10 mantissa bits,
    ties away from zero (the float32 bits' magnitude plus half a step,
    then the low 13 bits cleared)."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def product(a, b, terms="float32"):
    """a @ b in float32, or from ``terms`` (1 or 3) TF32 terms."""
    if terms == "float32":
        return a @ b
    ah, bh = tf32_rna(a), tf32_rna(b)
    if terms == 1:
        return ah @ bh
    assert terms == 3, terms
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate_passes(x, dA, Bm, Cm, chunk, terms=KERNEL_TERMS) -> dict:
    """The kernel's passes on float32 CPU tensors; returns its buffers:
    cum (B, H, S), states (B, nc, H, P, N; each chunk's own), prev (the same
    shape; the state entering each chunk, which pass 2 writes over states),
    cb (B, nc, Q, Q) and y (B, S, H, P)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = s // q
    xc = x.float().reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)  # b c h q p
    A = dA.float().reshape(b, nc, q, h).permute(0, 3, 1, 2)  # b h c q
    Bc = Bm.float().reshape(b, nc, q, n)
    Cc = Cm.float().reshape(b, nc, q, n)
    # 1. cum; each chunk's own state sum_j (x_j w_j)^T B_j
    cum = torch.cumsum(A, dim=-1)
    w = torch.exp(cum[..., -1:] - cum).permute(0, 2, 1, 3)  # b c h q
    states = product((xc * w[..., None]).transpose(-1, -2), Bc[:, :, None],
                     terms)
    # 2. state passing, in the plain version's order
    state = torch.zeros(b, h, p, n)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] + \
            states[:, c]
    prev = torch.stack(prev, dim=1)
    # 3. C B^T once per (b, c)
    cb = product(Cc, Bc.transpose(-1, -2), terms)
    # 4. y_i = exp(cum_i) C_i prev^T + sum_{j<=i} cb_ij exp(cum_i - cum_j) x_j
    cum_c = cum.permute(0, 2, 1, 3)  # b c h q
    y = product(Cc[:, :, None], prev.transpose(-1, -2), terms) * \
        torch.exp(cum_c)[..., None]
    diff = cum_c[..., :, None] - cum_c[..., None, :]
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    y = y + product(cb[:, :, None] * L, xc, terms)
    return {"cum": cum.reshape(b, h, s), "states": states, "prev": prev,
            "cb": cb, "y": y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p)}


def causal_tiles(q: int, tile: int = 64) -> torch.Tensor:
    """(q, q) mask of the 64 x 64 tiles (it, jt <= it) that pass 3 writes."""
    t = torch.arange(q) // tile
    return t[:, None] >= t[None, :]


def reference_states(x, dA, Bm, Cm, chunk):
    """ssd_reference's own chunk states and the states entering each chunk:
    its final state over one chunk alone, and over the chunks before."""
    b, s, h, p = x.shape
    q = min(chunk, s)
    own, prev = [], [torch.zeros(b, h, p, Bm.shape[-1])]
    for c in range(s // q):
        rows = slice(c * q, (c + 1) * q)
        own.append(ssd_reference(x[:, rows], dA[:, rows], Bm[:, rows],
                                 Cm[:, rows], q)[1])
        if c:
            upto = slice(0, c * q)
            prev.append(ssd_reference(x[:, upto], dA[:, upto], Bm[:, upto],
                                      Cm[:, upto], q)[1])
    return torch.stack(own, 1), torch.stack(prev, 1)


def model_scan_inputs(seq=512, seed=0):
    """A mamba2-130m block's scan inputs at full width (24 heads of 64,
    d_state 128) from random weights: the model's small |y| (largest about
    2e-3) and its decays."""
    from repro_torch.configs.base import get_config

    cfg = get_config("mamba2-130m")
    gen = torch.Generator().manual_seed(seed)
    block = init_mamba2(cfg, gen, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(seed)
    h = _t(rng.normal(size=(1, seq, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, _, xs, dA, Bm, Cm = mamba2_scan_inputs(block, h.bfloat16(), cfg)
    return [t.float().contiguous() for t in (xs, dA, Bm, Cm)], cfg.ssm.chunk


def _close_model(got, exp):
    return torch.allclose(got, exp, rtol=SSD_MODEL_TOL["rtol"],
                          atol=SSD_MODEL_TOL["atol_of_max"] *
                          float(exp.abs().max()))


@pytest.mark.parametrize("terms", ["float32", KERNEL_TERMS])
@pytest.mark.parametrize("cfg", SSD_CASES)
def test_passes_match_jax(cfg, terms):
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.ops import ssd_scan as jx_ssd_scan
    from repro.kernels.ssd_scan.ref import ssd_scan_ref as jx_ssd_scan_ref

    B, S, H, P, N, Q = cfg
    arrs = ssd_inputs(B, S, H, P, N)
    y = emulate_passes(*map(_t, arrs), Q, terms)["y"].numpy()
    jx, _ = jx_ssd_scan(*map(jnp.asarray, arrs), chunk=Q)  # Pallas, interpret
    np.testing.assert_allclose(y, np.asarray(jx), **SSD_TOL)
    jref = jx_ssd_scan_ref(*map(jnp.asarray, arrs), chunk=Q)
    np.testing.assert_allclose(y, np.asarray(jref), **SSD_TOL)


@pytest.mark.parametrize("terms", ["float32", KERNEL_TERMS])
@pytest.mark.parametrize("decay", [0.2, 6.0])
def test_passes_at_path_width(decay, terms):
    """mamba2-130m's heads; decay 6 puts cum near -1500 within a chunk."""
    B, S, H, P, N, Q = PATH_WIDTH
    arrs = list(map(_t, ssd_inputs(B, S, H, P, N, seed=7, decay=decay)))
    y = emulate_passes(*arrs, Q, terms)["y"]
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ssd_reference(*arrs, Q)[0], **SSD_TOL)


@pytest.mark.parametrize("terms", ["float32", KERNEL_TERMS])
def test_passes_on_model_inputs(terms):
    arrs, q = model_scan_inputs()
    exp = ssd_reference(*arrs, q)[0]
    got = emulate_passes(*arrs, q, terms)["y"]
    assert 1e-5 < float(exp.abs().max()) < 1e-1
    assert _close_model(got, exp), float((got - exp).abs().max())


@pytest.mark.parametrize("cfg,decay", [((2, 96, 2, 8, 8, 48), 0.2),
                                       ((1, 768, 2, 64, 128, 256), 6.0)])
def test_pass_intermediates_equal_the_reference(cfg, decay):
    """Pass 1's chunk states and pass 2's entering states are
    ssd_reference's own (its final state over one chunk, and over the
    chunks before each); cum is the chunk's cumulative sum; cb is C B^T."""
    B, S, H, P, N, Q = cfg
    x, dA, Bm, Cm = map(_t, ssd_inputs(B, S, H, P, N, seed=3, decay=decay))
    emu = emulate_passes(x, dA, Bm, Cm, Q)
    own, prev = reference_states(x, dA, Bm, Cm, Q)
    torch.testing.assert_close(emu["states"], own, **SSD_TOL)
    torch.testing.assert_close(emu["prev"], prev, **SSD_TOL)
    nc = S // Q
    cum = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)
    torch.testing.assert_close(emu["cum"],
                               cum.permute(0, 3, 1, 2).reshape(B, H, S))
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    torch.testing.assert_close(emu["cb"], Cc @ Bc.transpose(-1, -2),
                               **SSD_TOL)


@pytest.mark.parametrize("where", ["sweep", "path"])
def test_one_tf32_term_breaks_the_tolerance(where):
    """Why the kernel takes three terms: with one, the scan leaves SSD_TOL
    on three of the four sweep cases and at path width (largest errors
    about 2e-4 and 7e-4 against |y| up to 0.5 and 1.6); with three it
    stays within it (checked above)."""
    cases = ([(c, 0.2) for c in SSD_CASES[1:]] if where == "sweep" else
             [(PATH_WIDTH, 0.2), (PATH_WIDTH, 6.0)])
    for (B, S, H, P, N, Q), decay in cases:
        arrs = list(map(_t, ssd_inputs(B, S, H, P, N, seed=None if
                                       where == "sweep" else 7, decay=decay)))
        exp = ssd_reference(*arrs, Q)[0]
        one = emulate_passes(*arrs, Q, terms=1)["y"]
        three = emulate_passes(*arrs, Q, terms=3)["y"]
        assert not torch.allclose(one, exp, **SSD_TOL), (B, S, H, P, N, Q)
        assert torch.allclose(three, exp, **SSD_TOL), (B, S, H, P, N, Q)
        # three terms sit three orders of magnitude closer
        assert (three - exp).abs().max() * 100 < (one - exp).abs().max()


def test_tf32_rounding():
    """rna keeps 10 mantissa bits and rounds ties away from zero; hi + lo
    holds 21 of float32's 24 bits."""
    a = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      1.0 + 3 * 2 ** -11, 0.0, -0.0, 3.0e-38])
    got = tf32_rna(a)
    exp = torch.tensor([1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                        1.0 + 2 ** -9, 0.0, -0.0, tf32_rna(a[-1:])[0]])
    assert torch.equal(got, exp)
    v = _t(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tf32_rna(v)
    lo = tf32_rna(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) < 2 ** -20
    assert float(((hi - v).abs() / v.abs()).max()) <= 2 ** -11


def test_causal_tiles():
    m = causal_tiles(256)
    assert m[63, 63] and m[64, 0] and m[64, 127] and not m[63, 64]
    assert int(m.sum()) == 10 * 64 * 64  # T (T + 1) / 2 tiles, T = 4


def test_scratch_and_pass_checks():
    """The wrapper's scratch at the prefill's shape, and launch_pass's
    checks (CPU tensors never reach the kernel)."""
    from repro_torch.kernels.ssd_scan.ops import (PASSES, buffers,
                                                  launch_pass, scratch_bytes,
                                                  scratch_shapes)

    shapes = scratch_shapes(2, 32768, 24, 64, 128, 256)
    assert shapes["states"] == (2, 128, 24, 64, 128)
    assert shapes["cb"] == (2, 128, 256, 256)
    assert scratch_bytes(2, 32768, 24, 64, 128, 256) == \
        (192 + 64 + 6) * 2 ** 20
    x, dA, Bm, Cm = map(_t, ssd_inputs(1, 96, 2, 8, 8))
    bufs = buffers(x, Bm, 48)
    assert {k: tuple(v.shape) for k, v in bufs.items()} == \
        scratch_shapes(1, 96, 2, 8, 8, 48)
    assert all(v.dtype == torch.float32 for v in bufs.values())
    with pytest.raises(ValueError, match="no ssd_scan pass"):
        launch_pass("scan", x, dA, Bm, Cm, bufs, 48)
    for name in PASSES:
        with pytest.raises(ValueError, match="CUDA"):
            launch_pass(name, x, dA, Bm, Cm, bufs, 48)


def test_chip_smoke_bound_counts_the_kernels_terms():
    """chip_smoke.py's bound of ssd_scan's split takes the kernel's terms,
    and the kernel's mma_split issues that many tensor-core products."""
    import importlib.util
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TF32_TERMS == KERNEL_TERMS
    # the split products live in lm_common.cuh, shared with flash_attention
    with open(os.path.join(repo, "src/repro_torch/csrc/lm_common.cuh")) as f:
        src = f.read()
    body = src.split("void mma_split(", 1)[1].split("\n}\n", 1)[0]
    assert len(re.findall(r"\bmma\(d,", body)) == KERNEL_TERMS
