"""The panel LU kernel's decomposition (superlu_dist_tpu_torch/csrc/
panel_lu.cu), written out in PyTorch here and run on the CPU, against the
plain column loop (``ops.dense._panel_columns`` with the plain version,
``numeric.kernels.panel_lu_plain``) bit for bit: signed zeros, infinities
and NaNs included (NaNs compared as NaNs).

The decomposition is the kernel's: the pa steps run in chunks of
``kernels.PANEL_CHUNK``; for each chunk launch 1 runs its steps on its
pivot rows only and keeps a snapshot of each step (pivot row j as it
stands at the step, the raw and the fixed pivot); launch 2 replays the
chunk's steps on every other row — rows above j0 and the other chunks'
pivot rows too — from that snapshot.  The elementwise arithmetic is the
kernel's: each operation rounded on its own, complex values by parts.
Cases: the four dtypes, pb 16, 48, 112 and 128, pa < pb, a strided column
share of a wider front batch, a root panel with no other rows, batch 147,
tiny pivots replaced (a zero one and a complex one that keeps its phase),
a zero pivot without replacement (infinities and NaNs), and panels seeded
with -0.0.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); here its launch path refuses a CPU tensor and
a non-unit column stride.
"""

import numpy as np
import pytest
import torch

from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.ops.dense import _panel_columns

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]

#: (batch, rows m, columns of the batch, pb, first panel column k0, j0, pa)
SHAPES = {
    "pb16": (3, 40, 16, 16, 0, 0, 16),
    "pb16_rows_above": (2, 48, 32, 16, 16, 16, 9),
    "pb128": (2, 150, 128, 128, 0, 0, 128),
    "pb128_rows_above": (1, 300, 256, 128, 128, 128, 100),
    "column_share": (2, 64, 48, 16, 16, 32, 16),
    # the main path's own widths and the chunks' edges
    "pb48_pa40": (3, 96, 48, 48, 0, 0, 40),
    "pb112_rows_above": (1, 280, 224, 112, 112, 112, 104),
    "root": (2, 64, 64, 64, 0, 0, 64),          # m == pa: no other rows
    "batch147": (147, 24, 16, 16, 0, 0, 8),     # more fronts than SMs
}
KINDS = ("random", "tiny", "zero_pivot", "negzero")


def _panel(kind, dtype, shape, seed=0):
    """A seeded front batch (numpy), its panel view, j0, pa and thresh."""
    b, m, k, pb, k0, j0, pa = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, k))
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal((b, m, k))
    if kind == "negzero":
        # a sparse panel: zeros of both signs, negative entries beside
        x[rng.random(x.shape) < 0.6] = 0.0
        x[(x == 0) & (rng.random(x.shape) < 0.5)] = -0.0
    r = np.arange(pa)
    x[:, j0 + r, k0 + r] += 2.0 * np.sqrt(m)          # dominant pivots
    thresh = 1e-3
    if kind == "tiny":
        # pivot 1: a zero row and column (replaced by +thresh); pivot 5
        # (where pa allows): a tiny complex / negative one (phase kept)
        for jj, piv in ((1, 0.0), (5, -1e-6 * (0.6 - 0.8j)
                                   if dtype.is_complex else -1e-6)):
            if jj < pa:
                x[0, j0 + jj, :] = 0.0
                x[0, :, k0 + jj] = 0.0
                x[0, j0 + jj, k0 + jj] = piv
    if kind == "zero_pivot":
        thresh = 0.0                                 # replace_tiny=False
        x[0, j0, k0] = 0.0                           # step 0: exactly 0
    a = torch.as_tensor(x).to(dtype)
    real = a.real.dtype if dtype.is_complex else dtype
    return a, (k0, pb), j0, pa, torch.tensor(thresh, dtype=real)


def _parts(t):
    if t.dtype.is_complex:
        r = torch.view_as_real(t)
        return (r[..., 0], r[..., 1])
    return (t,)


def _div(a, c):
    if len(a) == 1:
        return (a[0] / c[0],)
    return kernels._cdiv_parts(a[0], a[1], c[0], c[1])


def _fix(raw, thresh):
    if len(raw) == 1:
        piv, tiny = kernels._fix_pivot(raw[0], thresh)
        return (piv,), tiny
    pr, pi, tiny = kernels._fix_pivot_parts(raw[0], raw[1], thresh)
    return (pr, pi), tiny


def _msub(a, l, u):
    """a - l·u, the product by parts for a complex value."""
    if len(a) == 1:
        return (a[0] - l[0] * u[0],)
    pr = l[0] * u[0] - l[1] * u[1]
    pi = l[0] * u[1] + l[1] * u[0]
    return (a[0] - pr, a[1] - pi)


def _wb(x, piv, raw, e):
    """x + (piv - raw)·e by parts, e real."""
    return tuple(xc + (pc - rc) * e for xc, pc, rc in zip(x, piv, raw))


def _col(x):
    return tuple(c[:, None] for c in x)


def _step(vals, rows, j, jj, u, raw, piv, zero, cols):
    """One step on rows ``rows`` (front row numbers) of ``vals`` (parts of
    (B, R, pb)), from the snapshot (u, raw, piv) of step jj; returns the
    new parts."""
    col = tuple(v[:, :, jj].clone() for v in vals)
    below = rows > j
    l = tuple(torch.where(below, c, zero) for c in _div(col, _col(piv)))
    um = tuple(torch.where(cols > jj, c, zero) for c in u)
    new = _msub(vals, tuple(c[:, :, None] for c in l),
                tuple(c[:, None, :] for c in um))
    e = (rows == j).to(zero.dtype)
    x = tuple(torch.where(below, lc, cc) for lc, cc in zip(l, col))
    for n, w in zip(new, _wb(x, _col(piv), _col(raw), e)):
        n[:, :, jj] = w
    return new


def two_launches(panel, j0, pa, thresh, flags, snapshot=True,
                 chunk=kernels.PANEL_CHUNK):
    """The kernel's launches in PyTorch, in place on ``panel``: per chunk
    of ``chunk`` steps, launch 1 on the chunk's pivot rows, then launch 2
    on every other row.  ``snapshot=False`` lets launch 2 read the pivot
    rows as launch 1 left them instead (the control that shows the
    snapshot is needed)."""
    b, m, pb = panel.shape
    parts = _parts(panel)
    zero = torch.zeros((), dtype=parts[0].dtype)
    cols = torch.arange(pb)
    for s0 in range(0, pa, chunk):
        kc = min(chunk, pa - s0)
        jc = j0 + s0
        # launch 1: the chunk's pivot rows, a snapshot of every step
        prow = torch.arange(jc, jc + kc)
        snap = []
        for jj in range(s0, s0 + kc):
            j = j0 + jj
            u = tuple(p[:, j, :].clone() for p in parts)
            raw = tuple(c[:, jj] for c in u)
            piv, tiny = _fix(raw, thresh)
            snap.append((jj, u, raw, piv))
            new = _step(tuple(p[:, jc:jc + kc, :] for p in parts), prow, j,
                        jj, u, raw, piv, zero, cols)
            for p, n in zip(parts, new):
                p[:, jc:jc + kc, :] = n
            flags[:, j] += tiny
        if not snapshot:
            snap = [(jj, tuple(p[:, j0 + jj, :].clone() for p in parts), raw,
                     piv) for jj, _, raw, piv in snap]
        # launch 2: every other row, each replaying the chunk's steps
        other = torch.cat([torch.arange(0, jc), torch.arange(jc + kc, m)])
        vals = tuple(p[:, other, :].clone() for p in parts)
        for jj, u, raw, piv in snap:
            vals = _step(vals, other, j0 + jj, jj, u, raw, piv, zero, cols)
        for p, v in zip(parts, vals):
            p[:, other, :] = v
    return panel


def same_bits(x, y) -> bool:
    """Equal bit for bit (signed zeros, infinities), NaNs as NaNs."""
    xs, ys = (torch.view_as_real(t) if t.is_complex() else t
              for t in (x, y))
    nx, ny = torch.isnan(xs), torch.isnan(ys)
    if xs.shape != ys.shape or not torch.equal(nx, ny):
        return False
    ib = {torch.float32: torch.int32, torch.float64: torch.int64}[xs.dtype]
    return torch.equal(torch.where(nx, 0, xs).contiguous().view(ib),
                       torch.where(ny, 0, ys).contiguous().view(ib))


def _run(fn, a, cols, j0, pa, thresh, **kw):
    a = a.clone()
    k0, pb = cols
    flags = torch.zeros((a.shape[0], j0 + pa + 3), dtype=torch.int32)
    fn(a[:, :, k0:k0 + pb], j0, pa, thresh, flags, **kw)
    return a, flags


def _plain(panel, j0, pa, thresh, flags):
    _panel_columns(panel, j0, pa, thresh, flags, kernels.panel_lu_plain)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_two_launches_equal_the_column_loop(dtype, shape, kind):
    a, cols, j0, pa, thresh = _panel(kind, dtype, SHAPES[shape])
    want, want_flags = _run(_plain, a, cols, j0, pa, thresh)
    got, got_flags = _run(two_launches, a, cols, j0, pa, thresh)
    assert same_bits(got, want)
    assert torch.equal(got_flags, want_flags)
    finite = bool(torch.isfinite(torch.view_as_real(want) if dtype.is_complex
                                 else want).all())
    assert finite == (kind != "zero_pivot")
    if kind == "tiny":
        assert int(want_flags[0].sum()) == (2 if pa > 5 else 1)
    # the default dispatch on a CPU panel is the plain loop
    dflt, dflt_flags = _run(_panel_columns, a, cols, j0, pa, thresh)
    assert same_bits(dflt, want) and torch.equal(dflt_flags, want_flags)


@pytest.mark.parametrize("chunk", [1, 5, 48])
def test_chunks_of_any_size_equal_the_column_loop(chunk):
    """The chunking of the steps does not change the bits: a chunk's
    later rows (the next chunks' pivot rows) take its steps in launch 2,
    its earlier ones (the last chunks' pivot rows) too."""
    a, cols, j0, pa, thresh = _panel("negzero", torch.complex64,
                                     SHAPES["pb112_rows_above"], seed=3)
    want, want_flags = _run(_plain, a, cols, j0, pa, thresh)
    got, got_flags = _run(two_launches, a, cols, j0, pa, thresh,
                          chunk=chunk)
    assert same_bits(got, want) and torch.equal(got_flags, want_flags)


def test_launch_2_needs_the_snapshot():
    """The masked later steps change pivot row j (-0.0 becomes +0.0
    where a later u is negative), so rows replayed from the pivot rows as
    launch 1 leaves them differ from the column loop (seed 2 makes such
    a zero meet a surviving -0.0 in a replayed row)."""
    a, cols, j0, pa, thresh = _panel("negzero", torch.float32,
                                     SHAPES["pb16_rows_above"], seed=2)
    want, _ = _run(_plain, a, cols, j0, pa, thresh)
    assert same_bits(_run(two_launches, a, cols, j0, pa, thresh)[0], want)
    assert not same_bits(_run(two_launches, a, cols, j0, pa, thresh,
                              snapshot=False)[0], want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_masked_terms_flip_zero_signs(dtype):
    """The -0.0 case is live: the loop's masked terms (a - 0·u with u <
    0) turn zeros seeded as -0.0 into +0.0, which a kernel that skipped
    them would leave as they were, and same_bits tells the two apart."""
    a, cols, j0, pa, thresh = _panel("negzero", dtype, SHAPES["pb16"])
    want, _ = _run(_plain, a, cols, j0, pa, thresh)
    x, y = ((torch.view_as_real(t) if dtype.is_complex else t)
            for t in (a, want))
    flipped = (x == 0) & torch.signbit(x) & (y == 0) & ~torch.signbit(y)
    assert bool(flipped.any())
    assert not same_bits(torch.where(flipped, x, y), y)


def test_the_launch_path_refuses_cpu_tensors_and_strided_columns():
    """``panel_launch_`` never falls back to the plain loop: a CPU panel
    raises, and so does a panel whose columns are not unit-stride."""
    a = torch.randn(2, 20, 20)
    flags = torch.zeros((2, 16), dtype=torch.int32)
    thresh = torch.tensor(1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.panel_launch_(a[:, :, :16], 0, 16, thresh, flags)
    with pytest.raises(ValueError, match="unit stride"):
        kernels.panel_launch_(a.transpose(1, 2)[:, :, :16], 0, 16, thresh,
                              flags)
    kernels.reset_launches()
    kernels.panel_lu_(a[:, :, :16], 0, 16, thresh, flags)
    assert kernels.LAUNCHES["panel_lu"] == 0


@pytest.mark.parametrize("bad", ["pa", "flags", "thresh", "devices"])
def test_the_wrapper_rejects_what_neither_version_takes(bad):
    a = torch.randn(2, 20, 16)
    flags = torch.zeros((2, 16), dtype=torch.int64 if bad == "flags"
                        else torch.int32)
    thresh = torch.tensor(1e-3 + 0j if bad == "thresh" else 1e-3)
    with pytest.raises((TypeError, ValueError)):
        if bad == "devices":
            kernels.panel_lu_(a, 0, 16, thresh.to("meta"), flags)
        else:
            kernels.panel_lu_(a, 0, 17 if bad == "pa" else 16, thresh,
                              flags)
