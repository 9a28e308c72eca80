"""The port's host I/O and small utilities on the CPU, held against the
JAX package on the same inputs: every matrix reader (the inline texts of
tests/test_io.py, plus small Harwell-Boeing and Rutherford-Boeing texts)
gives CSC arrays equal to the JAX reader's; writes and reads round-trip
across the two packages; the distributed-input format (DistributedCSR,
distribute_rows, gather_rows) and gssvx_dist; the precision utilities
(get_diag_u against the JAX package's on the same plan); the two gallery
generators this slice adds."""

import numpy as np
import pytest
import torch

from superlu_dist_tpu.io import readers as jrd
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel import dist as jdist
from superlu_dist_tpu.utils import precision as jprec
import superlu_dist_tpu as jslu

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.io import readers as rd
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.parallel import dist
from superlu_dist_tpu_torch.utils import precision, tols
from superlu_dist_tpu_torch.utils.errors import SuperLUError

MM_TEXT = """%%MatrixMarket matrix coordinate real general
% comment
3 3 5
1 1 2.0
2 2 3.0
3 3 4.0
1 3 -1.0
3 1 -1.5
"""

MM_SYM = """%%MatrixMarket matrix coordinate real symmetric
2 2 3
1 1 2.0
2 1 -1.0
2 2 2.0
"""

MM_COMPLEX_HERM = """%%MatrixMarket matrix coordinate complex hermitian
2 2 3
1 1 2.0 0.0
2 1 -1.0 0.5
2 2 2.0 0.0
"""

MM_PATTERN = """%%MatrixMarket matrix coordinate pattern general
3 3 4
1 1
2 3
3 2
3 3
"""

TRIPLES = """3 4
1 1 1.0
2 2 2.0
3 3 3.0
1 3 -1.0
"""

TRIPLES_NOHEADER_0 = """0 0 1.0
1 1 2.0
2 0 -0.5
2 2 3.0
"""


def _hb(mxtype, colptr, rowind, vals, rutherford=False):
    """A fixed-format Harwell-Boeing (or Rutherford-Boeing) text."""
    per = 3
    vlines = [vals[i:i + per] for i in range(0, len(vals), per)]
    card2 = f"{1:14d}{1:14d}{1:14d}{len(vlines):14d}"
    if not rutherford:
        card2 += f"{0:14d}"
    n = len(colptr) - 1
    lines = [f"{'a small test matrix':<72}{'KEY':<8}", card2,
             f"{mxtype:<14}{n:14d}{n:14d}{len(rowind):14d}{0:14d}",
             f"{'(8I5)':<16}{'(8I5)':<16}{'(3E20.12)':<20}",
             "".join(f"{c + 1:5d}" for c in colptr),
             "".join(f"{r + 1:5d}" for r in rowind)]
    lines += ["".join(f"{v:20.12E}" for v in chunk) for chunk in vlines]
    return "\n".join(lines) + "\n"


HB_RUA = _hb("RUA", [0, 2, 3, 5], [0, 2, 1, 0, 2], [2.0, -1.5, 3.0, -1.0,
                                                     4.0])
HB_RSA = _hb("RSA", [0, 2, 3], [0, 1, 1], [2.0, -1.0, 2.0])
HB_CUA = _hb("CUA", [0, 1, 3], [0, 0, 1], [2.0, 1.0, -1.0, 0.5, 3.0, -2.0])
HB_PUA = _hb("PUA", [0, 1, 2], [1, 0], [])
RB_RUA = _hb("rua", [0, 2, 3, 5], [0, 2, 1, 0, 2],
             [2.0, -1.5, 3.0, -1.0, 4.0], rutherford=True)


def _same_csc(ours, theirs):
    assert ours.shape == theirs.shape
    for name in ("indptr", "indices", "data"):
        got, want = (np.asarray(getattr(x, name)) for x in (ours, theirs))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("reader,text", [
    ("read_matrix_market", MM_TEXT),
    ("read_matrix_market", MM_SYM),
    ("read_matrix_market", MM_COMPLEX_HERM),
    ("read_matrix_market", MM_PATTERN),
    ("read_triples", TRIPLES),
    ("read_harwell_boeing", HB_RUA),
    ("read_harwell_boeing", HB_RSA),
    ("read_harwell_boeing", HB_CUA),
    ("read_harwell_boeing", HB_PUA),
    ("read_rutherford_boeing", RB_RUA),
])
def test_readers_match_jax(reader, text):
    _same_csc(getattr(rd, reader)(text), getattr(jrd, reader)(text))


def test_matrix_market_general_values():
    a = rd.read_matrix_market(MM_TEXT)
    want = np.array([[2.0, 0, -1.0], [0, 3.0, 0], [-1.5, 0, 4.0]])
    np.testing.assert_array_equal(a.to_dense(), want)
    np.testing.assert_array_equal(rd.read_harwell_boeing(HB_RUA).to_dense(),
                                  want)


@pytest.mark.parametrize("kw", [dict(header=False),
                                dict(header=False, zero_based=True),
                                dict(header=False, dtype=np.complex128)])
def test_triples_without_header_match_jax(kw):
    _same_csc(rd.read_triples(TRIPLES_NOHEADER_0, **kw),
              jrd.read_triples(TRIPLES_NOHEADER_0, **kw))


def test_malformed_inputs_raise():
    with pytest.raises(SuperLUError):
        rd.read_matrix_market("%%NotMatrixMarket\n1 1 1\n1 1 1.0\n")
    with pytest.raises(SuperLUError):
        rd.read_matrix_market("%%MatrixMarket matrix array real general\n")
    with pytest.raises(SuperLUError):
        rd.read_matrix("m.unknown")


@pytest.mark.parametrize("suffix,writer", [(".mtx", "write_matrix_market"),
                                           (".bin", "write_binary")])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_write_read_round_trips_across_packages(tmp_path, suffix, writer,
                                                dtype):
    """The port writes, both read; the JAX package writes, the port reads:
    the same CSC arrays each way."""
    a = gallery.random_sparse(40, density=0.1, seed=8, dtype=dtype)
    ours, theirs = tmp_path / f"p{suffix}", tmp_path / f"j{suffix}"
    getattr(rd, writer)(ours, a)
    getattr(jrd, writer)(theirs, jgal.random_sparse(40, density=0.1, seed=8,
                                                    dtype=dtype))
    assert ours.read_bytes() == theirs.read_bytes()
    got = rd.read_matrix(theirs)
    _same_csc(got, jrd.read_matrix(ours))
    np.testing.assert_array_equal(got.to_dense(), a.to_dense())


@pytest.mark.parametrize("suffix,text", [(".rua", HB_RUA), (".rb", RB_RUA),
                                         (".mtx", MM_TEXT),
                                         (".triple", TRIPLES)])
def test_read_matrix_dispatches_on_the_suffix(tmp_path, suffix, text):
    p = tmp_path / f"m{suffix}"
    p.write_text(text)
    _same_csc(rd.read_matrix(p), jrd.read_matrix(p))
    assert slt.read_matrix is rd.read_matrix


# ---------------------------------------------------------------------------
# distributed input, gssvx_ABglobal / gssvx_dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [1, 3, 7])
def test_distribute_and_gather_rows_match_jax(nparts):
    a = gallery.convection_diffusion_2d(9)
    ja = jgal.convection_diffusion_2d(9)
    parts, jparts = dist.distribute_rows(a, nparts), jdist.distribute_rows(
        ja, nparts)
    assert len(parts) == len(jparts) == nparts
    rng = np.random.default_rng(2)
    x = rng.standard_normal(a.n_rows)
    xs = rng.standard_normal((a.n_rows, 3))
    for p, q in zip(parts, jparts):
        assert (p.n, p.m_loc, p.fst_row, p.nnz_loc) == (q.n, q.m_loc,
                                                        q.fst_row, q.nnz_loc)
        for name in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(p, name), getattr(q, name))
        np.testing.assert_array_equal(p.matvec_local(x), q.matvec_local(x))
        np.testing.assert_array_equal(p.matvec_local(xs), q.matvec_local(xs))
        np.testing.assert_array_equal(p.abs_matvec_local(x),
                                      q.abs_matvec_local(x))
        np.testing.assert_array_equal(p.matvec_trans_local(x, conj=True),
                                      q.matvec_trans_local(x, conj=True))
        np.testing.assert_array_equal(p.abs_matvec_trans_local(x),
                                      q.abs_matvec_trans_local(x))
    g = dist.gather_rows(parts[::-1])
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(g, name), getattr(a, name))
    np.testing.assert_allclose(sum(p.matvec_trans_local(x) for p in parts),
                               a.transpose().matvec(x), rtol=1e-13)


def test_gssvx_dist_and_abglobal_solve_as_gssvx():
    a = gallery.poisson3d(6)
    b = a.matvec(np.random.default_rng(4).standard_normal(a.n_rows))
    x, lu, _, info = slt.gssvx(slt.Options(), a, b, device="cpu")
    xd, _, st, infod = slt.gssvx_dist(slt.Options(),
                                      dist.distribute_rows(a, 4), b,
                                      device="cpu")
    xg, _, _, infog = slt.gssvx_ABglobal(slt.Options(), a, b, device="cpu")
    assert info == infod == infog == 0
    np.testing.assert_array_equal(xd, x)
    np.testing.assert_array_equal(xg, x)
    xj, _, _, _ = jslu.gssvx_dist(jslu.Options(), jdist.distribute_rows(
        jgal.poisson3d(6), 4), b)
    np.testing.assert_allclose(xd, xj, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    assert st.solve_report.berr <= tols.berr_target(np.float64)


# ---------------------------------------------------------------------------
# precision utilities and the gallery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nrhs,dtype", [(1, np.float64), (3, np.complex128)])
def test_xtrue_rhs_and_error_match_jax(nrhs, dtype):
    a = gallery.poisson2d(7)
    x = precision.gen_xtrue(a.n_rows, nrhs, dtype, seed=3)
    assert np.array_equal(x, jprec.gen_xtrue(a.n_rows, nrhs, dtype, seed=3))
    for trans in (False, True):
        np.testing.assert_array_equal(
            precision.fill_rhs(a, x, trans=trans),
            jprec.fill_rhs(jgal.poisson2d(7), x, trans=trans))
    y = x * (1 + 1e-9)
    assert precision.inf_norm_error(y, x) == jprec.inf_norm_error(y, x)


def test_diag_u_matches_jax():
    """The U diagonal gathered from the port's torch fronts against the
    JAX package's get_diag_u on the same plan (float64)."""
    a = gallery.poisson3d(6)
    b = a.matvec(np.ones(a.n_rows))
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    _, jlu, _, _ = jslu.gssvx(jslu.Options(), jgal.poisson3d(6), b)
    d = precision.get_diag_u(lu.numeric)
    assert d.dtype == np.float64 and d.shape == (a.n_rows,)
    np.testing.assert_allclose(d, jprec.get_diag_u(jlu.numeric),
                               rtol=tols.SCHEDULE_DRIFT_RTOL,
                               atol=tols.SCHEDULE_DRIFT_ATOL)
    f32 = slt.gssvx(slt.Options(factor_dtype="float32"), a, b,
                    device="cpu")[1]
    assert precision.get_diag_u(f32.numeric).dtype == np.float32
    assert torch.isfinite(torch.as_tensor(d)).all()


@pytest.mark.parametrize("name,args", [
    ("anisotropic_poisson_2d", (9,)),
    ("anisotropic_poisson_2d", (6, 1e-2)),
    ("random_geometric_3d", (300,)),
    ("random_geometric_3d", (120, 6, 4)),
])
def test_gallery_generators_match_jax(name, args):
    a, ja = getattr(gallery, name)(*args), getattr(jgal, name)(*args)
    for attr in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, attr), getattr(ja, attr)), attr
    assert getattr(a, "grid_shape", None) == getattr(ja, "grid_shape", None)
    x, _, _, info = slt.gssvx(slt.Options(), a, a.matvec(np.ones(a.n_rows)),
                              device="cpu")
    assert info == 0 and np.allclose(x, 1.0, atol=1e-8)
