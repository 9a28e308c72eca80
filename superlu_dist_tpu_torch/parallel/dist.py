"""The refinement residual's SpMV on the card: ``DeviceSpMV``.

Port of ``DeviceSpMV`` from the JAX package's ``parallel/dist.py`` (the
pdgsmv analog, SRC/pdgsmv.c:234): y = A·x with the pattern and values
resident on the device, so iterative refinement's residual runs next to
the factors instead of on the host.  The upload (pattern, values and
|values|) happens once and is amortized over every refinement step and
repeated solve (the pdgsmv_init / SOLVEstruct discipline,
SRC/pdgsmv.c:31).  Beside it, the distributed-input format of that
module: ``DistributedCSR`` (NRformat_loc) with ``distribute_rows`` and
``gather_rows``, the input path of ``drivers/gssvx.gssvx_dist``, and
``ShardedSpMV``, the mesh tier's residual operator (parallel/grid.py):
each rank's block of rows through ``csr_spmv``, y gathered over the grid.

The product is ``csr_spmv``: on a CUDA tensor the hand-written kernel
``csrc/csr_spmv.cu`` (one thread per output element, CSR order, every
multiply and add rounded on its own), on a CPU tensor its plain PyTorch
twin ``csr_spmv_plain``, which performs the same operations in the same
order, vectorised over rows: the two are equal bit for bit.  There is no
fallback between them: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils.options import resolve_device

#: the kernel's instantiations (csrc/csr_spmv.cu), by dtype
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}
_fns = {}


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(kernels.library(), f"slu_csr_spmv_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(indptr, indices, vals, x):
    for t in (indptr, indices):
        if t.dim() != 1 or t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError("indptr and indices must be contiguous 1-D int64")
    if vals.dim() != 1 or vals.shape != indices.shape:
        raise ValueError("vals must be 1-D, one value per index")
    if x.dim() != 2 or vals.dtype != x.dtype or x.dtype not in _SUFFIX:
        raise TypeError(f"x must be 2-D and share vals' dtype, one of "
                        f"{sorted(map(str, _SUFFIX))}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("vals and x must be contiguous")
    devs = {t.device for t in (indptr, indices, vals, x)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devs))}")


def csr_spmv_plain(indptr, indices, vals, x, max_row=None):
    """Plain PyTorch y = A·x for a CSR matrix and a dense (n_cols, k)
    block, in the kernel's order: entry e = 0 … max_row − 1 of every row
    at once, each product and add rounded on its own, rows without an
    e-th entry left as they are; a complex product as
    (ar·xr − ai·xi, ar·xi + ai·xr)."""
    n_rows = indptr.shape[0] - 1
    start, end = indptr[:-1], indptr[1:]
    if max_row is None:
        max_row = int((end - start).max()) if n_rows else 0
    cplx = x.dtype.is_complex
    real = x.real.dtype if cplx else x.dtype
    shape = (n_rows, x.shape[1])
    acc = [torch.zeros(shape, dtype=real, device=x.device)
           for _ in range(2 if cplx else 1)]
    for e in range(max_row):
        idx = start + e
        valid = (idx < end)[:, None]
        idx = torch.where(idx < end, idx, 0)
        col = indices[idx]
        if cplx:
            ar, ai = vals.real[idx][:, None], vals.imag[idx][:, None]
            xr, xi = x.real[col], x.imag[col]
            terms = (ar * xr - ai * xi, ar * xi + ai * xr)
        else:
            terms = (vals[idx][:, None] * x[col],)
        acc = [torch.where(valid, a + t, a) for a, t in zip(acc, terms)]
    return torch.complex(*acc) if cplx else acc[0]


def csr_spmv(indptr, indices, vals, x, max_row=None):
    """y = A·x for a CSR matrix (int64 ``indptr``, ``indices``; ``vals``)
    and a dense (n_cols, k) block ``x`` of vals' dtype: float32, float64,
    complex64 or complex128.

    Beside the JAX package's scatter-add (superlu_dist_tpu/parallel/
    dist.py:181-185) — not a Pallas kernel there; written by hand here so
    the residual is deterministic (csrc/csr_spmv.cu).  On the card it
    launches ``csrc/csr_spmv.cu`` and counts one launch under
    ``kernels.LAUNCHES["csr_spmv"]``; on the CPU it runs
    ``csr_spmv_plain``.  Bound: bytes.  Raises on a refused launch."""
    _check(indptr, indices, vals, x)
    cuda = x.device.type == "cuda"
    if kernels._fake(x):
        return torch.ops.slu.csr_spmv(indptr, indices, vals, x)
    if not cuda:
        return csr_spmv_plain(indptr, indices, vals, x, max_row)
    return _csr_spmv_kernel(indptr, indices, vals, x)


def _csr_spmv_kernel(indptr, indices, vals, x):
    n_rows, k = indptr.shape[0] - 1, x.shape[1]
    y = torch.empty((n_rows, k), dtype=x.dtype, device=x.device)
    if n_rows * k == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel(x.dtype)(indptr.data_ptr(), indices.data_ptr(),
                          vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                          n_rows, k, stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv kernel launch failed: CUDA error {rc}")
    kernels.LAUNCHES["csr_spmv"] += 1
    return y


# the kernel as a registered op (numeric/kernels.py: what a program walk
# sees — y allocated, nothing launched)
@torch.library.custom_op("slu::csr_spmv", mutates_args=())
def _csr_spmv_op(indptr: torch.Tensor, indices: torch.Tensor,
                 vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _csr_spmv_kernel(indptr, indices, vals, x)


@_csr_spmv_op.register_fake
def _(indptr, indices, vals, x):
    return x.new_empty((indptr.shape[0] - 1, x.shape[1]))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class DeviceSpMV:
    """y = A·x with A resident on ``device`` (the card unless the caller
    asks for the CPU), in ``dtype`` (default: A's dtype promoted with
    float64).  Presents the ``matvec`` / ``abs_matvec`` / ``nnz`` surface
    the refinement loop uses, so it stands in for a SparseCSR there; x
    and y are numpy arrays."""

    def __init__(self, a: SparseCSR, dtype=None, device="cuda"):
        self.device = resolve_device(device)
        self.n_rows, self.n_cols = a.n_rows, a.n_cols
        self._nnz = a.nnz
        dtype = np.dtype(dtype or np.result_type(a.data.dtype, np.float64))
        real = np.zeros(0, dtype=dtype).real.dtype

        def put(arr):
            return torch.as_tensor(np.ascontiguousarray(arr),
                                   device=self.device)
        self._indptr = put(np.asarray(a.indptr, dtype=np.int64))
        self._indices = put(np.asarray(a.indices, dtype=np.int64))
        self._vals = {_torch_dtype(dtype): put(a.data.astype(dtype))}
        self._avals = {_torch_dtype(real): put(np.abs(a.data).astype(real))}
        self._max_row = int(np.diff(a.indptr).max(initial=0))

    @property
    def nnz(self) -> int:
        return self._nnz

    def _apply(self, table, x):
        x = np.asarray(x)
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        base = next(iter(table.values()))
        dt = torch.promote_types(base.dtype, _torch_dtype(x2.dtype))
        vals = table.get(dt)
        if vals is None:
            vals = table[dt] = base.to(dt)
        xt = torch.as_tensor(np.ascontiguousarray(x2),
                             device=self.device).to(dt)
        y = csr_spmv(self._indptr, self._indices, vals, xt,
                     self._max_row).cpu().numpy()
        return y[:, 0] if squeeze else y

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self._apply(self._vals, x)

    def abs_matvec(self, x: np.ndarray) -> np.ndarray:
        # |A|·x, NOT |A|·|x| — same contract as SparseCSR.abs_matvec
        return self._apply(self._avals, x)


class ShardedSpMV:
    """Grid-sharded op(A)·x — the pdgsmv analog for refinement at scale
    (port of the JAX package's ``ShardedSpMV``, parallel/dist.py:210),
    and the mesh tier's residual operator (parallel/pgsrfs.py under
    ``pgssvx(grid=)``).

    Rank r of ``grid`` keeps a block of rows of A on its device
    (``grid.device``): ``ShardedSpMV(a, grid)`` deals the whole A as
    ``distribute_rows`` does (rows [r·⌈n/P⌉, (r+1)·⌈n/P⌉)), and
    ``ShardedSpMV.from_rows(a_loc, grid)`` takes the rank's own block
    rows, the block-row input of ``pgssvx(grid=)``.  A·x (``__call__``)
    and |A|·x multiply the rank's rows through ``csr_spmv`` (the kernel
    on the card, its plain twin on the CPU) and gather them in rank order
    (``grid.gather_rows``).  Aᵀ·x, Aᴴ·x and |A|ᵀ·x multiply the rank's
    block transposed (built at first use) by its rows of x and sum the
    full-length products over the ranks (``grid.all_reduce_sum``).
    Collective: every rank calls with the same x and gets the whole y.
    Built once per pattern, reused across refinement steps (the
    pdgsmv_init discipline, SRC/pdgsmv.c:31)."""

    def __init__(self, a: SparseCSR, grid, dtype=None):
        n = a.n_rows
        step = -(-n // grid.nproc)
        counts = [max(0, min(step, n - r * step)) for r in range(grid.nproc)]
        lo = min(grid.rank * step, n)
        hi = lo + counts[grid.rank]
        s, e = int(a.indptr[lo]), int(a.indptr[hi])
        self._setup(grid, n, lo, counts, a.indptr[lo:hi + 1] - s,
                    a.indices[s:e], a.data[s:e], dtype)

    @classmethod
    def from_rows(cls, a_loc: DistributedCSR, grid, dtype=None):
        """The operator over the ranks' own block rows — collective: the
        blocks' (first row, rows) are gathered, and they must tile the
        rows of A in rank order."""
        me = torch.tensor([[a_loc.fst_row, a_loc.m_loc]], dtype=torch.int64)
        if grid.backend == "nccl":
            me = me.to(grid.device)
        blocks = grid.all_gather(me).cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(blocks[:, 1])[:-1]])
        if (not np.array_equal(blocks[:, 0], starts)
                or int(blocks[:, 1].sum()) != a_loc.n):
            raise ValueError(f"the ranks' block rows (first row, rows) "
                             f"{blocks.tolist()} do not tile the {a_loc.n} "
                             "rows of A in rank order")
        self = cls.__new__(cls)
        self._setup(grid, a_loc.n, a_loc.fst_row, blocks[:, 1].tolist(),
                    a_loc.indptr, a_loc.indices, a_loc.data, dtype)
        return self

    def _setup(self, grid, n, lo, counts, indptr, indices, data, dtype):
        self.grid, self.n, self._lo = grid, n, int(lo)
        self._counts = [int(c) for c in counts]
        self._rows = self._counts[grid.rank]
        dtype = np.dtype(dtype or np.result_type(data.dtype, np.float64))
        real = np.zeros(0, dtype).real.dtype
        self._host = (np.asarray(indptr, dtype=np.int64),
                      np.asarray(indices, dtype=np.int64),
                      np.asarray(data).astype(dtype))
        self._ops = {False: self._upload(*self._host, real)}
        self._trans = None

    def _upload(self, indptr, indices, data, real):
        """(indptr, indices, values by dtype, |values| by dtype, longest
        row) of a block on the grid's device."""
        def put(arr):
            return torch.as_tensor(np.ascontiguousarray(arr),
                                   device=self.grid.device)
        return (put(indptr), put(indices),
                {_torch_dtype(data.dtype): put(data)},
                {_torch_dtype(real): put(np.abs(data).astype(real))},
                int(np.diff(indptr).max(initial=0)))

    def _transposed(self):
        """The rank's block transposed: n rows, one column per local row
        (a column's entries in row order)."""
        if self._trans is None:
            indptr, indices, data = self._host
            rows = np.repeat(np.arange(self._rows, dtype=np.int64),
                             np.diff(indptr))
            order = np.argsort(indices, kind="stable")
            tptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(np.bincount(indices, minlength=self.n), out=tptr[1:])
            self._trans = self._upload(tptr, rows[order], data[order],
                                       np.zeros(0, data.dtype).real.dtype)
        return self._trans

    def _product(self, op, absolute, conj, x):
        indptr, indices, vals, avals, max_row = op
        table = avals if absolute else vals
        base = next(iter(table.values()))
        dt = torch.promote_types(base.dtype, _torch_dtype(x.dtype))
        v = table.get(dt)
        if v is None:
            v = table[dt] = base.to(dt)
        if conj and v.is_complex():
            v = v.conj().resolve_conj()
        xt = torch.as_tensor(np.ascontiguousarray(x),
                             device=self.grid.device).to(dt)
        return csr_spmv(indptr, indices, v, xt, max_row)

    def apply(self, x: np.ndarray, trans=None, absolute: bool = False
              ) -> np.ndarray:
        """op(A)·x, or |op(A)|·x when ``absolute``, with op per ``trans``
        (utils.options.Trans; None: NOTRANS) — collective."""
        from superlu_dist_tpu_torch.utils.options import Trans
        x = np.asarray(x)
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        if trans is None or trans == Trans.NOTRANS:
            y = self._product(self._ops[False], absolute, False, x2)
            y = self.grid.gather_rows(y, self._counts)
        else:
            y = self._product(self._transposed(), absolute,
                              trans == Trans.CONJ,
                              x2[self._lo:self._lo + self._rows])
            y = self.grid.all_reduce_sum(y)
        y = y.cpu().numpy()
        return y[:, 0] if squeeze else y

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.apply(x)


@dataclasses.dataclass
class DistributedCSR:
    """One rank's row block (the NRformat_loc analog, SRC/supermatrix.h:
    175-188): m_loc local rows starting at global row fst_row, with local
    row pointers and global column indices."""

    n: int                 # global dimension
    m_loc: int
    fst_row: int
    indptr: np.ndarray     # (m_loc+1,) local row pointers
    indices: np.ndarray    # global column indices
    data: np.ndarray

    @property
    def nnz_loc(self) -> int:
        return int(self.indptr[-1])

    def _rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.m_loc), np.diff(self.indptr))

    def matvec_local(self, x_global: np.ndarray) -> np.ndarray:
        """Local rows of A·x given the full x, (n,) or (n, nrhs)
        (pdgsmv's compute phase)."""
        rows = self._rows()
        x = np.asarray(x_global)
        if x.ndim > 1:
            out = np.zeros((self.m_loc, x.shape[1]),
                           dtype=np.result_type(self.data, x))
            np.add.at(out, rows, self.data[:, None] * x[self.indices])
            return out
        contrib = self.data * x[self.indices]
        if np.iscomplexobj(contrib):
            return (np.bincount(rows, weights=contrib.real,
                                minlength=self.m_loc)
                    + 1j * np.bincount(rows, weights=contrib.imag,
                                       minlength=self.m_loc))
        return np.bincount(rows, weights=contrib, minlength=self.m_loc)

    def abs_matvec_local(self, x: np.ndarray) -> np.ndarray:
        """Local rows of |A|·x (the berr denominator in refinement)."""
        contrib = np.abs(self.data) * np.asarray(x)[self.indices]
        return np.bincount(self._rows(), weights=contrib,
                           minlength=self.m_loc)

    def matvec_trans_local(self, x_global: np.ndarray,
                           conj: bool = False) -> np.ndarray:
        """This rank's full-length contribution to op(A)·x, op = Aᵀ/Aᴴ:
        out[j] += v̄·x[i] over local entries (i, j, v); the ranks' returns
        sum to op(A)·x."""
        vals = np.conj(self.data) if conj else self.data
        contrib = vals * np.asarray(x_global)[self.fst_row + self._rows()]
        out = np.zeros(self.n, dtype=np.result_type(contrib, np.float64))
        np.add.at(out, self.indices, contrib)
        return out

    def abs_matvec_trans_local(self, x: np.ndarray) -> np.ndarray:
        """Full-length contribution to |op(A)|·x (|Aᵀ| = |A|ᵀ = |Aᴴ|)."""
        contrib = (np.abs(self.data)
                   * np.asarray(x)[self.fst_row + self._rows()])
        out = np.zeros(self.n)
        np.add.at(out, self.indices, contrib)
        return out


def distribute_rows(a: SparseCSR, nparts: int) -> list[DistributedCSR]:
    """Block-row partition of A (the dcreate_matrix scatter,
    EXAMPLE/dcreate_matrix.c:66): part p gets rows [p·⌈n/P⌉, ...)."""
    n = a.n_rows
    step = -(-n // nparts)
    out = []
    for p in range(nparts):
        lo = min(p * step, n)
        hi = min(lo + step, n)
        indptr = a.indptr[lo:hi + 1].astype(np.int64)
        s, e = int(indptr[0]), int(indptr[-1])
        out.append(DistributedCSR(
            n=n, m_loc=hi - lo, fst_row=lo, indptr=indptr - s,
            indices=a.indices[s:e].copy(), data=a.data[s:e].copy()))
    return out


def gather_rows(parts: list[DistributedCSR]) -> SparseCSR:
    """Inverse of distribute_rows (pdCompRow_loc_to_CompCol_global
    analog, SRC/pdutil.c)."""
    parts = sorted(parts, key=lambda p: p.fst_row)
    n = parts[0].n
    indptr = [np.zeros(1, dtype=np.int64)]
    indices, data = [], []
    base = 0
    for p in parts:
        indptr.append(p.indptr[1:].astype(np.int64) + base)
        base += p.nnz_loc
        indices.append(p.indices)
        data.append(p.data)
    return SparseCSR(n, n, np.concatenate(indptr), np.concatenate(indices),
                     np.concatenate(data))
