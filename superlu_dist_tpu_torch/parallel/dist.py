"""The refinement residual's SpMV on the card: ``DeviceSpMV``.

Port of ``DeviceSpMV`` from the JAX package's ``parallel/dist.py`` (the
pdgsmv analog, SRC/pdgsmv.c:234): y = A·x with the pattern and values
resident on the device, so iterative refinement's residual runs next to
the factors instead of on the host.  The upload (pattern, values and
|values|) happens once and is amortized over every refinement step and
repeated solve (the pdgsmv_init / SOLVEstruct discipline,
SRC/pdgsmv.c:31).  The rest of that JAX module (the distributed-input
paths, the sharded SpMV) belongs to the multi-GPU slice.

The product is ``csr_spmv``: on a CUDA tensor the hand-written kernel
``csrc/csr_spmv.cu`` (one thread per output element, CSR order, every
multiply and add rounded on its own), on a CPU tensor its plain PyTorch
twin ``csr_spmv_plain``, which performs the same operations in the same
order, vectorised over rows: the two are equal bit for bit.  There is no
fallback between them: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

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
    if x.device.type != "cuda":
        return csr_spmv_plain(indptr, indices, vals, x, max_row)
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
