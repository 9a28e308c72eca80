"""Sparse matrix file readers/writers.

A copy of the JAX package's ``io/readers.py`` over this package's own
``sparse/formats.py`` (the same semantics, file for file).  Capability
parity with the reference's I/O layer: Harwell-Boeing (dreadhb.c:107),
Rutherford-Boeing (dreadrb.c), MatrixMarket (dreadMM.c), triples
with/without header (dreadtriple.c, dreadtriple_noheader.c), raw binary
(dbinary_io.c).  The text readers parse line by line in Python.

All readers return a :class:`SparseCSC` (the reference's NCformat analog) —
use ``.tocsr()`` for the row-major pipeline entry.
"""

from __future__ import annotations

import re

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSC, coo_to_csc
from superlu_dist_tpu_torch.utils.errors import SuperLUError

_FMT_RE = re.compile(
    r"\(\s*(?:(\d+)\s*[Pp][A-Za-z]*\s*,?\s*)?(\d+)\s*([IiEeDdFfGg])\s*(\d+)(?:\.(\d+))?\s*\)")


def _parse_fortran_format(fmt: str):
    """Parse e.g. '(16I5)' / '(5E15.8)' / '(1P,5E16.8)' -> (per_line, width, kind)."""
    m = _FMT_RE.search(fmt)
    if not m:
        raise SuperLUError(f"unsupported Fortran format: {fmt!r}")
    _, count, kind, width = m.group(1), int(m.group(2)), m.group(3).upper(), int(m.group(4))
    return count, width, kind


def _read_fixed(lines_iter, fmt, total, numeric):
    """Read `total` fixed-width fields laid out `per_line` per line."""
    per_line, width, kind = _parse_fortran_format(fmt)
    vals = []
    while len(vals) < total:
        line = next(lines_iter).rstrip("\n")
        for k in range(per_line):
            if len(vals) >= total:
                break
            field = line[k * width:(k + 1) * width]
            if not field.strip():
                continue
            if numeric == "int":
                vals.append(int(field))
            else:
                vals.append(float(field.replace("D", "E").replace("d", "e")))
    return np.array(vals)


def _hb_like(text: str, rutherford: bool) -> SparseCSC:
    lines = iter(text.splitlines())
    next(lines)                      # title + key
    card2 = next(lines).split()
    totcrd, ptrcrd, indcrd, valcrd = (int(x) for x in card2[:4])
    rhscrd = int(card2[4]) if len(card2) > 4 and not rutherford else 0
    card3 = next(lines).split()
    mxtype = card3[0].upper()
    nrow, ncol, nnz = int(card3[1]), int(card3[2]), int(card3[3])
    card4 = next(lines)
    # formats occupy fixed 16-char columns, but splitting on whitespace works
    fmts = card4.split()
    ptrfmt, indfmt = fmts[0], fmts[1]
    valfmt = fmts[2] if len(fmts) > 2 else "(5E15.8)"
    if (not rutherford) and rhscrd > 0:
        next(lines)                  # card 5: RHS descriptor (ignored)
    colptr = _read_fixed(lines, ptrfmt, ncol + 1, "int") - 1
    rowind = _read_fixed(lines, indfmt, nnz, "int") - 1
    is_complex = mxtype[0] == "C"
    is_pattern = mxtype[0] == "P"
    if is_pattern or valcrd == 0:
        data = np.ones(nnz)
    else:
        raw = _read_fixed(lines, valfmt, nnz * (2 if is_complex else 1), "float")
        data = raw[0::2] + 1j * raw[1::2] if is_complex else raw
    a = SparseCSC(nrow, ncol, colptr.astype(np.int32), rowind.astype(np.int32),
                  data)
    if mxtype[1] == "S":             # symmetric: only lower triangle stored
        a = _expand_symmetric(a, hermitian=False)
    elif mxtype[1] == "H":
        a = _expand_symmetric(a, hermitian=True)
    elif mxtype[1] == "Z":           # skew-symmetric
        a = _expand_symmetric(a, skew=True)
    return a


def _expand_symmetric(a: SparseCSC, hermitian=False, skew=False) -> SparseCSC:
    cols = np.repeat(np.arange(a.n_cols), np.diff(a.indptr)).astype(np.int64)
    rows = a.indices.astype(np.int64)
    off = rows != cols
    mrows = np.concatenate([rows, cols[off]])
    mcols = np.concatenate([cols, rows[off]])
    mirror = a.data[off]
    if hermitian:
        mirror = np.conj(mirror)
    if skew:
        mirror = -mirror
    mdata = np.concatenate([a.data, mirror])
    return coo_to_csc(a.n_rows, a.n_cols, mrows, mcols, mdata)


def read_harwell_boeing(path_or_text) -> SparseCSC:
    """Harwell-Boeing (.rua/.cua) reader — dreadhb_dist analog (dreadhb.c:107)."""
    return _hb_like(_as_text(path_or_text), rutherford=False)


def read_rutherford_boeing(path_or_text) -> SparseCSC:
    """Rutherford-Boeing (.rb) reader — dreadrb_dist analog (dreadrb.c)."""
    return _hb_like(_as_text(path_or_text), rutherford=True)


def read_matrix_market(path_or_text) -> SparseCSC:
    """MatrixMarket coordinate reader — dreadMM_dist analog (dreadMM.c)."""
    text = _as_text(path_or_text)
    lines = [l for l in text.splitlines()]
    header = lines[0].split()
    if len(header) < 5 or header[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise SuperLUError("not a MatrixMarket file")
    _, obj, fmt, field, symm = (h.lower() for h in header[:5])
    if obj != "matrix" or fmt != "coordinate":
        raise SuperLUError("only coordinate matrices supported")
    body = (l for l in lines[1:] if l.strip() and not l.lstrip().startswith("%"))
    nrow, ncol, nnz = (int(x) for x in next(body).split()[:3])
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    is_complex = field == "complex"
    is_pattern = field == "pattern"
    data = np.empty(nnz, dtype=np.complex128 if is_complex else np.float64)
    for k in range(nnz):
        parts = next(body).split()
        rows[k], cols[k] = int(parts[0]) - 1, int(parts[1]) - 1
        if is_pattern:
            data[k] = 1.0
        elif is_complex:
            data[k] = float(parts[2]) + 1j * float(parts[3])
        else:
            data[k] = float(parts[2])
    a = coo_to_csc(nrow, ncol, rows, cols, data)
    if symm in ("symmetric", "hermitian", "skew-symmetric"):
        a = _expand_symmetric(a, hermitian=symm == "hermitian",
                              skew=symm == "skew-symmetric")
    return a


def read_triples(path_or_text, zero_based=False, header=True,
                 dtype=np.float64) -> SparseCSC:
    """'i j value' triples — dreadtriple_dist / _noheader analog.

    With header=True the first line is 'n nnz' (reference convention,
    dreadtriple.c); otherwise dimensions are inferred from the data
    (dreadtriple_noheader.c behavior, which also auto-detects 0/1-base).
    """
    text = _as_text(path_or_text)
    rows_l, cols_l, vals_l = [], [], []
    lines = (l for l in text.splitlines() if l.strip())
    n = None
    if header:
        hdr = next(lines).split()
        n = int(hdr[0])
    is_complex = np.issubdtype(np.dtype(dtype), np.complexfloating)
    for line in lines:
        parts = line.split()
        rows_l.append(int(parts[0]))
        cols_l.append(int(parts[1]))
        if len(parts) < 3:
            vals_l.append(1.0)
        elif is_complex and len(parts) >= 4:
            vals_l.append(float(parts[2]) + 1j * float(parts[3]))
        else:
            vals_l.append(float(parts[2]))
    rows = np.array(rows_l, dtype=np.int64)
    cols = np.array(cols_l, dtype=np.int64)
    vals = np.array(vals_l, dtype=dtype)
    if not zero_based and (header or (rows.min(initial=1) >= 1 and
                                      cols.min(initial=1) >= 1)):
        rows -= 1
        cols -= 1
    if n is None:
        n = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
    return coo_to_csc(n, n, rows, cols, vals)


_BIN_MAGIC = b"SLUTPU1\0"


def write_binary(path, a) -> None:
    """Raw binary writer (dbinary_io.c capability analog; own format:
    magic, int64 nrow/ncol/nnz/iscomplex, then indptr/indices/data)."""
    csc = a if isinstance(a, SparseCSC) else a.tocsc()
    with open(path, "wb") as f:
        f.write(_BIN_MAGIC)
        is_c = int(np.issubdtype(csc.data.dtype, np.complexfloating))
        np.array([csc.n_rows, csc.n_cols, csc.nnz, is_c], dtype=np.int64).tofile(f)
        csc.indptr.astype(np.int64).tofile(f)
        csc.indices.astype(np.int64).tofile(f)
        csc.data.astype(np.complex128 if is_c else np.float64).tofile(f)


def read_binary(path) -> SparseCSC:
    with open(path, "rb") as f:
        if f.read(8) != _BIN_MAGIC:
            raise SuperLUError("bad binary matrix file")
        nrow, ncol, nnz, is_c = np.fromfile(f, dtype=np.int64, count=4)
        indptr = np.fromfile(f, dtype=np.int64, count=ncol + 1)
        indices = np.fromfile(f, dtype=np.int64, count=nnz)
        data = np.fromfile(f, dtype=np.complex128 if is_c else np.float64,
                           count=nnz)
    return SparseCSC(int(nrow), int(ncol), indptr.astype(np.int32),
                     indices.astype(np.int32), data)


def write_matrix_market(path, a) -> None:
    csc = a if isinstance(a, SparseCSC) else a.tocsc()
    is_c = np.issubdtype(csc.data.dtype, np.complexfloating)
    field = "complex" if is_c else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{csc.n_rows} {csc.n_cols} {csc.nnz}\n")
        cols = np.repeat(np.arange(csc.n_cols), np.diff(csc.indptr))
        for i, j, v in zip(csc.indices, cols, csc.data):
            if is_c:
                f.write(f"{i + 1} {j + 1} {v.real:.17g} {v.imag:.17g}\n")
            else:
                f.write(f"{i + 1} {j + 1} {v:.17g}\n")


def read_matrix(path) -> SparseCSC:
    """Extension-dispatched reader (the EXAMPLE drivers' '-f file' behavior,
    dcreate_matrix_postfix, EXAMPLE/dcreate_matrix.c:239)."""
    p = str(path)
    if p.endswith((".rua", ".cua", ".hb", ".rsa", ".csa")):
        return read_harwell_boeing(p)
    if p.endswith(".rb"):
        return read_rutherford_boeing(p)
    if p.endswith(".mtx"):
        return read_matrix_market(p)
    if p.endswith(".bin"):
        return read_binary(p)
    if p.endswith((".triple", ".txt")):
        return read_triples(p)
    raise SuperLUError(f"cannot infer matrix format from {p}")


def _as_text(path_or_text) -> str:
    s = str(path_or_text)
    if "\n" in s:
        return s
    with open(s) as f:
        return f.read()
