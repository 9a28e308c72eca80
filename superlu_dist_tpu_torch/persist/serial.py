"""Versioned, integrity-checked serialization of solver state.

Port of the JAX package's ``persist/serial.py``, with its bundle layout
(one directory per bundle)::

    <dir>/
      MANIFEST.json            # written LAST, atomically — the commit point
      <name>.npy               # one file per array, each written tmp+rename
      structure.pkl            # pickled host structures (symbolic + plan)

``MANIFEST.json`` carries ``{format, version, kind, meta, arrays}`` where
``arrays[name]`` records the file name, byte length and sha256 digest of
every artifact.  A bundle is readable iff the manifest parses, the
version is known, and every artifact matches its digest — anything else
raises a structured :class:`CheckpointError` subclass instead of handing
back garbage factors.  Because the manifest is replaced last and every
artifact is written to a temp name first, an interrupted writer always
leaves either the previous consistent bundle or no manifest at all.

``FORMAT``, ``FORMAT_VERSION``, the manifest and the ``.npy`` artifacts
are the JAX package's, so either package's manifest and array readers
read the other's bundles.  ``structure.pkl`` holds each package's own
classes: :func:`load_lu` unpickles it with an allow-list that admits this
package, numpy and plain builtins only, and refuses a bundle the JAX
package wrote with :class:`CheckpointMismatchError` (unpickling it would
import that package, and with it jax).

Every array is stored with its exact dtype, so float32, float64,
complex64 and complex128 factors round-trip bit for bit; dtype names in
the meta block are numpy's ("float32"), as the JAX package writes them.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle

import numpy as np
import torch

from superlu_dist_tpu_torch.utils.errors import (CheckpointCorruptError,
                                                 CheckpointError,
                                                 CheckpointMismatchError,
                                                 CheckpointVersionError)

FORMAT = "slu-tpu-persist"
FORMAT_VERSION = 1
MANIFEST = "MANIFEST.json"


# ---------------------------------------------------------------------------
# bundle primitives
# ---------------------------------------------------------------------------

def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array, its dtype
    kept exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_array(dirpath: str, name: str, arr: np.ndarray,
                entries: dict, skip_existing: bool = False) -> None:
    """Write one ``.npy`` artifact (tmp+rename) and record it in the
    manifest's ``entries`` dict.  ``skip_existing`` lets an advancing
    checkpoint reuse immutable artifacts already on disk (the digest in
    ``entries`` must then come from the previous manifest entry)."""
    fname = f"{name}.npy"
    path = os.path.join(dirpath, fname)
    if skip_existing and name in entries and os.path.exists(path):
        return
    data = _npy_bytes(arr)
    _atomic_write(path, data)
    entries[name] = {"file": fname, "bytes": len(data),
                     "sha256": _sha256(data),
                     "dtype": str(arr.dtype), "shape": list(arr.shape)}


def write_blob(dirpath: str, name: str, data: bytes, entries: dict) -> None:
    path = os.path.join(dirpath, name)
    _atomic_write(path, data)
    entries[name] = {"file": name, "bytes": len(data),
                     "sha256": _sha256(data)}


def write_manifest(dirpath: str, kind: str, meta: dict,
                   entries: dict) -> str:
    doc = {"format": FORMAT, "version": FORMAT_VERSION, "kind": kind,
           "meta": meta, "arrays": entries}
    _atomic_write(os.path.join(dirpath, MANIFEST),
                  json.dumps(doc, sort_keys=True).encode())
    return dirpath


def write_bundle(dirpath: str, kind: str, meta: dict,
                 arrays: dict, blobs: dict | None = None) -> str:
    """Write a whole bundle: every array, every blob, then the manifest
    (the commit point).  Returns ``dirpath``."""
    os.makedirs(dirpath, exist_ok=True)
    entries: dict = {}
    for name, arr in arrays.items():
        write_array(dirpath, name, host_array(arr), entries)
    for name, data in (blobs or {}).items():
        write_blob(dirpath, name, data, entries)
    return write_manifest(dirpath, kind, meta, entries)


def read_manifest(dirpath: str, kind: str | None = None) -> dict:
    mpath = os.path.join(dirpath, MANIFEST)
    if not os.path.isdir(dirpath) or not os.path.exists(mpath):
        raise CheckpointError(
            f"no persisted bundle at {dirpath!r} (missing {MANIFEST} — "
            "either the path is wrong or a writer died before its first "
            "commit point)")
    try:
        with open(mpath, "rb") as f:
            doc = json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest {mpath!r}: {type(e).__name__}: {e}")
    if not isinstance(doc, dict) or doc.get("format") != FORMAT:
        raise CheckpointError(
            f"{mpath!r} is not a {FORMAT} bundle (format="
            f"{doc.get('format') if isinstance(doc, dict) else doc!r})")
    if doc.get("version") != FORMAT_VERSION:
        raise CheckpointVersionError(
            f"bundle version {doc.get('version')!r} at {dirpath!r} is not "
            f"readable by this build (expected {FORMAT_VERSION})")
    if kind is not None and doc.get("kind") != kind:
        raise CheckpointError(
            f"bundle at {dirpath!r} is kind={doc.get('kind')!r}, "
            f"expected {kind!r}")
    return doc


def _read_artifact(dirpath: str, name: str, ent: dict) -> bytes:
    path = os.path.join(dirpath, ent["file"])
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorruptError(
            f"artifact {name!r} missing/unreadable at {path!r}: {e}")
    if len(data) != ent["bytes"]:
        raise CheckpointCorruptError(
            f"artifact {name!r} at {path!r} is truncated: "
            f"{len(data)} bytes on disk vs {ent['bytes']} in the manifest")
    if _sha256(data) != ent["sha256"]:
        raise CheckpointCorruptError(
            f"artifact {name!r} at {path!r} failed its sha256 digest "
            "check — the bundle is corrupt (refusing to return garbage "
            "factors)")
    return data


def read_array(dirpath: str, name: str, doc: dict) -> np.ndarray:
    ent = doc["arrays"].get(name)
    if ent is None:
        raise CheckpointCorruptError(
            f"manifest at {dirpath!r} has no artifact named {name!r}")
    data = _read_artifact(dirpath, name, ent)
    try:
        return np.load(io.BytesIO(data), allow_pickle=False)
    except ValueError as e:
        raise CheckpointCorruptError(
            f"artifact {name!r} at {dirpath!r} is not a valid .npy "
            f"payload: {type(e).__name__}: {e}")


def read_blob(dirpath: str, name: str, doc: dict) -> bytes:
    ent = doc["arrays"].get(name)
    if ent is None:
        raise CheckpointCorruptError(
            f"manifest at {dirpath!r} has no artifact named {name!r}")
    return _read_artifact(dirpath, name, ent)


def read_bundle(dirpath: str, kind: str | None = None):
    """Read and fully verify a bundle.  Returns ``(doc, arrays)`` where
    ``arrays`` maps each ``.npy`` artifact name to its ndarray (blobs are
    left to :func:`read_blob`)."""
    doc = read_manifest(dirpath, kind=kind)
    arrays = {name: read_array(dirpath, name, doc)
              for name, ent in doc["arrays"].items()
              if ent["file"].endswith(".npy")}
    return doc, arrays


# ---------------------------------------------------------------------------
# identity fingerprints
# ---------------------------------------------------------------------------

def plan_fingerprint(plan) -> str:
    """Structural identity of a FactorPlan: the dispatch-group geometry,
    batch membership, pool layout and assembly maps.  Two plans with the
    same fingerprint run the identical launch sequence, which is the
    precondition for splicing a checkpointed frontier into a fresh run
    (resume) and for a values-only refactor."""
    h = hashlib.sha256()
    h.update(f"n={plan.n};pool={plan.pool_size};"
             f"sched={plan.schedule};groups={len(plan.groups)};".encode())
    for grp in plan.groups:
        h.update(np.int64([grp.level, grp.m, grp.w, grp.u,
                           grp.batch]).tobytes())
        for x in (grp.sns, grp.ws, grp.off, grp.a_src):
            h.update(np.ascontiguousarray(x, dtype=np.int64).tobytes())
        for cs in grp.children:
            h.update(np.int64([cs.ub]).tobytes())
            h.update(np.ascontiguousarray(cs.child_off,
                                          dtype=np.int64).tobytes())
    return h.hexdigest()


def pattern_digest(indptr, indices) -> str:
    """Identity of a symmetrized-permuted sparsity pattern: sha256 over
    the CSR structure arrays as int64 (int-width portable).  The refactor
    pipeline's pattern key: drift raises ``PatternMismatchError``."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def dtype_str(dtype) -> str:
    """Canonical dtype name of a torch or numpy dtype: numpy's spelling
    ("float32"), as the JAX package records it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def values_digest(pattern_values, dtype, thresh, gemm_prec: str = "") -> str:
    """Identity of the numeric inputs a frontier was computed from: the
    structurally-permuted value array, factor dtype, GESP threshold (its
    float value, rounded to the factors' real type) and the GEMM ladder
    tier (``gemm_prec``; "" = unspecified).  A resume against different
    values is refused via CheckpointMismatchError."""
    h = hashlib.sha256()
    v = np.ascontiguousarray(np.asarray(pattern_values))
    h.update(str(v.dtype).encode())
    h.update(v.tobytes())
    h.update(dtype_str(dtype).encode())
    h.update(np.float64(float(np.real(thresh))).tobytes())
    if gemm_prec:
        h.update(f";gemm={gemm_prec}".encode())
    return h.hexdigest()


def front_digest(arr) -> str:
    """sha256 of one front panel's canonical ``.npy`` payload — the same
    digest ``save_lu`` records in a bundle manifest, computable from a
    live (device-resident) panel with one copy to the host."""
    return _sha256(_npy_bytes(host_array(arr)))


def front_digests(fronts) -> list:
    """Per-front ``(sha256_L, sha256_U)`` digests of a live handle's
    panel stacks, in group order."""
    return [(front_digest(lp), front_digest(up)) for lp, up in fronts]


def bundle_front_digests(dirpath: str) -> list:
    """Per-front ``(sha256_L, sha256_U)`` digests straight from a
    persisted LU bundle's manifest — no array reads."""
    doc = read_manifest(dirpath, kind="lu_handle")
    ent = doc["arrays"]
    out = []
    for g in range(int(doc["meta"]["n_groups"])):
        try:
            out.append((ent[f"front_{g:05d}_l"]["sha256"],
                        ent[f"front_{g:05d}_u"]["sha256"]))
        except KeyError:
            raise CheckpointCorruptError(
                f"bundle at {dirpath!r} is missing the manifest entry "
                f"for front group {g}")
    return out


# ---------------------------------------------------------------------------
# the structure blob
# ---------------------------------------------------------------------------

_PACKAGE = "superlu_dist_tpu_torch"
_BUILTINS = frozenset({"list", "dict", "tuple", "set", "frozenset", "int",
                       "float", "complex", "bool", "str", "bytes",
                       "bytearray", "slice", "range", "object"})


class _StructureUnpickler(pickle.Unpickler):
    """Admits this package's classes, numpy's and plain builtins; refuses
    the JAX package's (a bundle it wrote) and everything else."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in (_PACKAGE, "numpy") or (module == "builtins"
                                           and name in _BUILTINS):
            return super().find_class(module, name)
        if root == "superlu_dist_tpu":
            raise CheckpointMismatchError(
                f"the bundle's structure blob holds {module}.{name}: it was "
                "written by the JAX package (superlu_dist_tpu), whose "
                f"structures {_PACKAGE} does not load — re-analyze and "
                "factor with this package, or read the arrays with "
                "read_array")
        raise CheckpointCorruptError(
            f"the bundle's structure blob refers to {module}.{name}, which "
            "no bundle of this package holds")


def load_structure(data: bytes, dirpath: str):
    """Unpickle a structure blob through the allow-list."""
    try:
        return _StructureUnpickler(io.BytesIO(data)).load()
    except CheckpointError:
        raise
    except (pickle.UnpicklingError, EOFError, AttributeError, ImportError,
            IndexError, TypeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"structure blob at {dirpath!r} failed to unpickle: "
            f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# LU handle save / load
# ---------------------------------------------------------------------------

def save_lu(lu, dirpath: str) -> str:
    """Persist a factored :class:`LUFactorization` handle.

    Saved: the scaling/permutation transforms, the symbolic fact + plan
    (one digest-checked pickle blob), and every numeric front as its own
    digest-checked ``.npy`` pair, copied from the factors' device.  Not
    saved: the matrix ``a`` (pass it to ``gssvx(Fact.FACTORED, a, b,
    lu=loaded)`` for refinement) and the device-side caches (solver,
    SpMV, index maps), which rebuild at first use."""
    if lu.numeric is None:
        raise CheckpointError("save_lu requires a factored handle "
                              "(lu.numeric is None — run the "
                              "factorization first)")
    numeric = lu.numeric
    if numeric.shard is not None:
        raise CheckpointError("save_lu takes a whole factorization: this "
                              "handle's factors are sharded over a grid's "
                              "ranks (each holds its own slots)")
    os.makedirs(dirpath, exist_ok=True)
    entries: dict = {}
    arrays = {"dr": lu.dr, "dc": lu.dc, "r1": lu.r1, "c1": lu.c1,
              "row_order": lu.row_order}
    if lu.col_order is not None:
        arrays["col_order"] = lu.col_order
    if lu.a_sym_indptr is not None:
        arrays["a_sym_indptr"] = lu.a_sym_indptr
        arrays["a_sym_indices"] = lu.a_sym_indices
    for name, arr in arrays.items():
        write_array(dirpath, name, np.asarray(arr), entries)
    for g, (lp, up) in enumerate(numeric.fronts):
        write_array(dirpath, f"front_{g:05d}_l", host_array(lp), entries)
        write_array(dirpath, f"front_{g:05d}_u", host_array(up), entries)
    blob = pickle.dumps((lu.sf, lu.plan), protocol=pickle.HIGHEST_PROTOCOL)
    write_blob(dirpath, "structure.pkl", blob, entries)
    meta = {
        "n": int(lu.n),
        "equed": lu.equed,
        "anorm": float(lu.anorm),
        "factor_dtype": dtype_str(numeric.dtype),
        "tiny_pivots": int(numeric.tiny_pivots),
        "finite": bool(numeric.finite),
        "info_col": int(numeric.info_col),
        "n_groups": len(numeric.fronts),
        "plan_fingerprint": plan_fingerprint(lu.plan),
        "has_col_order": lu.col_order is not None,
        "has_sym_pattern": lu.a_sym_indptr is not None,
        # the GEMM ladder tier the factors ran at: a reloaded handle must
        # not claim a higher tier than it ran
        "gemm_precision": numeric.gemm_prec,
    }
    if lu.a_sym_indptr is not None:
        meta["pattern_digest"] = pattern_digest(lu.a_sym_indptr,
                                                lu.a_sym_indices)
    return write_manifest(dirpath, "lu_handle", meta, entries)


def lu_meta(dirpath: str) -> dict:
    """Manifest meta block of a persisted LU handle — a cheap peek (no
    array reads, no digest work), plus a computed ``nbytes`` key (the sum
    of every artifact's manifest byte length)."""
    doc = read_manifest(dirpath, kind="lu_handle")
    meta = dict(doc["meta"])
    meta["nbytes"] = sum(int(e.get("bytes", 0))
                         for e in doc["arrays"].values())
    return meta


def load_lu(dirpath: str, device=None):
    """Load a persisted handle: verify every digest, rebuild the
    :class:`LUFactorization` with its factors on ``device`` — the card
    unless the caller asks for the CPU (CUDA without a card raises) — and
    return it ready to solve with ``Fact.FACTORED`` (``lu.a`` is None:
    supply the matrix when refinement is wanted)."""
    from superlu_dist_tpu_torch.drivers.gssvx import LUFactorization
    from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
    from superlu_dist_tpu_torch.utils.options import (FACTOR_DTYPES, Options,
                                                      resolve_device)

    device = resolve_device("cuda" if device is None else device)
    doc = read_manifest(dirpath, kind="lu_handle")
    meta = doc["meta"]
    sf, plan = load_structure(read_blob(dirpath, "structure.pkl", doc),
                              dirpath)
    if plan_fingerprint(plan) != meta["plan_fingerprint"]:
        raise CheckpointCorruptError(
            f"structure blob at {dirpath!r} does not match the "
            "manifest's plan fingerprint")
    n_groups = int(meta["n_groups"])
    if n_groups != len(plan.groups):
        raise CheckpointCorruptError(
            f"bundle at {dirpath!r} has {n_groups} front pairs for a "
            f"{len(plan.groups)}-group plan")
    dtype = FACTOR_DTYPES.get(meta["factor_dtype"])
    if dtype is None:
        raise CheckpointMismatchError(
            f"bundle at {dirpath!r} holds {meta['factor_dtype']} factors, "
            f"which this package does not run ({sorted(FACTOR_DTYPES)})")
    fronts = []
    for g in range(n_groups):
        pair = []
        for side in ("l", "u"):
            arr = read_array(dirpath, f"front_{g:05d}_{side}", doc)
            if arr.dtype != np.dtype(meta["factor_dtype"]):
                raise CheckpointCorruptError(
                    f"front {g}{side} at {dirpath!r} is {arr.dtype}, the "
                    f"manifest says {meta['factor_dtype']}")
            # one copy onto the device (the .npy payload is read-only)
            pair.append(torch.tensor(arr, device=device))
        fronts.append(tuple(pair))
    numeric = NumericFactorization(
        plan=plan, fronts=fronts, tiny_pivots=int(meta["tiny_pivots"]),
        dtype=dtype, finite=bool(meta["finite"]),
        info_col=int(meta["info_col"]),
        gemm_prec=str(meta.get("gemm_precision", "highest")))
    arr = lambda name: read_array(dirpath, name, doc)   # noqa: E731
    sym = bool(meta.get("has_sym_pattern"))
    return LUFactorization(
        n=int(meta["n"]), options=Options(), device=device,
        equed=meta["equed"], dr=arr("dr"), dc=arr("dc"), r1=arr("r1"),
        c1=arr("c1"), row_order=arr("row_order"),
        col_order=arr("col_order") if meta.get("has_col_order") else None,
        sf=sf, plan=plan, numeric=numeric, anorm=float(meta["anorm"]),
        a=None,
        a_sym_indptr=arr("a_sym_indptr") if sym else None,
        a_sym_indices=arr("a_sym_indices") if sym else None)
