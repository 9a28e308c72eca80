"""The two irregular kernels of the factor path, hand-written for Hopper.

The JAX package runs both as Pallas kernels on the TPU
(superlu_dist_tpu/numeric/pallas_kernels.py).  Here each is a CUDA C++
kernel under ``csrc/`` (compiled at first use by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ``ctypes``),
and beside each sits its plain PyTorch version:

* ``extend_add_`` — the multifrontal extend-add of one child set
  (``csrc/extend_add.cu``; replaces ``extend_add_set_pallas``);
* ``assemble_`` — the A-entry assembly of one group
  (``csrc/assemble.cu``; replaces ``assemble_avals_pallas``).

Both wrappers update ``f`` in place on PyTorch's current stream.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback between the two.  Each launch adds one to
``LAUNCHES[name]``, so a run can show that it went through the kernels.
The kernels equal their plain versions bit for bit: the extend-add
applies children in ascending order per front position, and the assembly
targets are unique, so every sum is the same sequence of adds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: kernel launches since the last reset, per wrapper
LAUNCHES = {"extend_add": 0, "assemble": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build outputs, keyed by a hash of the sources and flags (kept out of git)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_BAND_ROWS = 32        # csrc/extend_add.cu kBandRows
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (one ``nvcc`` per
    source, all started together, then one link) unless a library for
    these exact sources and flags exists.  Raises on any failure."""
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libslu_torch_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    failed = []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"lib.{tag}.tmp.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


def _library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"slu_extend_add_{sfx}")
            fn.argtypes = [ptr] * 5 + [i64] * 5 + [ptr]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"slu_assemble_{sfx}")
            fn.argtypes = [ptr] * 5 + [i64] * 4 + [ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_cuda(f: torch.Tensor, values: torch.Tensor, index) -> bool:
    """True for the kernel path, False for the plain version; raises on
    mixed devices or on inputs the kernel does not take."""
    devs = {t.device for t in (f, values, *index)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    if f.dtype not in _SUFFIX or values.dtype != f.dtype:
        raise TypeError(f"f and values must share float32 or float64, got "
                        f"{f.dtype} and {values.dtype}")
    if not (f.is_contiguous() and values.is_contiguous()):
        raise ValueError("f and values must be contiguous")
    for t in index:
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError("index maps must be contiguous int64 tensors")
    return f.device.type == "cuda"


# ---------------------------------------------------------------------------
# K1: extend-add
# ---------------------------------------------------------------------------

def extend_add_plain(f, pool, m, ub, child_off, child_slot, rel):
    """Plain PyTorch extend-add, in place on f (batch, m·m).

    Children are applied in rounds: round k takes the k-th child (in
    ascending child order) of every parent slot, so no round has two
    writers to one position and the per-position order is ascending in
    the child index — the arithmetic of the kernel and of the JAX
    package's in-order ``.at[].add`` scatter."""
    batch = f.shape[0]
    pool_len = pool.shape[0]
    nc = child_off.shape[0]
    dev = f.device
    live = ((child_slot >= 0) & (child_slot < batch) & (child_off >= 0)
            & (child_off < pool_len))
    # rank of each child among the live children of its slot
    order = torch.argsort(torch.where(live, child_slot, batch), stable=True)
    sorted_slot = torch.where(live, child_slot, batch)[order]
    first = torch.searchsorted(sorted_slot, sorted_slot, right=False)
    rank = torch.empty(nc, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(nc, device=dev) - first
    ii = torch.arange(ub, device=dev)
    flat = f.view(-1)
    n_rounds = int(rank[live].max()) + 1 if bool(live.any()) else 0
    for k in range(n_rounds):
        cs = torch.nonzero(live & (rank == k)).squeeze(1)
        src = (child_off[cs, None, None] + ii[None, :, None] * ub
               + ii[None, None, :])
        vals = torch.zeros(src.shape, dtype=f.dtype, device=dev)
        inr = src < pool_len
        vals[inr] = pool[src[inr]]
        r = rel[cs]
        ri, rj = r[:, :, None], r[:, None, :]
        hit = (ri >= 0) & (ri < m) & (rj >= 0) & (rj < m)
        dst = child_slot[cs, None, None] * (m * m) + ri * m + rj
        dst, vals = dst[hit], vals[hit]
        flat[dst] = flat[dst] + vals
    return f


def extend_add_(f, pool, m, ub, child_off, child_slot, rel):
    """K1: add one child set's Schur blocks into the parent fronts, in
    place on f (batch, m·m).  For child c (ascending) and positions
    (i, j) of its ub×ub block: ``f[slot[c], rel[c,i]·m + rel[c,j]] +=
    pool[off[c] + i·ub + j]``; rel == m (any rel ≥ m) drops the pair, a
    child with slot ∉ [0, batch) or off ∉ [0, len(pool)) is dropped, a
    pool read past the end reads 0.

    Replaces superlu_dist_tpu/numeric/pallas_kernels.py:extend_add_set_pallas.
    Bound: bytes (one pool read and one front read-modify-write per child
    element).  Design: one CUDA block per (parent slot, band of 32 parent
    rows), so each front position has one writer and no atomics are
    needed; the block walks the children in ascending order with a
    barrier between them (csrc/extend_add.cu)."""
    if f.dim() != 2 or f.shape[1] != m * m:
        raise ValueError(f"f must be (batch, {m}*{m}), got {tuple(f.shape)}")
    nc = child_off.shape[0]
    if (child_off.dim() != 1 or child_slot.shape != (nc,)
            or rel.shape != (nc, ub) or pool.dim() != 1):
        raise ValueError("child_off/child_slot must be (C,), rel (C, ub) "
                         "and pool 1-D")
    if not _on_cuda(f, pool, (child_off, child_slot, rel)):
        return extend_add_plain(f, pool, m, ub, child_off, child_slot, rel)
    batch = f.shape[0]
    if batch == 0 or nc == 0:
        return f
    if -(-m // _BAND_ROWS) > 65535 or batch >= 2 ** 31:
        raise ValueError(f"front size {m} / batch {batch} exceed the grid")
    fn = getattr(_library(), f"slu_extend_add_{_SUFFIX[f.dtype]}")
    stream = torch.cuda.current_stream(f.device).cuda_stream
    _check_launch(fn(f.data_ptr(), pool.data_ptr(), child_off.data_ptr(),
                     child_slot.data_ptr(), rel.data_ptr(), batch, m, ub,
                     nc, pool.shape[0], stream), "extend_add")
    LAUNCHES["extend_add"] += 1
    return f


# ---------------------------------------------------------------------------
# K2: A-entry assembly
# ---------------------------------------------------------------------------

def assemble_plain(f, avals, a_slot, a_flat, a_src):
    """Plain PyTorch A-entry assembly, in place on f (batch, m²)."""
    batch, m2 = f.shape
    n_avals = avals.shape[0]
    keep = (a_slot >= 0) & (a_slot < batch) & (a_flat >= 0) & (a_flat < m2)
    src = a_src[keep]
    ok = (src >= 0) & (src < n_avals)
    vals = torch.zeros(src.shape, dtype=f.dtype, device=f.device)
    vals[ok] = avals[src[ok]]
    dst = a_slot[keep] * m2 + a_flat[keep]
    flat = f.view(-1)
    flat[dst] = flat[dst] + vals
    return f


def assemble_(f, avals, a_slot, a_flat, a_src):
    """K2: ``f[a_slot[e], a_flat[e]] += avals[a_src[e]]`` in place on
    f (batch, m²); a slot ∉ [0, batch) or flat ∉ [0, m²) drops the
    entry, a src ∉ [0, len(avals)) reads 0.  Targets are unique.

    Replaces superlu_dist_tpu/numeric/pallas_kernels.py:assemble_avals_pallas.
    Bound: bytes, and launch latency at the main path's sizes.  Design:
    one thread per entry; unique targets need no slot sort and no
    atomics (csrc/assemble.cu)."""
    n = a_slot.shape[0]
    if f.dim() != 2 or avals.dim() != 1 or a_flat.shape != (n,) \
            or a_src.shape != (n,) or a_slot.dim() != 1:
        raise ValueError("f must be (batch, m*m), avals and the maps 1-D "
                         "of one length")
    if not _on_cuda(f, avals, (a_slot, a_flat, a_src)):
        return assemble_plain(f, avals, a_slot, a_flat, a_src)
    if n == 0 or f.shape[0] == 0:
        return f
    fn = getattr(_library(), f"slu_assemble_{_SUFFIX[f.dtype]}")
    stream = torch.cuda.current_stream(f.device).cuda_stream
    _check_launch(fn(f.data_ptr(), avals.data_ptr(), a_slot.data_ptr(),
                     a_flat.data_ptr(), a_src.data_ptr(), n, f.shape[0],
                     f.shape[1], avals.shape[0], stream), "assemble")
    LAUNCHES["assemble"] += 1
    return f
