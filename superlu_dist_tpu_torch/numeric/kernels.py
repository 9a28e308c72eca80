"""The front assembly of the factor path, hand-written for Hopper.

The JAX package assembles each dispatch group's fronts with two Pallas
kernels on the TPU (superlu_dist_tpu/numeric/pallas_kernels.py): the
A-entry assembly (``assemble_avals_pallas``) and one extend-add per child
set (``extend_add_set_pallas``), after a zero fill and the identity
padding.  Here one CUDA C++ kernel, ``csrc/front_assemble.cu`` (compiled at
first use by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``), does all of it in one launch per
group, on maps built once per plan on the host (``build_front_maps``):

* ``front_assemble_`` — a group's whole front batch (build mode), or
  one rank's column share of it on the mesh tier's 2-D grid
  (parallel/mesh_stream.py: (batch, m, mc) fronts of the rank's columns,
  maps from ``front_map_arrays(..., cols=)``);
* ``extend_add_`` / ``assemble_`` — the two TPU kernels' functions with
  their JAX signatures, in place on ``f``: the same kernel in accumulate
  mode, on maps built from their arguments at each call.

The kernel is built for float32, float64, complex64 and complex128; a
complex add is two real adds, one per component, in the kernel as in
torch.  Beside each sits its plain PyTorch version.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises — there is
no fallback between the two.  Each launch adds one to ``LAUNCHES[name]``, so
a run can show that it went through the kernel.  The kernel equals the
plain versions bit for bit: every front position receives the same adds
in the same order (identity, A entry, then the children in set order and
child order), and one block owns each position.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

#: kernel launches since the last reset, per wrapper (``csr_spmv`` is the
#: refinement residual's kernel, parallel/dist.py)
LAUNCHES = {"front_assemble": 0, "extend_add": 0, "assemble": 0,
            "csr_spmv": 0}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build outputs, keyed by a hash of the sources and flags (kept out of git)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
BUCKET = 64            # csrc/front_assemble.cu kBucket
#: the kernel's instantiations (csrc/front_assemble.cu), by dtype
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex64: "c64", torch.complex128: "c128"}

_lib = None
_fns = {}              # dtype -> the library's launch function


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
    # one build per directory at a time (the ranks of a grid on one host
    # start together); the lock is the open file's, released when its
    # holder exits
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():            # built while this process waited
            return lib
        return _compile(nvcc, srcs, out_dir, lib)


def _compile(nvcc, srcs, out_dir, lib) -> Path:
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


def library():
    """The loaded kernel library (every ``csrc/*.cu``), built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for dtype, sfx in _SUFFIX.items():
            fn = getattr(lib, f"slu_front_assemble_{sfx}")
            fn.argtypes = [ptr] * 10 + [i64] * 10 + [ptr]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        _lib = lib
    return _lib


def _on_cuda(values, index) -> bool:
    """True for the kernel path, False for the plain version; raises on
    mixed devices or on inputs the kernel does not take.  ``values`` are
    the float tensors (None for an absent one), ``index`` the int64 maps."""
    values = [v for v in values if v is not None]
    devs = {t.device for t in (*values, *index)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    if values[0].dtype not in _SUFFIX or any(v.dtype != values[0].dtype
                                             for v in values):
        raise TypeError("the value inputs must share one of "
                        f"{sorted(map(str, _SUFFIX))}, got "
                        f"{[v.dtype for v in values]}")
    if not all(v.is_contiguous() for v in values):
        raise ValueError("the float inputs must be contiguous")
    for t in index:
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError("index maps must be contiguous int64 tensors")
    return values[0].device.type == "cuda"


# ---------------------------------------------------------------------------
# the kernel's maps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrontMaps:
    """One group's maps for ``csrc/front_assemble.cu`` on one device (the
    layout is documented at the head of that file).  Every sentinel is
    dropped while the maps are built, so the kernel checks none of them
    but the pool and avals bounds."""

    kind: str               # the LAUNCHES key a launch on these maps counts
    batch: int
    m: int
    pool_len: int
    a_bkt: torch.Tensor     # (batch, nb+1) int64
    a_ent: torch.Tensor     # (na, 2) int64: flat target, src
    ch_ptr: torch.Tensor    # (batch+1,) int64
    ch_rec: torch.Tensor    # (nch, 6) int64: off, pool row stride, row rel
                            # start, row bkt start, col rel start, col bkt
                            # start
    rel: torch.Tensor       # (npos, 2) int32: front position, child index
    ch_bkt: torch.Tensor    # int32: per child nb+1 row, nbc+1 col buckets
    pairs: int              # child pairs added (pool values read)
    mc: int = None          # columns of a front (None: m, a whole front)
    cols: tuple = (1, 1, 0)  # a column share's (pb, npcol, pcol): local
                             # column c is global ((c // pb) · npcol +
                             # pcol) · pb + c % pb

    def __post_init__(self):
        if self.mc is None:
            self.mc = self.m
        # the launch passes these on every call: take them once
        self.device = self.a_bkt.device
        self.ptrs = tuple(t.data_ptr() for t in self.tensors())

    def tensors(self):
        return (self.a_bkt, self.a_ent, self.ch_ptr, self.ch_rec, self.rel,
                self.ch_bkt)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    @property
    def n_a(self) -> int:
        return int(self.a_ent.shape[0])


def _i64(x):
    return np.asarray(x, dtype=np.int64)


def _sorted_unique(key, rows, message):
    """key ascending with rows beside it (most plans come sorted already);
    raises ValueError(message) on a repeated key."""
    if not np.all(key[1:] > key[:-1]):
        order = np.argsort(key, kind="stable")
        key, rows = key[order], rows[order]
        if np.any(key[1:] == key[:-1]):
            raise ValueError(message)
    return key, rows


def share_cols(m: int, cols, share) -> tuple:
    """A column share's (pb, npcol, pcol) — the kernel's arithmetic for a
    local column's global index — checked against its ascending global
    columns ``cols`` of an m-column front; (1, 1, 0) for the whole front
    (``cols`` None).  Raises ValueError when they disagree."""
    if cols is None:
        return (1, 1, 0)
    pb, npcol, pcol = (int(x) for x in share)
    c = np.arange(len(cols))
    if not (pb >= 1 and 0 <= pcol < npcol and np.array_equal(
            _i64(cols), ((c // pb) * npcol + pcol) * pb + c % pb)):
        raise ValueError(f"columns {list(cols)[:8]}... are not the share "
                         f"(pb={pb}, npcol={npcol}, pcol={pcol}): local "
                         "column c is global ((c // pb) * npcol + pcol) * "
                         "pb + c % pb")
    return (pb, npcol, pcol)


def front_map_arrays(batch: int, m: int, pool_len: int, a=None,
                     children=(), cols=None):
    """The kernel's maps of one group as numpy arrays (a_bkt, a_ent,
    ch_ptr, ch_rec, rel, ch_bkt), and the number of child pairs.

    ``a`` is (a_slot, a_flat, a_src) or None (``a_flat`` = row·m +
    column); ``children`` is a list of child sets in set order, each
    (ub, child_off, child_slot, rel) — child c adds pool[off[c] + i·ub +
    j] at (rel[c,i], rel[c,j]) — or, for a column share, (ub, child_off,
    child_slot, rel, crel, stride): pool[off[c] + i·stride[c] + k] at
    (rel[c,i], local column crel[c,k]).  ``cols`` (ascending global
    columns; None: all m) makes the maps those of a column share, fronts
    of mc = len(cols) columns: A entries outside it are dropped and the
    rest renumbered.  A entries with a slot outside [0, batch) or a flat target
    outside [0, m²), child sets' children with a slot outside [0, batch)
    or an offset outside [0, pool_len), rel entries outside [0, m) and
    crel entries outside [0, mc) are dropped here.  Raises ValueError on
    repeated A targets or a child with a repeated position (the kernel,
    like the TPU kernels, needs them distinct)."""
    mc = m if cols is None else len(cols)
    loc = None
    if cols is not None:
        loc = np.full(m + 1, -1, dtype=np.int64)
        loc[_i64(cols)] = np.arange(mc)
    nb = -(-m // BUCKET)
    edges = np.minimum(np.arange(nb + 1, dtype=np.int64) * BUCKET, m)
    nbc = -(-mc // BUCKET)
    edges_c = np.minimum(np.arange(nbc + 1, dtype=np.int64) * BUCKET, mc)

    a_slot, a_flat, a_src = ((_i64(x).ravel() for x in a) if a is not None
                             else (np.zeros(0, np.int64),) * 3)
    keep = (a_slot >= 0) & (a_slot < batch) & (a_flat >= 0) & (a_flat < m * m)
    if not keep.all():
        a_slot, a_flat, a_src = a_slot[keep], a_flat[keep], a_src[keep]
    if loc is not None:
        lc = loc[a_flat % m]
        own = lc >= 0
        a_slot, a_src = a_slot[own], a_src[own]
        a_flat = (a_flat[own] // m) * mc + lc[own]
    key = a_slot * (m * mc) + a_flat
    key, a_ent = _sorted_unique(key, np.stack([a_flat, a_src], axis=1),
                                "A-entry targets must be unique")
    a_bkt = np.searchsorted(key, np.arange(batch, dtype=np.int64)[:, None]
                            * (m * mc) + edges[None, :] * mc)

    recs, slots, rels, bkts = [], [], [], []
    n_rel = n_bkt = pairs = 0
    for child in children:
        ub, off, slot, rel = child[:4]
        off, slot = _i64(off).ravel(), _i64(slot).ravel()
        rel = _rows(rel, len(off))
        live = (slot >= 0) & (slot < batch) & (off >= 0) & (off < pool_len)
        ci, ii, ent, has, start, bk, counts = _child_entries(rel, m, live,
                                                             edges)
        if len(child) > 4:
            crel, stride = _rows(child[4], len(off)), _i64(child[5]).ravel()
            _, _, ent_c, has_c, start_c, bk_c, counts_c = _child_entries(
                crel, mc, live, edges_c)
            both = np.intersect1d(has, has_c)
            pick = np.searchsorted(has, both)
            pick_c = np.searchsorted(has_c, both)
            row_start, row_bk = start[pick], bk[pick]
            col_start, col_bk = start_c[pick_c] + len(ent), bk_c[pick_c]
            per = (nb + 1) + (nbc + 1)
            bkt_at = n_bkt + np.arange(len(both)) * per
            recs.append(np.stack([off[both], stride[both],
                                  n_rel + row_start, bkt_at,
                                  n_rel + col_start, bkt_at + nb + 1],
                                 axis=1))
            slots.append(slot[both])
            rels.append(np.concatenate([ent, ent_c]))
            bkts.append(np.concatenate([row_bk, col_bk], axis=1).ravel())
            pairs += int((counts[both] * counts_c[both]).sum())
            n_rel += len(ent) + len(ent_c)
            n_bkt += len(both) * per
            continue
        recs.append(np.stack([off[has], np.full(len(has), int(ub)),
                              n_rel + start,
                              n_bkt + np.arange(len(has)) * (nb + 1),
                              n_rel + start,
                              n_bkt + np.arange(len(has)) * (nb + 1)],
                             axis=1))
        slots.append(slot[has])
        rels.append(ent)
        bkts.append(bk.ravel())
        pairs += int((counts[has] ** 2).sum())
        n_rel += len(ent)
        n_bkt += len(has) * (nb + 1)
    ch_slot = np.concatenate(slots) if slots else np.zeros(0, np.int64)
    order = np.argsort(ch_slot, kind="stable")
    ch_rec = (np.concatenate(recs)[order] if recs
              else np.zeros((0, 6), np.int64))
    ch_ptr = np.searchsorted(ch_slot[order], np.arange(batch + 1))

    rel = np.concatenate(rels) if rels else np.zeros((0, 2), np.int64)
    ch_bkt = np.concatenate(bkts) if bkts else np.zeros(0, np.int64)
    return ([a_bkt, a_ent, ch_ptr, ch_rec, rel.astype(np.int32),
             ch_bkt.astype(np.int32)], pairs)


def _rows(x, n):
    """``x`` as an int64 (n, k) array (k = 0 for an empty one)."""
    x = _i64(x)
    return x.reshape(n, -1) if x.size else x.reshape(n, 0)


def _child_entries(rel, m, live, edges):
    """One child set's real (position, child index) entries along one
    axis of m positions: (child of each entry, its index, the entries
    sorted by child then position, the children with any, each one's
    first entry, its bucket starts relative to that, entries per child)."""
    real = (rel >= 0) & (rel < m) & live[:, None]
    ci, ii = np.nonzero(real)
    pos = rel[real]
    key, ent = _sorted_unique(ci * (m + 1) + pos, np.stack([pos, ii], 1),
                              "a child's rel positions must be distinct")
    counts = np.bincount(ci, minlength=len(rel))
    has = np.nonzero(counts)[0]
    start = np.searchsorted(key, has * (m + 1))
    bk = (np.searchsorted(key, has[:, None] * (m + 1) + edges[None, :])
          - start[:, None])
    return ci, ii, ent, has, start, bk, counts


def upload(arrays, device) -> list:
    """int64 and int32 numpy arrays on ``device`` in one host-to-device
    copy per dtype: views of one buffer each, every view starting on a
    16-byte boundary (the kernel reads rel as 8-byte pairs)."""
    out = [None] * len(arrays)
    for dtype in (np.int64, np.int32):
        idx = [i for i, x in enumerate(arrays) if x.dtype == dtype]
        step = 16 // np.dtype(dtype).itemsize
        parts, starts, at = [np.zeros(0, dtype)], [], 0
        for i in idx:
            starts.append(at)
            parts.append(arrays[i].ravel())
            pad = -arrays[i].size % step
            if pad:
                parts.append(np.zeros(pad, dtype))
            at += arrays[i].size + pad
        buf = torch.as_tensor(np.concatenate(parts), device=device)
        for i, st in zip(idx, starts):
            out[i] = buf[st:st + arrays[i].size].view(arrays[i].shape)
    if any(x is None for x in out):
        raise TypeError("upload takes int64 and int32 arrays only")
    return out


def build_front_maps(batch: int, m: int, pool_len: int, a=None, children=(),
                     *, device, kind: str = "front_assemble",
                     cols=None, share=None) -> FrontMaps:
    """The kernel's maps of one group on ``device``, from numpy index maps
    (``front_map_arrays``, then ``upload``); ``cols`` a column share's
    global columns, ``share`` its (pb, npcol, pcol) (``share_cols``)."""
    arrays, pairs = front_map_arrays(batch, m, pool_len, a, children, cols)
    return FrontMaps(kind, int(batch), int(m), int(pool_len),
                     *upload(arrays, device), pairs=pairs,
                     mc=m if cols is None else len(cols),
                     cols=share_cols(m, cols, share))


@dataclasses.dataclass
class GroupMaps:
    """One group's index maps on the device (uploaded once per plan): the
    plan's own maps, which the plain versions read, and the kernel's."""

    ws: torch.Tensor
    off: torch.Tensor
    a_slot: torch.Tensor
    a_flat: torch.Tensor
    a_src: torch.Tensor
    children: list          # [(ub, child_off, child_slot, rel)], or for a
                            # column share [(ub, off, slot, rel, crel,
                            # stride)] (``front_map_arrays``)
    front: FrontMaps
    keep: torch.Tensor = None   # slots written back to the pool (None:
                                # all of them)
    gcol: torch.Tensor = None   # a column share's global columns (None:
                                # the whole front; a_flat is row·mc + local
                                # column)


def launch_(f, maps: FrontMaps, pool=None, avals=None, ws=None, w=0):
    """Launch ``csrc/front_assemble.cu`` on prebuilt maps, into f
    (batch, m·mc) on the card.  With ``ws`` (the slots' real pivot widths)
    the kernel builds the fronts from nothing (identity padding on columns
    [ws, w)); without it, it adds into f.  Counts one launch under
    ``LAUNCHES[maps.kind]``.  Raises on a refused launch."""
    batch, m, mc = maps.batch, maps.m, maps.mc
    dev = f.device
    if dev.type != "cuda" or f.dtype not in _SUFFIX \
            or not f.is_contiguous() or f.shape != (batch, m * mc):
        raise ValueError(f"f must be a contiguous CUDA tensor of shape "
                         f"({batch}, {m}*{mc}) in one of "
                         f"{sorted(map(str, _SUFFIX))}")
    if maps.device != dev or any(t is not None and t.device != dev
                                 for t in (pool, avals, ws)):
        raise ValueError("f, its inputs and the maps must share a device")
    for t in (pool, avals):
        if t is not None and (t.dtype != f.dtype or not t.is_contiguous()):
            raise TypeError("pool and avals must be contiguous, of f's dtype")
    pool_len = 0 if pool is None else pool.shape[0]
    if maps.pairs and pool_len != maps.pool_len:
        raise ValueError(f"the maps were built for a pool of {maps.pool_len}"
                         f" values, not {pool_len}")
    if ws is not None and (ws.shape != (batch,) or ws.dtype != torch.int64):
        raise ValueError("ws must be (batch,) int64")
    if batch == 0 or mc == 0:
        return f

    def p(t):
        return 0 if t is None else t.data_ptr()

    if _lib is None:
        library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fns[f.dtype](f.data_ptr(), p(pool), p(avals), p(ws), *maps.ptrs,
                       batch, m, mc, w, pool_len,
                       0 if avals is None else avals.shape[0],
                       *maps.cols, int(ws is None), stream)
    if rc != 0:
        raise RuntimeError(f"front_assemble kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[maps.kind] += 1
    return f


def _host(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the group's fronts from nothing
# ---------------------------------------------------------------------------

def front_assemble_plain(avals, pool, m, w, maps: GroupMaps):
    """Plain PyTorch front assembly of one group: zeros, the identity
    padding, the A entries (``assemble_plain``), then each child set in
    order (``extend_add_plain``).  Returns the (batch, m²) front batch, or
    for a column share (``maps.gcol``) the (batch, m·mc) batch of its
    columns."""
    batch = maps.ws.shape[0]
    dev = pool.device
    g = torch.arange(m, device=dev) if maps.gcol is None else maps.gcol
    mc = g.shape[0]
    f = torch.zeros((batch, m * mc), dtype=pool.dtype, device=dev)
    # identity columns for pivot-block padding (cols ws..w), so padded
    # batch slots (ws == 0) become identity fronts: row g[c] of local
    # column c is its diagonal
    diag = (g[None, :] >= maps.ws[:, None]) & (g[None, :] < w)
    tgt = g * mc + torch.arange(mc, device=dev)
    f[:, tgt] += diag.to(f.dtype)
    if maps.a_src.shape[0]:
        assemble_plain(f, avals, maps.a_slot, maps.a_flat, maps.a_src)
    for child in maps.children:
        if len(child) == 4:
            ub, off, cslot, rel = child
            _extend_add_rounds(f, pool, m, mc, off, cslot, rel, rel, None,
                               ub)
        else:
            ub, off, cslot, rel, crel, stride = child
            _extend_add_rounds(f, pool, m, mc, off, cslot, rel, crel, stride)
    return f


def front_assemble_(avals, pool, m, w, maps: GroupMaps):
    """One group's front batch (batch, m²), built from nothing: +0.0, 1.0
    on the diagonal in columns [ws, w), the A entries, then the children
    of every set in order — ``front_assemble_plain``'s function.

    Replaces superlu_dist_tpu/numeric/pallas_kernels.py:assemble_avals_pallas
    and :extend_add_set_pallas with the zero fill and identity padding
    around them.  Bound: bytes (one write of each front element, one read
    of each pool value, A value and map entry used).  Design: one block per
    (slot, 64 KB front tile) in shared memory, stored once; see
    csrc/front_assemble.cu.  The batch comes from ``torch.empty``: the
    kernel writes every element."""
    fm = maps.front
    if fm.m != m:
        raise ValueError(f"the maps were built for m={fm.m}, not {m}")
    if not _on_cuda((pool, avals), (maps.ws,)):
        return front_assemble_plain(avals, pool, m, w, maps)
    f = torch.empty((fm.batch, m * fm.mc), dtype=pool.dtype,
                    device=pool.device)
    return launch_(f, fm, pool=pool, avals=avals, ws=maps.ws, w=w)


# ---------------------------------------------------------------------------
# K1: extend-add of one child set, in place
# ---------------------------------------------------------------------------

def extend_add_plain(f, pool, m, ub, child_off, child_slot, rel):
    """Plain PyTorch extend-add, in place on f (batch, m·m).

    Children are applied in rounds: round k takes the k-th child (in
    ascending child order) of every parent slot, so no round has two
    writers to one position and the per-position order is ascending in
    the child index — the arithmetic of the kernel and of the JAX
    package's in-order ``.at[].add`` scatter."""
    return _extend_add_rounds(f, pool, m, m, child_off, child_slot, rel, rel,
                              None, ub)


def _extend_add_rounds(f, pool, m, mc, child_off, child_slot, rel, crel,
                       stride, ub=None):
    """The rounds of ``extend_add_plain`` on (batch, m·mc) fronts: child c
    adds pool[off[c] + i·stride[c] + k] at row rel[c, i], local column
    crel[c, k] (``stride`` None: ub for every child, the whole front's
    square blocks)."""
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
    ii = torch.arange(rel.shape[1], device=dev)
    kk = torch.arange(crel.shape[1], device=dev)
    flat = f.view(-1)
    n_rounds = int(rank[live].max()) + 1 if bool(live.any()) else 0
    for k in range(n_rounds):
        cs = torch.nonzero(live & (rank == k)).squeeze(1)
        st = ub if stride is None else stride[cs, None, None]
        src = (child_off[cs, None, None] + ii[None, :, None] * st
               + kk[None, None, :])
        vals = torch.zeros(src.shape, dtype=f.dtype, device=dev)
        inr = src < pool_len
        vals[inr] = pool[src[inr]]
        ri, rj = rel[cs][:, :, None], crel[cs][:, None, :]
        hit = (ri >= 0) & (ri < m) & (rj >= 0) & (rj < mc)
        dst = child_slot[cs, None, None] * (m * mc) + ri * mc + rj
        dst, vals = dst[hit], vals[hit]
        flat[dst] = flat[dst] + vals
    return f


def extend_add_(f, pool, m, ub, child_off, child_slot, rel):
    """K1: add one child set's Schur blocks into the parent fronts, in
    place on f (batch, m·m).  For child c (ascending) and positions
    (i, j) of its ub×ub block: ``f[slot[c], rel[c,i]·m + rel[c,j]] +=
    pool[off[c] + i·ub + j]``; rel ∉ [0, m) drops the pair, a child with
    slot ∉ [0, batch) or off ∉ [0, len(pool)) is dropped, a pool read past
    the end reads 0.  A child's real rel positions must be distinct.

    Replaces superlu_dist_tpu/numeric/pallas_kernels.py:extend_add_set_pallas.
    On the card: ``csrc/front_assemble.cu`` in accumulate mode, on maps
    built from the arguments on the host at each call (the main path
    builds its maps once per plan and runs ``front_assemble_``)."""
    if f.dim() != 2 or f.shape[1] != m * m:
        raise ValueError(f"f must be (batch, {m}*{m}), got {tuple(f.shape)}")
    nc = child_off.shape[0]
    if (child_off.dim() != 1 or child_slot.shape != (nc,)
            or rel.shape != (nc, ub) or pool.dim() != 1):
        raise ValueError("child_off/child_slot must be (C,), rel (C, ub) "
                         "and pool 1-D")
    if not _on_cuda((f, pool), (child_off, child_slot, rel)):
        return extend_add_plain(f, pool, m, ub, child_off, child_slot, rel)
    maps = build_front_maps(
        f.shape[0], m, pool.shape[0], device=f.device, kind="extend_add",
        children=[(ub, _host(child_off), _host(child_slot), _host(rel))])
    return launch_(f, maps, pool=pool)


# ---------------------------------------------------------------------------
# K2: A-entry assembly, in place
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
    On the card: ``csrc/front_assemble.cu`` in accumulate mode, on maps
    built from the arguments on the host at each call."""
    n = a_slot.shape[0]
    if f.dim() != 2 or avals.dim() != 1 or a_flat.shape != (n,) \
            or a_src.shape != (n,) or a_slot.dim() != 1:
        raise ValueError("f must be (batch, m*m), avals and the maps 1-D "
                         "of one length")
    if not _on_cuda((f, avals), (a_slot, a_flat, a_src)):
        return assemble_plain(f, avals, a_slot, a_flat, a_src)
    m = int(round(f.shape[1] ** 0.5))
    if m * m != f.shape[1]:
        raise ValueError(f"f's rows must hold square fronts, got {f.shape[1]}")
    maps = build_front_maps(f.shape[0], m, 0, device=f.device,
                            kind="assemble",
                            a=(_host(a_slot), _host(a_flat), _host(a_src)))
    return launch_(f, maps, avals=avals)
