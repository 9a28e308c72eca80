"""The hand-written CUDA kernels of the factor path, for Hopper.

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

The panel LU's column loop — the column step the JAX package runs inside
each group's compiled program (superlu_dist_tpu/ops/dense.py
``_blocked_partial_factor``) — is ``csrc/panel_lu.cu``, two launches per
PANEL_CHUNK pivot steps of a panel (the chunk's pivot rows in one
block's registers, then every other row replayed from their snapshot;
``panel_lu_``; plain version ``panel_lu_plain``).

The kernels are built for float32, float64, complex64 and complex128; a
complex add is two real adds, one per component, in the kernel as in
torch, and the panel LU spells its complex products and quotients out by
parts in both versions.  Beside each kernel sits its plain PyTorch
version.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback between the two.  Each launch adds
one to ``LAUNCHES[name]``, so a run can show that it went through the
kernel.  The kernels equal the plain versions bit for bit: every front
position receives the same adds in the same order (identity, A entry,
then the children in set order and child order), and one block owns each
position; every panel element the same rounded operations in the same
order.

Each kernel is also a registered op (``slu::front_assemble``,
``extend_add``, ``assemble``, ``panel_lu``; ``csr_spmv`` in
parallel/dist.py) with a fake implementation, so a program walk on fake
tensors (analysis/program.py, the runtime audits) sees a launch as one
op; real tensors reach the launches directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from superlu_dist_tpu_torch.obs.compilestats import record_build

#: kernel launches since the last reset, per wrapper (``csr_spmv`` is the
#: refinement residual's kernel, parallel/dist.py; ``panel_lu`` counts one
#: per panel, its launches together: two per PANEL_CHUNK pivot steps)
LAUNCHES = {"front_assemble": 0, "extend_add": 0, "assemble": 0,
            "csr_spmv": 0, "panel_lu": 0}

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
_panel_fns = {}        # dtype -> csrc/panel_lu.cu's launch function
_panel_ready = set()   # devices whose panel_lu shared-memory limit is set


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
    these exact sources, the headers beside them (``csrc/*.cuh``) and
    flags exists.  Raises on any failure.  The build, or the hit, is one
    record of the build census (site ``kernels.build``, key the hash)."""
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    key = digest.hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / "libslu_torch_kernels.so"
    hit = lib.exists()
    if not hit:
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        # one build per directory at a time (the ranks of a grid on one
        # host start together); the lock is the open file's, released
        # when its holder exits
        with open(out_dir / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            hit = lib.exists()      # built while this process waited
            if not hit:
                _compile(nvcc, srcs, out_dir, lib)
    record_build("kernels.build", key, t0, time.perf_counter() - t0,
                 persistent_hit=hit)
    return lib


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
            fn = getattr(lib, f"slu_panel_lu_{sfx}")
            fn.argtypes = [ptr] * 4 + [i64] * 8 + [ptr]
            fn.restype = ctypes.c_int
            _panel_fns[dtype] = fn
        _lib = lib
    return _lib


def _panel_init(index: int) -> None:
    """csrc/panel_lu.cu's shared-memory limit on device ``index`` (a kernel
    attribute is the device's), once, before the device's first panel —
    which the executors run in a warm-up, outside any CUDA graph
    capture."""
    if index in _panel_ready:
        return
    with torch.cuda.device(index):
        rc = _lib.slu_panel_lu_init()
    if rc != 0:
        raise RuntimeError(f"slu_panel_lu_init failed on cuda:{index}: "
                           f"CUDA error {rc}")
    _panel_ready.add(index)


def _fake(t) -> bool:
    """True for a tensor of a program walk (a FakeTensor, analysis/
    program.py — a torch.Tensor subclass): it holds no memory, so it
    takes the kernel op's fake implementation, which allocates what the
    kernel allocates and launches nothing.  A real tensor reaches the
    launch directly: the op's dispatch would be host time on a
    host-paced FACT (PERF.md §6)."""
    return type(t) is not torch.Tensor


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
        self.device = self.a_bkt.device
        self._ptrs = None

    @property
    def ptrs(self) -> tuple:
        """The maps' addresses, which every launch passes: read once, at
        the first launch (a program walk's fake maps have none)."""
        if self._ptrs is None:
            self._ptrs = tuple(t.data_ptr() for t in self.tensors())
        return self._ptrs

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
    cuda = _on_cuda((pool, avals), (maps.ws,))
    if _fake(pool):
        return torch.ops.slu.front_assemble(
            pool, avals, maps.ws, list(fm.tensors()),
            [fm.batch, m, fm.mc, w, fm.pool_len, fm.pairs, *fm.cols],
            fm.kind)
    if not cuda:
        return front_assemble_plain(avals, pool, m, w, maps)
    return _front_assemble_kernel(avals, pool, w, maps.ws, fm)


def _front_assemble_kernel(avals, pool, w, ws, fm: FrontMaps):
    f = torch.empty((fm.batch, fm.m * fm.mc), dtype=pool.dtype,
                    device=pool.device)
    return launch_(f, fm, pool=pool, avals=avals, ws=ws, w=w)


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
    cuda = _on_cuda((f, pool), (child_off, child_slot, rel))
    if _fake(f):
        torch.ops.slu.extend_add(f, pool, m, ub, child_off, child_slot, rel)
        return f
    if not cuda:
        return extend_add_plain(f, pool, m, ub, child_off, child_slot, rel)
    return _extend_add_kernel(f, pool, m, ub, child_off, child_slot, rel)


def _extend_add_kernel(f, pool, m, ub, child_off, child_slot, rel):
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
    cuda = _on_cuda((f, avals), (a_slot, a_flat, a_src))
    m = int(round(f.shape[1] ** 0.5))
    if cuda and m * m != f.shape[1]:
        raise ValueError(f"f's rows must hold square fronts, got {f.shape[1]}")
    if _fake(f):
        torch.ops.slu.assemble(f, avals, a_slot, a_flat, a_src)
        return f
    if not cuda:
        return assemble_plain(f, avals, a_slot, a_flat, a_src)
    return _assemble_kernel(f, avals, a_slot, a_flat, a_src)


def _assemble_kernel(f, avals, a_slot, a_flat, a_src):
    m = int(round(f.shape[1] ** 0.5))
    maps = build_front_maps(f.shape[0], m, 0, device=f.device,
                            kind="assemble",
                            a=(_host(a_slot), _host(a_flat), _host(a_src)))
    return launch_(f, maps, avals=avals)


# ---------------------------------------------------------------------------
# the panel LU's column loop, in place
# ---------------------------------------------------------------------------

#: the widest panel the kernel takes (ops/dense.py ``_PANEL_BLOCK``)
PANEL_MAX = 128
#: pivot steps a launch pair of csrc/panel_lu.cu runs (its ``kChunk``): the
#: pivot rows of a chunk are what one block holds in registers
PANEL_CHUNK = 32


def _fix_pivot(piv: torch.Tensor, thresh: torch.Tensor):
    """GESP tiny-pivot replacement of real pivots: piv -> sign(piv)·thresh
    if |piv| < thresh (a zero one becomes +thresh).  Returns (pivots,
    int32 tiny flags)."""
    ap = piv.abs()
    safe = torch.where(ap == 0, torch.ones_like(ap), ap)
    unit = torch.where(ap == 0, torch.ones_like(piv), piv / safe)
    tiny = ap < thresh
    return torch.where(tiny, unit * thresh, piv), tiny.to(torch.int32)


def _fix_pivot_parts(pr, pi, thresh):
    """``_fix_pivot`` of complex pivots given by parts: |piv| is
    hypot(re, im), a replaced pivot keeps its phase (re/|piv|, im/|piv|)
    times thresh, a zero one becomes +thresh.  Returns (re, im, int32 tiny
    flags)."""
    ap = torch.hypot(pr, pi)
    z = ap == 0
    safe = torch.where(z, torch.ones_like(ap), ap)
    ur = torch.where(z, torch.ones_like(pr), pr / safe)
    ui = torch.where(z, torch.zeros_like(pi), pi / safe)
    tiny = ap < thresh
    return (torch.where(tiny, ur * thresh, pr),
            torch.where(tiny, ui * thresh, pi), tiny.to(torch.int32))


def _cdiv_parts(ar, ai, cr, ci):
    """(ar + i·ai) / (cr + i·ci) by parts, every operation rounded on its
    own, in c10::complex's order (Smith's method, as numpy divides):
    |cr| >= |ci|: rat = ci/cr, scl = 1/(cr + ci·rat), ((ar + ai·rat)·scl,
    (ai − ar·rat)·scl), and a zero divisor gives (ar/|cr|, ai/|ci|); else
    rat = cr/ci, scl = 1/(ci + cr·rat), ((ar·rat + ai)·scl, (ai·rat −
    ar)·scl)."""
    acr, aci = cr.abs(), ci.abs()
    big = acr >= aci
    rat = torch.where(big, ci / cr, cr / ci)
    scl = torch.reciprocal(torch.where(big, cr + ci * rat, ci + cr * rat))
    re = torch.where(big, ar + ai * rat, ar * rat + ai) * scl
    im = torch.where(big, ai - ar * rat, ai * rat - ar) * scl
    both0 = (acr == 0) & (aci == 0)
    return (torch.where(both0, ar / acr, re), torch.where(both0, ai / aci, im))


def panel_lu_plain(panel, j0, pa, thresh, flags):
    """Plain PyTorch column loop of one panel, in place: masked rank-1
    steps over the panel's pb columns for its pa active pivots j0 ..
    j0+pa-1 (``panel`` a (B, M, pb) view of every row of the fronts;
    rows and pivots are front rows).  Tiny pivots are replaced (GESP) and
    flagged in ``flags`` (B, w) int32.  A complex panel runs the same
    steps by parts (``_panel_lu_parts``)."""
    dev = panel.device
    rows = torch.arange(panel.shape[1], device=dev)
    cols_pb = torch.arange(panel.shape[2], device=dev)
    if panel.dtype.is_complex:
        return _panel_lu_parts(panel, rows, cols_pb, j0, pa, thresh, flags)
    zero = torch.zeros((), dtype=panel.dtype, device=dev)
    for jj in range(pa):
        j = j0 + jj
        col = panel[:, :, jj].clone()
        rowj = panel[:, j, :].clone()
        piv_raw = rowj[:, jj]
        piv, tiny = _fix_pivot(piv_raw, thresh)
        below = rows > j
        l = torch.where(below, col / piv[:, None], zero)
        urow = torch.where(cols_pb > jj, rowj, zero)
        panel -= l[:, :, None] * urow[:, None, :]
        # write the multipliers + fixed pivot into column jj as
        # computed: the JAX version's cur + (new − cur) keeps only
        # eps·|pivot| of a multiplier's relative accuracy (ROADMAP.md)
        panel[:, :, jj] = (torch.where(below, l, col)
                           + (piv - piv_raw)[:, None]
                           * (rows == j).to(panel.dtype))
        flags[:, j] += tiny
    return panel


def _panel_lu_parts(panel, rows, cols_pb, j0, pa, thresh, flags):
    """``panel_lu_plain``'s steps on a complex panel, on its real and
    imaginary parts (views into it): the pivot's modulus is hypot, the
    quotient ``_cdiv_parts``, the product (lr·ur − li·ui, lr·ui + li·ur)
    subtracted by parts, the pivot's correction times the real 0/1 row
    mask by parts — the kernel's order (csrc/panel_lu.cu), every operation
    rounded on its own."""
    parts = torch.view_as_real(panel)
    re, im = parts[..., 0], parts[..., 1]
    zero = torch.zeros((), dtype=re.dtype, device=re.device)
    for jj in range(pa):
        j = j0 + jj
        cr, ci = re[:, :, jj].clone(), im[:, :, jj].clone()
        rr, ri = re[:, j, :].clone(), im[:, j, :].clone()
        raw_r, raw_i = rr[:, jj], ri[:, jj]
        pr, pi, tiny = _fix_pivot_parts(raw_r, raw_i, thresh)
        below = rows > j
        qr, qi = _cdiv_parts(cr, ci, pr[:, None], pi[:, None])
        lr = torch.where(below, qr, zero)[:, :, None]
        li = torch.where(below, qi, zero)[:, :, None]
        keep = cols_pb > jj
        ur = torch.where(keep, rr, zero)[:, None, :]
        ui = torch.where(keep, ri, zero)[:, None, :]
        re -= lr * ur - li * ui
        im -= lr * ui + li * ur
        e = (rows == j).to(re.dtype)
        re[:, :, jj] = torch.where(below, lr[:, :, 0], cr) \
            + (pr - raw_r)[:, None] * e
        im[:, :, jj] = torch.where(below, li[:, :, 0], ci) \
            + (pi - raw_i)[:, None] * e
        flags[:, j] += tiny
    return panel


def _check_panel(panel, j0, pa, thresh, flags):
    """Raise on arguments neither version takes."""
    if panel.dim() != 3 or panel.dtype not in _SUFFIX:
        raise TypeError(f"panel must be (B, M, pb) in one of "
                        f"{sorted(map(str, _SUFFIX))}, got "
                        f"{tuple(panel.shape)} {panel.dtype}")
    b, m, pb = panel.shape
    if not (0 <= j0 and 1 <= pa <= pb and j0 + pa <= m):
        raise ValueError(f"pivots j0={j0}, pa={pa} outside a panel of "
                         f"{m} rows and {pb} columns")
    if (flags.dtype != torch.int32 or flags.dim() != 2
            or flags.shape[0] != b or flags.shape[1] < j0 + pa):
        raise TypeError(f"flags must be int32 (B, >= {j0 + pa}), got "
                        f"{tuple(flags.shape)} {flags.dtype}")
    if thresh.dim() != 0 or thresh.dtype.is_complex:
        raise TypeError("thresh must be a real 0-d tensor")


def panel_lu_(panel, j0, pa, thresh, flags):
    """The column loop of one panel of the blocked partial LU, in place:
    ``panel_lu_plain``'s function (the column step of
    superlu_dist_tpu/ops/dense.py:_blocked_partial_factor, :299-323).

    ``panel`` is a (B, M, pb) view — a[:, :, j0:j0+pb] of a front batch,
    or a[:, :, k0:k0+pb] of a rank's column share on the 2-D mesh — whose
    columns have unit stride; ``thresh`` a 0-d tensor of the real
    component type on the panel's device (another real type is cast
    there; it is read by pointer, no host sync); ``flags`` (B, w) int32.
    A CPU panel runs ``panel_lu_plain``.  A CUDA panel launches
    ``csrc/panel_lu.cu`` and counts one launch under
    ``LAUNCHES["panel_lu"]``, or raises: a column stride other than 1,
    pb > 128, a failed build or a refused launch.  The kernel runs the
    pivot steps PANEL_CHUNK at a time, two launches a chunk: the chunk's
    pivot rows in one block's registers per front, each step's pivot row
    published behind its own barrier and kept in a snapshot; then every
    other row replayed from that snapshot, a row on 4 or 8 lanes (scratch
    from ``torch.empty`` on the current stream, so a CUDA graph can hold
    it).  Bound: the pivot rows' chain of dependent steps on one SM a
    front at small batch, else the operations of the other rows' steps."""
    _check_panel(panel, j0, pa, thresh, flags)
    devs = {t.device for t in (panel, thresh, flags)}
    if len(devs) != 1:
        raise ValueError(f"panel, thresh and flags lie on several devices: "
                         f"{sorted(map(str, devs))}")
    cuda = panel.device.type == "cuda"
    if _fake(panel):
        torch.ops.slu.panel_lu(panel, thresh, flags, j0, pa)
        return panel
    if not cuda:
        return panel_lu_plain(panel, j0, pa, thresh, flags)
    return panel_launch_(panel, j0, pa, thresh, flags)


def panel_launch_(panel, j0, pa, thresh, flags):
    """Launch ``csrc/panel_lu.cu`` on a CUDA panel (``panel_lu_``'s
    kernel path), or raise."""
    _panel_kernel(panel, j0, pa, thresh, flags)
    return panel


def _panel_kernel(panel, j0, pa, thresh, flags):
    """``panel_launch_``'s launch; returns the kernel's snapshot scratch
    (B, pa, pb + 2), which the launch pair writes and reads."""
    _check_panel(panel, j0, pa, thresh, flags)
    b, m, pb = panel.shape
    dev = panel.device
    if panel.stride(2) != 1 or flags.stride(1) != 1:
        raise ValueError(f"the panel's and the flags' columns must have "
                         f"unit stride, got {panel.stride()} and "
                         f"{flags.stride()}")
    if dev.type != "cuda" or thresh.device != dev or flags.device != dev:
        raise ValueError("the panel LU kernel takes CUDA tensors on one "
                         "device")
    if pb > PANEL_MAX:
        raise ValueError(f"panels of at most {PANEL_MAX} columns, got {pb}")
    snap = torch.empty((b, pa, pb + 2), dtype=panel.dtype, device=dev)
    if b == 0:
        return snap
    real = panel.real.dtype if panel.dtype.is_complex else panel.dtype
    if thresh.dtype != real:
        thresh = thresh.to(real)
    if _lib is None:
        library()
    _panel_init(dev.index if dev.index is not None
                else torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _panel_fns[panel.dtype](
        panel.data_ptr(), thresh.data_ptr(), flags.data_ptr(),
        snap.data_ptr(), b, m, pb, panel.stride(0), panel.stride(1), j0, pa,
        flags.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"panel_lu kernel launch failed: CUDA error {rc}")
    LAUNCHES["panel_lu"] += 1
    return snap


# ---------------------------------------------------------------------------
# the kernels as registered ops: what a program walk sees
# ---------------------------------------------------------------------------
#
# Each kernel is one ``slu::`` op whose implementation is its launch and
# whose fake implementation allocates what the kernel allocates (the
# front batch, the panel's snapshot scratch, y) and launches nothing; the
# schema declares what it writes in place (f, the panel and its flags).
# A program walk (analysis/program.py, on FakeTensors) sees each launch
# as one op.  Real tensors reach the launches directly.

@torch.library.custom_op("slu::front_assemble", mutates_args=())
def _front_assemble_op(pool: torch.Tensor, avals: torch.Tensor | None,
                       ws: torch.Tensor, maps: list[torch.Tensor],
                       dims: list[int], kind: str) -> torch.Tensor:
    batch, m, mc, w, pool_len, pairs, *cols = dims
    fm = FrontMaps(kind, batch, m, pool_len, *maps, pairs=pairs, mc=mc,
                   cols=tuple(cols))
    return _front_assemble_kernel(avals, pool, w, ws, fm)


@_front_assemble_op.register_fake
def _(pool, avals, ws, maps, dims, kind):
    return pool.new_empty((dims[0], dims[1] * dims[2]))


@torch.library.custom_op("slu::extend_add", mutates_args=("f",))
def _extend_add_op(f: torch.Tensor, pool: torch.Tensor, m: int, ub: int,
                   child_off: torch.Tensor, child_slot: torch.Tensor,
                   rel: torch.Tensor) -> None:
    _extend_add_kernel(f, pool, m, ub, child_off, child_slot, rel)


@_extend_add_op.register_fake
def _(f, pool, m, ub, child_off, child_slot, rel):
    return None


@torch.library.custom_op("slu::assemble", mutates_args=("f",))
def _assemble_op(f: torch.Tensor, avals: torch.Tensor, a_slot: torch.Tensor,
                 a_flat: torch.Tensor, a_src: torch.Tensor) -> None:
    _assemble_kernel(f, avals, a_slot, a_flat, a_src)


@_assemble_op.register_fake
def _(f, avals, a_slot, a_flat, a_src):
    return None


@torch.library.custom_op("slu::panel_lu", mutates_args=("panel", "flags"))
def _panel_lu_op(panel: torch.Tensor, thresh: torch.Tensor,
                 flags: torch.Tensor, j0: int, pa: int) -> torch.Tensor:
    return _panel_kernel(panel, j0, pa, thresh, flags)


@_panel_lu_op.register_fake
def _(panel, thresh, flags, j0, pa):
    return panel.new_empty((panel.shape[0], pa, panel.shape[2] + 2))
