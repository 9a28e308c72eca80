"""Program-level audit — the torch counterpart of the JAX package's
``analysis/program.py`` (its jaxpr tier).

slulint reads SOURCE; what runs on the card is a program: one group's
``group_step``, a fused or level wave, a mega bucket, a solve sweep, a
grid's group.  Its hazards — a dead Schur pool copied where it should be
updated in place, a per-matrix tensor a CUDA graph bakes by address, a
collective sequence that differs between ranks, a narrowing copy or a
GEMM outside the ladder, a gathered buffer on every rank, a peak above
the card's memory — show in the program, not in the source.  The JAX
package walks each jitted program's closed jaxpr.  The port has no
jaxpr, so :func:`trace_spec` runs the program once on FakeTensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes,
devices and strides, no memory, no device work) under a recording
``TorchDispatchMode``: every aten op and every kernel op of
``numeric/kernels.py`` / ``parallel/dist.py`` (``slu::*``, one op a
kernel, through its fake implementation) becomes an :class:`OpRecord`,
every ``ProcessGrid`` collective a :class:`CollectiveRec`.  A fake tensor
on ``device="cuda"`` takes the port's CUDA path — the kernel branches,
the TF32 switch, the bf16 route — with no card, so the CPU tests audit
the card's programs.

The peak-memory walk is eager PyTorch's own lifetime rule: every op
output goes live at its op, and a ``weakref.finalize`` on its storage
retires it when Python drops the last reference (the caching allocator
frees a block at that moment too).  The arguments are live throughout
(the caller holds them) and so is a tensor from outside the arguments.

Layering: this module and ``utils/programaudit.py`` are the only ones
that import the fake-tensor machinery, lazily (inside
:func:`trace_spec`); the rule halves in ``rules_program.py``,
``rules_precision.py`` and ``rules_sharding.py`` walk plain records and
import no torch, and the slulint CLI never imports this module.

The runtime twin is ``utils/programaudit.py`` (``SLU_TPU_VERIFY_PROGRAMS``
/ ``_DTYPES`` / ``_SHARDING`` / ``SLU_TPU_MEM_BUDGET_BYTES``): the
executors submit each program once before it first runs, and a finding
raises a structured error before any device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import math
import threading
import types
import weakref

from superlu_dist_tpu_torch.parallel.grid import AXES as GRID_AXES

#: ProcessGrid collectives that deliver whole gathered buffers to every
#: rank of their communicator (SLU119's subject)
GATHERING_COLLECTIVES = frozenset({"all_gather", "gather_rows"})


@dataclasses.dataclass(frozen=True)
class TensorRec:
    """One tensor an op read or returned."""

    shape: tuple
    dtype: object              # torch.dtype
    nbytes: int                # the tensor's own bytes (numel · itemsize)
    storage: int               # its storage's serial (unique in one walk)
    storage_bytes: int
    source: str                # "arg", "outside" or "op"

    def short(self) -> str:
        return f"{self.dtype}{list(self.shape)}".replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its overload name (``aten.mm.default``,
    ``slu.panel_lu.default``), its tensor inputs in schema order, which
    of them it writes (the schema's alias info), its tensor outputs and
    which of those hold a storage it allocated."""

    op: str
    inputs: tuple
    writes: tuple
    outputs: tuple
    fresh: tuple

    @property
    def name(self) -> str:
        """The op's packet name: ``mm`` of ``aten.mm.default``."""
        parts = self.op.split(".")
        return parts[1] if len(parts) > 1 else self.op


@dataclasses.dataclass(frozen=True)
class CollectiveRec:
    """One ProcessGrid collective the program entered: its method, the
    grid axes its communicator spans, and what it delivers here."""

    op: str
    axes: tuple
    nbytes: int
    shape: tuple = ()
    dtype: object = None


@dataclasses.dataclass
class ProgramSpec:
    """One recorded program plus the call-site facts the rules need.

    ``dead`` are the argument positions the CALL SITE treats as dead
    after the call (the submitter knows its own liveness); ``args`` holds
    (position, TensorRec) for every tensor among the arguments; ``grid``
    is the real ProcessGrid a collective program runs on (its ranks
    compare their collective sequences, SLU114)."""

    label: str
    site: str
    ops: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    args: list = dataclasses.field(default_factory=list)
    dead: tuple = ()
    mesh_axes: tuple = ()
    grid: object = None
    peak_bytes: int = 0        # high-water live bytes of the walk
    args_bytes: int = 0        # the arguments' storages
    peak_buffers: tuple = ()   # (bytes, description) live at the peak

    def collective_sequence(self) -> list:
        """The (op, axes) sequence of the program's collectives."""
        return [(c.op, tuple(c.axes)) for c in self.collectives]


def dtype_width(dtype) -> int | None:
    """Float width in bits of a torch dtype (a complex one's component
    width); None for integer and bool dtypes."""
    name = str(dtype).replace("torch.", "")
    w = {"float64": 64, "complex128": 64, "float32": 32, "complex64": 32,
         "bfloat16": 16, "float16": 16, "complex32": 16}.get(name)
    if w is None and name.startswith("float8"):
        return 8
    return w


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def _tensors(val):
    """The tensors in one argument or result (a tensor, a list or tuple
    of them, or None)."""
    import torch
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


#: one FakeTensorMode for every walk, so the arguments a process's walks
#: share (an executor's avals, pool and map buffers) are faked once; the
#: lock keeps one walk at a time on it
_MODE = []
_LOCK = threading.RLock()


def _fake_mode():
    if not _MODE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        # each program brings new shapes: its ops would fill the mode's
        # dispatch cache with entries no later op hits (a third of a
        # walk's time, measured on poisson3d(24)'s groups)
        mode.cache_enabled = False
        _MODE.append(mode)
    return _MODE[0]


@functools.cache
def _recorder_class():
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        """Records every op dispatched on fake tensors and tracks live
        storage bytes (module docstring).  Real tensors an op receives
        come from outside the arguments: they are converted through the
        walk's FakeTensorMode and counted live from then on."""

        def __init__(self, mode):
            super().__init__()
            self.mode = mode
            self.ops, self.collectives = [], []
            self._serial = {}        # id(storage) -> serial (live ones)
            self._source = {}        # serial -> "arg" / "outside" / "op"
            self._live = {}          # serial -> (bytes, description)
            self._next = 0
            self.live = self.peak = 0
            self.peak_buffers = ()
            self.closed = False

        # ---- storages -----------------------------------------------------

        def _free(self, serial, key) -> None:
            if self._serial.get(key) == serial:
                del self._serial[key]
            if self.closed:
                return
            nb, _ = self._live.pop(serial, (0, None))
            self.live -= nb

        def rec(self, t, source="op", what=""):
            """The TensorRec of ``t``; a storage not seen before is
            registered live under ``source``."""
            st = t.untyped_storage()
            key = id(st)
            serial = self._serial.get(key)
            nb = int(st.nbytes())
            if serial is None:
                serial = self._next
                self._next += 1
                self._serial[key] = serial
                self._source[serial] = source
                self._live[serial] = (nb, what or f"{source} "
                                      f"{str(t.dtype).replace('torch.', '')}"
                                      f"{list(t.shape)}")
                self.live += nb
                weakref.finalize(st, self._free, serial, key)
            return TensorRec(tuple(int(s) for s in t.shape), t.dtype,
                             int(t.numel()) * t.element_size(), serial, nb,
                             self._source[serial])

        def known(self, t) -> bool:
            return id(t.untyped_storage()) in self._serial

        def _mark_peak(self) -> None:
            if self.live > self.peak:
                self.peak = self.live
                self.peak_buffers = tuple(sorted(
                    self._live.values(), key=lambda x: -x[0])[:3])

        def _outside(self, val):
            """``val`` with every real tensor replaced by its fake
            (memoized by the mode), registered as from outside."""
            if isinstance(val, torch.Tensor) and not isinstance(val,
                                                                FakeTensor):
                fake = self.mode.from_tensor(val)
                self.rec(fake, "outside")
                return fake
            if isinstance(val, (list, tuple)):
                out = [self._outside(v) for v in val]
                return type(val)(out) if isinstance(val, tuple) else out
            return val

        # ---- ops ----------------------------------------------------------

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            if func.namespace == "prim":      # a metadata query: no data
                return func(*args, **(kwargs or {}))
            kwargs = {k: self._outside(v) for k, v in (kwargs or {}).items()}
            args = tuple(self._outside(a) for a in args)
            ins, writes = [], []
            for i, a in enumerate(func._schema.arguments):
                val = args[i] if i < len(args) else kwargs.get(a.name)
                w = a.alias_info is not None and a.alias_info.is_write
                for t in _tensors(val):
                    if w:
                        writes.append(len(ins))
                    ins.append(self.rec(t))
            out = func(*args, **kwargs)
            outs, fresh = [], []
            name = str(func)
            for t in _tensors(out):
                if not self.known(t):
                    fresh.append(len(outs))
                outs.append(self.rec(
                    t, "op", f"{name} -> {str(t.dtype).replace('torch.', '')}"
                             f"{list(t.shape)}"))
            self._mark_peak()
            self.ops.append(OpRecord(name, tuple(ins), tuple(writes),
                                     tuple(outs), tuple(fresh)))
            return out

        def note_collective(self, c: CollectiveRec) -> None:
            self.collectives.append(c)

        def close(self) -> None:
            self.closed = True

    return Recorder


class RecordingGrid:
    """A stand-in for a ``parallel/grid.ProcessGrid`` inside a walk: each
    collective is recorded with the axes of its communicator and answered
    with a new tensor of the shape the real one delivers (``out`` when
    the call passes one); nothing is sent.  A collective the real grid
    skips (a communicator of one rank) is skipped here too.  Every other
    attribute is the real grid's."""

    def __init__(self, grid, note, device=None):
        self._grid, self._note_fn = grid, note
        self._device = device if device is not None else grid.device

    def __getattr__(self, name):
        return getattr(self._grid, name)

    @property
    def device(self):
        return self._device

    def _note(self, op, axis, out):
        axes = GRID_AXES if axis is None else (axis,)
        self._note_fn(CollectiveRec(
            op, axes, int(out.numel()) * out.element_size(),
            tuple(int(s) for s in out.shape), out.dtype))
        return out

    def all_gather(self, t, axis=None):
        k = self._grid._members(axis)
        if k == 1:
            return t
        out = t.new_empty((k * t.shape[0],) + tuple(t.shape[1:]))
        return self._note("all_gather", axis, out)

    def bcast_row(self, t, src_pcol, shape, dtype, out=None):
        g = self._grid
        if g.npcol == 1:
            return t
        import torch
        shape = tuple(int(x) for x in shape)
        if g.rank == g.prow * g.npcol + int(src_pcol):
            res = t
        elif out is not None:
            res = out
        else:
            res = torch.empty(shape, dtype=dtype, device=self._device)
        return self._note("bcast_row", "panel", res)

    def all_reduce_row(self, t):
        if self._grid.npcol == 1:
            return t
        return self._note("all_reduce_row", "panel", t.new_empty(t.shape))

    def exchange(self, send, send_counts, recv_counts, out=None):
        if self._grid.nproc == 1:
            return send
        total = int(sum(int(c) for c in recv_counts))
        res = out[:total] if out is not None else send.new_empty(total)
        return self._note("exchange", None, res)

    def gather_rows(self, t, counts, out=None):
        if self._grid.nproc == 1:
            return t
        shape = (int(sum(int(c) for c in counts)),) + tuple(t.shape[1:])
        if out is None:
            res = t.new_empty(shape)
        else:
            res = out[:math.prod(shape)].view(shape)
        return self._note("gather_rows", None, res)

    def all_reduce_sum(self, t):
        if self._grid.nproc == 1:
            return t.clone()
        return self._note("all_reduce", None, t.new_empty(t.shape))


@functools.cache
def _indexing_mode_class():
    import torch
    from torch.overrides import TorchFunctionMode
    aten = torch.ops.aten

    def parts(x, idx):
        """``x`` basic-indexed (views: unsqueeze, select, slice — the ops
        the C++ indexing issues), and the advanced indices left for
        ``index`` / ``index_put_`` (None when there are none)."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        used = sum(1 for i in idx if i is not None and i is not Ellipsis)
        if any(i is Ellipsis for i in idx):
            k = idx.index(Ellipsis)
            idx = (idx[:k] + (slice(None),) * (x.dim() - used)
                   + idx[k + 1:])
        out, dim, adv = x, 0, []
        for i in idx:
            if i is None:
                out = aten.unsqueeze.default(out, dim)
                dim += 1
            elif isinstance(i, slice):
                out = aten.slice.Tensor(out, dim, i.start, i.stop,
                                        1 if i.step is None else i.step)
                dim += 1
            elif isinstance(i, (torch.Tensor, list)):
                t = i if isinstance(i, torch.Tensor) else torch.tensor(
                    i, device=x.device)
                if t.dtype == torch.bool:
                    raise TypeError("a boolean mask index needs the data")
                adv.append((dim, t))
                dim += 1
            else:
                out = aten.select.int(out, dim, int(i))
        if not adv:
            return out, None
        ind = [None] * out.dim()
        for d, t in adv:
            ind[d] = t
        return out, ind

    class Indexing(TorchFunctionMode):
        """The tensor methods whose Python bindings take a device guard —
        ``__getitem__`` / ``__setitem__``, ``contiguous``, ``copy_`` — as
        the aten ops those bindings issue, for fake tensors of a device
        this torch was built without (it has no guard for them)."""

        def __torch_function__(self, func, types_, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.Tensor.contiguous:
                x = args[0]
                fmt = kwargs.get("memory_format", args[1] if len(args) > 1
                                 else torch.contiguous_format)
                return x if x.is_contiguous(memory_format=fmt) else \
                    aten.clone.default(x, memory_format=fmt)
            if func is torch.Tensor.copy_:
                return aten.copy_.default(*args, **kwargs)
            if func is torch.Tensor.__getitem__:
                out, ind = parts(*args)
                return out if ind is None else aten.index.Tensor(out, ind)
            if func is torch.Tensor.__setitem__:
                x, idx, v = args
                out, ind = parts(x, idx)
                if ind is not None:
                    if not isinstance(v, torch.Tensor):
                        v = torch.full((), v, dtype=x.dtype, device=x.device)
                    aten.index_put_.default(out, ind, v)
                elif isinstance(v, torch.Tensor):
                    aten.copy_.default(out, v)
                else:
                    aten.fill_.Scalar(out, v)
                return None
            return func(*args, **kwargs)

    return Indexing


def _is_grid(x) -> bool:
    from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
    return isinstance(x, ProcessGrid)


def _faker(mode, device, on_grid, memo):
    """A function turning an argument tree into its fake twin: tensors
    (``mode.from_tensor``, or new fakes on ``device`` of the same shape,
    dtype and strides), a ProcessGrid (``on_grid``), and the lists,
    tuples, dicts, namespaces and dataclasses holding them — a container
    without either is passed as it is.  ``memo`` (the caller's, cleared
    once the tree is faked: the recursive function is a reference cycle,
    which must not keep the real tensors alive) maps id(tensor) to
    (tensor, fake)."""
    import torch

    def fake(x):
        if isinstance(x, torch.Tensor):
            hit = memo.get(id(x))
            if hit is None:
                if device is None:
                    f = mode.from_tensor(x)
                else:
                    f = torch.empty_strided(tuple(x.shape), x.stride(),
                                            dtype=x.dtype, device=device)
                hit = memo[id(x)] = (x, f)
            return hit[1]
        if _is_grid(x):
            return on_grid(x)
        if isinstance(x, (list, tuple)):
            out = [fake(v) for v in x]
            if all(a is b for a, b in zip(out, x)):
                return x
            return type(x)(out) if type(x) in (list, tuple) else \
                type(x)(*out)
        if isinstance(x, dict):
            out = {k: fake(v) for k, v in x.items()}
            return x if all(out[k] is x[k] for k in x) else out
        if isinstance(x, types.SimpleNamespace):
            d = vars(x)
            out = {k: fake(v) for k, v in d.items()}
            return x if all(out[k] is d[k] for k in d) else \
                types.SimpleNamespace(**out)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            fields = [f.name for f in dataclasses.fields(x) if f.init]
            out = {k: fake(getattr(x, k)) for k in fields}
            if all(out[k] is getattr(x, k) for k in fields):
                return x
            return dataclasses.replace(x, **out)
        return x

    return fake


def trace_spec(fn, args, *, label: str, site: str, dead=(), mesh_axes=(),
               device=None) -> ProgramSpec:
    """Run ``fn(*args)`` once on fake tensors under the recorder and
    package what it did with the call-site facts.

    The arguments are faked with ``FakeTensorMode.from_tensor`` (device,
    shape, dtype and strides kept; views of one buffer share a fake
    storage); ``device`` (e.g. ``torch.device("cuda", 0)``) makes them
    fakes on that device instead, so a CPU host walks a card's program.
    A ProcessGrid among them becomes a :class:`RecordingGrid` and
    ``mesh_axes`` defaults to its axes.  Nothing runs on a device and no
    kernel launches: the kernel ops take their fake implementations."""
    import torch
    collect = gc.isenabled()
    with _LOCK:
        first = not _MODE
        # a walk makes tens of thousands of short-lived objects: no
        # cyclic collection of a large process heap in the middle of it
        gc.disable()
        try:
            return _trace(fn, args, label, site, dead, mesh_axes, device,
                          torch, _fake_mode())
        finally:
            if collect:
                gc.enable()
            if first:
                # the first walk's one-time set-up leaves reference
                # cycles holding its arguments (frames of caught
                # exceptions): free them now, not at some later
                # collection — they may be a Schur pool on the card
                gc.collect()


def _trace(fn, args, label, site, dead, mesh_axes, device, torch, mode):
    rec = _recorder_class()(mode)
    grids = []

    def on_grid(g):
        grids.append(g)
        return RecordingGrid(g, rec.note_collective, device)

    spec = ProgramSpec(label=label, site=site, dead=tuple(dead))
    if device is not None:
        device = torch.device(device)
    # a build without CUDA has no device guard for fake CUDA tensors,
    # which torch's C++ indexing takes: index through the aten ops there
    hostless = (device is not None and device.type == "cuda"
                and not torch.backends.cuda.is_built())
    indexing = _indexing_mode_class()() if hostless else \
        contextlib.nullcontext()
    with torch.no_grad(), mode:
        memo = {}
        fargs = _faker(mode, device, on_grid, memo)(tuple(args))
        memo.clear()
        for pos, a in enumerate(fargs):
            for t in _flat_tensors(a):
                spec.args.append((pos, rec.rec(t, "arg")))
        spec.args_bytes = rec.live
        rec._mark_peak()
        with indexing, rec:
            fn(*fargs)
    rec.close()
    spec.ops, spec.collectives = rec.ops, rec.collectives
    spec.peak_bytes = int(rec.peak)
    spec.peak_buffers = rec.peak_buffers
    if grids:
        spec.grid = grids[0]
        if not mesh_axes:
            mesh_axes = GRID_AXES
    spec.mesh_axes = tuple(mesh_axes)
    return spec


def _flat_tensors(x) -> list:
    """Every tensor inside one (faked) argument tree."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat_tensors(v)]
    if isinstance(x, types.SimpleNamespace):
        return [t for v in vars(x).values() for t in _flat_tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _flat_tensors(getattr(x, f.name, None))]
    return []


# --------------------------------------------------------------------------
# the three audits (the JAX module's audit_spec / audit_dtypes /
# audit_sharding)
# --------------------------------------------------------------------------

def audit_spec(spec: ProgramSpec, inplace_min_bytes: int,
               const_max_bytes: int):
    """SLU111 / SLU112 / SLU114 (a) over one spec.  Returns ``(findings,
    stats)``: stats carry the in-place coverage and baked bytes."""
    from superlu_dist_tpu_torch.analysis import rules_program as rp
    f1, inplace = rp.audit_inplace(spec, inplace_min_bytes)
    f2, consts = rp.audit_baked_consts(spec, const_max_bytes)
    f3 = rp.audit_collective_lockstep(spec)
    findings = f1 + f2 + f3
    stats = {"label": spec.label, "site": spec.site,
             "findings": len(findings), "n_ops": len(spec.ops),
             "n_collectives": len(spec.collectives)}
    stats.update(inplace)
    stats.update(consts)
    return findings, stats


def audit_dtypes(spec: ProgramSpec):
    """SLU115 / SLU116 over one spec.  Returns ``(findings, stats)``."""
    from superlu_dist_tpu_torch.analysis import rules_precision as rp
    f1, narrow = rp.audit_narrowing(spec)
    f2, accum = rp.audit_accumulation(spec)
    findings = f1 + f2
    stats = {"label": spec.label, "site": spec.site,
             "findings": len(findings)}
    stats.update(narrow)
    stats.update(accum)
    return findings, stats


def audit_sharding(spec: ProgramSpec, reshard_min_bytes: int,
                   budget_bytes: int = 0):
    """SLU119 / SLU121 over one spec.  Returns ``(findings, stats)``:
    stats carry ``peak_bytes_est`` and ``replicated_bytes``."""
    from superlu_dist_tpu_torch.analysis import rules_sharding as rs
    f1, reshard = rs.audit_resharding(spec, reshard_min_bytes)
    f2, mem = rs.audit_peak_memory(spec, budget_bytes)
    findings = f1 + f2
    stats = {"label": spec.label, "site": spec.site,
             "findings": len(findings)}
    stats.update(reshard)
    stats.update(mem)
    return findings, stats
