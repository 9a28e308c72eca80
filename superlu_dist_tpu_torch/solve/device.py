"""Device-resident supernodal triangular solves.

Port of the JAX package's ``solve/device.py`` (the pdgstrs analog,
SRC/pdgstrs.c:838, with the lsum kernels of SRC/pdgstrs_lsum.c): the
forward solve L·y = d walks the sweep batches of a
:class:`~superlu_dist_tpu_torch.solve.plan.SolvePlan` bottom-up, the
backward solve U·x = y walks them back down.  Each batch gathers its RHS
segments, solves its diagonal triangles by recursive blocked TRSM
(``_trsm``, leaf 64: the off-diagonal blocks become batched GEMMs at the
solver's GEMM tier) or, with DiagInv, by one GEMM with the precomputed
inverse, and scatter-adds the L21·y contributions into the lsum vector
(``_scatter_add``, in slot order: ``scatter_layers``); the factors
never leave the device, only the right-hand side crosses.

Sweep batches come from the solve plan (dataflow by default): batches
that coincide with a factor group alias its panel arrays; merged batches
gather — and, for promoted shape keys, identity/zero-pad — a fresh panel
stack once at construction (``_gather_panels``).  Right-hand sides map
onto the plan's closed nrhs bucket set and are column-chunked past its
cap (``_run_sweeps``).

``fused`` takes the place of the JAX package's one-jitted-program-per-
sweep: on the card each (sweep direction, nrhs bucket, trans/conj) is one
``torch.cuda.CUDAGraph``, captured on static (n+1, kb) buffers at first
use and replayed; the closed bucket set bounds the number of graphs.
The CPU runs the same bodies eagerly.  Every operation of a sweep is
deterministic — the lsum scatter adds each row's contributions in slot
order, and no two float atomics ever meet on an address — so on the card
two solves on one handle are bit for bit equal, and so are a fused and
an eager one.

The transposed system (L·U)ᵀ·x = d (conjugated under ``conj``) runs
through the same factors: Uᵀ leads, walking the batches bottom-up, then
Lᵀ walks them back down (``solve_trans``).

Threads: one solver runs one solve at a time (its static buffers are
shared by every solve of a bucket).  Captures hold ``ops.dense.
MATH_LOCK`` and record in torch's ``thread_local`` capture mode, so
other threads may use the card meanwhile (a serving dispatcher's
replays, a scrubber's copies, a swap's upload); nothing is retried and
nothing falls back to eager sweeps if a capture fails.  A solve opens
the ``device-solve`` kernel span, its ``solve-d2h`` comm span and, for
non-finite columns, a ``solve-probe`` verify span on the process tracer
(obs/trace.py): host timestamps around the copy that already
synchronizes.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.ops.dense import gemm, gemm_precision, matmul_tf32
from superlu_dist_tpu_torch.solve.plan import (SolvePlan, build_solve_plan,
                                               chunk_nrhs)

#: plans with at most this many sweep batches solve fused (the JAX rule)
FUSE_MAX_BATCHES = 256


def _trsm(a, b, lower, unit, trans, leaf, prec="highest"):
    """Batched triangular solve op(a)·x = b with recursive blocking.

    a is (B, w, w), b is (B, w, k); op(a) is aᵀ when ``trans``.  At or
    below ``leaf`` one ``torch.linalg.solve_triangular`` runs; above it the
    triangle splits in half and the off-diagonal block becomes one batched
    GEMM at the ladder tier ``prec`` (``ops/dense.gemm``) — the leaf
    triangles always solve at full precision.  ``leaf <= 0`` disables
    blocking.  Conjugation is the caller's job (conjugate the triangle
    first, as the transposed sweeps do)."""
    w = a.shape[-1]
    if leaf <= 0 or w <= leaf:
        return torch.linalg.solve_triangular(
            a.mT if trans else a, b, upper=lower == bool(trans),
            unitriangular=unit)
    h = w // 2
    a11, a22 = a[:, :h, :h], a[:, h:, h:]
    b1, b2 = b[:, :h], b[:, h:]
    if lower != bool(trans):
        # dependency runs top-down: x1 first, then fold A21·x1 (notrans
        # lower) / A12ᵀ·x1 (trans upper) out of b2
        off = a[:, h:, :h] if lower else a[:, :h, h:].mT
        x1 = _trsm(a11, b1, lower, unit, trans, leaf, prec)
        x2 = _trsm(a22, b2 - gemm(off, x1, prec), lower, unit, trans, leaf,
                   prec)
    else:
        # bottom-up: x2 first (notrans upper / trans lower)
        off = a[:, :h, h:] if not lower else a[:, h:, :h].mT
        x2 = _trsm(a22, b2, lower, unit, trans, leaf, prec)
        x1 = _trsm(a11, b1 - gemm(off, x2, prec), lower, unit, trans, leaf,
                   prec)
    return torch.cat([x1, x2], dim=1)


def scatter_layers(rows: np.ndarray, n: int):
    """The fixed-order plan of one batch's lsum scatter.

    ``rows`` (B, u) are the target rows of the batch's contributions, n the
    dump row of padding.  Sibling fronts share ancestor rows, so a real
    row can be hit by several slots.  Layer j holds the j-th hit of every
    real row in slot order (and, in layer 0, every dump-row entry, all of
    which add exact zeros): within a layer no real row repeats, so one
    ``index_add_`` per layer adds each row at most once — no two atomics
    meet on an address, and the sum runs in slot order, the CPU's order.
    Returns None when no real row repeats (one launch on ``rows`` as they
    are), else (perm, [(lo, hi, targets)]): the flat contributions
    reordered by layer and each layer's span and target rows."""
    flat = rows.reshape(-1)
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    run_start = np.r_[0, np.nonzero(np.diff(srt))[0] + 1]
    occ = np.empty(len(flat), dtype=np.int64)
    occ[order] = np.arange(len(flat)) - np.repeat(
        run_start, np.diff(np.r_[run_start, len(flat)]))
    occ[flat == n] = 0
    if occ.max(initial=0) == 0:
        return None
    perm, parts, lo = [], [], 0
    for j in range(int(occ.max()) + 1):
        pos = np.nonzero(occ == j)[0]
        perm.append(pos)
        parts.append((lo, lo + len(pos), flat[pos]))
        lo += len(pos)
    return np.concatenate(perm), parts


def _scatter_add(lsum, rows, contrib, layers):
    """lsum[rows] += contrib for a batch's (B, u, k) contributions, one
    ``index_add_`` per layer of ``layers`` (``scatter_layers``, uploaded):
    deterministic on the card — no real row is added twice in one launch,
    so float atomics never race — and in slot order everywhere."""
    c = contrib.reshape(-1, contrib.shape[-1])
    if layers is None:
        lsum.index_add_(0, rows.reshape(-1), c)
        return
    perm, parts = layers
    c = c[perm]
    for lo, hi, targets in parts:
        lsum.index_add_(0, targets, c[lo:hi])


def _fwd_body(lpanel, x, lsum, cols, rows, layers, w, u, linv, leaf, prec):
    """x[cols] <- L11⁻¹(x[cols] − lsum[cols]); lsum[rows] += L21·x[cols].
    With ``linv`` (DiagInv) the triangular solve is one GEMM with the
    precomputed inverse (pdgstrs.c:1252-1396)."""
    rhs = x[cols] - lsum[cols]                          # (B, w, k)
    if linv is not None:
        y = torch.matmul(linv, rhs)
    else:
        y = _trsm(lpanel[:, :w, :w], rhs, True, True, False, leaf, prec)
    x[cols] = y
    if u:
        _scatter_add(lsum, rows, torch.matmul(lpanel[:, w:, :], y), layers)


def _bwd_body(lpanel, upanel, x, cols, rows, w, u, uinv, leaf, prec):
    """x[cols] <- U11⁻¹(x[cols] − U12·x[rows])."""
    rhs = x[cols]
    if u:
        rhs = rhs - torch.matmul(upanel, x[rows])
    if uinv is not None:
        y = torch.matmul(uinv, rhs)
    else:
        y = _trsm(lpanel[:, :w, :w], rhs, False, False, False, leaf, prec)
    x[cols] = y


def _fwd_body_trans(lpanel, upanel, x, lsum, cols, rows, layers, w, u, conj,
                    leaf, prec):
    """Transposed forward sweep: x[cols] <- U11⁻ᵀ(x[cols] − lsum[cols]);
    lsum[rows] += U12ᵀ·x[cols].  Mᵀ = UᵀLᵀ, so Uᵀ (lower) leads — the
    trans_t path through the same factors (superlu_defs.h:628-657)."""
    rhs = x[cols] - lsum[cols]
    u11 = lpanel[:, :w, :w]
    if conj:
        u11 = u11.conj()
    y = _trsm(u11, rhs, False, False, True, leaf, prec)
    x[cols] = y
    if u:
        u12 = upanel.conj() if conj else upanel         # (B, w, u)
        _scatter_add(lsum, rows, torch.matmul(u12.mT, y), layers)


def _bwd_body_trans(lpanel, x, cols, rows, w, u, conj, leaf, prec):
    """Transposed backward sweep: x[cols] <- L11⁻ᵀ(x[cols] − L21ᵀ·x[rows])."""
    rhs = x[cols]
    if u:
        l21 = lpanel[:, w:, :]
        if conj:
            l21 = l21.conj()
        rhs = rhs - torch.matmul(l21.mT, x[rows])
    l11 = lpanel[:, :w, :w]
    if conj:
        l11 = l11.conj()
    x[cols] = _trsm(l11, rhs, True, True, True, leaf, prec)


def _diag_inv(lpanel, w, leaf, prec):
    """Batched inverses of the packed diagonal blocks (L11⁻¹, U11⁻¹) — the
    pdCompute_Diag_Inv analog (SRC/pdgstrs.c:647, dtrtri per block)."""
    f11 = lpanel[:, :w, :w]
    eye = torch.eye(w, dtype=lpanel.dtype, device=lpanel.device).expand(
        f11.shape).contiguous()
    return (_trsm(f11, eye, True, True, False, leaf, prec),
            _trsm(f11, eye, False, False, False, leaf, prec))


def _pad_panels(lp, up, w0, u0, W, U):
    """Promote one factor group's panel stack from its (w0, u0) padding to
    a merged solve key (W, U): identity on the new pivot diagonal (benign
    under both the unit-lower and the non-unit upper solves — padded
    columns gather from and write to the dump row only), zeros everywhere
    else so padded L21/U12 contributions vanish exactly."""
    b = lp.shape[0]
    lo = lp.new_zeros((b, W + U, W))
    lo[:, :w0, :w0] = lp[:, :w0, :w0]
    lo[:, W:W + u0, :w0] = lp[:, w0:w0 + u0, :]
    idx = torch.arange(w0, W, device=lp.device)
    lo[:, idx, idx] = 1
    uo = up.new_zeros((b, W, U))
    uo[:, :w0, :u0] = up
    return lo, uo


class DeviceSolver:
    """Solve (L·U)x = d on the factors' device, in the factor's permuted
    labeling.

    The dSOLVEstruct_t analog (superlu_ddefs.h:216-228): the sweep
    schedule (a SolvePlan), per-batch index maps and panel stacks are
    built once and reused across solves (pdgssvx.c:1330-1337).  Row ``n``
    of the (n+1, kb) work buffers is a dump row: padded pivot columns read
    and write it and padded below-diagonal rows add into it; the factor
    entries there are exactly identity/zero, so what it holds never
    reaches a real unknown.

    ``fused``: True, False or "auto" (fused when the plan has at most
    ``FUSE_MAX_BATCHES`` sweep batches).  Fused sweeps are CUDA graphs on
    the card; on the CPU the sweeps always run eagerly.  A failed capture
    raises.  ``gemm_prec`` is the ladder tier of the blocked TRSM's
    off-diagonal GEMMs (the driver passes the factors' tier); every other
    product of the solve is an IEEE product."""

    def __init__(self, fact: NumericFactorization, diag_inv: bool = False,
                 fused: str | bool = "auto",
                 solve_plan: SolvePlan | None = None,
                 schedule: str = "dataflow", window: int = 0,
                 align: float = 1.25, trsm_leaf: int = 64,
                 nrhs_max: int | None = None,
                 nrhs_growth: float | None = None,
                 gemm_prec: str | None = None):
        from superlu_dist_tpu_torch.utils.options import env_float, env_int
        if nrhs_max is None:
            nrhs_max = env_int("SLU_TPU_SOLVE_NRHS_MAX")
        if nrhs_growth is None:
            nrhs_growth = env_float("SLU_TPU_SOLVE_NRHS_GROWTH")
        self.fact = fact
        self.diag_inv = bool(diag_inv)
        self.trsm_leaf = int(trsm_leaf)
        self.gemm_prec = gemm_precision(gemm_prec)
        plan = fact.plan
        if solve_plan is None:
            solve_plan = build_solve_plan(plan, schedule=schedule,
                                          window=window, align=align,
                                          nrhs_max=nrhs_max,
                                          nrhs_growth=nrhs_growth)
        self.splan = solve_plan
        self.n = plan.n
        self.device = fact.device
        if fused == "auto":
            fused = len(solve_plan.groups) <= FUSE_MAX_BATCHES
        self.fused = bool(fused) and self.device.type == "cuda"
        self.last_solve_stats = None
        sf = plan.sf
        first = np.asarray(sf.sn_start[:-1])
        self._groups = []
        self.fronts = []
        self.gathered_bytes = 0
        # a host-share factorization (numeric/stream.py) leaves the leading
        # levels' fronts on the CPU: upload them once, here (the factors'
        # own record keeps them where they are)
        src = [(lp.to(self.device), up.to(self.device))
               for lp, up in fact.fronts]
        self.uploaded_bytes = sum(
            lp.numel() * lp.element_size() + up.numel() * up.element_size()
            for (lp, up), (slp, _) in zip(fact.fronts, src) if slp is not lp)
        for sg in solve_plan.groups:
            k = np.arange(sg.w)
            cols = np.where(k[None, :] < sg.ws[:, None],
                            first[sg.sns][:, None] + k, self.n)
            rows = np.full((sg.batch, sg.u), self.n, dtype=np.int64)
            for slot, s in enumerate(sg.sns):
                r = sf.sn_rows[s]
                rows[slot, :len(r)] = r
            layers = scatter_layers(rows, self.n)
            if layers is not None:
                dev = self.device
                layers = (torch.as_tensor(layers[0], device=dev),
                          [(lo, hi, torch.as_tensor(t, device=dev))
                           for lo, hi, t in layers[1]])
            self._groups.append(
                (sg, torch.as_tensor(cols, dtype=torch.int64,
                                     device=self.device),
                 torch.as_tensor(rows, device=self.device), layers))
            if sg.reuse >= 0:
                self.fronts.append(src[sg.reuse])
            else:
                lp, up = self._gather_panels(sg, src, plan)
                self.fronts.append((lp, up))
                self.gathered_bytes += (lp.numel() * lp.element_size()
                                        + up.numel() * up.element_size())
        self._invs_cached = None
        # fused state: static (x, lsum) buffers per nrhs bucket, one graph
        # per (direction, bucket, mode), all in one private memory pool
        self._buffers = {}
        self._graphs = {}
        self._pool = None
        self.graph_pool_bytes = 0
        # one solve at a time on the static buffers
        self._lock = threading.Lock()

    @staticmethod
    def _gather_panels(sg, src_fronts, plan):
        """One merged sweep batch's panel stack from the factor fronts: per
        contiguous source-group run one index gather, promoted keys
        identity/zero-padded, concatenated in member (slot) order.  Runs
        once at construction, on the device."""
        parts_l, parts_u = [], []
        i, b = 0, sg.batch
        while i < b:
            g = int(sg.src_group[i])
            j = i
            while j < b and int(sg.src_group[j]) == g:
                j += 1
            slots = np.ascontiguousarray(sg.src_slot[i:j], dtype=np.int64)
            lp, up = src_fronts[g]
            fg = plan.groups[g]
            if not (len(slots) == fg.batch
                    and np.array_equal(slots, np.arange(fg.batch))):
                idx = torch.as_tensor(slots, device=lp.device)
                lp, up = lp[idx], up[idx]
            if (fg.w, fg.u) != (sg.w, sg.u):
                lp, up = _pad_panels(lp, up, fg.w, fg.u, sg.w, sg.u)
            parts_l.append(lp)
            parts_u.append(up)
            i = j
        if len(parts_l) == 1:
            return parts_l[0], parts_u[0]
        return torch.cat(parts_l), torch.cat(parts_u)

    @property
    def _invs(self):
        """Batched diagonal-block inverses (DiagInv), computed lazily on the
        first non-transposed solve — transposed sweeps never read them."""
        if self._invs_cached is None:
            if self.diag_inv:
                with matmul_tf32(False):
                    self._invs_cached = [
                        _diag_inv(lp, sg.w, self.trsm_leaf, self.gemm_prec)
                        for (sg, *_), (lp, _) in zip(self._groups,
                                                       self.fronts)]
            else:
                self._invs_cached = [(None, None)] * len(self._groups)
        return self._invs_cached

    @property
    def diag_inv_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pair in (self._invs_cached or []) for t in pair
                   if t is not None)

    @property
    def buffer_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pair in self._buffers.values() for t in pair)

    def memory_stats(self) -> dict:
        """Device bytes the solver holds beyond the factors: gathered panel
        stacks, DiagInv blocks, the fused path's static buffers and its
        graph pool (reserved while capturing)."""
        return {"gathered_panel_bytes": self.gathered_bytes,
                "uploaded_front_bytes": self.uploaded_bytes,
                "diag_inv_bytes": self.diag_inv_bytes,
                "buffer_bytes": self.buffer_bytes,
                "graph_pool_bytes": self.graph_pool_bytes,
                "graphs": len(self._graphs)}

    # -- sweeps --------------------------------------------------------------

    def _sweep(self, direction, mode, x, lsum):
        """One whole sweep over the batches, in place on x (and lsum)."""
        leaf, prec = self.trsm_leaf, self.gemm_prec
        batches = list(zip(self._groups, self.fronts))
        if mode == "N":
            invs = self._invs
            if direction == "fwd":
                lsum.zero_()
                for ((sg, cols, rows, lay), (lp, _)), (linv, _) in zip(
                        batches, invs):
                    _fwd_body(lp, x, lsum, cols, rows, lay, sg.w, sg.u, linv,
                              leaf, prec)
            else:
                for ((sg, cols, rows, _), (lp, up)), (_, uinv) in zip(
                        reversed(batches), reversed(invs)):
                    _bwd_body(lp, up, x, cols, rows, sg.w, sg.u, uinv, leaf,
                              prec)
            return
        conj = mode == "C"
        if direction == "fwd":
            lsum.zero_()
            for (sg, cols, rows, lay), (lp, up) in batches:
                _fwd_body_trans(lp, up, x, lsum, cols, rows, lay, sg.w, sg.u,
                                conj, leaf, prec)
        else:
            for (sg, cols, rows, _), (lp, _) in reversed(batches):
                _bwd_body_trans(lp, x, cols, rows, sg.w, sg.u, conj, leaf,
                                prec)

    def _capture(self, direction, mode, kb):
        """Capture the CUDA graph of one sweep on bucket kb's static
        buffers, after one eager warm-up run on the capture stream (the
        buffers' contents are overwritten; the caller loads them after)."""
        x, lsum = self._buffers[kb]
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._sweep(direction, mode, x, lsum)
        stream.synchronize()
        reserved = torch.cuda.memory_reserved(dev)
        # capture_begin/_end rather than torch.cuda.graph, which empties the
        # allocator's whole cache before every capture; the private pool's
        # segments are new, so the reserved bytes' growth is the graph's
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                self._sweep(direction, mode, x, lsum)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph_pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self._graphs[(direction, mode, kb)] = graph

    def _run_sweeps(self, rhs: np.ndarray, mode: str) -> np.ndarray:
        """Shared scaffolding of the plain and transposed solves: map the
        columns onto the closed bucket set (column-chunking past the cap),
        pad each chunk into an (n+1, kb) buffer (row n is the dump row),
        run the forward and backward sweeps, then unpad.  Complex
        right-hand sides with real factors are solved as their real and
        imaginary parts (``nrhs`` counts the columns solved).  Executed vs
        structural flops and the non-finite columns are latched on
        ``last_solve_stats``."""
        squeeze = rhs.ndim == 1
        r2 = rhs[:, None] if squeeze else rhs
        dt = self.fact.dtype
        split = np.iscomplexobj(r2) and not dt.is_complex
        if split:
            r2 = np.concatenate([r2.real, r2.imag], axis=1)
        k = r2.shape[1]
        chunks = chunk_nrhs(k, self.splan.nrhs_bucket_set)
        kb_total = sum(b for _, _, b in chunks)
        structural = self.splan.flops_per_rhs * k
        executed = self.splan.executed_flops_per_rhs * kb_total
        padding = round(executed / max(structural, 1.0), 4)
        out = None
        nonfinite_cols = []
        tracer = get_tracer()
        d2h_s, d2h_bytes = 0.0, 0
        with self._lock, tracer.span(
                "device-solve", cat="kernel", n=self.n, nrhs=k,
                padded_nrhs=kb_total, chunks=len(chunks), fused=self.fused,
                n_groups=len(self._groups), schedule=self.splan.schedule,
                solve_flops=structural, executed_flops=executed,
                padding_factor=padding,
                dtype=str(dt).replace("torch.", "")):
            for lo, hi, kb in chunks:
                src = torch.as_tensor(np.ascontiguousarray(r2[:, lo:hi])).to(
                    device=self.device, dtype=dt)
                if self.fused:
                    self._ensure_graphs(mode, kb)
                    x = self._buffers[kb][0]
                    x.zero_()
                    x[:self.n, :hi - lo] = src
                    self._graphs[("fwd", mode, kb)].replay()
                    self._graphs[("bwd", mode, kb)].replay()
                else:
                    with matmul_tf32(False):
                        x = torch.zeros((self.n + 1, kb), dtype=dt,
                                        device=self.device)
                        x[:self.n, :hi - lo] = src
                        lsum = torch.zeros_like(x)
                        self._sweep("fwd", mode, x, lsum)
                        self._sweep("bwd", mode, x, lsum)
                t0 = time.perf_counter()
                res = x[:self.n, :hi - lo].cpu().numpy()
                d2h_s += time.perf_counter() - t0
                d2h_bytes += int(res.nbytes)
                if out is None:
                    out = np.empty((self.n, k), dtype=res.dtype)
                fin = np.isfinite(res).all(axis=0)
                if not fin.all():
                    nonfinite_cols.extend(int(lo + j)
                                          for j in np.nonzero(~fin)[0])
                out[:, lo:hi] = res
            if tracer.enabled:
                # the solution's copy to the host (the only factor-sized
                # data that crosses per solve), timed where it already
                # synchronizes
                tracer.complete("solve-d2h", "comm",
                                time.perf_counter() - d2h_s, d2h_s,
                                op="d2h", bytes=d2h_bytes)
        if nonfinite_cols and tracer.enabled:
            tracer.complete("solve-probe", "verify", time.perf_counter(),
                            0.0, nonfinite=len(nonfinite_cols))
        self.last_solve_stats = {
            "nrhs": k, "padded_nrhs": kb_total, "chunks": len(chunks),
            "solve_flops": structural, "executed_flops": executed,
            "padding_factor": padding,
            "fused": self.fused, "finite": not nonfinite_cols,
            "nonfinite_cols": nonfinite_cols}
        if split:
            h = k // 2
            out = out[:, :h] + 1j * out[:, h:]
        return out[:, 0] if squeeze else out

    def _ensure_graphs(self, mode: str, kb: int) -> None:
        """Bucket kb's static buffers and its two sweep graphs for
        ``mode``, captured at first use under ``MATH_LOCK`` (which
        ``matmul_tf32`` holds; DiagInv's blocks are computed before any
        capture)."""
        need = [d for d in ("fwd", "bwd") if (d, mode, kb) not in self._graphs]
        if not need:
            return
        with matmul_tf32(False):
            if kb not in self._buffers:
                self._buffers[kb] = tuple(
                    torch.zeros((self.n + 1, kb), dtype=self.fact.dtype,
                                device=self.device) for _ in range(2))
            if mode == "N":
                self._invs          # computed before any capture
            for direction in need:
                self._capture(direction, mode, kb)

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """rhs (n,) or (n, k) in permuted labeling -> solution of
        (L·U)·x = rhs, same shape, in the factor dtype (complex for a
        complex rhs)."""
        return self._run_sweeps(np.asarray(rhs), "N")

    def solve_trans(self, rhs: np.ndarray, conj: bool = False) -> np.ndarray:
        """Solve (L·U)ᵀ·x = rhs, or (L·U)ᴴ·x = rhs with conj, through the
        same factors (the reference's trans_t, superlu_defs.h:628-657): Uᵀ
        ascending, then Lᵀ descending."""
        conj = bool(conj) and self.fact.dtype.is_complex
        return self._run_sweeps(np.asarray(rhs), "C" if conj else "T")
