"""Factorization plan: mapping supernodes onto level-batched padded fronts.

This is the analog of the reference's *distribution* phase
(pddistribute, SRC/pddistribute.c:322): where the reference builds
dLocalLU_t index structures plus MPI send/recv schedules, we precompute —
entirely on the host, once per sparsity pattern — the gather/scatter maps
that let the numeric factorization run as a short sequence of device
operations per (level, bucket) group:

  assemble:   F[slot] += A entries            (host-built index triples)
              F[slot] += children's Schur     (extend-add, device-computed
                                               indices from per-child
                                               relative-position vectors —
                                               the dscatter.c:111 analog)
  factor:     batched partial LU (ops.dense)  (the pdgstrf hot loop)
  write-back: pool[off[slot]] = Schur block   (strided, device-computed)

Dispatch groups are formed by an earliest-ready DATAFLOW scheduler by
default (the reference's elimination-tree task parallelism + pipelined
look-ahead, SRC/pdgstrf.c:624-697): ready supernodes sharing a (m, w, u)
bucket shape pack into maximal batches across elimination levels, bounded
by a look-ahead window so pool liveness stays bounded.  schedule="level"
restores strict level lockstep; both schedules produce identical factors.

Fronts are square (symmetrized pattern): index set = supernode columns +
below-diagonal rows, padded to bucket sizes (W for the pivot block, M = W+U
total).  Children's Schur blocks live in a device pool as zero-padded U×U
blocks whose offsets come from a size-class free-list allocator simulated
at plan time — pool memory is the live tree frontier (the multifrontal
"update stack"), not the sum over all supernodes.  Host-side index volume
is O(nnz(A) + nnz(L)): per-entry extend-add maps are never materialized
(they are broadcast-computed on device), which is what lets plans scale to
large n.

Like the reference's SamePattern path, a plan is reusable across numeric
refactorizations with the same sparsity pattern.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from superlu_dist_tpu_torch import native as slu_host
from superlu_dist_tpu_torch.symbolic.symbfact import SymbolicFact


@dataclasses.dataclass
class ChildSet:
    """Children of one group's fronts, bucketed by child U size.

    The extend-add kernel gathers each child's padded ub×ub Schur block from
    the pool and scatter-adds it into the parent front at positions
    rel[c,i]·M + rel[c,j]; rel == M is the sentinel for padding (maps past
    the front, dropped)."""

    ub: int                 # child U bucket (block is ub*ub in the pool)
    child_off: np.ndarray   # (C,) pool offset of each child block
    child_slot: np.ndarray  # (C,) parent slot in this group
    rel: np.ndarray         # (C, ub) child row -> parent front position


@dataclasses.dataclass
class Group:
    """One (level, bucket) batch of fronts."""

    level: int
    m: int                  # padded front size
    w: int                  # padded pivot width
    u: int                  # padded Schur size (m - w); 0 => no write-back
    batch: int              # number of real fronts
    sns: np.ndarray         # supernode ids, slot order
    ws: np.ndarray          # (batch,) real pivot widths (identity padding)
    off: np.ndarray         # (batch,) pool offset of each front's Schur
                            # block (pool_size => no write-back for slot)
    # assembly of original matrix entries
    a_slot: np.ndarray
    a_flat: np.ndarray
    a_src: np.ndarray
    children: list          # list[ChildSet]


@dataclasses.dataclass
class FactorPlan:
    n: int
    sf: SymbolicFact
    pattern_indptr: np.ndarray     # permuted symmetrized pattern (CSR)
    pattern_indices: np.ndarray
    groups: list                   # Groups in dispatch (topological) order
    pool_size: int                 # peak live Schur-pool entries
    sn_group: np.ndarray           # (ns,) group index of each supernode
    sn_slot: np.ndarray            # (ns,) slot within its group
    flops: float
    front_bytes: int               # total padded front storage (per dtype unit)
    schedule: str = "level"        # "level" | "dataflow" (build_plan)
    sched_window: int = 0          # dataflow look-ahead window (levels)
    n_level_groups: int = 0        # groups a pure level schedule yields
    critical_path: int = 0         # longest chain of dependent groups
    closed: bool = False           # shape-key set closed onto ladder rungs
    bucket_set: tuple = ()         # sorted distinct (W, U) keys over groups

    def __getstate__(self):
        # the device-map cache (numeric/factor.upload_maps) and the executor
        # cache (numeric/factor.get_executor) hold tensors and graphs on a
        # device: a pickled plan (persist/serial.save_lu) leaves them out,
        # and they are rebuilt at first use
        state = dict(self.__dict__)
        state.pop("_device_maps", None)
        state.pop("_factor_fns", None)
        # the mesh tier's per-rank shares (parallel/spmd.local_plan,
        # parallel/layout2d.layout)
        state.pop("_spmd_local", None)
        state.pop("_mesh2d_layout", None)
        return state

    @property
    def n_levels(self) -> int:
        return int(self.sf.sn_level.max()) + 1 if len(self.sf.sn_level) else 0

    @property
    def mean_occupancy(self) -> float:
        """Mean real fronts per dispatch group — the batching quality the
        dataflow scheduler optimizes (level lockstep leaves deep-tree
        tails at occupancy ~1)."""
        return (self.sf.n_supernodes / len(self.groups)
                if self.groups else 0.0)

    def bytes_moved(self, itemsize: int = 8) -> int:
        """Irregular gather/scatter traffic of one factorization at this
        plan, in bytes — the data-movement twin of the flop padding
        factor.  Counted per moved element as its accesses:

        * A-entry assembly: one avals read + a front read-modify-write
          per structural entry (3 accesses);
        * extend-add: one pool read + a front read-modify-write per
          child Schur element (3 accesses, real child count × ub²);
        * Schur write-back: one front read + one pool write per u²
          element of every real front (2 accesses).

        ``itemsize`` defaults to 8 (f64); callers that know the factor
        dtype pass its itemsize for exact bytes.
        """
        elems = 0
        for g in self.groups:
            elems += 3 * len(g.a_src)
            elems += 3 * sum(len(cs.child_off) * cs.ub * cs.ub
                             for cs in g.children)
            elems += 2 * g.batch * g.u * g.u
        return int(elems) * int(itemsize)

    def schedule_stats(self, itemsize: int = 8) -> dict:
        """Schedule telemetry block shared by Stats.report, the trace
        span (numeric.factor.numeric_factorize) and the bench JSON row:
        dispatch-group count before/after aggregation, mean batch
        occupancy, shape-padding factor (executed/structural flops, batch
        padding excluded), the dependent-group critical-path length and
        the irregular gather/scatter traffic (``bytes_moved``)."""
        from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
        executed = float(sum(g.batch * _front_flops(g.w, g.u)
                             for g in self.groups))
        return {
            "schedule": self.schedule,
            "n_groups": len(self.groups),
            "n_level_groups": self.n_level_groups,
            "occupancy": round(self.mean_occupancy, 2),
            "padding_factor": round(executed / max(self.flops, 1.0), 4),
            "critical_path": self.critical_path,
            "bytes_moved": self.bytes_moved(itemsize),
        }

    def check_index_width(self):
        """Flat pool offsets must fit the int64 index maps every device
        array of the port uses (the XSDK_INDEX_SIZE=64 analog,
        superlu_defs.h:85-88)."""
        if self.pool_size >= 2 ** 63:
            raise ValueError(f"pool_size {self.pool_size} exceeds the int64 "
                             "index range")


# ---------------------------------------------------------------------------
# The canonical bucket ladder — ONE source of truth for every pad-to-rung
# rounding: the plan's front buckets (_bucket_sizes)
# and the executors' array padding share this recurrence.
# ---------------------------------------------------------------------------

def ladder_rungs(lo: int, growth: float):
    """Infinite generator of ladder rungs: ``lo``, then
    ``max(prev + step, ceil(prev * growth / step) * step)`` with step = 8
    (multiple-of-8 rungs) above the base, step = 1 below it.  growth=2
    from lo=8 reproduces the streamed executor's historical pow-2 rungs;
    growth=1.5 from a plan ``min_bucket`` reproduces _bucket_sizes'."""
    step = 8 if lo >= 8 else 1
    s = int(lo)
    while True:
        yield s
        s = max(s + step, int(np.ceil(s * growth / step) * step))


def bucket_rung(n: int, lo: int = 8, growth: float = 2.0) -> int:
    """Smallest ladder rung >= n on the n-independent canonical ladder
    the closure pass rounds onto."""
    for s in ladder_rungs(int(lo), max(float(growth), 1.01)):
        if s >= n:
            return s


def _bucket_sizes(max_needed: int, min_bucket: int, growth: float):
    """Front-size rungs for one plan: the shared ladder's rungs below
    ``max_needed`` plus one tight top rung hugging the largest front
    (the legacy open-ladder behavior; a CLOSED plan re-rounds every key
    onto canonical ladder rungs afterwards — _close_shape_keys)."""
    sizes = []
    for s in ladder_rungs(min_bucket, growth):
        if s >= max_needed:
            break
        sizes.append(s)
    sizes.append(int(np.ceil(max_needed / 8.0) * 8) if max_needed > min_bucket
                 else min_bucket)
    return np.unique(np.array(sizes, dtype=np.int64))


def _align_shape_keys(sn_W, sn_U, tol: float):
    """Schedule-aware shape-key coalescing (the interleaved-batching
    enabler, arXiv:1909.04539).  SHARED MACHINERY: the solve-side
    scheduler (solve/plan.py) runs this a second time on top of the
    factor keys — keep the signature/semantics stable for both callers.
    Greedily merge (W, U) bucket keys —
    promoting the smaller key's members to the merged (max W, max U)
    padding — while the merged members' executed flops stay within
    `tol`x the ORIGINAL constituent flops (the amalgamation budget
    discipline, symbfact.amalgamate_supernodes: chained merges never
    compound past tol).  Fine bucket rungs (growth ~1.05 leaves
    same-width cells 5% apart in U) otherwise scatter the supernodes
    over so many distinct shapes that no scheduler can batch them:
    the bench matrix at n=32768 has 83 distinct keys over 101 level
    cells.  Runs BEFORE the schedule branch so level and dataflow see
    identical per-supernode padding — the bitwise level/dataflow
    equivalence rests on it (padding is NOT arithmetic-neutral: a wider
    GEMM K retiles the real partial-sum reduction).

    Returns (sn_W, sn_U) with coalesced assignments; tol <= 1 disables.
    """
    from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
    if not tol or tol <= 1.0 or len(sn_W) == 0:
        return sn_W, sn_U
    pairs = np.stack([sn_W, sn_U], axis=1)
    keys, inv, cnt = np.unique(pairs, axis=0, return_inverse=True,
                               return_counts=True)
    k = len(keys)
    W = keys[:, 0].astype(np.int64).copy()
    U = keys[:, 1].astype(np.int64).copy()
    n_mem = cnt.astype(np.int64).copy()
    base = n_mem * _front_flops(W, U)     # original constituent flops
    rep = np.arange(k)
    alive = np.ones(k, dtype=bool)
    while alive.sum() > 1:
        ai = np.flatnonzero(alive)
        Wm = np.maximum.outer(W[ai], W[ai])
        Um = np.maximum.outer(U[ai], U[ai])
        tot = n_mem[ai][:, None] + n_mem[ai][None, :]
        ratio = tot * _front_flops(Wm, Um) / (base[ai][:, None]
                                              + base[ai][None, :])
        np.fill_diagonal(ratio, np.inf)
        i, j = np.unravel_index(np.argmin(ratio), ratio.shape)
        if ratio[i, j] > tol:
            break
        a, b = int(ai[i]), int(ai[j])
        a, b = min(a, b), max(a, b)       # deterministic representative
        W[a], U[a] = max(W[a], W[b]), max(U[a], U[b])
        n_mem[a] += n_mem[b]
        base[a] += base[b]
        alive[b] = False
        rep[b] = a
    # path-compress representatives, then map supernodes through
    for i in range(k):
        r = i
        while rep[r] != r:
            r = rep[r]
        rep[i] = r
    return W[rep[inv]], U[rep[inv]]


def _close_shape_keys(sn_W, sn_U, max_keys: int):
    """The global shape-key CLOSURE pass (the mega-executor prerequisite,
    arXiv:2406.10511's one-engine-every-front-shape discipline): map the
    aligned (W, U) key set onto at most ``max_keys`` keys whose values
    are canonical ladder rungs (bucket_rung), so the compiled-program
    count is bounded by ``max_keys`` INDEPENDENT of matrix size and two
    matrices of the same size class land on the same compiled set.

    Unlike _align_shape_keys (a flop-budgeted OPTIMIZATION), closure is
    a hard bound: merges proceed cheapest-flop-ratio-first until the
    count target is met, and every surviving key is rounded up to ladder
    rungs — the padding cost is the price of the closed compile set
    (docs/PERFORMANCE.md quantifies it).  Like alignment it runs BEFORE
    the schedule branch, so level and dataflow pad identically and the
    bitwise schedule-equivalence guarantee carries over to closed plans.

    Returns (sn_W, sn_U) with closed assignments.
    """
    from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
    if len(sn_W) == 0:
        return sn_W, sn_U
    rung = np.vectorize(bucket_rung, otypes=[np.int64])
    pairs = np.stack([rung(np.maximum(sn_W, 1)),
                      np.where(sn_U > 0, rung(np.maximum(sn_U, 1)), 0)],
                     axis=1)
    keys, inv, cnt = np.unique(pairs, axis=0, return_inverse=True,
                               return_counts=True)
    k = len(keys)
    W = keys[:, 0].astype(np.int64).copy()
    U = keys[:, 1].astype(np.int64).copy()
    n_mem = cnt.astype(np.int64).copy()
    base = n_mem * _front_flops(W, U)
    rep = np.arange(k)
    alive = np.ones(k, dtype=bool)
    while alive.sum() > max(int(max_keys), 1):
        ai = np.flatnonzero(alive)
        # merged key = rung-rounded (max W, max U): the ratio accounts
        # the TRUE padded flops of the canonical merged rung
        Wm = rung(np.maximum.outer(W[ai], W[ai]))
        Um = np.maximum.outer(U[ai], U[ai])
        Um = np.where(Um > 0, rung(np.maximum(Um, 1)), 0)
        tot = n_mem[ai][:, None] + n_mem[ai][None, :]
        ratio = tot * _front_flops(Wm, Um) / (base[ai][:, None]
                                              + base[ai][None, :])
        np.fill_diagonal(ratio, np.inf)
        i, j = np.unravel_index(np.argmin(ratio), ratio.shape)
        a, b = int(ai[i]), int(ai[j])
        a, b = min(a, b), max(a, b)
        W[a] = int(Wm[i, j])
        U[a] = int(Um[i, j])
        n_mem[a] += n_mem[b]
        base[a] += base[b]
        alive[b] = False
        rep[b] = a
    for i in range(k):
        r = i
        while rep[r] != r:
            r = rep[r]
        rep[i] = r
    return W[rep[inv]], U[rep[inv]]


def _level_batches(sf: SymbolicFact, sn_W, sn_U) -> list:
    """The classic level-lockstep partition: one batch per distinct
    (elimination level, W, U) triple, level-ascending then shape-key
    ascending.  Returns [(level, sns ndarray), ...] in dispatch order."""
    ns = sf.n_supernodes
    key_order = np.lexsort((sn_U, sn_W, sf.sn_level))
    out = []
    i = 0
    while i < ns:
        s0 = key_order[i]
        lvl, W, U = int(sf.sn_level[s0]), int(sn_W[s0]), int(sn_U[s0])
        j = i
        members = []
        while (j < ns and sf.sn_level[key_order[j]] == lvl
               and sn_W[key_order[j]] == W and sn_U[key_order[j]] == U):
            members.append(key_order[j])
            j += 1
        out.append((lvl, np.array(members, dtype=np.int64)))
        i = j
    return out


def _dataflow_batches(sf: SymbolicFact, sn_W, sn_U, window: int) -> list:
    """Earliest-ready dataflow schedule (the reference's elimination-tree
    task parallelism + look-ahead, SRC/pdgstrf.c:624-697, recast for
    batched dispatch; arXiv:2406.10511 medium-granularity dataflow,
    arXiv:1909.04539 interleaved small-problem batching).  SHARED
    MACHINERY: solve/plan.py schedules the triangular sweeps through
    this same function (and _level_batches) — the etree dependency is
    identical on both sides, so a change here changes BOTH dispatch
    sequences.

    A supernode is READY once every child that extend-adds into its
    front has been dispatched in an earlier batch (the Schur-scatter
    dependency = the supernode etree, symbfact.dispatch_dependencies).
    A (key, level) cell — the unit the level scheduler dispatches — is
    CLOSED once all its members are ready.  Each step dispatches, among
    shape keys with undispatched members at the oldest incomplete level
    `base`, the key whose closed cells inside the look-ahead window
    [base, base + window) hold the most members, as ONE batch (window
    <= 0 means unbounded).  Merging whole closed cells (never a ready
    subset of a cell) guarantees the group count is <= the level
    partition's — eager partial dispatch would FRAGMENT cells the level
    schedule batches together — while cross-level cells of the same key
    collapse whenever readiness allows.  Progress is guaranteed: every
    base-level cell is closed, so some key is always dispatchable.

    window=1 degenerates to the level partition (only base-level cells
    are eligible).  Batch membership only changes WHEN a front is
    factored, never the arithmetic within it, so any schedule produced
    here yields bitwise-identical L/U to the level partition
    (tests/test_schedule.py pins this).

    Returns [(wave, sns ndarray), ...]; wave = base at emission time is
    monotonically non-decreasing, so the stream executor's
    granularity="level" groupby stays contiguous.
    """
    from superlu_dist_tpu_torch.symbolic.symbfact import dispatch_dependencies
    ns = sf.n_supernodes
    if ns == 0:
        return []
    lvl = sf.sn_level
    par = sf.sn_parent
    n_levels = int(lvl.max()) + 1
    pending = dispatch_dependencies(par)    # undispatched children per sn
    level_left = np.bincount(lvl, minlength=n_levels)
    # per (key, level) cell: undispatched member count and the ready
    # members; bucketing by level keeps each step O(keys * window)
    keys = [(int(sn_W[s]), int(sn_U[s])) for s in range(ns)]
    remaining: dict = {}
    ready: dict = {}
    for s in range(ns):
        cell = remaining.setdefault(keys[s], {})
        cell[int(lvl[s])] = cell.get(int(lvl[s]), 0) + 1
    for s in np.flatnonzero(pending == 0):
        s = int(s)
        ready.setdefault(keys[s], {}).setdefault(int(lvl[s]), []).append(s)
    out = []
    left = ns
    base = 0
    while left:
        while base < n_levels and level_left[base] == 0:
            base += 1
        limit = base + window if window >= 1 else n_levels
        best_key, best_cnt = None, 0
        for key, by_lvl in ready.items():
            if not by_lvl.get(base):
                continue        # keys absent at base defer and accumulate
            cnt = sum(len(m) for l, m in by_lvl.items()
                      if l < limit and len(m) == remaining[key][l])
            if cnt > best_cnt or (cnt == best_cnt and key < best_key):
                best_key, best_cnt = key, cnt
        assert best_cnt > 0, "scheduler stalled (cyclic dependency?)"
        by_lvl = ready[best_key]
        members = []
        for l in sorted(l for l, m in by_lvl.items()
                        if l < limit and len(m) == remaining[best_key][l]):
            members.extend(by_lvl.pop(l))
            del remaining[best_key][l]
        if not by_lvl:
            del ready[best_key]
        # slot order sorted by supernode id: batch membership is greedy
        # but the per-front arithmetic ordering stays schedule-invariant
        members.sort()
        out.append((base, np.array(members, dtype=np.int64)))
        left -= len(members)
        for s in members:
            level_left[lvl[s]] -= 1
            p = int(par[s])
            if p >= 0:
                pending[p] -= 1
                if pending[p] == 0:
                    ready.setdefault(keys[p], {}).setdefault(
                        int(lvl[p]), []).append(p)
    return out


def build_plan(sf: SymbolicFact, min_bucket: int = 8,
               growth: float = 1.5, schedule: str = "dataflow",
               window: int = 8, align: float = 1.1, closed: bool = False,
               max_keys: int = 6, native: bool = True) -> FactorPlan:
    """Precompute all index maps.  Pure numpy; cost is O(nnz(A) + nnz(L)).

    schedule selects the dispatch-group former: "dataflow" packs ready
    supernodes into maximal same-shape batches across elimination levels
    (_dataflow_batches); "level" keeps the strict level-lockstep
    partition for A/B.  window is the dataflow look-ahead span in levels
    (1 = level order, 0 = unbounded).  align is the shape-key coalescing
    flop tolerance (<= 1 disables), applied before the schedule branch so
    both schedules pad every supernode identically.  Both schedules
    produce identical factors — only dispatch count and batch occupancy
    differ.

    closed additionally runs the shape-key CLOSURE pass
    (_close_shape_keys): the (W, U) key set is merged onto at most
    ``max_keys`` canonical ladder rungs.  The defaults are the JAX
    package's knob defaults.

    ``native`` answers the front-position queries in the native library
    (slu_positions); False runs the numpy search, its twin."""
    if schedule not in ("level", "dataflow"):
        raise ValueError(f"schedule must be 'level' or 'dataflow', "
                         f"got {schedule!r}")
    n = sf.n
    ns = sf.n_supernodes
    indptr, indices = sf.pattern_indptr, sf.pattern_indices

    widths = np.diff(sf.sn_start).astype(np.int64)
    us = np.array([len(r) for r in sf.sn_rows], dtype=np.int64)

    w_sizes = _bucket_sizes(int(widths.max(initial=1)), min_bucket, growth)
    u_sizes = _bucket_sizes(int(us.max(initial=1)), min_bucket, growth)

    sn_W = w_sizes[np.searchsorted(w_sizes, np.maximum(widths, 1))]
    sn_U = np.where(us == 0, 0,
                    u_sizes[np.searchsorted(u_sizes, np.maximum(us, 1))])
    sn_W, sn_U = _align_shape_keys(sn_W, sn_U, float(align))
    if closed:
        sn_W, sn_U = _close_shape_keys(sn_W, sn_U, int(max_keys))

    if schedule == "dataflow":
        batches = _dataflow_batches(sf, sn_W, sn_U, int(window))
        n_level_groups = len(_level_batches(sf, sn_W, sn_U))
    else:
        batches = _level_batches(sf, sn_W, sn_U)
        n_level_groups = len(batches)

    groups: list[Group] = []
    sn_group = np.empty(ns, dtype=np.int64)
    sn_slot = np.empty(ns, dtype=np.int64)
    for lvl, sns in batches:
        s0 = int(sns[0])
        W, U = int(sn_W[s0]), int(sn_U[s0])
        for slot, s in enumerate(sns):
            sn_group[s] = len(groups)
            sn_slot[s] = slot
        groups.append(Group(level=int(lvl), m=W + U, w=W, u=U,
                            batch=len(sns), sns=sns, ws=widths[sns],
                            off=None, a_slot=None, a_flat=None, a_src=None,
                            children=[]))

    # position helpers: global index x within the front of supernode s.
    # The vectorized form answers ALL (s, x) queries with one searchsorted
    # over segment-offset keys (sn_rows are sorted within each supernode and
    # supernode ids ascend, so s·(n+1)+row is globally sorted) — the
    # per-supernode Python-call version was the plan-build hot spot at
    # n ~ 1e6 (VERDICT r1 weak #4 class).
    first = sf.sn_start[:-1]
    last = sf.sn_start[1:] - 1
    rows_ptr = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(us, out=rows_ptr[1:])
    rows_concat = (np.concatenate(sf.sn_rows) if ns
                   else np.empty(0, dtype=np.int64))
    _twin_keys = []              # built once, on the twin's first query

    def positions_vec(s_arr: np.ndarray, x_arr: np.ndarray) -> np.ndarray:
        if native:
            return slu_host.positions(s_arr, x_arr, first, last, sn_W,
                                      rows_ptr, rows_concat)
        inpiv = x_arr <= last[s_arr]
        pos = np.where(inpiv, x_arr - first[s_arr], 0)
        below = ~inpiv
        if below.any():
            sb = s_arr[below]
            if not _twin_keys:
                _twin_keys.append(
                    np.repeat(np.arange(ns, dtype=np.int64), us) * (n + 1)
                    + rows_concat)
            idx = np.searchsorted(_twin_keys[0],
                                  sb * (n + 1) + x_arr[below])
            pos[below] = sn_W[sb] + (idx - rows_ptr[sb])
        return pos

    # --- A-entry assembly maps (fully vectorized) -------------------------
    rows_all = np.repeat(np.arange(n), np.diff(indptr)).astype(np.int64)
    cols_all = indices.astype(np.int64)
    owner = sf.col_to_sn[np.minimum(rows_all, cols_all)]
    group_m = np.array([g.m for g in groups], dtype=np.int64)
    pi_all = positions_vec(owner, rows_all)
    pj_all = positions_vec(owner, cols_all)
    flat_all = pi_all * group_m[sn_group[owner]] + pj_all
    slot_all = sn_slot[owner]
    g_of_entry = sn_group[owner]
    by_group = np.argsort(g_of_entry, kind="stable")
    gbounds = np.searchsorted(g_of_entry[by_group],
                              np.arange(len(groups) + 1))
    ga_slot = [slot_all[by_group[gbounds[g]:gbounds[g + 1]]]
               for g in range(len(groups))]
    ga_flat = [flat_all[by_group[gbounds[g]:gbounds[g + 1]]]
               for g in range(len(groups))]
    ga_src = [by_group[gbounds[g]:gbounds[g + 1]]
              for g in range(len(groups))]

    # positions of every supernode's rows within its PARENT front (the
    # extend-add targets), one vectorized query for all children at once
    parent_rep = np.repeat(np.where(sf.sn_parent >= 0, sf.sn_parent, 0), us)
    rel_all = (positions_vec(parent_rep, rows_concat)
               if len(rows_concat) else rows_concat)

    # --- pool allocation (size-class free lists) --------------------------
    # Simulated in group execution order: a group's extend-add consumes its
    # children's blocks (freed), then its own Schur blocks are written
    # (allocated) — the multifrontal update-stack discipline, batched.
    free: dict[int, list] = {}
    top = 0

    def alloc(size: int) -> int:
        nonlocal top
        lst = free.get(size)
        if lst:
            return lst.pop()
        off = top
        top += size
        return off

    sn_off = np.empty(ns, dtype=np.int64)
    # children of each group, bucketed by child U size
    grp_children: list[dict[int, list]] = [dict() for _ in groups]
    for g, grp in enumerate(groups):
        # free children blocks (they are fully consumed by this group)
        for ub, lst in grp_children[g].items():
            for (c, _) in lst:
                free.setdefault(ub * ub, []).append(sn_off[c])
        # allocate this group's blocks and register with parents
        for slot, s in enumerate(grp.sns):
            if us[s] == 0:
                sn_off[s] = -1
                continue
            ub = int(sn_U[s])
            sn_off[s] = alloc(ub * ub)
            p = int(sf.sn_parent[s])
            assert p >= 0
            gp = int(sn_group[p])
            assert gp > g, "parent group must execute after child"
            grp_children[gp].setdefault(ub, []).append((s, p))

    pool_size = int(top)

    front_bytes = 0
    for g, grp in enumerate(groups):
        grp.a_slot, grp.a_flat, grp.a_src = ga_slot[g], ga_flat[g], ga_src[g]
        grp.off = np.where(us[grp.sns] > 0, sn_off[grp.sns], pool_size)
        for ub, lst in sorted(grp_children[g].items()):
            # child-id order, not dispatch order: the scatter-add rows a
            # parent front accumulates must be sequenced identically
            # under every schedule or the bitwise level/dataflow
            # equivalence guarantee breaks on ties
            lst.sort()
            C = len(lst)
            cs = np.fromiter((c for c, _ in lst), dtype=np.int64, count=C)
            ps = np.fromiter((p for _, p in lst), dtype=np.int64, count=C)
            child_off = sn_off[cs]
            child_slot = sn_slot[ps]
            rel = np.full((C, ub), grp.m, dtype=np.int64)   # sentinel = M
            # scatter each child's precomputed parent-positions into row k
            kidx = np.repeat(np.arange(C), us[cs])
            cidx = np.concatenate([np.arange(us[c]) for c in cs]) \
                if C else np.empty(0, dtype=np.int64)
            src = np.concatenate([rel_all[rows_ptr[c]:rows_ptr[c + 1]]
                                  for c in cs]) \
                if C else np.empty(0, dtype=np.int64)
            rel[kidx, cidx] = src
            grp.children.append(ChildSet(ub=ub, child_off=child_off,
                                         child_slot=child_slot, rel=rel))
        front_bytes += grp.batch * grp.m * grp.m

    # dependent-group critical path: the longest chain of groups where a
    # later group consumes a member's child from an earlier one — the
    # serial depth of the schedule (level lockstep: == n_levels)
    pdepth = np.zeros(ns, dtype=np.int64)
    critical_path = 0
    for grp in groups:
        d = int(pdepth[grp.sns].max(initial=0)) + 1
        critical_path = max(critical_path, d)
        pg = sf.sn_parent[grp.sns]
        valid = pg >= 0
        if valid.any():
            np.maximum.at(pdepth, pg[valid], d)

    return FactorPlan(n=n, sf=sf, pattern_indptr=indptr,
                      pattern_indices=indices, groups=groups,
                      pool_size=pool_size, sn_group=sn_group, sn_slot=sn_slot,
                      flops=sf.flops, front_bytes=front_bytes,
                      schedule=schedule, sched_window=int(window),
                      n_level_groups=n_level_groups,
                      critical_path=critical_path,
                      closed=bool(closed),
                      bucket_set=tuple(sorted({(g.w, g.u) for g in groups})))
