"""Dense supernodal kernels: the batched partial factorization of fronts.

Port of the JAX package's ``ops/dense.py`` (the reference's BLAS seam:
pdgstrf2_trsm, SRC/pdgstrf2.c:140-318, and the Schur-complement GEMM,
dSchCompUdt-2Ddynamic.c:566).  Fronts are padded to bucket sizes (M total,
W pivot columns), with identity columns in the pivot-block padding so the
unpivoted LU passes through them untouched.  Tiny pivots are replaced by
±thresh exactly like the reference's GESP (pdgstrf2.c:218-232, option
ReplaceTinyPivot), and counted.

Layout of a factored front F (M×M, pivot width W, real sizes w ≤ W,
u ≤ M−W):
    F[:W, :W]   packed LU of the diagonal block (unit-lower L11 + U11)
    F[W:, :W]   L21 = A21·U11⁻¹   (real data in rows W..W+u)
    F[:W, W:]   U12 = L11⁻¹·A12
    F[W:, W:]   Schur complement S = A22 − L21·U12 (scattered to the pool)

The JAX package ``vmap``s a ``fori_loop`` over one front; here the batch
is an explicit leading dimension.  Each panel's column loop is one call of
``panel`` (``_panel_columns``): on the card the hand-written kernel
``csrc/panel_lu.cu`` (``numeric/kernels.panel_lu_``, two launches per
32 pivot steps), on the CPU — or when a caller passes ``kernels.panel_lu_plain`` —
its plain PyTorch version, the loop of masked rank-1 steps.  The
triangular solves and GEMMs go to ``torch.linalg.solve_triangular`` and
``torch.matmul``, as the JAX package leaves them to XLA; neither is a
Pallas kernel there.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import kernels

_PANEL_BLOCK = 128   # outer panel width of the blocked right-looking LU

# ---------------------------------------------------------------------------
# The GEMM precision ladder (the JAX package's ops/dense.py:62-155)
#
# Every Schur-update GEMM of the factor path, and the off-diagonal GEMMs
# of the solve's blocked TRSM, run at one named tier, fastest and least
# accurate first:
#
#   bf16     real inputs rounded to bfloat16, products accumulated in
#            float32 (``bmm(..., out_dtype=float32)`` on the card)
#   default  TF32 on the card: tensor-core inputs with float32
#            accumulate (the JAX package's tensorfloat-analog tier)
#   f32      IEEE float32 (float64 for float64 operands) products
#   highest  the same products as f32 on the card and on the CPU
#
# The CPU has no TF32, so there default, f32 and highest are one
# arithmetic.  A reduced tier is made safe by the gemm-precision rung of
# the escalation ladder (drivers/gssvx._escalate): a BERR miss refactors
# the same skeleton one tier up (``next_gemm_precision``).  The TF32
# switch is set around each ``gemm`` call and restored afterwards, so no
# other product of the process runs at TF32.
# ---------------------------------------------------------------------------

GEMM_PREC_LADDER = ("bf16", "default", "f32", "highest")


def gemm_precision(name: str | None = None) -> str:
    """The GEMM tier an ``Options.gemm_prec`` value names: None or an
    empty name resolves to the ladder default ``"default"`` (the JAX
    package's resolution with no knob set).  Raises ValueError on a name
    outside the ladder."""
    if name is None or not str(name).strip():
        return "default"
    name = str(name).strip().lower()
    if name not in GEMM_PREC_LADDER:
        raise ValueError(f"gemm_prec={name!r} — expected one of "
                         f"{list(GEMM_PREC_LADDER)}")
    return name


def next_gemm_precision(tier: str, device) -> str | None:
    """The next-higher tier whose arithmetic differs on ``device``, or
    None at the top: the escalation rung's step.  On the CPU only the
    bfloat16 input rounding is a real boundary (bf16 → default, then
    None); on the card bf16 → default (TF32) → f32, then None, because
    f32 and highest are the same IEEE products there."""
    tier = gemm_precision(tier)
    on_card = torch.device(device).type == "cuda"
    step = {"bf16": "default", "default": "f32" if on_card else None}
    return step.get(tier)


def resolve_gemm_tier(prec: str, dtype) -> str:
    """The tier :func:`gemm` runs for ``dtype`` operands: complex operands
    have no bfloat16 carrier, so ``bf16`` resolves to ``default`` for
    them."""
    prec = gemm_precision(prec)
    if prec == "bf16" and dtype.is_complex:
        return "default"
    return prec


#: one process-wide reentrant lock over the card's math switches and
#: every CUDA-graph capture.  torch's TF32 and bf16-reduction switches are
#: process state, not thread state: a block that sets one and launches
#: under it must not interleave with another thread's block (a serving
#: dispatcher's solve and a refactor on another thread would otherwise
#: trade tiers).  A capture holds it too, so captures are serialized and
#: the switches cannot move while cuBLAS records its kernels.
MATH_LOCK = threading.RLock()

_CAPTURE_STREAMS = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream every CUDA-graph capture and its warm-up run on:
    one per card for the process.  torch keeps a cuBLAS workspace for
    every (handle, stream) pair that ran a cuBLAS call until the process
    ends (32 MiB each on the H100), so a new stream per capture would
    leave one behind each.  Its users hold :data:`MATH_LOCK` while they
    issue work on it: two threads' captures or warm-ups on one stream
    would interleave."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with MATH_LOCK:
        stream = _CAPTURE_STREAMS.get(index)
        if stream is None:
            stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(
                torch.device("cuda", index))
    return stream


@contextlib.contextmanager
def matmul_tf32(enabled: bool):
    """Set the card's TF32 switch for float32 matmuls inside the block and
    restore it afterwards (``fp32_precision`` where torch has it, else the
    legacy ``allow_tf32``), holding :data:`MATH_LOCK` throughout."""
    m = torch.backends.cuda.matmul
    with MATH_LOCK:
        if hasattr(m, "fp32_precision"):
            old = m.fp32_precision
            m.fp32_precision = "tf32" if enabled else "ieee"
            try:
                yield
            finally:
                m.fp32_precision = old
        else:
            old = m.allow_tf32
            m.allow_tf32 = bool(enabled)
            try:
                yield
            finally:
                m.allow_tf32 = old


def _bmm_out_dtype() -> bool:
    """True when torch has ``bmm(a, b, out_dtype=...)`` (a CUDA kernel:
    bfloat16 inputs, float32 accumulate and output)."""
    return any("bmm.dtype" in str(s) for s in
               torch._C._jit_get_schemas_for_operator("aten::bmm"))


#: how the bf16 tier multiplies on the card: "bmm_out_dtype" (one bf16
#: GEMM with float32 output) or "rounded_f32" (bfloat16-rounded inputs
#: multiplied as IEEE float32 — the products are exact there, so the
#: contract is the same); fixed by the installed torch
BF16_ROUTE = "bmm_out_dtype" if _bmm_out_dtype() else "rounded_f32"


def _bf16_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bfloat16-rounded real inputs, float32 accumulate; float32 result."""
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda" and BF16_ROUTE == "bmm_out_dtype":
        if ab.dim() != 3 or bb.dim() != 3:
            raise ValueError("the bf16 tier takes batched (B, m, k) x "
                             "(B, k, n) operands")
        reduced = torch.backends.cuda.matmul
        with MATH_LOCK:
            old = reduced.allow_bf16_reduced_precision_reduction
            reduced.allow_bf16_reduced_precision_reduction = False
            try:
                return torch.bmm(ab, bb, out_dtype=torch.float32)
            finally:
                reduced.allow_bf16_reduced_precision_reduction = old
    with matmul_tf32(False):
        return torch.matmul(ab.float(), bb.float())


def gemm(a: torch.Tensor, b: torch.Tensor, prec: str = "highest"):
    """One ladder-tier batched matmul: every Schur-update GEMM of the
    factor path and the blocked TRSM's off-diagonal GEMMs route through
    here.  The result has the operands' dtype; bf16 products accumulate
    in float32 and are cast back (asserted real: complex bf16 resolves to
    default)."""
    out_dt = torch.promote_types(a.dtype, b.dtype)
    tier = resolve_gemm_tier(prec, out_dt)
    if tier == "bf16":
        assert not out_dt.is_complex, \
            "bf16 tier on complex operands must resolve to 'default'"
        return _bf16_gemm(a, b).to(out_dt)
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    with matmul_tf32(tier == "default"):
        return torch.matmul(a, b)


_UNROLL = 16         # panel width factored by the unrolled column loop


def _lu_masked(a: torch.Tensor, thresh: torch.Tensor,
               panel=kernels.panel_lu_):
    """Unpivoted LU of a batch of small blocks (B, k, k) with tiny-pivot
    replacement, one rank-1 step per column (the JAX package's
    ``_lu_masked``): the column loop of one panel with j0 = 0 and pa = k,
    so the recursive path runs the same body (``_panel_columns``) as the
    blocked one.  Returns (packed LU, tiny (B, k) int32 per-column
    flags)."""
    b, k, _ = a.shape
    flags = torch.zeros((b, k), dtype=torch.int32, device=a.device)
    a = a.clone(memory_format=torch.contiguous_format)
    _panel_columns(a, 0, k, thresh, flags, panel)
    return a, flags


def lu_nopivot(a: torch.Tensor, thresh: torch.Tensor,
               gemm_prec: str = "highest", panel=kernels.panel_lu_):
    """Blocked-recursive unpivoted LU of a batch (B, n, n) with tiny-pivot
    replacement; the trailing update is one batched GEMM per recursion
    level.  Returns (packed LU, tiny (B, n) int32 per-column flags)."""
    n = a.shape[-1]
    if n <= _UNROLL:
        return _lu_masked(a, thresh, panel)
    h = max(_UNROLL, (n // 2 + _UNROLL - 1) // _UNROLL * _UNROLL)
    h = min(h, n - 1)
    f11, c1 = lu_nopivot(a[:, :h, :h], thresh, gemm_prec, panel)
    u12 = torch.linalg.solve_triangular(f11, a[:, :h, h:], upper=False,
                                        unitriangular=True)
    l21 = torch.linalg.solve_triangular(f11, a[:, h:, :h], upper=True,
                                        left=False)
    s = a[:, h:, h:] - gemm(l21, u12, gemm_prec)
    f22, c2 = lu_nopivot(s, thresh, gemm_prec, panel)
    return (torch.cat([torch.cat([f11, u12], dim=2),
                       torch.cat([l21, f22], dim=2)], dim=1),
            torch.cat([c1, c2], dim=1))


def panel_width(w: int):
    """(panel width pb, panel count) of the blocked partial LU over w
    pivot columns: PB = 128 at most, shrunk so nsteps·pb hugs w in
    multiples of 16 (the JAX package's rule).  The mesh tier's column map
    (parallel/layout2d.py) deals columns in these panels."""
    pb = min(_PANEL_BLOCK, -(-w // 16) * 16)
    nsteps = -(-w // pb)
    pb = -(-(-(-w // nsteps)) // 16) * 16
    return pb, -(-w // pb)


def _panel_columns(a, j0, pa, thresh, flags, panel=kernels.panel_lu_):
    """The column loop of one panel, in place: masked rank-1 steps over
    the pb columns of ``a`` (a (B, M_ext, pb) view of every row of the
    fronts) for its pa active pivots j0 .. j0+pa-1, tiny pivots replaced
    and flagged in ``flags`` (B, w).  ``panel`` is ``kernels.panel_lu_``
    (the kernel on the card, the plain loop on the CPU) or
    ``kernels.panel_lu_plain``.  The one body of the single-process
    blocked LU, of the mesh tier's panel owner (``panel_steps``) and of
    the recursive path's small blocks (``_lu_masked``)."""
    panel(a, j0, pa, thresh, flags)


def _blocked_partial_factor(f: torch.Tensor, thresh: torch.Tensor, w: int,
                            gemm_prec: str = "highest",
                            panel=kernels.panel_lu_):
    """Right-looking blocked partial LU of a batch of fronts, in place.

    f is (B, M, M); the leading w columns are eliminated.  Each PB-wide
    panel is eliminated with masked rank-1 steps over the whole panel
    width (``_panel_columns``), then one unit-lower triangular solve gives
    the U rows right of the panel and one (M, pa)×(pa, M) GEMM updates the
    trailing matrix — the arithmetic of the JAX package's
    ``_blocked_partial_factor`` (ops/dense.py:253), with the padding
    columns (j ≥ w) skipped instead of masked: a masked step there leaves
    every value unchanged.  The trailing TRSM and GEMM run only over the
    columns right of the panel and the rows below the active pivots, where
    the JAX version's masked full-width products add exact zeros.

    Returns (packed fronts (B, M, M) — f itself when no padding was
    needed — and tiny flags (B, w) int32).
    """
    b, m, _ = f.shape
    pb, nsteps = panel_width(w)
    m_ext = max(m, nsteps * pb)
    a = f
    if m_ext > m:
        # zero padding; padded columns are never eliminated (j >= w) and
        # padded rows stay zero throughout
        a = torch.nn.functional.pad(f, (0, m_ext - m, 0, m_ext - m))
    flags = torch.zeros((b, w), dtype=torch.int32, device=f.device)
    for p in range(nsteps):
        j0 = p * pb
        pa = min(pb, w - j0)                  # active pivots in this panel
        # a view: updates land in a
        _panel_columns(a[:, :, j0:j0 + pb], j0, pa, thresh, flags, panel)
        c1 = j0 + pb
        if c1 < m_ext:
            # U rows: solve unit-L11 against the columns right of the panel
            u12 = torch.linalg.solve_triangular(
                a[:, j0:j0 + pa, j0:j0 + pa], a[:, j0:j0 + pa, c1:],
                upper=False, unitriangular=True)
            a[:, j0:j0 + pa, c1:] = u12
            # trailing update: every non-pivot row below the active pivots
            a[:, j0 + pa:, c1:] -= gemm(a[:, j0 + pa:, j0:j0 + pa], u12,
                                        gemm_prec)
    return a[:, :m, :m], flags


def panel_partial_factor(a: torch.Tensor, thresh: torch.Tensor, w: int,
                         gcol: torch.Tensor, npcol: int, pcol: int,
                         bcast=None, gemm_prec: str = "highest",
                         panel=kernels.panel_lu_):
    """The blocked partial LU of ``_blocked_partial_factor`` over one
    rank's column share of a batch of fronts, in place — the "panel" axis
    of the mesh tier (parallel/mesh_stream.py).

    ``a`` is (B, M_ext, k): every row of the padded front and the k
    columns this rank owns, ascending, whose global indices are ``gcol``
    (a host int64 array; panel p of ``panel_width(w)`` is owned by
    process column p % npcol, and its pb columns are contiguous here).
    Per panel: its owner runs the column loop (``_panel_columns``, the
    single-process path's own body) and ``bcast(t, owner, shape)``
    hands every rank of the row the factored panel's rows j0.. over its
    pa active columns (``t`` the owner's (B, M_ext-j0, pa) view, None
    elsewhere; None ``bcast``: a one-column grid); then every rank solves
    the unit-lower L11 against its own columns right of the panel and
    updates them with one GEMM at ``gemm_prec``.  With npcol = 1 these are
    the single-process path's operations, in its order.

    Returns the tiny flags (B, w) int32 of the pivots this rank owns
    (zero elsewhere)."""
    steps = panel_steps(a, thresh, w, gcol, npcol, pcol, gemm_prec,
                        bcast is not None, panel)
    try:
        req = next(steps)
        while True:
            req = steps.send(bcast(*req))
    except StopIteration as done:
        return done.value


def panel_steps(a: torch.Tensor, thresh: torch.Tensor, w: int,
                gcol: torch.Tensor, npcol: int, pcol: int,
                gemm_prec: str = "highest", broadcast: bool = True,
                panel=kernels.panel_lu_):
    """``panel_partial_factor`` as a generator: where the function calls
    ``bcast(t, owner, shape)``, this yields ``(t, owner, shape)`` and
    takes the broadcast panel back through ``send`` (``broadcast=False``:
    a one-column grid, which yields nothing).  Its caller runs each
    broadcast — eagerly, or between two captured CUDA graphs
    (parallel/mesh_graphs.py): the launches between two yields are
    rank-local.  Returns (``StopIteration.value``) the tiny flags."""
    b, m_ext, _ = a.shape
    pb, nsteps = panel_width(w)
    flags = torch.zeros((b, w), dtype=torch.int32, device=a.device)
    for p in range(nsteps):
        j0 = p * pb
        pa = min(pb, w - j0)
        owner = p % npcol
        mine = None
        if owner == pcol:
            k0 = (p // npcol) * pb
            own = a[:, :, k0:k0 + pb]
            _panel_columns(own, j0, pa, thresh, flags, panel)
            mine = own[:, j0:, :pa]
        lpan = (yield (mine, owner, (b, m_ext - j0, pa))) if broadcast \
            else mine
        k1 = int(np.searchsorted(gcol, j0 + pb))
        if k1 < a.shape[2]:
            u12 = torch.linalg.solve_triangular(
                lpan[:, :pa, :], a[:, j0:j0 + pa, k1:], upper=False,
                unitriangular=True)
            a[:, j0:j0 + pa, k1:] = u12
            a[:, j0 + pa:, k1:] -= gemm(lpan[:, pa:, :], u12, gemm_prec)
        del lpan
    return flags


def group_partial_factor(fronts: torch.Tensor, thresh: torch.Tensor, w: int,
                         pivot: str = "blocked", gemm_prec: str = "highest",
                         panel=kernels.panel_lu_):
    """Partial factorization of a batch of fronts (B, m, m).

    pivot="blocked" (the main path) runs ``_blocked_partial_factor`` in
    place where no padding is needed (the JAX version returns new
    arrays); pivot="recursive" factors the pivot block with
    ``lu_nopivot`` and then forms U12, L21 and the Schur block with two
    triangular solves and one GEMM, as the JAX package's recursive path.

    Returns (lpanel (B,m,w), upanel (B,w,u), schur (B,u,u), tiny (B,w)).
    lpanel stacks the packed diagonal block (L11 unit-lower + U11) over
    L21; upanel is U12.  The caller scatters the Schur block into the
    update pool and keeps copies of the panels, so the eliminated A22 is
    never stored (superlu_ddefs.h:97-183).  ``panel`` is the column loop
    of both paths (``_panel_columns``).
    """
    if pivot == "blocked":
        packed, tiny = _blocked_partial_factor(fronts, thresh, w, gemm_prec,
                                               panel)
        return (packed[:, :, :w], packed[:, :w, w:], packed[:, w:, w:],
                tiny)
    if pivot != "recursive":
        raise ValueError(f"pivot must be 'blocked' or 'recursive', "
                         f"got {pivot!r}")
    f11, tiny = lu_nopivot(fronts[:, :w, :w], thresh, gemm_prec, panel)
    u12 = torch.linalg.solve_triangular(f11, fronts[:, :w, w:], upper=False,
                                        unitriangular=True)
    l21 = torch.linalg.solve_triangular(f11, fronts[:, w:, :w], upper=True,
                                        left=False)
    s = fronts[:, w:, w:] - gemm(l21, u12, gemm_prec)
    return torch.cat([f11, l21], dim=1), u12, s, tiny
