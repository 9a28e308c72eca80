"""Multifrontal numeric factorization on the device.

Port of the JAX package's ``numeric/factor.py`` together with the group
loop of its streamed executor (``numeric/stream.py``): the plan's
dispatch groups run in order, each as one ``group_step`` — the front
assembly (identity padding, A entries and the extend-add of every child
set, one kernel launch: ``kernels.front_assemble_``), the batched blocked
partial LU with GESP tiny-pivot replacement, and the Schur write-back to
the update pool.

Where the JAX version returns new arrays, this one updates the pool in
place: each group's front batch is built once by the assembly, the
partial LU factors it in place, and the Schur block is copied into the
pool, which lives on the device for the whole factorization.  So a
checkpoint (persist/checkpoint.py) copies the pool only at a group
boundary, from inside the loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.numeric.kernels import GroupMaps
from superlu_dist_tpu_torch.numeric.plan import FactorPlan
from superlu_dist_tpu_torch.ops.dense import (gemm_precision,
                                              group_partial_factor)
from superlu_dist_tpu_torch.utils.errors import (CheckpointMismatchError,
                                                 NumericBreakdownError)
from superlu_dist_tpu_torch.utils.options import resolve_device

#: the front assembly the main path runs; a caller may pass the plain
#: version instead to hold the kernel against it on the card
KERNELS = kernels.front_assemble_
PLAIN = kernels.front_assemble_plain


def upload_maps(plan: FactorPlan, device: torch.device) -> list:
    """The plan's index maps on the device — its own, int64, and the
    front-assembly kernel's (``kernels.front_map_arrays``) — in one copy
    per dtype, cached on the plan per device (the SamePattern reuse tier
    keeps them across factorizations)."""
    cache = plan.__dict__.setdefault("_device_maps", {})
    maps = cache.get(str(device))
    if maps is None:
        arrays, pairs = [], []
        for g in plan.groups:
            arrays += [np.asarray(x, dtype=np.int64) for x in (
                g.ws, g.off, g.a_slot, g.a_flat, g.a_src,
                *(x for cs in g.children
                  for x in (cs.child_off, cs.child_slot, cs.rel)))]
            front, n = kernels.front_map_arrays(
                g.batch, g.m, plan.pool_size, a=(g.a_slot, g.a_flat, g.a_src),
                children=[(cs.ub, cs.child_off, cs.child_slot, cs.rel)
                          for cs in g.children])
            arrays += front
            pairs.append(n)
        views = iter(kernels.upload(arrays, device))
        maps = []
        for g, n in zip(plan.groups, pairs):
            ws, off, a_slot, a_flat, a_src = (next(views) for _ in range(5))
            children = [(cs.ub, next(views), next(views), next(views))
                        for cs in g.children]
            front = kernels.FrontMaps("front_assemble", g.batch, g.m,
                                      plan.pool_size,
                                      *(next(views) for _ in range(6)),
                                      pairs=n)
            maps.append(GroupMaps(ws=ws, off=off, a_slot=a_slot,
                                  a_flat=a_flat, a_src=a_src,
                                  children=children, front=front))
        cache[str(device)] = maps
    return maps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def group_step(dims, avals, pool, thresh, maps: GroupMaps,
               gemm_prec="default", scatter=KERNELS, timings=None):
    """One (level, bucket) group: assemble + factor + write back.

    dims = (batch, m, w, u).  ``scatter(avals, pool, m, w, maps)`` returns
    the group's assembled (batch, m²) front batch.  Writes the group's
    Schur blocks into ``pool`` in place (slots with off == pool size have
    none) and returns ((lpanel, upanel), tiny count as a 0-d device
    tensor).  ``timings``, when a dict, accumulates seconds per stage,
    synchronizing the device at each stage boundary."""
    batch, m, w, u = dims
    dev = pool.device
    clock = [time.perf_counter()]

    def lap(name):
        if timings is not None:
            _sync(dev)
            t = time.perf_counter()
            timings[name] = timings.get(name, 0.0) + t - clock[0]
            clock[0] = t

    f = scatter(avals, pool, m, w, maps)
    lap("front_assemble")
    lpanel, upanel, schur, flags = group_partial_factor(
        f.view(batch, m, m), thresh, w, gemm_prec=gemm_prec)
    # identity-padding columns (col >= ws) are unit pivots — a thresh > 1
    # must not count them as tiny
    real = torch.arange(w, device=dev)[None, :] < maps.ws[:, None]
    tiny = torch.where(real, flags, 0).sum()
    lap("partial_factor")
    if u > 0:
        keep = maps.off < pool.shape[0]
        dst = maps.off[keep, None] + torch.arange(u * u, device=dev)
        pool[dst] = schur.reshape(batch, u * u)[keep]
    packed = (lpanel.contiguous(), upanel.contiguous())
    lap("write_back")
    return packed, tiny


@dataclasses.dataclass
class NumericFactorization:
    """LU factors as packed front batches (the dLUstruct_t analog,
    superlu_ddefs.h:186-191), on the device they were computed on."""

    plan: FactorPlan
    fronts: list              # per group: (lpanel (B,M,w), upanel (B,w,u))
    tiny_pivots: int
    dtype: torch.dtype
    finite: bool = True       # False => an exact zero pivot propagated
                              # (only possible with replace_tiny=False)
    info_col: int = -1        # first zero-pivot column (0-based, final
                              # labeling) when not finite
    gemm_prec: str = "default"   # the GEMM tier the factors ran at
    resumed_groups: int = 0   # groups spliced from a checkpoint (resume_from)

    @property
    def device(self) -> torch.device:
        return self.fronts[0][0].device if self.fronts else torch.device("cpu")


def _apply_resume(resume, plan: FactorPlan, dtype, device):
    """A verified ResumeState on the device: (fronts of the first k groups,
    the pool at boundary k).  The pool must come back in the factor dtype
    it was written in (the value digest covers the dtype; this guards the
    array itself)."""
    want = np.dtype(str(dtype).replace("torch.", ""))
    if resume.pool.dtype != want or resume.pool.shape != (plan.pool_size,):
        raise CheckpointMismatchError(
            f"checkpoint pool at {resume.path!r} is {resume.pool.dtype} "
            f"{resume.pool.shape}, this run needs {want} "
            f"({plan.pool_size},)")
    fronts = [tuple(torch.tensor(x, device=device) for x in pair)
              for pair in resume.fronts]
    return fronts, torch.tensor(resume.pool, device=device)


def numeric_factorize(plan: FactorPlan, pattern_values: np.ndarray,
                      anorm: float, dtype=torch.float64,
                      device="cuda", replace_tiny: bool = True,
                      check_finite: bool = True, gemm_prec: str | None = None,
                      ckpt_dir: str | None = None, ckpt_every: int = 0,
                      resume_from: str | None = None, deadline=None,
                      scatter=KERNELS, timings=None) -> NumericFactorization:
    """Factor with values aligned to plan.pattern_indices, on ``device``
    (the card unless the caller asks for the CPU; CUDA without a card
    raises), in ``dtype``: float32, float64, complex64 or complex128.

    anorm: ‖A‖ for the GESP tiny-pivot threshold sqrt(eps)·‖A‖
    (reference pdgstrf2.c:218 uses eps·‖A‖; the sqrt variant keeps half
    the digits of f32 factors), as in the JAX package (factor.py:528).
    With replace_tiny=False an exact zero pivot propagates inf/nan and the
    result is flagged non-finite (the reference's info>0 singularity path,
    pdgstrf.c:234-241).  check_finite arms the isfinite sentinel: with
    ReplaceTinyPivot active a NaN/Inf in the factors means overflow or NaN
    input, and NumericBreakdownError names the first contaminated
    supernode.  ``gemm_prec`` is the Schur GEMMs' ladder tier
    (``ops/dense.gemm_precision``: None is "default", TF32 on the card).

    Crash consistency (persist/): ``ckpt_dir`` / ``ckpt_every`` arm a
    FactorCheckpointer that flushes the completed-group frontier every
    ``ckpt_every`` groups and on deadline, breakdown or SIGTERM;
    ``resume_from`` loads a checkpoint, verifies its plan fingerprint and
    value digest against this call's inputs, and restarts the group loop
    at its frontier — factors bit for bit equal to an uninterrupted run.
    ``deadline`` (a utils.deadline.Deadline) is polled before every group.
    ``scatter`` and ``timings`` are passed to every ``group_step``.
    """
    device = resolve_device(device)
    plan.check_index_width()
    gemm_prec = gemm_precision(gemm_prec)
    # the threshold is compared with |pivot|: a tensor of the real
    # component type (torch.finfo of a complex type is its component's);
    # its float, rounded to that type, is what the value digest records
    real_dtype = torch.empty((), dtype=dtype).real.dtype
    eps = torch.finfo(dtype).eps
    thresh_host = torch.tensor(
        np.sqrt(eps) * max(anorm, 1e-300) if replace_tiny else 0.0,
        dtype=real_dtype)
    thresh_f = float(thresh_host)
    thresh = thresh_host.to(device)
    resume = None
    if resume_from:
        from superlu_dist_tpu_torch.persist.checkpoint import load_checkpoint
        resume = load_checkpoint(resume_from, plan=plan,
                                 pattern_values=pattern_values,
                                 thresh=thresh_f, dtype=dtype,
                                 gemm_prec=gemm_prec)
    avals = torch.as_tensor(np.asarray(pattern_values), device=device).to(dtype)
    maps = upload_maps(plan, device)
    tiny = torch.zeros((), dtype=torch.int64, device=device)
    start = tiny_resumed = 0
    if resume is None:
        pool = torch.zeros(plan.pool_size, dtype=dtype, device=device)
        fronts = []
    else:
        fronts, pool = _apply_resume(resume, plan, dtype, device)
        start, tiny_resumed = resume.k, resume.tiny
    ckpt = None
    if ckpt_dir or ckpt_every > 0:
        from superlu_dist_tpu_torch.persist.checkpoint import (
            FactorCheckpointer)
        ckpt = FactorCheckpointer(ckpt_dir or ".slu_ckpt", plan,
                                  pattern_values, thresh_f, dtype,
                                  every=int(ckpt_every), gemm_prec=gemm_prec)
        if resume is not None:
            ckpt.seed(resume)
    try:
        for gi, (grp, gm) in enumerate(zip(plan.groups, maps)):
            if gi < start:
                continue
            if deadline is not None:
                # a group boundary: the latest noted frontier is the pool
                # as it stands
                deadline.poll(where="numeric factorization", on_expire=(
                    None if ckpt is None
                    else (lambda: ckpt.flush_latest("deadline"))))
            packed, t = group_step((grp.batch, grp.m, grp.w, grp.u), avals,
                                   pool, thresh, gm, gemm_prec=gemm_prec,
                                   scatter=scatter, timings=timings)
            fronts.append(packed)
            tiny += t
            if ckpt is not None:
                ckpt.note(gi, fronts, pool, tiny)
        del pool        # a checkpointer keeps its own reference
        finite, info_col = True, -1
        if not replace_tiny:
            finite, info_col = localize_singularity(plan, fronts)
        elif check_finite and not fronts_finite(fronts):
            sn, col = localize_nonfinite(plan, fronts)
            err = NumericBreakdownError(supernode=sn, col=col,
                                        where="numeric factorization")
            # the loop's end is a boundary: the frontier may include the
            # contaminated group (crash consistency, not numerical
            # validity — a resume reproduces the breakdown)
            err.checkpoint_path = (ckpt.flush_latest("numeric-breakdown")
                                   if ckpt is not None else None)
            raise err
    except BaseException:
        if ckpt is not None:
            # keep the flushed frontier on disk, but deregister: a later
            # factorization's SIGTERM must not reach this one's refs
            ckpt.complete(cleanup=False)
        raise
    if ckpt is not None:
        ckpt.complete(cleanup=True)
    return NumericFactorization(plan=plan, fronts=fronts,
                                tiny_pivots=int(tiny) + tiny_resumed,
                                dtype=dtype, finite=finite, info_col=info_col,
                                gemm_prec=gemm_prec,
                                resumed_groups=start)


def fronts_finite(fronts) -> bool:
    """Cheap isfinite sentinel over factored panels: reduced on the
    device, one host transfer for all groups."""
    if not fronts:
        return True
    flags = torch.stack([torch.isfinite(lp).all() & torch.isfinite(up).all()
                         for lp, up in fronts])
    return bool(flags.all())


def _nonfinite_slots(lp, up) -> np.ndarray:
    b = lp.shape[0]
    nf = ~torch.isfinite(lp.reshape(b, -1)).all(dim=1)
    nf |= ~torch.isfinite(up.reshape(b, -1)).all(dim=1)
    return nf.cpu().numpy()


def localize_nonfinite(plan: FactorPlan, fronts):
    """Earliest contaminated supernode over all fronts: returns
    (supernode, first global column), or (-1, -1) if everything is finite.
    Attribution is per SLOT — an unrelated subtree batched in the same
    group must not be blamed."""
    sn_start = plan.sf.sn_start
    best_sn, best_col = -1, -1
    for grp, (lp, up) in zip(plan.groups, fronts):
        nf = _nonfinite_slots(lp, up)
        if nf.any():
            sns = np.asarray(grp.sns)[np.nonzero(nf)[0]]
            sn = int(sns[np.argmin(sn_start[sns])])
            col = int(sn_start[sn])
            if best_col < 0 or col < best_col:
                best_sn, best_col = sn, col
    return best_sn, best_col


def localize_singularity(plan: FactorPlan, fronts):
    """Zero-pivot detection + localization over factored fronts: a zero
    or non-finite U diagonal in a real (non-padding) column; the earliest
    such global column is the reference's info>0 first-zero-pivot index
    (pdgstrf.c:1920-1924).  Returns (finite, info_col)."""
    bad_cols = []
    sn_start = plan.sf.sn_start
    for grp, (lp, up) in zip(plan.groups, fronts):
        diag = torch.diagonal(lp[:, :grp.w, :grp.w], dim1=1,
                              dim2=2).cpu().numpy()
        bad = (diag == 0) | ~np.isfinite(diag)
        bad &= np.arange(grp.w)[None, :] < np.asarray(grp.ws)[:, None]
        if bad.any():
            slots, cols = np.nonzero(bad)
            bad_cols.append(int((sn_start[grp.sns[slots]] + cols).min()))
        else:
            nf = _nonfinite_slots(lp, up)
            if nf.any():
                bad_cols.append(int(sn_start[grp.sns[nf]].min()))
    if bad_cols:
        return False, min(bad_cols)
    return True, -1


def query_space(numeric: NumericFactorization) -> dict:
    """Memory held by the factorization — the dQuerySpace_dist analog
    (SRC/dmemory_dist.c:73): packed-front (L+U) bytes plus the transient
    Schur update pool."""
    itemsize = torch.empty((), dtype=numeric.dtype).element_size()
    front_b = sum(lp.numel() + up.numel() for lp, up in numeric.fronts) \
        * itemsize
    pool_b = int(numeric.plan.pool_size) * itemsize
    return {"for_lu_bytes": front_b, "pool_bytes": pool_b,
            "total_bytes": front_b + pool_b}
