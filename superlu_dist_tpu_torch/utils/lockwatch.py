"""Runtime lock-order verifier.

Port of the JAX package's ``utils/lockwatch.py`` (the runtime twin of
its static lock-order rule SLU109).  ``SLU_TPU_VERIFY_LOCKS=1`` swaps
every lock built through :func:`make_lock` / :func:`make_condition` for
an instrumented wrapper that records per-thread acquisition stacks into
one process-global order graph: edge ``A -> B`` the first time B is
acquired while A is held, with the acquiring call site as the witness.
The check runs BEFORE blocking on the inner lock, so the first
inversion raises a structured
:class:`~superlu_dist_tpu_torch.utils.errors.LockOrderError` naming both
call sites — a would-be deadlock converted into a diagnosis (with its
flight-recorder postmortem already dumped at construction), instead of
two threads frozen forever.

Observability: each release feeds a ``slu_lock_hold_seconds`` histogram
(labeled by lock name) into the metrics registry when it is enabled.

Disabled path: with the knob unset, :func:`make_lock` returns a PLAIN
``threading.Lock`` — no wrapper, no graph, no module state beyond the
latched flag; ``_WATCH`` stays None.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_enabled = None          # latched on first use; _reset() re-reads
_WATCH = None            # the single _Watch when enabled, else None


def verify_locks_enabled() -> bool:
    global _enabled, _WATCH
    if _enabled is None:
        from superlu_dist_tpu_torch.utils.options import env_flag
        _enabled = bool(env_flag("SLU_TPU_VERIFY_LOCKS"))
        if _enabled and _WATCH is None:
            _WATCH = _Watch()
    return _enabled


def _reset() -> None:
    """Re-read ``SLU_TPU_VERIFY_LOCKS`` on next use (test hygiene).
    Locks built before the reset keep their old behavior — rebuild the
    producers, exactly like metrics.install()."""
    global _enabled, _WATCH
    _enabled = None
    _WATCH = None


def _call_site() -> str:
    """First stack frame outside this module and the threading module
    (Condition delegates acquire/release through threading.py)."""
    skip = {os.path.abspath(__file__),
            os.path.abspath(threading.__file__)}
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) in skip:
        f = f.f_back
    if f is None:
        return "<unknown>"
    parts = f.f_code.co_filename.replace(os.sep, "/").split("/")
    return "/".join(parts[-2:]) + f":{f.f_lineno}"


class _Watch:
    """The process-global order graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()     # guards the graph (plain lock:
        self._after: dict = {}          # instrumenting it would recurse)
        self._sites: dict = {}          # (a, b) -> witness site of the
        self._tls = threading.local()   # b-acquire
        self.edges = 0
        self.checks = 0

    # ---- per-thread stack ----------------------------------------------
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _reachable(self, frm: str, to: str) -> bool:
        seen, work = set(), [frm]
        while work:
            cur = work.pop()
            if cur == to:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            work.extend(self._after.get(cur, ()))
        return False

    # ---- hooks ----------------------------------------------------------
    def note_acquire(self, name: str) -> None:
        """Called BEFORE blocking on `name`: record the order edges and
        raise on the first cycle — the hang becomes a diagnosis."""
        if getattr(self._tls, "busy", False):
            return          # instrumentation-side lock (metrics): skip
        site = _call_site()
        stack = self._stack()
        self.checks += 1
        inversion = None
        if stack:
            with self._mu:
                for held, _, _ in stack:
                    if held == name or (held, name) in self._sites:
                        continue
                    # an inverse path existing means acquiring now can
                    # deadlock against a thread holding `name`
                    if self._reachable(name, held):
                        inversion = (held, name, site,
                                     self._inverse_witness(name, held))
                        break
                    self._after.setdefault(held, set()).add(name)
                    self._sites[(held, name)] = site
                    self.edges += 1
        if inversion is not None:
            # raise OUTSIDE self._mu: the error's flight-recorder dump
            # may touch instrumented locks (metrics snapshot)
            from superlu_dist_tpu_torch.utils.errors import LockOrderError
            raise LockOrderError(*inversion)
        stack.append((name, site, time.perf_counter()))

    def _inverse_witness(self, frm: str, to: str) -> str:
        """Site of the first edge on a path frm -> ... -> to."""
        direct = self._sites.get((frm, to))
        if direct is not None:
            return direct
        for (a, b), site in self._sites.items():
            if a == frm and self._reachable(b, to):
                return site
        return "<recorded earlier>"

    def note_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, _, t0 = stack.pop(i)
                held_s = time.perf_counter() - t0
                if getattr(self._tls, "busy", False):
                    return      # metrics' own lock: no self-accounting
                self._tls.busy = True
                try:
                    from superlu_dist_tpu_torch.obs.metrics import get_metrics
                    m = get_metrics()
                    if m.enabled:
                        m.observe("slu_lock_hold_seconds", held_s,
                                  lock=name)
                finally:
                    self._tls.busy = False
                return

    def order_graph(self) -> dict:
        with self._mu:
            return {a: sorted(bs) for a, bs in self._after.items()}


class InstrumentedLock:
    """``threading.Lock`` twin feeding the order graph.  Duck-typed to
    the Lock protocol (``Condition`` delegates ``acquire``/``release``
    straight through, so ``make_condition`` wraps one of these)."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str):
        self._name = name
        self._inner = threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking=True, timeout=-1):
        _WATCH.note_acquire(self._name)
        got = self._inner.acquire(blocking, timeout)
        if not got:
            _WATCH.note_release(self._name)   # never actually held
        return got

    def release(self):
        self._inner.release()
        _WATCH.note_release(self._name)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<InstrumentedLock {self._name!r} {self._inner!r}>"


def make_lock(name: str):
    """A lock participating in the order graph under
    ``SLU_TPU_VERIFY_LOCKS=1``; a PLAIN ``threading.Lock`` otherwise
    (zero wrapper, zero global state — the off path costs nothing)."""
    if not verify_locks_enabled():
        return threading.Lock()
    return InstrumentedLock(name)


def make_condition(name: str, lock=None):
    """A ``threading.Condition``; under verify-lock mode its underlying
    mutex is instrumented (pass the sibling :func:`make_lock` result to
    share ONE identity with it — the ``Condition(self._lock)`` idiom)."""
    if not verify_locks_enabled():
        return threading.Condition(lock)
    if lock is None:
        lock = InstrumentedLock(name)
    return threading.Condition(lock)


def order_graph() -> dict:
    """The current global order graph (empty when verification is off)
    — for tests and postmortems."""
    return _WATCH.order_graph() if _WATCH is not None else {}
