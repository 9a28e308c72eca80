"""Multi-handle residency — an LRU of factored handles per replica.

Port of the JAX package's ``serve/handlecache.py``.  One ``SolveServer``
owns one factored handle; the fleet's traffic shape (the many-small-
systems class) is a MIXED stream of matrices keyed by persist bundle.  This cache gives a
replica that mixed-stream capability without refactoring anything:

* handles load **zero-refactor** through ``SolveServer.from_bundle``
  (persist/serial.load_lu — digest-verified, FACT time stays 0.0), and
  every load/reload is **scrub-verified**: one ``scrub_now()`` pass
  compares the freshly resident panel stacks against the bundle
  manifest's sha256 digests before the handle serves a single column;
* residency is budgeted in BYTES (``SLU_TPU_FLEET_HANDLE_BYTES``)
  using the manifest's byte ledger via the ``persist.lu_meta`` cheap
  peek — the cost of admitting a handle is known BEFORE paying the
  load;
* eviction is least-recently-used over **idle** servers only
  (``SolveServer.idle()``), so evicting a handle can never drop a
  ticket; a cache whose resident handles are all busy is allowed to
  run over budget rather than lose work (the zero-loss discipline);
* an evicted key reloads transparently on its next ``get`` — the
  reload runs the same digest verification + scrub pass, so a bundle
  rotted on disk between visits surfaces as a structured
  ``CheckpointCorruptError`` / ``FactorCorruptError``, never garbage X.

Handles load onto the card unless the cache was built with
``device="cpu"``.  Evictions feed ``slu_fleet_handle_evictions_total``
(obs/metrics.py).
"""

from __future__ import annotations

import collections

from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.utils.errors import SuperLUError
from superlu_dist_tpu_torch.utils.lockwatch import make_condition, make_lock


class _Entry:
    __slots__ = ("key", "path", "server", "nbytes")

    def __init__(self, key, path, server, nbytes):
        self.key = key
        self.path = path
        self.server = server
        self.nbytes = int(nbytes)


class HandleCache:
    """LRU of factored serve handles, keyed by the caller's matrix key
    and backed by persist bundles.

    Parameters
    ----------
    budget_bytes : int
        Resident-handle byte budget; None reads
        ``SLU_TPU_FLEET_HANDLE_BYTES`` (0 = unbounded).
    server_kw : dict
        Extra ``SolveServer`` constructor keywords for every loaded
        handle (e.g. ``max_wait_s=0.0`` for the fleet's deterministic
        one-request batches).
    device :
        Where handles load: None is the card (CUDA without a card
        raises), ``"cpu"`` the CPU.
    """

    def __init__(self, budget_bytes: int | None = None,
                 server_kw: dict | None = None, device=None):
        from superlu_dist_tpu_torch.utils.options import (env_int,
                                                          resolve_device)
        if budget_bytes is None:
            budget_bytes = env_int("SLU_TPU_FLEET_HANDLE_BYTES")
        self.budget_bytes = int(budget_bytes)
        self.device = resolve_device("cuda" if device is None else device)
        self._server_kw = dict(server_kw or {})
        self._lock = make_lock("HandleCache._lock")
        self._cond = make_condition("HandleCache._cond", self._lock)
        self._paths: dict = {}                      # key -> bundle dir
        self._entries = collections.OrderedDict()   # key -> _Entry (LRU)
        self._loading: set = set()
        self._bytes = 0
        self._loads = 0
        self._hits = 0
        self._evictions = 0
        self._closed = False
        m = get_metrics()
        self._metrics = m if m.enabled else None

    # ------------------------------------------------------------------
    def register(self, key, bundle_path: str) -> dict:
        """Bind ``key`` to a persist bundle and return its manifest
        meta (the lu_meta cheap peek — validates the manifest and
        prices the handle without reading an array).  Re-registering a
        key (a deploy) re-points FUTURE loads; an already resident
        handle keeps serving until swapped or evicted."""
        from superlu_dist_tpu_torch.persist.serial import lu_meta
        meta = lu_meta(str(bundle_path))      # validates + prices
        with self._lock:
            self._paths[key] = str(bundle_path)
        return meta

    def path(self, key) -> str:
        with self._lock:
            return self._paths[key]

    def keys(self) -> list:
        """Registered keys (resident or not)."""
        with self._lock:
            return list(self._paths)

    def resident(self) -> list:
        """Keys currently holding a loaded server, LRU order."""
        with self._lock:
            return list(self._entries)

    # ------------------------------------------------------------------
    def get(self, key):
        """The server for ``key`` — a cache hit refreshes its LRU slot;
        a miss loads the registered bundle zero-refactor, evicting idle
        least-recently-used handles past the byte budget first, and
        scrub-verifies the freshly resident factors before returning.
        Concurrent getters of the same key coalesce onto one load."""
        while True:
            with self._lock:
                if self._closed:
                    raise SuperLUError("HandleCache is closed")
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self._hits += 1
                    return ent.server
                if key in self._loading:
                    self._cond.wait(0.05)
                    continue
                path = self._paths.get(key)
                if path is None:
                    raise SuperLUError(
                        f"handle key {key!r} is not registered with "
                        "this cache (register(key, bundle_path) first)")
                self._loading.add(key)
                break
        try:
            server, nbytes = self._load(key, path)
        except BaseException:
            with self._lock:
                self._loading.discard(key)
                self._cond.notify_all()
            raise
        with self._lock:
            self._loading.discard(key)
            self._entries[key] = _Entry(key, path, server, nbytes)
            self._bytes += nbytes
            self._loads += 1
            self._cond.notify_all()
        return server

    def _load(self, key, path):
        """Outside the lock (bundle I/O + digest work must never stall
        submit-side cache hits): price the
        handle off the manifest, make room, load, scrub-verify."""
        from superlu_dist_tpu_torch.persist.serial import lu_meta
        from superlu_dist_tpu_torch.serve.server import SolveServer
        nbytes = int(lu_meta(path).get("nbytes", 0))
        with get_tracer().span("handle-load", cat="request",
                               key=str(key), nbytes=nbytes):
            self._evict_for(nbytes)
            server = SolveServer.from_bundle(path, device=self.device,
                                             **self._server_kw)
            # scrub-verified (re)load: the resident panel stacks must
            # match the bundle manifest's sha256 ground truth BEFORE
            # serving (raises FactorCorruptError + quarantine on
            # mismatch)
            server.scrub_now()
        return server, nbytes

    def _evict_for(self, incoming: int) -> int:
        """Evict idle LRU entries until ``incoming`` bytes fit the
        budget.  Busy servers are never evicted (tickets outlive
        handles, not the other way round) — when everything resident is
        busy the cache runs over budget instead of dropping work.
        Server shutdown happens OUTSIDE the lock (close joins
        threads)."""
        if self.budget_bytes <= 0:
            return 0
        victims = []
        with self._lock:
            while self._bytes + incoming > self.budget_bytes:
                victim = None
                for ent in self._entries.values():      # LRU order
                    if ent.server.idle():
                        victim = ent
                        break
                if victim is None:
                    break
                del self._entries[victim.key]
                self._bytes -= victim.nbytes
                victims.append(victim)
            self._evictions += len(victims)
        for ent in victims:
            ent.server.close(timeout=10.0)
        if victims and self._metrics is not None:
            self._metrics.inc("slu_fleet_handle_evictions_total",
                              float(len(victims)))
        return len(victims)

    def deploy(self, key, bundle_path: str) -> bool:
        """Re-point ``key`` to a new bundle and hot-swap the resident
        server if one is loaded (``SolveServer.swap`` — the
        digest-verified load, queued + future tickets on the new
        handle, the in-flight batch finishing on the old one, zero
        dropped; the scrub baseline re-bases to the new manifest).
        Returns True when a resident handle was actually swapped.  The
        swap's bundle I/O runs OUTSIDE the cache lock."""
        meta = self.register(key, bundle_path)
        with self._lock:
            ent = self._entries.get(key)
            server = ent.server if ent is not None else None
        if server is None:
            return False
        server.swap(str(bundle_path))
        nbytes = int(meta.get("nbytes", 0))
        with self._lock:
            ent2 = self._entries.get(key)
            if ent2 is ent:
                self._bytes += nbytes - ent.nbytes
                ent.nbytes = nbytes
                ent.path = str(bundle_path)
        return True

    def drop(self, key) -> bool:
        """Explicitly evict ``key``'s resident server (idle or not —
        the deploy path drains through ``SolveServer.swap`` instead, so
        this is for teardown/tests).  Returns True when something was
        resident."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= ent.nbytes
        if ent is None:
            return False
        ent.server.close(timeout=10.0)
        return True

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": len(self._paths),
                "resident": len(self._entries),
                "resident_bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "loads": self._loads,
                "hits": self._hits,
                "evictions": self._evictions,
            }

    def close(self):
        with self._lock:
            self._closed = True
            servers = [ent.server for ent in self._entries.values()]
            self._entries.clear()
            self._bytes = 0
        for srv in servers:
            srv.close(timeout=10.0)
