"""Solver options.

Mirrors the reference's runtime option struct ``superlu_dist_options_t``
(SRC/superlu_defs.h:628-657) and its defaults ``set_default_options_dist``
(SRC/util.c:376-401).  The values are the defaults the JAX package
resolves when no environment knob is set.

The environment-knob registry (``register_knob``, ``env_int`` /
``env_float`` / ``env_str`` / ``env_flag``) is the JAX package's, with
the knobs this package reads: the device solve's nrhs buckets, the
serving tier (``SLU_TPU_SERVE_*``, ``SLU_TPU_FLEET_*``), observability
(``SLU_TPU_TRACE``, ``SLU_TPU_METRICS``, ``SLU_TPU_FLIGHTREC*``,
``SLU_TPU_SLO_*``, ``SLU_TPU_STATS``), the chaos harness, the lock-order
verifier and the distributed tier (``SLU_TPU_FAULTS``,
``SLU_TPU_VERIFY_COLLECTIVES``, ``SLU_TPU_COMM_*``,
``SLU_TPU_HEARTBEAT_S``, ``SLU_TPU_FT``, ``SLU_TPU_DEADLINE_POLL``).
Each has the JAX package's kind, default and meaning.  The solver's
other choices are ``Options`` fields here, not knobs, except ``ft``,
which defaults to ``SLU_TPU_FT`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import os

import torch


# ---------------------------------------------------------------------------
# Environment-knob registry — the single source of truth for every env var
# this package reads.  Every read routes through env_int/env_float/env_str/
# env_flag below, and SLU_TPU_STRICT_ENV=1 turns a typo'd SLU_TPU_* knob
# name into a hard error instead of a silently-ignored setting.
# ---------------------------------------------------------------------------


class UnknownKnobError(KeyError):
    """An env knob was read or set that the registry does not declare."""


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str            # "int" | "float" | "str" | "flag"
    default: object
    help: str
    group: str = "solver"
    choices: tuple | None = None


KNOB_REGISTRY: dict[str, Knob] = {}


def register_knob(name: str, kind: str, default, help: str,
                  group: str = "solver", choices: tuple | None = None) -> None:
    assert kind in ("int", "float", "str", "flag"), kind
    KNOB_REGISTRY[name] = Knob(name, kind, default, help, group, choices)


def _register_all() -> None:
    r = register_knob
    # --- device solve / serving tier (solve/device.py, serve/) -------------
    r("SLU_TPU_SOLVE_NRHS_MAX", "int", 1024,
      "largest nrhs bucket — the column-chunking cap that closes the "
      "set of solve graphs", group="solve")
    r("SLU_TPU_SOLVE_NRHS_GROWTH", "float", 1.5,
      "geometric nrhs bucket growth past the power-of-two rungs "
      "(rounded to multiples of 32)", group="solve")
    r("SLU_TPU_SERVE_MAX_BATCH", "int", 0,
      "SolveServer micro-batch column cap (0 = the nrhs bucket cap)",
      group="serve")
    r("SLU_TPU_SERVE_MAX_WAIT_MS", "float", 2.0,
      "SolveServer coalescing window: how long the dispatcher holds the "
      "oldest pending request open for co-batching before dispatching",
      group="serve")
    r("SLU_TPU_SERVE_QUEUE_MAX", "int", 0,
      "SolveServer admission cap in pending COLUMNS: a submit that "
      "would exceed it is shed with ServeOverloadError instead of "
      "queueing (0 = unbounded)", group="serve")
    r("SLU_TPU_SERVE_DEADLINE_MS", "float", 0.0,
      "per-request serving deadline: columns still queued past it are "
      "expired with ServeDeadlineError and removed from the queue "
      "(0 = off)", group="serve")
    r("SLU_TPU_SERVE_BERR_MAX", "float", 0.0,
      "per-request componentwise-berr quality gate: a served ticket "
      "whose berr exceeds it is routed through a per-ticket iterative-"
      "refinement rung (refine/ir.refine_ticket) before delivery "
      "(0 = off; needs the original matrix on the handle)",
      group="serve")
    r("SLU_TPU_SERVE_SCRUB_S", "float", 0.0,
      "factor-integrity scrub period: a background thread re-hashes "
      "the handle's panel stacks against their persist-bundle sha256 "
      "digests every this-many seconds, quarantining the handle with "
      "FactorCorruptError on mismatch (0 = off)", group="serve")
    # --- serving fleet -----------------------------------------------------
    r("SLU_TPU_FLEET_REPLICAS", "int", 2,
      "FleetRouter default replica count (serve/fleet.py): how many "
      "SolveServer replicas the routing front fans submits across",
      group="fleet")
    r("SLU_TPU_FLEET_KIND", "str", "thread",
      "fleet replica isolation: in-process worker threads or spawned "
      "worker processes behind the same interface", group="fleet",
      choices=("thread", "process"))
    r("SLU_TPU_FLEET_HANDLE_BYTES", "int", 0,
      "per-replica resident-handle byte budget for the multi-handle "
      "LRU cache (serve/handlecache.py, sized via the persist lu_meta "
      "cheap peek): least-recently-used idle handles are evicted and "
      "scrub-verified on reload (0 = unbounded)", group="fleet")
    r("SLU_TPU_FLEET_QUEUE_MAX", "int", 0,
      "fleet-level admission cap in undelivered COLUMNS across all "
      "replicas: a submit past it is shed with ServeOverloadError "
      "(reason fleet_queue_full) at the router, before any replica "
      "queues it (0 = unbounded)", group="fleet")
    r("SLU_TPU_FLEET_DEADLINE_MS", "float", 0.0,
      "end-to-end per-ticket fleet deadline: a ticket undelivered past "
      "it — queued, in flight, or mid-failover — is expired with "
      "ServeDeadlineError by the health monitor or the waiting ticket "
      "itself (0 = off)", group="fleet")
    r("SLU_TPU_FLEET_HEALTH_S", "float", 0.05,
      "fleet health-monitor poll period: replica process/thread "
      "liveness (pid_alive), failover re-routing of undelivered "
      "tickets, and deadline sweeps run on this cadence", group="fleet")
    # --- the mesh tier's factor pool (parallel/mesh_stream.py) -------------
    r("SLU_TPU_POOL_PARTITION", "flag", False,
      "shard the Schur update pool across all mesh devices", group="numeric")
    # --- distributed tier (parallel/treecomm.py, parallel/recover.py) ------
    r("SLU_TPU_FAULTS", "str", "",
      "fault-injection spec for TreeComm (e.g. 'drop=0.2,seed=7')",
      group="parallel")
    r("SLU_TPU_VERIFY_COLLECTIVES", "flag", False,
      "TreeComm lockstep-verify mode: cross-check every collective's "
      "(call-site, op, shape/dtype, seq) digest across ranks and raise "
      "CollectiveMismatchError instead of deadlocking",
      group="parallel")
    r("SLU_TPU_COMM_TIMEOUT_S", "float", 0.0,
      "bounded-wait collectives: every native tree leg's spin loop gets "
      "this deadline (exponential backoff + jitter); on expiry the "
      "failure detector is consulted — dead peer => RankFailureError on "
      "every survivor, live peer => retry.  0 = unbounded",
      group="parallel")
    r("SLU_TPU_COMM_RETRIES", "int", 0,
      "timed-out-but-peer-alive retry budget per collective leg; "
      "exhausting it raises CommTimeoutError.  0 = unlimited (a slow "
      "peer is waited out; only DEATH fails the collective)",
      group="parallel")
    r("SLU_TPU_HEARTBEAT_S", "float", 0.5,
      "failure-detector heartbeat interval (epoch bumps in the shared "
      "segment + heartbeat-age gauge); the thread only starts when "
      "SLU_TPU_COMM_TIMEOUT_S > 0.  0 disables the thread (pid "
      "liveness still detects death)", group="parallel")
    r("SLU_TPU_FT", "str", "abort",
      "rank-failure policy for fault-tolerant drivers "
      "(parallel/recover.pgssvx_ft): abort = raise RankFailureError; "
      "shrink = survivors re-partition and resume from the checkpoint "
      "frontier; respawn = replacement processes take the dead ranks",
      group="parallel", choices=("abort", "shrink", "respawn"))
    r("SLU_TPU_DEADLINE_POLL", "int", 1,
      "poll cadence of the collective deadline flag allreduce "
      "(one exchange per N dispatch groups)", group="persist")
    r("SLU_TPU_STATS", "flag", False,
      "print the PStatPrint-analog report from any driver run", group="obs")
    r("SLU_TPU_VERIFY_LOCKS", "flag", False,
      "lock-order verify mode (utils/lockwatch.py): instrument every "
      "make_lock/make_condition lock, record per-thread acquisition "
      "stacks into a global order graph, and raise LockOrderError "
      "naming both call sites on the first inversion instead of "
      "deadlocking; feeds the slu_lock_hold_seconds histogram when "
      "metrics are on", group="parallel")
    # --- observability -----------------------------------------------------
    r("SLU_TPU_TRACE", "str", "",
      "structured span trace output path ('%p' expands to the pid)",
      group="obs")
    r("SLU_TPU_METRICS", "str", "",
      "metrics registry: '1' enables; a path additionally dumps the "
      "JSON/Prometheus export there at exit ('%p' expands to the pid)",
      group="obs")
    r("SLU_TPU_FLIGHTREC", "str", "",
      "flight recorder: '1' enables (default flightrec-%p.json dump); "
      "a path names the postmortem artifact ('%p' expands to the pid)",
      group="obs")
    r("SLU_TPU_FLIGHTREC_DEPTH", "int", 512,
      "flight-recorder ring depth (events kept for the postmortem)",
      group="obs")
    r("SLU_TPU_SLO_P99_MS", "float", 0.0,
      "global p99 latency SLO target in ms for the serving tier "
      "(obs/slo.py SLOEvaluator, fleet health model; 0 = no SLO)",
      group="obs")
    r("SLU_TPU_SLO_TARGETS", "str", "",
      "per-traffic-class p99 SLO overrides, 'class=ms,class=ms' "
      "(classes: serve, fleet, driver, bench; overrides "
      "SLU_TPU_SLO_P99_MS for the named class)", group="obs")
    r("SLU_TPU_SLO_BUDGET", "float", 0.01,
      "SLO error budget: provisioned fraction of requests allowed over "
      "the p99 target; burn rate = over-target fraction / budget",
      group="obs")
    # --- env discipline ----------------------------------------------------
    r("SLU_TPU_STRICT_ENV", "flag", False,
      "raise on SLU_TPU_* env vars the registry does not declare")
    # --- test / CI harness -------------------------------------------------
    r("SLU_TPU_CHAOS", "str", "",
      "failure-domain chaos-injection spec (testing/chaos.py, e.g. "
      "'kill_group=5', 'nan_supernode=3', 'kill_refactor@step=0', "
      "'poison_values=2'); empty = off", group="test")


_register_all()

_FLAG_FALSE = ("", "0", "false", "no", "off")
_strict_checked = False


def _check_strict_env() -> None:
    """Under SLU_TPU_STRICT_ENV=1, an SLU_TPU_* env var the registry does
    not declare raises (with a did-you-mean) instead of being silently
    ignored.  Checked once, on the first registry read.  The JAX
    package's own knobs count as undeclared here: this package reads
    none of them."""
    global _strict_checked
    if _strict_checked:
        return
    _strict_checked = True
    raw = os.environ.get("SLU_TPU_STRICT_ENV", "")
    if raw.strip().lower() in _FLAG_FALSE:
        return
    unknown = sorted(k for k in os.environ
                     if k.startswith("SLU_TPU_") and k not in KNOB_REGISTRY)
    if unknown:
        import difflib
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, KNOB_REGISTRY, n=1)
            hints.append(f"{k}" + (f" (did you mean {close[0]}?)"
                                   if close else ""))
        raise UnknownKnobError(
            "unknown SLU_TPU_* environment knob(s) under "
            f"SLU_TPU_STRICT_ENV=1: {', '.join(hints)}")


_UNSET = object()


def _knob_raw(name: str, default):
    if name not in KNOB_REGISTRY:
        raise UnknownKnobError(
            f"env knob {name!r} is not declared in the registry "
            "(superlu_dist_tpu_torch/utils/options.py) — register it there")
    _check_strict_env()
    raw = os.environ.get(name)
    d = KNOB_REGISTRY[name].default if default is _UNSET else default
    return raw, d


def env_int(name: str, default=_UNSET) -> int:
    """Registered integer knob; unset or unparsable values yield the
    default."""
    raw, d = _knob_raw(name, default)
    if raw is None:
        return d
    try:
        return int(raw)
    except ValueError:
        return d


def env_float(name: str, default=_UNSET) -> float:
    raw, d = _knob_raw(name, default)
    if raw is None:
        return d
    try:
        return float(raw)
    except ValueError:
        return d


def env_str(name: str, default=_UNSET) -> str:
    raw, d = _knob_raw(name, default)
    return d if raw is None else raw


def env_flag(name: str, default=_UNSET) -> bool:
    """Registered on/off knob: unset -> default; '', '0', 'false', 'no',
    'off' (any case) -> False; anything else -> True."""
    raw, d = _knob_raw(name, default)
    if raw is None:
        return bool(d)
    return raw.strip().lower() not in _FLAG_FALSE


def knob_table_md(groups: tuple | None = None) -> str:
    """Markdown table of the registry."""
    lines = ["| Knob | Kind | Default | Group | Meaning |",
             "|---|---|---|---|---|"]
    for k in sorted(KNOB_REGISTRY.values(),
                    key=lambda k: (k.group, k.name)):
        if groups is not None and k.group not in groups:
            continue
        extra = (f" ({'/'.join(map(str, k.choices))})" if k.choices else "")
        lines.append(f"| `{k.name}` | {k.kind} | `{k.default}` | {k.group} "
                     f"| {k.help}{extra} |")
    return "\n".join(lines)


class Fact(enum.Enum):
    """Factorization reuse tiers (reference fact_t, superlu_defs.h:489-510)."""

    DOFACT = 0                      # factor from scratch
    SamePattern = 1                 # reuse column perm + symbolic + plan
    SamePattern_SameRowPerm = 2     # additionally reuse row perm + scalings
    FACTORED = 3                    # reuse the numeric factors (solve only)


class ColPerm(enum.Enum):
    """Fill-reducing column orderings (reference colperm_t; dispatch
    get_perm_c_dist, SRC/get_perm_c.c:463-530)."""

    NATURAL = 0
    MMD_AT_PLUS_A = 1       # minimum degree on pattern of A^T + A
    ND_AT_PLUS_A = 2        # nested dissection (METIS analog)
    METIS_AT_PLUS_A = 2     # alias: the reference default maps to our ND
    MY_PERMC = 3            # user-supplied permutation
    MMD_ATA = 4             # minimum degree on pattern of A^T A
    COLAMD = 5              # approximate column MD directly on A


class RowPerm(enum.Enum):
    """Numerical row pivoting strategy (reference rowperm_t;
    dldperm_dist, SRC/dldperm_dist.c:95)."""

    NOROWPERM = 0
    LargeDiag_MC64 = 1      # maximum-product weighted bipartite matching
    LargeDiag_AWPM = 2      # approximate-weight perfect matching
    MY_PERMR = 3


class IterRefine(enum.Enum):
    """Iterative refinement (reference IterRefine_t; pdgsrfs.c:120)."""

    NOREFINE = 0
    SLU_SINGLE = 1
    SLU_DOUBLE = 2


class Trans(enum.Enum):
    """Which system is solved through the factors of A (reference
    trans_t, superlu_defs.h:628-657): A·X = B, Aᵀ·X = B or Aᴴ·X = B."""

    NOTRANS = 0
    TRANS = 1
    CONJ = 2


@dataclasses.dataclass
class RecoveryPolicy:
    """Solver health and recovery (the pdgscon/pdgsrfs repair loop made
    automatic), with the JAX package's defaults.

    ``enabled`` drives the escalation ladder of drivers/gssvx.py: when
    refinement stagnates above ``berr_target`` (None: 10·eps of the
    residual dtype) the driver escalates the residual precision, the GEMM
    tier, the factor precision, and finally refactors with equilibration
    and MC64 forced on, recording every rung in the SolveReport (at most
    ``max_rungs``).  ``sentinels`` arms the isfinite checks on the factors
    and on the delivered solution.  ``condest`` says when rcond and ferr
    are estimated: "always", "never", or "auto" (when the ladder fired,
    tiny pivots were replaced, or refinement missed its target)."""

    enabled: bool = True
    sentinels: bool = True
    condest: str = "auto"              # "always" | "auto" | "never"
    berr_target: float | None = None   # None => 10·eps(residual dtype)
    max_rungs: int = 3                 # ladder depth cap


#: the numeric executors the port runs ("spmd": the 1-D mesh tier,
#: parallel/spmd.py — every rank of a grid of several ranks factors its
#: own slots; off such a grid it resolves to "stream", the JAX rule; on
#: such a grid "stream" is the 2-D mesh executor, parallel/mesh_stream.py)
EXECUTORS = ("auto", "stream", "fused", "mega", "spmd")


@dataclasses.dataclass
class Options:
    """Runtime options (analog of superlu_dist_options_t).

    Defaults follow set_default_options_dist (SRC/util.c:376-401):
    Fact=DOFACT, Equil=YES, ColPerm=METIS_AT_PLUS_A, RowPerm=LargeDiag_MC64,
    ReplaceTinyPivot, IterRefine=DOUBLE, plus the JAX package's blocking
    and scheduling defaults.  ``native``, ``symb_threads`` and
    ``nd_threads`` take the place of the JAX package's SLU_TPU_NO_NATIVE,
    SLU_TPU_SYMB_THREADS and SLU_TPU_ND_THREADS; ``gemm_prec``,
    ``solve_schedule``, ``solve_window`` and ``solve_align`` hold the
    values its SLU_TPU_GEMM_PREC and SLU_TPU_SOLVE_* knobs resolve to when
    unset.
    """

    fact: Fact = Fact.DOFACT
    equil: bool = True
    col_perm: ColPerm = ColPerm.ND_AT_PLUS_A
    row_perm: RowPerm = RowPerm.LargeDiag_MC64
    replace_tiny_pivot: bool = True
    iter_refine: IterRefine = IterRefine.SLU_DOUBLE
    trans: Trans = Trans.NOTRANS
    relax: int = 20                   # NREL: amalgamate subtrees <= relax cols
    max_supernode: int = 256          # NSUP: cap supernode width
    factor_dtype: str | None = None   # None => float32 on cuda, float64 on
                                      # cpu; complex values take the
                                      # complex type of that width
    ir_dtype: str = "float64"         # residual precision for refinement
    amalg_tol: float = 1.2            # fill-tolerant amalgamation flop growth
    bucket_growth: float = 1.5        # geometric padding of front buckets
    min_bucket: int = 8               # smallest padded front dimension
    schedule: str = "dataflow"        # factor-group scheduler
    sched_window: int = 8             # dataflow look-ahead, in levels
    sched_align: float = 1.1          # shape-key coalescing flop tolerance
    gemm_prec: str = "default"        # GEMM ladder tier (ops/dense.gemm):
                                      # bf16 | default (TF32 on the card) |
                                      # f32 | highest
    diag_inv: bool = False            # DiagInv: solve the diagonal blocks
                                      # by GEMMs with their inverses
    solve_schedule: str = "dataflow"  # sweep schedule (solve/plan.py):
                                      # dataflow | level | factor
    solve_window: int = 0             # dataflow look-ahead of the solve
                                      # (levels; 0 = unbounded)
    solve_align: float = 1.25         # solve-side shape-key coalescing
    native: bool = True               # host analysis in the native library
                                      # (native/); False runs the Python
                                      # twins
    symb_threads: int = 1             # threads of the native symbolic
    nd_threads: int = 1               # threads of the native multilevel ND
    recovery: RecoveryPolicy = dataclasses.field(
        default_factory=RecoveryPolicy)
    # user-supplied permutations for MY_PERMC / MY_PERMR
    user_perm_c: object = dataclasses.field(default=None, compare=False)
    user_perm_r: object = dataclasses.field(default=None, compare=False)
    print_stat: bool = False          # print the options banner and the
                                      # Stats report after each gssvx
    # crash consistency (persist/): a cooperative factorization deadline
    # in seconds, polled between dispatch groups (None = off), the
    # checkpoint interval in completed groups (0 = off) and the
    # checkpoint directory ("" = .slu_ckpt in the working directory)
    deadline_s: float | None = None
    ckpt_every: int = 0
    ckpt_dir: str = ""
    # the numeric executor (numeric/factor.get_executor) and its knobs,
    # each at the value the JAX package's knob resolves to when unset
    executor: str = "auto"            # SLU_TPU_EXECUTOR: auto | stream |
                                      # fused | mega | spmd (auto: spmd
                                      # under a grid, else stream on the
                                      # card and fused on the CPU; stream
                                      # or pool_partition under a grid:
                                      # the 2-D mesh executor)
    bucket_closed: bool = False       # SLU_TPU_BUCKET_CLOSED: close the
                                      # plan's shape keys (mega's plans)
    bucket_keys: int = 6              # SLU_TPU_BUCKET_KEYS: the closed
                                      # key budget
    front_bytes_limit: float = 6e9    # SLU_TPU_FRONT_BYTES_LIMIT: padded
                                      # front bytes above which the stream
                                      # executor offloads factors to host
    offload_lag: int = 8              # SLU_TPU_OFFLOAD_LAG: groups of
                                      # device panels in flight to host
    host_flops: float = 0.0           # SLU_TPU_HOST_FLOPS: leading levels
                                      # cheaper than this run on the CPU
                                      # (0 = off)
    # the mesh tier's distributed ordering + symbolic (ParSymbFact,
    # parallel/panalysis.py): read by pgssvx(grid=)
    par_symb_fact: bool = False
    # keep each Schur element only on the grid rank that extend-adds it
    # (the 2-D mesh executor, parallel/mesh_stream.py: per-rank pool
    # memory falls with the grid); ignored off a grid of several ranks,
    # as the JAX package's pool_spec is without a mesh —
    # SLU_TPU_POOL_PARTITION=1
    pool_partition: bool = dataclasses.field(
        default_factory=lambda: env_flag("SLU_TPU_POOL_PARTITION"))
    # what a declared-dead peer rank does to a fault-tolerant driver
    # (parallel/recover.pgssvx_ft): "abort" re-raises RankFailureError,
    # "shrink" resumes on the survivors, "respawn" replaces the dead rank
    # with a fresh process.  Only the FT epoch loop consults it; the
    # drivers validate it
    ft: str = dataclasses.field(
        default_factory=lambda: env_str("SLU_TPU_FT"))

    def __post_init__(self):
        # the JAX package reads these from SLU_TPU_DEADLINE_S and
        # SLU_TPU_CKPT_EVERY, where 0 means off
        if not self.deadline_s:
            self.deadline_s = None
        elif self.deadline_s < 0:
            raise ValueError(f"deadline_s must be positive or None, got "
                             f"{self.deadline_s!r}")
        if int(self.ckpt_every) < 0:
            raise ValueError(f"ckpt_every must be >= 0, got "
                             f"{self.ckpt_every!r}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"executor must be one of {EXECUTORS}, got "
                             f"{self.executor!r}")
        if int(self.offload_lag) < 0 or int(self.bucket_keys) < 1:
            raise ValueError("offload_lag must be >= 0 and bucket_keys >= 1")


#: the rank-failure policies of ``Options.ft``
FT_MODES = ("abort", "shrink", "respawn")


def check_ft(options) -> str:
    """``options.ft`` (empty: "abort"), or SuperLUError for a typo — every
    driver checks it, so a mistyped SLU_TPU_FT fails at once instead of
    silently aborting the first real rank failure."""
    ft = getattr(options, "ft", "abort") or "abort"
    if ft not in FT_MODES:
        from superlu_dist_tpu_torch.utils.errors import SuperLUError
        raise SuperLUError(
            f"Options.ft must be abort|shrink|respawn, got {ft!r}")
    return ft


def print_options(o: Options) -> str:
    """print_options_dist analog (SRC/util.c:405-439)."""
    lines = ["**************************************************",
             ".. options:"]
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if f.name in ("user_perm_c", "user_perm_r"):
            # summarize, never dump an n-entry permutation into the banner
            v = None if v is None else f"<perm len={len(v)}>"
        elif f.name == "recovery":
            v = (f"enabled={v.enabled} sentinels={v.sentinels} "
                 f"condest={v.condest}")
        lines.append(f"**    {f.name:<20s} {getattr(v, 'name', v)}")
    lines.append("**************************************************")
    return "\n".join(lines)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  "cuda" without a card raises:
    the port never falls back to the CPU — only a caller that passes
    device="cpu" gets it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def default_factor_dtype(device: torch.device) -> torch.dtype:
    """float32 factors on the card (refined to f64 on the host), float64
    on the CPU — the JAX package's TPU/CPU split."""
    return torch.float32 if device.type == "cuda" else torch.float64


#: factor dtypes the port runs, by name; complex values promote a real
#: name to the complex type of its width (the JAX package's rule,
#: drivers/gssvx.py:415-416)
FACTOR_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "complex64": torch.complex64, "complex128": torch.complex128}
_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def resolve_factor_dtype(name: str | None, device: torch.device,
                         cplx: bool = False) -> torch.dtype:
    """The torch dtype of the factors: ``name`` (an Options.factor_dtype)
    or the device's default, promoted to complex for complex values.
    Raises NotImplementedError for a name the port does not run (df64,
    the JAX package's emulated double, is not ported)."""
    if name is None:
        dt = default_factor_dtype(device)
    elif str(name) in FACTOR_DTYPES:
        dt = FACTOR_DTYPES[str(name)]
    else:
        raise NotImplementedError(
            f"factor_dtype {name!r} is not ported; the port runs "
            f"{sorted(FACTOR_DTYPES)} (ROADMAP.md)")
    return _COMPLEX_OF.get(dt, dt) if cplx else dt
