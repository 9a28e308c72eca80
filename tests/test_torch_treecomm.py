"""The port's tree collectives (superlu_dist_tpu_torch/parallel/
treecomm.py over native/slu_host.cpp's slu_tree_*): flat and binary
trees with a nonzero root, bcast_obj bit for bit over chunked payloads,
the single-rank no-op, the fault-injection wrapper and its spec parser
against the JAX package's, the lockstep verifier naming both divergent
call sites, a JAX rank and a port rank in one shared-memory domain, and
the cross-rank reductions (Stats.reduce / StatsSummary, Metrics.reduce,
LatencyAccounter.reduce) against the JAX package's on the same inputs.

Ranks are threads of this process (each attaches the domain on its own;
ctypes releases the GIL in every native leg), so nothing forks under
JAX or torch.
"""

import os

import numpy as np
import pytest

from superlu_dist_tpu.obs import metrics as jmetrics
from superlu_dist_tpu.obs import slo as jslo
from superlu_dist_tpu.parallel import treecomm as jtreecomm
from superlu_dist_tpu.utils import stats as jstats

from superlu_dist_tpu_torch.obs import metrics, slo
from superlu_dist_tpu_torch.parallel import treecomm
from superlu_dist_tpu_torch.parallel.treecomm import (FaultyTreeComm,
                                                      TreeComm,
                                                      make_treecomm,
                                                      parse_fault_spec)
from superlu_dist_tpu_torch.testing.ranks import run_thread_ranks
from superlu_dist_tpu_torch.utils import stats
from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError

_SEQ = [0]


def _name(tag):
    _SEQ[0] += 1
    return f"/slt_tc_{tag}_{os.getpid()}_{_SEQ[0]}"


def run_ranks(n_ranks, fn, max_len=64, classes=None):
    return run_thread_ranks(_name("r"), n_ranks, fn, max_len=max_len,
                            classes=classes)


def _tree_ops(root):
    def fn(tc):
        buf = tc.bcast(np.full(8, float(tc.rank)), root=root)
        red = tc.reduce_sum(np.full(8, float(tc.rank + 1)), root=root)
        allred = tc.allreduce_sum(np.ones(8), root=root)
        return bool((buf == root).all()), float(red[0]), float(allred[0])
    return fn


@pytest.mark.parametrize("n_ranks,root", [(6, 3), (12, 7)],
                         ids=["flat6", "binary12"])
def test_tree_topologies_with_a_nonzero_root(n_ranks, root):
    """Flat tree up to 8 ranks, binary beyond (TreeBcast_slu.hpp:17-29),
    each rooted away from rank 0: bcast, reduce and an allreduce reusing
    the slots."""
    out = run_ranks(n_ranks, _tree_ops(root))
    total = n_ranks * (n_ranks + 1) / 2.0
    for r, (bcast_ok, red, allred) in out.items():
        assert bcast_ok, r
        if r == root:
            assert red == total
        assert allred == float(n_ranks)


def _obj_payload():
    return {
        "blob": b"\x00\xff analysis \x01" * 7,        # odd length, NULs
        "big_ints": np.array([2**62 + 3, -(2**55) - 1], dtype=np.int64),
        "nan_bits": np.array([np.nan, -0.0, np.inf]),
        "rows": [np.arange(5), np.arange(3) * 7],
    }


def test_bcast_obj_bit_exact_over_chunks():
    """Pickled objects ride the f64 slots bit for bit (int64 beyond 2^53,
    NaN payloads, a signed zero), through max_len=16 chunks."""
    out = run_ranks(4, lambda tc: tc.bcast_obj(
        _obj_payload() if tc.rank == 1 else None, root=1), max_len=16)
    ref = _obj_payload()
    for r, got in out.items():
        assert got["blob"] == ref["blob"], r
        assert np.array_equal(got["big_ints"], ref["big_ints"])
        assert np.array_equal(got["nan_bits"], ref["nan_bits"],
                              equal_nan=True)
        assert np.signbit(got["nan_bits"][1])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["rows"], ref["rows"]))


def test_any_payloads_complex_int_and_chunked():
    rng = np.random.default_rng(4)
    z = rng.standard_normal(37) + 1j * rng.standard_normal(37)
    k = np.arange(21, dtype=np.int64) * 3

    def fn(tc):
        return (tc.bcast_any(z if tc.rank == 0 else np.zeros_like(z)),
                tc.allreduce_sum_any(k), tc.reduce_sum_any(z, root=2))

    out = run_ranks(3, fn, max_len=8)
    for r, (bz, sk, rz) in out.items():
        assert np.array_equal(bz, z) and bz.dtype == z.dtype
        assert np.array_equal(sk, 3 * k) and sk.dtype == np.int64
        if r == 2:
            assert np.array_equal(rz, z + z + z)


def test_single_rank_noop():
    with TreeComm(_name("solo"), 1, 0, max_len=16, create=True) as tc:
        b = np.arange(4.0)
        tc.bcast(b)
        tc.reduce_sum(b)
        np.testing.assert_array_equal(b, np.arange(4.0))
        assert tc.comm_stats.totals()["bcast"]["calls"] == 1


FAULT_SPEC = "drop=0.3,dup=0.2,reorder=0.5,delay=0.0005,seed=7"


@pytest.mark.faultinject
def test_faulty_collectives_bit_exact_and_counted_as_jax():
    """Chunk faults (drop + retry, duplicate, reorder) are masked by the
    retransmission layer, and the deterministic schedule injects the same
    faults as the JAX package's wrapper on the same payloads."""
    payload = np.random.default_rng(3).standard_normal(700)
    blob = b"\x01\x02 fault transport \xff" * 41
    counts = []
    for cls in (FaultyTreeComm, jtreecomm.FaultyTreeComm):
        with cls(_name("fault"), 1, 0, max_len=64, create=True,
                 **parse_fault_spec(FAULT_SPEC)) as tc:
            np.testing.assert_array_equal(tc.bcast_any(payload.copy()),
                                          payload)
            np.testing.assert_array_equal(
                tc.allreduce_sum_any(payload.copy()), payload)
            assert tc.bcast_bytes(blob) == blob
            counts.append(dict(tc.fault_counts))
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0


@pytest.mark.parametrize("spec", [" drop=0.1, seed=3 ", FAULT_SPEC,
                                  "max_retries=5,dup=0.5", "dorp=0.1"])
def test_parse_fault_spec_equals_jax(spec):
    try:
        want = jtreecomm.parse_fault_spec(spec)
    except ValueError:
        with pytest.raises(ValueError, match="unknown"):
            parse_fault_spec(spec)
        return
    assert parse_fault_spec(spec) == want


def test_make_treecomm_is_env_gated(monkeypatch):
    monkeypatch.delenv("SLU_TPU_FAULTS", raising=False)
    with make_treecomm(_name("mk"), 1, 0, max_len=8, create=True) as tc:
        assert type(tc) is TreeComm
    monkeypatch.setenv("SLU_TPU_FAULTS", "drop=0.5,seed=1")
    with make_treecomm(_name("mk"), 1, 0, max_len=8, create=True) as tc:
        assert isinstance(tc, FaultyTreeComm) and tc._p_drop == 0.5


def _divergent(tc):
    if tc.rank == 0:
        return tc.bcast(np.ones(3))                    # site A
    return tc.reduce_sum(np.ones(5))                   # site B


def test_lockstep_verifier_names_both_divergent_sites(monkeypatch):
    """With SLU_TPU_VERIFY_COLLECTIVES=1 two ranks entering different
    collectives both raise CollectiveMismatchError naming both call sites
    instead of deadlocking."""
    monkeypatch.setenv("SLU_TPU_VERIFY_COLLECTIVES", "1")
    out = run_ranks(2, _divergent)
    for r, exc in out.items():
        assert isinstance(exc, CollectiveMismatchError), (r, exc)
        msg = str(exc)
        assert "bcast[3]" in msg and "reduce_sum[5]" in msg, msg
        sites = {rec["site"] for rec in exc.records}
        assert len(sites) == 2 and all(
            s.startswith("tests/test_torch_treecomm.py:") for s in sites)


def test_verified_lockstep_runs_clean(monkeypatch):
    monkeypatch.setenv("SLU_TPU_VERIFY_COLLECTIVES", "1")
    out = run_ranks(3, lambda tc: (tc.allreduce_sum_any(np.ones(4)),
                                   tc._verifier.checks))
    assert all((v == 3).all() and checks == 1 for v, checks in out.values())


def test_jax_rank_and_port_rank_share_one_domain():
    """The port's slu_tree_* is the JAX library's code: a JAX TreeComm and
    a port TreeComm join one shared-memory domain and complete bcast,
    reduce and allreduce together (either side creating it)."""
    z = np.random.default_rng(5).standard_normal(50)

    def fn(tc):
        got = tc.bcast_any(z if tc.rank == 1 else np.zeros(50), root=1)
        red = tc.reduce_sum_any(np.full(6, tc.rank + 1.0), root=0)
        return got, red, tc.allreduce_sum_any(np.arange(4.0))

    for classes in ({0: TreeComm, 1: jtreecomm.TreeComm},
                    {0: jtreecomm.TreeComm, 1: TreeComm}):
        out = run_ranks(2, fn, max_len=16, classes=classes)
        for r, (got, red, allred) in out.items():
            assert np.array_equal(got, z)
            assert np.array_equal(allred, 2 * np.arange(4.0))
            if r == 0:
                assert np.array_equal(red, np.full(6, 3.0))


def test_pid_alive_is_the_fleets_verdict():
    from superlu_dist_tpu_torch.serve import fleet
    assert fleet.pid_alive is treecomm.pid_alive
    assert treecomm.pid_alive(os.getpid()) == jtreecomm.pid_alive(os.getpid())
    assert not treecomm.pid_alive(0) and not jtreecomm.pid_alive(0)


def _fill_stats(mod, rank):
    st = mod.Stats()
    for i, p in enumerate(mod.PHASES):
        st.utime[p] = 0.25 * (i + 1) * (rank + 1)
        st.ops[p] = 1e6 * (i + rank)
    st.tiny_pivots, st.refine_steps = rank, 2 * rank
    st.peak_memory_bytes = 1000 * (rank + 1)
    cs = mod.CommStats()
    cs.add("bcast", 800 * (rank + 1), 0.01 * (rank + 1))
    cs.add("allreduce", 64, 0.002)
    return st.attach_comm(cs)


def test_stats_reduce_and_summary_equal_jax():
    """Stats.reduce over three ranks — rank 0 a port rank, the others JAX
    ranks of the same domain — gives every rank the same StatsSummary as
    the JAX package's, min / max / avg / balance and the comm split."""
    classes = {0: TreeComm, 1: jtreecomm.TreeComm, 2: jtreecomm.TreeComm}

    def fn(tc):
        mod = stats if isinstance(tc, TreeComm) else jstats
        return _fill_stats(mod, tc.rank).reduce(tc)

    out = run_ranks(3, fn, max_len=32, classes=classes)
    mine = out[0]
    for r in (1, 2):
        ref = out[r]
        assert mine.n_ranks == ref.n_ranks == 3
        assert mine.utime == {p: jstats_to_port(v)
                              for p, v in ref.utime.items()}
        assert mine.ops == {p: jstats_to_port(v) for p, v in ref.ops.items()}
        assert (mine.tiny_pivots, mine.refine_steps) == (3, 6)
        assert mine.comm.keys() == ref.comm.keys() == {"bcast", "allreduce"}
        assert mine.report() == ref.report()
    assert mine.balance("FACT") == pytest.approx(1.5)


def jstats_to_port(rs):
    return stats.RankStat(min=rs.min, max=rs.max, avg=rs.avg, total=rs.total)


def test_metrics_reduce_equals_jax_over_two_ranks():
    """Metrics.reduce agrees the key union (one bcast_obj per rank) and
    reduces the aligned values: a port rank and a JAX rank with different
    series each get the JAX package's result."""
    def fn(tc):
        mod = metrics if isinstance(tc, TreeComm) else jmetrics
        m = mod.Metrics()
        m.inc("slu_comm_calls_total", 1.0 + tc.rank, op="bcast")
        m.set(f"slu_rank{tc.rank}_gauge", 2.0)
        m.observe("slu_comm_seconds", 0.01 * (tc.rank + 1), op="bcast")
        return m.reduce(tc)

    out = run_ranks(2, fn, classes={0: TreeComm, 1: jtreecomm.TreeComm})
    assert out[0] == out[1]
    assert out[0]["counter:slu_comm_calls_total{op=\"bcast\"}"] == {
        "sum": 3.0, "min": 1.0, "max": 2.0, "avg": 1.5}
    assert out[0]["gauge:slu_rank1_gauge"]["min"] == 0.0


def test_latency_accounter_reduce_equals_jax():
    def fn(tc):
        mod = slo if isinstance(tc, TreeComm) else jslo
        acc = mod.LatencyAccounter()
        for k, sec in ((1, 0.001 * (tc.rank + 1)), (16, 0.02), (4, 0.5)):
            acc.observe(k, sec)
        return acc.reduce(tc)

    out = run_ranks(3, fn, max_len=32,
                    classes={0: TreeComm, 1: jtreecomm.TreeComm,
                             2: TreeComm})
    assert out[0] == out[1] == out[2]
    assert sum(s["count"] for s in out[0].values()) == 9
