"""The port's C API (superlu_dist_tpu_torch/bindings/) on the CPU, beside
the JAX package's.

* ``capi_impl`` of both packages on the same CSR and b, through the same
  raw-pointer calls the C shim makes: the options registry contract
  (error codes -3 bad handle, -5 unknown key, -6 bad value; the
  reference-style aliases; options snapshotted at factor time), the
  strided (ldb > n) factor / refactor tiers 1 and 2 / solve, the one-shot
  and legacy solves, and the ``stat_get`` names; x within DEVICE_VS_HOST.
* The C client (bindings/test_capi.c) compiled with gcc against
  ``libslu_tpu_torch.so`` and run with ``slu_tpu_init("cpu")``: the
  tridiagonal self-check, and poisson3d(6) built in C, its x bit for bit
  the port's in-process ``gssvx`` of the same b on the CPU.
* ``slu_tpu_init("tpu")`` is -1, and so is the default (the card) on a
  machine without one: nothing falls back to the CPU.
"""

import math
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import superlu_dist_tpu.bindings.capi_impl as jimpl

import superlu_dist_tpu_torch as slt
import superlu_dist_tpu_torch.bindings.capi_impl as impl
from superlu_dist_tpu_torch.bindings import build
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("FACT", "SOLVE", "REFINE", "EQUIL", "ROWPERM", "COLPERM",
         "SYMBFACT", "DIST", "FACT_FLOPS", "FACT_GFLOPS", "TINY_PIVOTS",
         "REFINE_STEPS", "BERR", "LU_BYTES", "TOTAL_BYTES", "NNZ_L", "NNZ_U")


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    assert impl.init("cpu") == 0
    yield
    impl.shutdown()


def _ptr(arr):
    return arr.ctypes.data


class System:
    """A CSR, kept alive, and its pointers as the C shim passes them."""

    def __init__(self, a):
        self.n, self.nnz = a.n_rows, a.nnz
        self.ip = np.ascontiguousarray(a.indptr, dtype=np.int64)
        self.ix = np.ascontiguousarray(a.indices, dtype=np.int64)
        self.v = np.ascontiguousarray(a.data, dtype=np.float64)

    def args(self, v=None):
        return (self.n, self.nnz, _ptr(self.ip), _ptr(self.ix),
                _ptr(self.v if v is None else v))


def _strided(n, nrhs, ld, seed):
    b = np.zeros((ld, nrhs), order="F")
    b[:n] = np.random.default_rng(seed).standard_normal((n, nrhs))
    return b


def _solve_factored(mod, h, opt, n, b, ld, nrhs):
    x = np.zeros((ld, nrhs), order="F")
    rc = mod.solve_factored_opts(h, opt, n, _ptr(b), ld, _ptr(x), ld, nrhs)
    return rc, x[:n]


def test_options_registry_contract():
    for mod in (impl, jimpl):
        h = mod.opt_create()
        assert mod.opt_set(h, "ColPerm", "MMD_AT_PLUS_A") == 0
        assert mod.opt_set(h, "Trans", "TRANS") == 0
        assert mod.opt_set(h, "IterRefine", "SLU_DOUBLE") == 0
        assert mod.opt_set(h, "Equil", "NO") == 0
        assert mod.opt_set(h, "relax", "12") == 0
        assert mod.opt_set(h, "NoSuchKey", "1") == -5
        assert mod.opt_set(h, "Equil", "MAYBE") == -6
        assert mod.opt_set(h, "Fact", "NoSuchFact") == -6
        assert mod.opt_set(10 ** 6, "Trans", "TRANS") == -3
        assert mod.opt_get(h, "NoSuchKey") == -5
        assert mod.opt_get(10 ** 6, "Trans") == -3
        assert mod.opt_free(h) == 0 and mod.opt_free(h) == -3
    keys = list(impl._KEY_ALIAS) + ["relax", "max_supernode",
                                    "factor_dtype", "diag_inv"]
    assert impl._KEY_ALIAS == jimpl._KEY_ALIAS
    mine, ref = impl.opt_create(), jimpl.opt_create()
    for key, val in (("ColPerm", "COLAMD"), ("Trans", "CONJ"),
                     ("Equil", "NO"), ("relax", "12"),
                     ("factor_dtype", "float32")):
        assert impl.opt_set(mine, key, val) == jimpl.opt_set(ref, key, val) \
            == 0
    assert [impl.opt_get(mine, k) for k in keys] == \
        [jimpl.opt_get(ref, k) for k in keys]


def _both_factor(a):
    sysm = System(a)
    (rc, h), (jrc, jh) = impl.factor_opts(0, *sysm.args()), \
        jimpl.factor_opts(0, *sysm.args())
    assert rc == jrc == 0
    return sysm, h, jh


def test_strided_factor_refactor_solve_match_jax():
    a = gallery.convection_diffusion_2d(10)
    sysm, h, jh = _both_factor(a)
    n, nrhs, ld = sysm.n, 2, sysm.n + 3
    b = _strided(n, nrhs, ld, 1)

    def both():
        (rc, x), (jrc, jx) = (_solve_factored(impl, h, 0, n, b, ld, nrhs),
                              _solve_factored(jimpl, jh, 0, n, b, ld, nrhs))
        assert rc == jrc == 0
        np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
        return x

    x = both()
    assert np.abs(b[n:]).max() == 0          # the padding rows untouched
    for tier, scale in ((1, 1.3), (2, 0.7)):
        v = sysm.v * scale
        assert impl.refactor(h, sysm.nnz, _ptr(v), tier) == \
            jimpl.refactor(jh, sysm.nnz, _ptr(v), tier) == 0
        x2 = both()
        np.testing.assert_allclose(x2, x / scale, rtol=1e-9)
    assert impl.refactor(h, sysm.nnz, _ptr(sysm.v), 3) == -6
    assert impl.refactor(h, sysm.nnz - 1, _ptr(sysm.v), 1) == -6
    assert impl.refactor(10 ** 6, sysm.nnz, _ptr(sysm.v), 1) == -3
    assert _solve_factored(impl, h, 0, n, b, n - 1, 1)[0] == -6
    assert impl.free(h) == 0 and impl.free(h) == -3
    jimpl.free(jh)


def test_factored_solve_keeps_the_options_of_its_handle():
    a = gallery.convection_diffusion_2d(9)
    sysm = System(a)
    n = sysm.n
    b = _strided(n, 1, n, 2)
    xs = {}
    for mod in (impl, jimpl):
        opt = mod.opt_create()
        rc, h = mod.factor_opts(opt, *sysm.args())
        assert rc == 0
        assert mod.opt_set(opt, "Trans", "TRANS") == 0
        rc0, x_own = _solve_factored(mod, h, 0, n, b, n, 1)
        rc1, x_t = _solve_factored(mod, h, opt, n, b, n, 1)
        assert rc0 == rc1 == 0
        assert np.linalg.norm(a.matvec(x_own[:, 0]) - b[:, 0]) < 1e-12
        assert np.linalg.norm(a.transpose().matvec(x_t[:, 0]) - b[:, 0]) \
            < 1e-12
        xs[mod] = (x_own, x_t)
        mod.free(h)
        mod.opt_free(opt)
    for i in range(2):
        np.testing.assert_allclose(xs[impl][i], xs[jimpl][i], rtol=RTOL,
                                   atol=ATOL)


def test_one_shot_and_legacy_solves_match_jax():
    a = gallery.random_sparse(120, density=0.05, seed=4)
    sysm = System(a)
    n, ld = sysm.n, sysm.n + 2
    b = _strided(n, 3, ld, 3)
    got = {}
    for mod in (impl, jimpl):
        x = np.zeros((ld, 3), order="F")
        assert mod.solve_opts(0, *sysm.args(), _ptr(b), ld, _ptr(x), ld,
                              3) == 0
        b1 = np.ascontiguousarray(b[:n, 0])
        x1 = np.zeros(n)
        assert mod.solve(*sysm.args(), _ptr(b1), _ptr(x1), 1) == 0
        rc, h = mod.factor(*sysm.args())
        x2 = np.zeros(n)
        assert rc == 0 and mod.solve_factored(h, n, _ptr(b1), _ptr(x2),
                                              1) == 0
        mod.free(h)
        got[mod] = (x[:n], x1, x2)
        assert mod.solve_opts(0, *sysm.args(), _ptr(b), n - 1, _ptr(x), ld,
                              3) == -6
        assert mod.solve_opts(10 ** 6, *sysm.args(), _ptr(b), ld, _ptr(x),
                              ld, 3) == -3
    for mine, ref in zip(got[impl], got[jimpl]):
        np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=ATOL)


def test_stat_get_names_match_jax():
    sysm, h, jh = _both_factor(gallery.poisson3d(5))
    b = _strided(sysm.n, 1, sysm.n, 5)
    assert _solve_factored(impl, h, 0, sysm.n, b, sysm.n, 1)[0] == 0
    assert _solve_factored(jimpl, jh, 0, sysm.n, b, sysm.n, 1)[0] == 0
    for name in STATS:
        mine, ref = impl.stat_get(h, name), jimpl.stat_get(jh, name)
        assert isinstance(mine, float) and math.isfinite(mine), name
        assert isinstance(ref, float) and math.isfinite(ref), name
    for name in ("NNZ_L", "NNZ_U", "TINY_PIVOTS", "FACT_FLOPS"):
        assert impl.stat_get(h, name) == jimpl.stat_get(jh, name), name
    assert 0 < impl.stat_get(h, "BERR") <= TARGET
    assert math.isnan(impl.stat_get(h, "NoSuchStat"))
    assert impl.stat_get(10 ** 6, "FACT") == -3
    impl.free(h)
    jimpl.free(jh)


# ---- the C client -----------------------------------------------------------

def _client(*args):
    lib, exe = build.build()
    assert lib.parent.parts[-3:-1] == ("build", "torch_capi")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return subprocess.run([str(exe), *map(str, args)], capture_output=True,
                          text=True, env=env, timeout=300,
                          stdin=subprocess.DEVNULL)


def test_c_client_tridiagonal_on_the_cpu():
    res = _client("cpu")
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "C API PASS" in res.stdout


def test_c_client_poisson3d_matches_the_ports_gssvx(tmp_path):
    out = tmp_path / "x.bin"
    res = _client("cpu", 6, out)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "C API poisson3d(6) PASS" in res.stdout
    raw = out.read_bytes()
    n = int(np.frombuffer(raw[:8], dtype=np.int64)[0])
    b = np.frombuffer(raw[8:8 + 8 * n], dtype=np.float64)
    x = np.frombuffer(raw[8 + 8 * n:], dtype=np.float64)
    a = gallery.poisson3d(6)
    assert n == a.n_rows
    # the C code built the gallery's matrix: b = A·xtrue for its xtrue
    xt = 1.0 + 0.01 * (np.arange(n) % 101)
    np.testing.assert_allclose(b, a.matvec(xt), rtol=4 * np.finfo(float).eps)
    x_ref, _, _, info = slt.gssvx(slt.Options(), a, b, device="cpu")
    assert info == 0
    np.testing.assert_array_equal(x, x_ref)
    st = dict(kv.split("=") for kv in re.search(
        r"CAPI_STATS (.*)", res.stdout).group(1).split())
    assert float(st["berr"]) <= TARGET and float(st["nnz_l"]) > n
    times = dict(kv.split("=") for kv in re.search(
        r"CAPI_TIMES (.*)", res.stdout).group(1).split())
    assert set(times) == {"init", "dofact", "solve1", "solve4",
                          "factor_refactor_handle", "refactor",
                          "refactor_solve", "finalize"}


def test_c_client_init_refuses_other_backends_and_a_missing_card():
    res = _client("tpu")
    assert res.returncode == 3 and "init rc=-1" in res.stdout
    assert "unknown backend 'tpu'" in res.stdout
    if not torch.cuda.is_available():
        res = _client("default")           # NULL: the card
        assert res.returncode == 3 and "init rc=-1" in res.stdout
        assert "torch.cuda.is_available() is False" in res.stdout


def test_init_names():
    assert impl.init("tpu") == -1
    assert impl.init("") == impl.init("gpu") == impl.init("cuda")
    assert (impl.init("cuda") == 0) == torch.cuda.is_available()
    assert impl.init("cpu") == 0
    assert impl._device[0] == torch.device("cpu")
