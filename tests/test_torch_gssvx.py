"""The port end to end: ``superlu_dist_tpu_torch.gssvx(device="cpu")``
against ``superlu_dist_tpu.gssvx`` on the gallery — X agrees at the
device-vs-host gate and the delivered BERR meets ``berr_target(float64)``
— plus the port's hygiene: it imports nothing of JAX or of the JAX
package, and never falls back to the CPU on its own."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.utils import tols

ROOT = pathlib.Path(__file__).resolve().parents[1]

MATRICES = {
    "poisson2d_20": lambda g: g.poisson2d(20),
    "poisson3d_8": lambda g: g.poisson3d(8),
    "convdiff_15": lambda g: g.convection_diffusion_2d(15),
    "random_120": lambda g: g.random_sparse(120, density=0.04, seed=2),
}


def _rhs(n, nrhs=None):
    rng = np.random.default_rng(11)
    return rng.standard_normal(n if nrhs is None else (n, nrhs))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gssvx_matches_jax(name):
    a = MATRICES[name](gallery)
    b = _rhs(a.n_rows)
    x, lu, _, info = slt.gssvx(slt.Options(), a, b, device="cpu")
    x_ref, _, _, info_ref = jslu.gssvx(jslu.Options(), MATRICES[name](jgal), b)
    assert info == info_ref == 0
    np.testing.assert_allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    assert lu.berrs[-1] <= tols.berr_target(np.float64)


@pytest.mark.parametrize("name", ["poisson3d_8", "convdiff_15"])
def test_float32_factors_refine_to_float64(name):
    """The card's configuration on the CPU: float32 factors, float64
    refinement, several right-hand sides."""
    a = MATRICES[name](gallery)
    b = _rhs(a.n_rows, 3)
    x, lu, stats, info = slt.gssvx(slt.Options(factor_dtype="float32"), a, b,
                                   device="cpu")
    assert info == 0 and lu.numeric.dtype == torch.float32
    assert lu.berrs[-1] <= tols.berr_target(np.float64)
    assert stats.refine_steps > 1
    r = b - a.matvec(x)
    assert np.linalg.norm(r) <= tols.RESID_GATE * np.linalg.norm(b)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = gallery.poisson2d(4)
    with pytest.raises(RuntimeError, match="cuda"):
        slt.gssvx(slt.Options(), a, np.ones(a.n_rows))


@pytest.mark.parametrize("options,error", [
    (slt.Options(factor_dtype="int32"), NotImplementedError),
    (slt.Options(gemm_prec="tf32"), ValueError),
    (slt.Options(solve_schedule="wavefront"), ValueError),
])
def test_unported_options_raise(options, error):
    """An option the port does not run raises: a factor dtype neither
    package runs (int32), a GEMM tier or a solve schedule outside the JAX
    package's."""
    a = gallery.poisson2d(4)
    with pytest.raises(error):
        slt.gssvx(options, a, np.ones(a.n_rows), device="cpu")


def test_import_leaves_jax_unloaded():
    code = ("import sys, superlu_dist_tpu_torch, superlu_dist_tpu_torch.interop;"
            "import superlu_dist_tpu_torch.persist, superlu_dist_tpu_torch.io;"
            "import superlu_dist_tpu_torch.__main__;"
            "import superlu_dist_tpu_torch.numeric.stream,"
            " superlu_dist_tpu_torch.numeric.fused,"
            " superlu_dist_tpu_torch.numeric.mega,"
            " superlu_dist_tpu_torch.solve.trisolve;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'superlu_dist_tpu')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_sources_name_no_jax():
    files = sorted((ROOT / "superlu_dist_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|superlu_dist_tpu)\b",
                         re.M)
    for path in files:
        text = path.read_text()
        assert not imports.search(text), path
        assert "superlu_dist_tpu." not in text.replace(
            "superlu_dist_tpu_torch.", ""), path
