"""``parallel/grid.gridmap`` over a subset of the world — the reference's
superlu_gridmap as its pddrive4 uses it — on gloo CPU ranks.

Four spawned ranks (``testing.ranks.run_mesh_ranks``, the case in
tests/torch_mesh_cases.py) split into two 2×1 sub-grids, ranks [0, 1]
and [2, 3], with SLU_TPU_VERIFY_COLLECTIVES on; each sub-grid solves its
own system with ``gssvx(grid=)`` while the other solves its own.  Held
against:

* the JAX ``gssvx(grid=gridinit(2, 1, devices[:2]))`` (and
  ``devices[2:4]``) on the conftest's virtual devices, within
  DEVICE_VS_HOST;
* sub-grid [0, 1] solving the second system alone afterwards: bit for bit
  sub-grid [2, 3]'s x, with the same number of verified collectives (a
  collective that counted a rank of the other sub-grid would have met a
  record of the other system and raised, or hung);
* the grid of a rank outside it: None.
"""

import numpy as np
import pytest

import jax

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel.grid import gridinit as jgridinit

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.parallel.grid import gridmap
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
VERIFY = {"SLU_TPU_VERIFY_COLLECTIVES": "1"}
#: the two sub-grids' systems: different sizes, so their collectives'
#: records differ
SPECS = [("poisson3d", (5,), 1, None), ("poisson3d", (6,), 2, None)]

_RUN = {}


def _run():
    if not _RUN:
        _RUN.update(run_mesh_ranks(4, cases.subgrids, SPECS, timeout=240,
                                   env=VERIFY))
    return _RUN


def test_each_rank_is_in_one_subgrid_with_its_own_rank():
    out = _run()
    for r in range(4):
        which = r // 2
        want = [which == 0, which == 1]
        assert out[r]["members"] == want        # None outside its grid
        assert out[r]["n_grids"] == 1
        assert (out[r]["grid_rank"], out[r]["nproc"]) == (r % 2, 2)
        assert out[r]["info"] == 0 and out[r]["berr"] <= TARGET
        assert out[r]["shard"]["own_slots_only"]
    for lo in (0, 2):
        np.testing.assert_array_equal(out[lo]["x"], out[lo + 1]["x"])


@pytest.mark.parametrize("which", [0, 1])
def test_subgrid_x_matches_the_jax_subgrid(which):
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs the virtual CPU mesh (conftest XLA_FLAGS)")
    out = _run()
    name, args, _, _ = SPECS[which]
    a = getattr(jgal, name)(*args)
    _, b = cases._system(SPECS[which])
    grid = jgridinit(2, 1, devices[2 * which:2 * which + 2])
    jx, _, _, info = jslu.gssvx(jslu.Options(), a, b, grid=grid)
    assert info == 0
    np.testing.assert_allclose(out[2 * which]["x"], np.asarray(jx),
                               rtol=RTOL, atol=ATOL)


def test_a_subgrid_alone_gives_the_same_bits_and_collectives():
    out = _run()
    np.testing.assert_array_equal(out[0]["x_alone"], out[2]["x"])
    np.testing.assert_array_equal(out[1]["x_alone"], out[3]["x"])
    assert out[0]["seq_alone"] == out[2]["seq"] == out[3]["seq"]
    # each grid's collectives ran over its two ranks only
    for r in range(4):
        assert out[r]["seq"][None] > 0
        assert set(out[r]["comm"]) <= {"gather_rows", "all_gather",
                                        "all_reduce"}


@pytest.mark.parametrize("ranks,shape", [([1, 0], (2, 1)), ([0, 0], (2, 1)),
                                         ([0], (2, 1)), ([0, 5], (1, 2))])
def test_gridmap_refuses_a_bad_rank_list(ranks, shape):
    with pytest.raises(ValueError, match="gridmap"):
        gridmap(ranks, *shape, device="cpu")


def test_gridmap_of_the_one_process_world():
    grid = gridmap([0], 1, 1, device="cpu")
    assert (grid.rank, grid.nproc, grid.world_ranks) == (0, 1, (0,))
