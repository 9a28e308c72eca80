"""The port's scatter kernels (superlu_dist_tpu_torch/numeric/kernels.py)
held against the JAX package: the plain PyTorch versions of the
extend-add (K1) and the A-entry assembly (K2) must equal, bit for bit,
both the JAX ``.at[]`` lowering (numeric/factor.py) and the Pallas
kernels in interpret mode, sentinels and repeated parent slots included;
and the maps of the fused kernel (``build_front_maps``), walked tile by
tile as csrc/front_assemble.cu walks them, must enumerate exactly the
pairs of the child sets in the same per-position order.  On CPU tensors
the wrappers take the plain versions; their CUDA path is covered by
tests/test_torch_cuda.py on a card."""

from collections import defaultdict

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superlu_dist_tpu.numeric.factor import extend_add_set
from superlu_dist_tpu.numeric.pallas_kernels import (assemble_avals_pallas,
                                                     extend_add_set_pallas)
from superlu_dist_tpu_torch.numeric import kernels

DTYPES = [np.float32, np.float64]


def _extend_add_case(seed, dtype, repeated):
    """A child set with every sentinel: an OOB pool offset, an OOB slot,
    rel == m padding; with ``repeated`` several children share a parent
    slot and the SAME targets, so the add order shows in the bits."""
    rng = np.random.default_rng(seed)
    m, ub, batch, pool_len = 12, 5, 3, 200
    pool = rng.standard_normal(pool_len).astype(dtype)
    f = rng.standard_normal((batch, m * m)).astype(dtype)
    if repeated:
        child_off = np.array([0, 25, 50, 75, 100, pool_len, 150])
        child_slot = np.array([1, 0, 1, 1, 2, 1, batch])
    else:
        child_off = np.array([0, 25, 50, pool_len])
        child_slot = np.array([1, 0, 1, batch])
    nc = len(child_off)
    rel = np.full((nc, ub), m, dtype=np.int64)
    shared = rng.choice(m, size=4, replace=False)
    for c in range(nc):
        rel[c, :4] = (shared if repeated and child_slot[c] == 1
                      else rng.choice(m, size=4, replace=False))
    return f, pool, m, ub, child_off, child_slot, rel


def _torch_extend_add(f, pool, m, ub, child_off, child_slot, rel):
    ft = torch.from_numpy(f.copy())
    kernels.extend_add_(ft, torch.from_numpy(pool), m, ub,
                        torch.from_numpy(child_off), torch.from_numpy(child_slot),
                        torch.from_numpy(rel))
    return ft.numpy()


@pytest.mark.parametrize("repeated", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_add_plain_equals_jax(dtype, repeated):
    f, pool, m, ub, off, slot, rel = _extend_add_case(3, dtype, repeated)
    out = _torch_extend_add(f, pool, m, ub, off, slot, rel)
    args = (jnp.asarray(f), jnp.asarray(pool), m, ub, jnp.asarray(off),
            jnp.asarray(slot), jnp.asarray(rel))
    ref = np.asarray(extend_add_set(*args))
    pal = np.asarray(extend_add_set_pallas(*args, mode="interpret"))
    assert out.dtype == dtype
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), pal.view(np.uint8))
    assert not np.array_equal(out, f)          # the case does add something


def test_extend_add_order_is_ascending():
    """Two children adding onto one position in a float32 case where the
    order changes the rounded sum: the plain version must match the
    ascending order, not the reversed one."""
    m, ub = 2, 1
    f = np.array([[1.0, 0, 0, 0]], dtype=np.float32)
    pool = np.array([2.0 ** 24, 2.0 - 2.0 ** 24], dtype=np.float32)
    off, slot = np.array([0, 1]), np.array([0, 0])
    rel = np.zeros((2, 1), dtype=np.int64)
    out = _torch_extend_add(f, pool, m, ub, off, slot, rel)
    # (1 + 2^24) rounds to 2^24 in float32, so ascending order gives 2;
    # the reversed order would give 3
    assert out[0, 0] == 2.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_assemble_plain_equals_jax(dtype):
    rng = np.random.default_rng(4)
    batch, m, n_avals, la = 4, 9, 50, 37
    avals = rng.standard_normal(n_avals).astype(dtype)
    f = rng.standard_normal((batch, m * m)).astype(dtype)
    pairs = rng.choice(batch * m * m, size=30, replace=False)
    a_slot = np.concatenate([pairs // (m * m), np.full(la - 30, batch)])
    a_flat = np.concatenate([pairs % (m * m),
                             np.zeros(la - 30, dtype=np.int64)])
    a_src = np.concatenate([rng.integers(0, n_avals, 30),
                            np.full(la - 30, n_avals)])
    ft = torch.from_numpy(f.copy())
    kernels.assemble_(ft, torch.from_numpy(avals), torch.from_numpy(a_slot),
                      torch.from_numpy(a_flat), torch.from_numpy(a_src))
    jf, jav = jnp.asarray(f), jnp.asarray(avals)
    js, jfl, jsr = map(jnp.asarray, (a_slot, a_flat, a_src))
    ref = np.asarray(jf.at[(js, jfl)].add(
        jav.at[jsr].get(mode="fill", fill_value=0), mode="drop"))
    pal = np.asarray(assemble_avals_pallas(jf, jav, js, jfl, jsr,
                                           mode="interpret"))
    out = ft.numpy()
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), pal.view(np.uint8))


def test_assemble_src_out_of_range_reads_zero():
    f = torch.ones((1, 4), dtype=torch.float64)
    kernels.assemble_(f, torch.tensor([5.0], dtype=torch.float64),
                      torch.tensor([0, 0]), torch.tensor([1, 2]),
                      torch.tensor([0, 7]))
    assert f.tolist() == [[1.0, 6.0, 1.0, 1.0]]


def test_extend_add_on_a_plan_child_set():
    """The largest child set of a real plan (poisson3d), on random fronts
    and pool, against the JAX lowering."""
    from superlu_dist_tpu.models.gallery import poisson3d
    from superlu_dist_tpu.numeric.plan import build_plan
    from superlu_dist_tpu.ordering.dispatch import get_perm_c
    from superlu_dist_tpu.sparse.formats import symmetrize_pattern
    from superlu_dist_tpu.symbolic.symbfact import symbolic_factorize
    from superlu_dist_tpu.utils.options import Options
    a = poisson3d(7)
    sym = symmetrize_pattern(a)
    plan = build_plan(symbolic_factorize(sym, get_perm_c(Options(), a, sym)))
    grp, cs = max(((g, cs) for g in plan.groups for cs in g.children),
                  key=lambda gc: len(gc[1].child_off) * gc[1].ub ** 2)
    rng = np.random.default_rng(5)
    f = rng.standard_normal((grp.batch, grp.m * grp.m))
    pool = rng.standard_normal(plan.pool_size)
    args = (f, pool, grp.m, cs.ub, cs.child_off.astype(np.int64),
            cs.child_slot.astype(np.int64), cs.rel.astype(np.int64))
    out = _torch_extend_add(*args)
    ref = np.asarray(extend_add_set(*(jnp.asarray(x) if isinstance(
        x, np.ndarray) else x for x in args)))
    assert np.array_equal(out, ref)


def test_cpu_wrappers_take_plain_and_count_nothing():
    kernels.reset_launches()
    f = torch.zeros((1, 4), dtype=torch.float32)
    kernels.assemble_(f, torch.ones(1), torch.tensor([0]), torch.tensor([3]),
                      torch.tensor([0]))
    kernels.extend_add_(f, torch.ones(1), 2, 1, torch.tensor([0]),
                        torch.tensor([0]), torch.tensor([[1]]))
    assert f.tolist() == [[0.0, 0.0, 0.0, 2.0]]
    from superlu_dist_tpu_torch.parallel.dist import csr_spmv
    y = csr_spmv(torch.tensor([0, 1]), torch.tensor([3]), torch.ones(1),
                 f.view(4, 1))
    assert y.tolist() == [[2.0]]
    assert kernels.LAUNCHES == {"front_assemble": 0, "extend_add": 0,
                                "assemble": 0, "csr_spmv": 0}


@pytest.mark.parametrize("bad", ["dtype", "index", "shape"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    f = torch.zeros((1, 4), dtype=torch.float32)
    pool = torch.ones(3, dtype=torch.float64 if bad == "dtype"
                      else torch.float32)
    idx = torch.tensor([0], dtype=torch.int32 if bad == "index"
                       else torch.int64)
    rel = torch.zeros((1, 2 if bad == "shape" else 1), dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        kernels.extend_add_(f, pool, 2, 1, idx, idx, rel)
    with pytest.raises((TypeError, ValueError)):
        kernels.assemble_(f if bad != "shape" else f.view(-1), pool, idx,
                          idx, idx)


# ---------------------------------------------------------------------------
# the fused kernel's maps
# ---------------------------------------------------------------------------

def _walk_maps(fm, tile_rows, tile_cols=128):
    """What csrc/front_assemble.cu reads from its maps, tile by tile:
    (slot, flat) -> [pool index, ...] in add order, and (slot, flat) -> src
    of the A entries (flat = row·mc + local column; mc = m for a whole
    front)."""
    a_bkt, a_ent, ch_ptr, ch_rec, rel, ch_bkt = (t.numpy()
                                                 for t in fm.tensors())
    m, mc, b = fm.m, fm.mc, kernels.BUCKET
    nb, nbc = -(-m // b), -(-mc // b)
    seq, a = defaultdict(list), {}
    for s in range(fm.batch):
        for r0 in range(0, m, tile_rows):
            for c0 in range(0, mc, tile_cols):
                th, tw = min(tile_rows, m - r0), min(tile_cols, mc - c0)
                bl, bh = r0 // b, -(-(r0 + th) // b)
                cl, chh = c0 // b, -(-(c0 + tw) // b)
                for e in range(a_bkt[s, bl], a_bkt[s, bh]):
                    flat, src = a_ent[e]
                    assert r0 <= flat // mc < r0 + th
                    if c0 <= flat % mc < c0 + tw:
                        assert (s, flat) not in a
                        a[(s, int(flat))] = int(src)
                for k in range(ch_ptr[s], ch_ptr[s + 1]):
                    off, stride, start, bstart, cstart, cbstart = ch_rec[k]
                    bk = ch_bkt[bstart:bstart + nb + 1]
                    bkc = ch_bkt[cbstart:cbstart + nbc + 1]
                    ent, ent_c = rel[start:], rel[cstart:]
                    for i in range(bk[bl], bk[bh]):
                        for j in range(bkc[cl], bkc[chh]):
                            assert r0 <= ent[i, 0] < r0 + th
                            assert c0 <= ent_c[j, 0] < c0 + tw
                            seq[(s, int(ent[i, 0] * mc + ent_c[j, 0]))].append(
                                int(off + ent[i, 1] * stride + ent_c[j, 1]))
    return seq, a


def _pairs_of_sets(batch, m, pool_len, children):
    """The same from the raw child sets, in set, child, i, j order."""
    seq = defaultdict(list)
    for ub, off, slot, rel in children:
        for c in range(len(off)):
            if not (0 <= slot[c] < batch and 0 <= off[c] < pool_len):
                continue
            for i in range(ub):
                for j in range(ub):
                    ri, rj = rel[c, i], rel[c, j]
                    if 0 <= ri < m and 0 <= rj < m:
                        seq[(int(slot[c]), int(ri * m + rj))].append(
                            int(off[c] + i * ub + j))
    return seq


def _plan_groups(name):
    from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
    from superlu_dist_tpu.models import gallery as jgal
    from superlu_dist_tpu.utils.options import Options as JaxOptions
    from superlu_dist_tpu_torch.interop import plan_from_reference
    make = {"poisson2d_14": lambda: jgal.poisson2d(14),
            "poisson3d_6": lambda: jgal.poisson3d(6),
            "random_80": lambda: jgal.random_sparse(80, density=0.05, seed=3)}
    plan = plan_from_reference(jax_analyze(JaxOptions(), make[name]())[0].plan)
    return [(g.batch, g.m, plan.pool_size, (g.a_slot, g.a_flat, g.a_src),
             [(cs.ub, cs.child_off, cs.child_slot, cs.rel)
              for cs in g.children]) for g in plan.groups]


def _sentinel_groups():
    f, pool, m, ub, off, slot, rel = _extend_add_case(3, np.float64, True)
    rng = np.random.default_rng(9)
    rel = rel.copy()
    for r in rel:
        rng.shuffle(r)                       # unsorted, sentinels between
    batch = f.shape[0]
    tgt = rng.choice(batch * m * m, size=20, replace=False)
    a = (np.concatenate([tgt // (m * m), [batch, -1, 0]]),
         np.concatenate([tgt % (m * m), [0, 0, m * m]]),
         np.arange(23))
    return [(batch, m, len(pool), a, [(ub, off, slot, rel)])]


@pytest.mark.parametrize("tile_rows", [128, 64])
@pytest.mark.parametrize("case", ["poisson2d_14", "poisson3d_6", "random_80",
                                  "sentinels"])
def test_front_maps_enumerate_the_child_sets(case, tile_rows):
    groups = _sentinel_groups() if case == "sentinels" else _plan_groups(case)
    for batch, m, pool_len, a, children in groups:
        fm = kernels.build_front_maps(batch, m, pool_len, a=a,
                                      children=children, device="cpu")
        seq, a_map = _walk_maps(fm, tile_rows)
        ref = _pairs_of_sets(batch, m, pool_len, children)
        assert seq == ref
        assert fm.pairs == sum(map(len, ref.values()))
        a_slot, a_flat, a_src = a
        keep = ((a_slot >= 0) & (a_slot < batch) & (a_flat >= 0)
                & (a_flat < m * m))
        assert a_map == {(int(s), int(fl)): int(sr) for s, fl, sr in
                         zip(a_slot[keep], a_flat[keep], a_src[keep])}


@pytest.mark.parametrize("tile", [(64, 128), (64, 64)])
@pytest.mark.parametrize("case", ["poisson3d_6", "sentinels"])
def test_front_maps_walk_the_complex_tiles(case, tile):
    """The complex64 (64 x 128) and complex128 (64 x 64) tiles of
    csrc/front_assemble.cu read the same maps and enumerate the same pairs
    in the same per-position order."""
    groups = _sentinel_groups() if case == "sentinels" else _plan_groups(case)
    for batch, m, pool_len, a, children in groups:
        fm = kernels.build_front_maps(batch, m, pool_len, a=a,
                                      children=children, device="cpu")
        seq, _ = _walk_maps(fm, *tile)
        assert seq == _pairs_of_sets(batch, m, pool_len, children)


def test_front_maps_refuse_repeated_targets():
    rel = np.array([[1, 3, 1]])
    with pytest.raises(ValueError, match="distinct"):
        kernels.build_front_maps(1, 4, 9, children=[(3, [0], [0], rel)],
                                 device="cpu")
    with pytest.raises(ValueError, match="unique"):
        kernels.build_front_maps(2, 3, 0, a=([1, 0, 1], [4, 4, 4], [0, 1, 2]),
                                 device="cpu")


def test_upload_packs_aligned_views():
    """One copy per dtype; every view starts on a 16-byte boundary (the
    kernel reads rel as 8-byte pairs) and holds its array."""
    arrays = [np.arange(3, dtype=np.int64), np.arange(3, dtype=np.int32),
              np.arange(10, dtype=np.int32).reshape(5, 2),
              np.zeros((0, 4), np.int64), np.arange(7, dtype=np.int64)]
    views = kernels.upload(arrays, "cpu")
    for x, v in zip(arrays, views):
        assert v.data_ptr() % 16 == 0 and v.is_contiguous()
        assert np.array_equal(v.numpy(), x) and v.shape == x.shape
    with pytest.raises(TypeError):
        kernels.upload([np.zeros(2)], "cpu")
