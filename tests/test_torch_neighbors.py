"""Parity of the port's neighbour tables (kernels #3 and #4 as their plain
PyTorch versions, the slab layout, the sorted and full tables, CN counts)
with the JAX package on the CPU, on the same numpy inputs.

Tolerance: exact for counts, neighbour slots (positions and species, in
slot order) and the slab layout arrays. Inputs sit on the dyadic grid of
``test_torch_rdf.grid_case`` (see its module docstring: XLA:CPU contracts
multiply-adds into FMAs, the port does not; on the grid both are exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amof_tpu.ops import pair_engine as jax_pe
from amof_tpu.ops import pallas_neighbors as jax_nb
from amof_tpu.ops import slab_table as jax_slab
from amof_tpu_torch.ops import neighbor_kernel, pair_engine, slab_table

from test_torch_rdf import grid_case, t

torch.set_num_threads(2)

CUTOFF = np.array([[2.2, 2.0, 1.8], [2.0, 1.6, 2.4], [1.8, 2.4, 0.0]],
                  np.float32)


def _eq(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.array_equal(g, r)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _sorted_case(n, seed, triclinic=False, pad_from=None):
    pos, cell, sp = grid_case(n, 3, seed, triclinic, box=16.0,
                              pad_from=pad_from)
    inv = pair_engine.inverse_cell(t(cell))
    _, pos_s, sp_s = pair_engine.sort_by_fractional_x(t(pos), t(sp), inv)
    return pos_s.numpy(), sp_s.numpy(), cell


@pytest.mark.parametrize("triclinic,k", [(False, 8), (True, 16), (False, 3)])
def test_window_table_matches_pallas(triclinic, k):
    """Kernel #4's plain version == pallas_window_table (interpret)."""
    pos_s, sp_s, cell = _sorted_case(768, 11, triclinic, pad_from=740)
    ref = jax_nb.pallas_window_table(
        pos_s, sp_s, cell, CUTOFF, 3, k, 128, 128, interpret=True)
    got = neighbor_kernel.window_table(t(pos_s), t(sp_s), t(cell), t(CUTOFF),
                                       k, 128, 128)
    if k == 3:  # the overflow case really overflows
        assert int(got[2].max()) > k
    _eq(got, ref)


@pytest.mark.parametrize("triclinic", [False, True])
def test_slab_layout_and_kernel_match_jax(triclinic):
    """build_slab_layout's five outputs equal the JAX ones; kernel #3's
    plain version == pallas_window_table_slab (interpret) on them."""
    rng_pad = 2000
    pos, cell, sp = grid_case(2048, 3, 12, triclinic, box=32.0,
                              pad_from=rng_pad)
    plan_j = jax_slab.slab_plan(cell, float(CUTOFF.max()), 2048,
                                positions=pos[None], species_idx=sp)
    plan_t = slab_table.slab_plan(cell, float(CUTOFF.max()), 2048,
                                  positions=pos[None], species_idx=sp)
    assert plan_j is not None and tuple(plan_j) == tuple(plan_t)
    ref = jax_slab.build_slab_layout(jnp.asarray(pos), jnp.asarray(sp),
                                     jnp.asarray(cell), plan_j)
    got = slab_table.build_slab_layout(t(pos), t(sp), t(cell), plan_t)
    assert not bool(got[4])
    _eq(got, ref)
    centers, cand, starts, qb, _ = (np.asarray(a) for a in ref)
    k = 12
    ref_tab = jax_nb.pallas_window_table_slab(
        centers, cand, starts, qb, cell, CUTOFF, 3, k, plan_j.chunk,
        plan_j.window, interpret=True)
    got_tab = neighbor_kernel.window_table_slab(
        t(centers), t(cand), t(starts), t(qb), t(cell), t(CUTOFF), k,
        plan_t.chunk, plan_t.window)
    _eq(got_tab, ref_tab)


def test_slab_plan_matches_jax_over_frames():
    rng = np.random.default_rng(13)
    cells = np.tile(np.eye(3, dtype=np.float32) * 30.0, (5, 1, 1))
    cells[:, 0, 0] += rng.uniform(0, 1, 5).astype(np.float32)
    pos = rng.uniform(0, 30, (5, 2000, 3)).astype(np.float32)
    sp = rng.integers(0, 3, 2000).astype(np.int32)
    for chunk in (16, 32):
        a = jax_slab.slab_plan(cells, 2.1, 2000, chunk, positions=pos,
                               species_idx=sp)
        b = slab_table.slab_plan(cells, 2.1, 2000, chunk, positions=pos,
                                 species_idx=sp)
        assert tuple(a) == tuple(b)
    assert slab_table.slab_plan(cells[:1], 20.0, 2000) is None
    assert jax_slab.slab_plan(cells[:1], 20.0, 2000) is None


@pytest.mark.parametrize("triclinic", [False, True])
def test_sorted_table_matches_jax(triclinic):
    """1-level sorted table (sort, coverage check, kernel #4 plain, CN
    from the table) == the JAX XLA sorted table."""
    pos, cell, sp = grid_case(512, 3, 14, triclinic, box=16.0,
                              pad_from=500)
    ref = jax_pe.frame_neighbor_payload_table_sorted(
        *_j(pos, cell, sp, CUTOFF), max_neighbors=24, chunk=64, window=128,
        emit_cn=True)
    got = pair_engine.frame_neighbor_payload_table_sorted(
        t(pos), t(cell), t(sp), t(CUTOFF), 24, 64, 128, emit_cn=True)
    assert not bool(ref[3])
    _eq(got, ref)


def test_sorted_table_window_miss_flags():
    pos, cell, sp = grid_case(1024, 3, 15, box=16.0)
    ref = jax_pe.frame_neighbor_payload_table_sorted(
        *_j(pos, cell, sp, CUTOFF), max_neighbors=12, chunk=128, window=16)
    got = pair_engine.frame_neighbor_payload_table_sorted(
        t(pos), t(cell), t(sp), t(CUTOFF), 12, 128, 16)
    assert bool(ref[3]) and bool(got[3])


@pytest.mark.parametrize("k", [4, 32])
def test_full_table_matches_jax(k):
    pos, cell, sp = grid_case(512, 3, 16, triclinic=True, box=16.0,
                              pad_from=500)
    ref = jax_pe.frame_neighbor_payload_table(pos, cell, sp, CUTOFF,
                                              max_neighbors=k, chunk=128)
    got = pair_engine.frame_neighbor_payload_table(
        t(pos), t(cell), t(sp), t(CUTOFF), k, chunk=128)
    _eq(got, ref)


@pytest.mark.parametrize("triclinic", [False, True])
def test_cn_counts_match_jax(triclinic):
    pos, cell, sp = grid_case(640, 3, 17, triclinic, box=16.0, pad_from=600)
    ref = jax_pe.frame_cn_counts(pos, cell, sp, CUTOFF, 3, chunk=128)
    got = pair_engine.frame_cn_counts(t(pos), t(cell), t(sp), t(CUTOFF), 3,
                                      chunk=128)
    assert float(got.sum()) > 0
    _eq([got], [ref])

