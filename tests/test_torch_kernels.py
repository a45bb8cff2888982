"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card. Tolerance: exact (integer outputs, and neighbour positions are
copies of input positions).

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest imports the JAX package.)
"""

import numpy as np
import pytest
import torch

from amof_tpu_torch.ops import (neighbor_kernel, pair_engine, rdf_kernel,
                                slab_table)

CUTOFF = np.array([[2.2, 2.0, 1.8], [2.0, 1.6, 2.4], [1.8, 2.4, 0.0]],
                  np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs its plain version)")
    return torch.device("cuda")


def case(n, n_species, seed, box, triclinic=False, pad_from=None):
    rng = np.random.default_rng(seed)
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, -box / 5
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    sp = rng.integers(0, n_species, n).astype(np.int32)
    if pad_from is not None:
        sp[pad_from:] = -1
        pos[pad_from:] = 0.0
    return pos, cell, sp


def on(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def assert_same(got, ref):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("triclinic", [False, True])
def test_rdf_kernels_match_plain(cuda, blocked, triclinic):
    pos, cell, sp = case(3000, 4, 1, 36.0, triclinic, pad_from=2990)
    if blocked:
        perm, sp = rdf_kernel.species_block_layout(sp, 256, 256)
        pos = rdf_kernel.apply_atom_layout(pos, perm)
    fn = rdf_kernel.rdf_counts_blocked if blocked else rdf_kernel.rdf_counts
    p, c, s = on(cuda, pos, cell, sp)
    got = fn(p, c, s, 0.01, 4, 1800, ortho=not triclinic)
    ref = rdf_kernel.rdf_counts_plain(p, c, s, 0.01, 4, 1800,
                                      ortho=not triclinic)
    assert float(ref.sum()) > 0
    assert_same([got], [ref])


@pytest.mark.cuda
def test_rdf_global_atomics_mode_matches_plain(cuda):
    """S*S*bins too large for shared memory: atomics to device memory."""
    pos, cell, sp = case(1000, 6, 2, 40.0)
    p, c, s = on(cuda, pos, cell, sp)
    got = rdf_kernel.rdf_counts(p, c, s, 0.001, 6, 2000)
    ref = rdf_kernel.rdf_counts_plain(p, c, s, 0.001, 6, 2000)
    assert_same([got], [ref])


@pytest.mark.cuda
@pytest.mark.parametrize("k,chunk,window", [(2, 100, 300), (8, 256, 512),
                                            (40, 64, 200)])
def test_window_kernel_matches_plain(cuda, k, chunk, window):
    pos, cell, sp = case(3000, 3, 3, 36.0, triclinic=True, pad_from=2950)
    p, c, s, cut = on(cuda, pos, cell, sp, CUTOFF)
    inv = pair_engine.inverse_cell(c)
    _, pos_s, sp_s = pair_engine.sort_by_fractional_x(p, s, inv)
    args = (pos_s.contiguous(), sp_s.contiguous(), c, cut, k, chunk, window)
    got = neighbor_kernel.window_table(*args)
    ref = neighbor_kernel.window_table_plain(*args)
    assert int(ref[2].max()) > 0
    assert_same(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 16, 1024])
def test_slab_kernel_matches_plain(cuda, k):
    pos, cell, sp = case(4096, 3, 4, 40.0, pad_from=4000)
    plan = slab_table.slab_plan(cell, float(CUTOFF.max()), 4096,
                                positions=pos[None], species_idx=sp)
    assert plan is not None
    p, c, s, cut = on(cuda, pos, cell, sp, CUTOFF)
    lay = slab_table.build_slab_layout(p, s, c, plan)
    assert not bool(lay[4])
    args = (*lay[:4], c, cut, k, plan.chunk, plan.window)
    got = neighbor_kernel.window_table_slab(*args)
    ref = neighbor_kernel.window_table_slab_plain(*args)
    assert_same(got, ref)


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_inputs(cuda):
    pos, cell, sp = case(512, 2, 5, 20.0)
    p, c, s = on(cuda, pos, cell, sp)
    before = rdf_kernel.LAUNCHES["rdf_counts"]
    rdf_kernel.rdf_counts(p, c, s, 0.05, 2, 100)
    assert rdf_kernel.LAUNCHES["rdf_counts"] == before + 1
    rdf_kernel.rdf_counts_plain(p, c, s, 0.05, 2, 100)
    assert rdf_kernel.LAUNCHES["rdf_counts"] == before + 1
    with pytest.raises(ValueError):
        rdf_kernel.rdf_counts(p.double(), c, s, 0.05, 2, 100)
    with pytest.raises(ValueError):
        rdf_kernel.rdf_counts(p, c, s.long(), 0.05, 2, 100)
