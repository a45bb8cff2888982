"""Parity of the port's RDF pair pass (kernels #1 and #2, plain PyTorch
versions on the CPU) with the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs.

Tolerance: exact. The counts are integers.

Why the parity inputs sit on a dyadic grid: XLA:CPU contracts
``a*b + c`` into fused multiply-adds (``x0*m00 + x1*m10 + x2*m20``
compiles to fma(x2, m20, fma(x0, m00, x1*m10)); measured on this
package's jax), while the port rounds every multiply and add on its own,
as the CUDA kernels do (built with --fmad=false). On generic floats the
two therefore differ in the last bit of some distances, and a pair that
sits within an ulp of a bin edge changes bin (6 of 1.2M bins at 1024
atoms, dr 0.01). On a grid of 1/32 A in a box whose cell inverse is
exact (power-of-two lengths), every product and sum in the distance
chain is exact in float32, so contraction cannot change a bit and the
two packages must agree exactly. ``test_generic_floats_match_ieee_oracle``
covers generic floats against an independent numpy oracle that rounds
each op in float32, as the port does (its square root included:
PyTorch's vectorized CPU sqrt is not correctly rounded, so the port's
plain versions take ``pair_engine.sqrt_rn``).
"""

import numpy as np
import pytest
import torch

from amof_tpu.ops import pallas_rdf as jax_rdf
from amof_tpu_torch.ops import pair_engine, rdf_kernel

torch.set_num_threads(2)


def grid_case(n, n_species, seed, triclinic=False, box=16.0, pad_from=None):
    """Positions on a 1/32 A grid; cell lower-triangular with
    power-of-two diagonal, so its float32 inverse is exact."""
    rng = np.random.default_rng(seed)
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0] = box / 4
        cell[2, 0] = box / 8
        cell[2, 1] = box / 4
    frac = rng.uniform(0, 1, (n, 3))
    pos = np.round((frac @ cell) * 32) / 32
    sp = rng.integers(0, n_species, n).astype(np.int32)
    if pad_from is not None:
        sp[pad_from:] = -1
        pos[pad_from:] = 0.0
    return pos.astype(np.float32), cell, sp


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("triclinic", [False, True])
def test_blocked_matches_pallas(triclinic):
    pos, cell, sp = grid_case(384, 3, seed=1, triclinic=triclinic,
                              pad_from=370)
    perm, sp_l = rdf_kernel.species_block_layout(sp, block=128,
                                                 total_multiple=128)
    pos_l = rdf_kernel.apply_atom_layout(pos, perm)
    ortho = not triclinic
    bins = int(8.0 // 0.05)
    ref = np.asarray(jax_rdf.pallas_rdf_counts_blocked(
        pos_l, cell, sp_l, 0.05, 3, bins, ti=128, tj=128, g=16,
        ortho=ortho, interpret=True,
    ))
    got = rdf_kernel.rdf_counts_blocked(
        t(pos_l), t(cell), t(sp_l), 0.05, 3, bins, ortho=ortho).numpy()
    assert got.shape == ref.shape == (3, 3, bins)
    assert ref.sum() > 0
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("triclinic", [False, True])
def test_unblocked_matches_pallas(triclinic):
    pos, cell, sp = grid_case(256, 2, seed=2, triclinic=triclinic,
                              pad_from=240)
    bins = int(8.0 // 0.01)
    ref = np.asarray(jax_rdf.pallas_rdf_counts(
        pos, cell, sp, 0.01, 2, bins, ti=128, tj=128, interpret=True,
    ))
    got = rdf_kernel.rdf_counts(t(pos), t(cell), t(sp), 0.01, 2,
                                bins).numpy()
    assert np.array_equal(got, ref)


def test_ortho_path_equals_full_transform():
    pos, cell, sp = grid_case(300, 2, seed=3)
    a = rdf_kernel.rdf_counts(t(pos), t(cell), t(sp), 0.05, 2, 160,
                              ortho=True)
    b = rdf_kernel.rdf_counts(t(pos), t(cell), t(sp), 0.05, 2, 160,
                              ortho=False)
    assert torch.equal(a, b)


def test_blocked_layout_is_permutation_invariant():
    pos, cell, sp = grid_case(500, 4, seed=4)
    perm, sp_l = rdf_kernel.species_block_layout(sp, block=256,
                                                 total_multiple=256)
    pos_l = rdf_kernel.apply_atom_layout(pos, perm)
    a = rdf_kernel.rdf_counts_blocked(t(pos_l), t(cell), t(sp_l), 0.02, 4,
                                      400)
    b = rdf_kernel.rdf_counts(t(pos), t(cell), t(sp), 0.02, 4, 400)
    assert torch.equal(a, b)


@pytest.mark.parametrize("block,total", [(128, 128), (256, 512), (64, 256)])
def test_species_block_layout_matches_jax(block, total):
    rng = np.random.default_rng(5)
    sp = rng.integers(0, 4, 700).astype(np.int32)
    sp[650:] = -1
    perm_j, sp_j = jax_rdf.species_block_layout(sp, block, total)
    perm_t, sp_t = rdf_kernel.species_block_layout(sp, block, total)
    assert np.array_equal(perm_j, perm_t)
    assert np.array_equal(sp_j, sp_t)
    pos = rng.uniform(0, 10, (2, 700, 3)).astype(np.float32)
    assert np.array_equal(jax_rdf.apply_atom_layout(pos, perm_j),
                          rdf_kernel.apply_atom_layout(pos, perm_t))


def _ieee_oracle(pos, cell, sp, dr, n_species, bins):
    """numpy float32, one rounding per op, the Pallas expression order."""
    inv = torch.linalg.inv(torch.from_numpy(cell)).numpy()
    n = len(pos)
    out = np.zeros((n_species, n_species, bins), np.int64)
    inv_dr = np.float32(1.0 / dr)
    he = np.float32(0.5 + 1e-7)
    for i in range(n - 1):
        d = pos[i + 1:] - pos[i]
        f = [(d[:, 0] * inv[0, k] + d[:, 1] * inv[1, k]) + d[:, 2] * inv[2, k]
             for k in range(3)]
        f = [x - np.floor(x + he) for x in f]
        w = [(f[0] * cell[0, k] + f[1] * cell[1, k]) + f[2] * cell[2, k]
             for k in range(3)]
        dist = np.sqrt((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
        b = np.floor(dist * inv_dr).astype(np.int64)
        sj = sp[i + 1:]
        ok = (b < bins) & (sj >= 0) & (sp[i] >= 0)
        np.add.at(out, (sp[i], sj[ok], b[ok]), 1)
    return out + out.transpose(1, 0, 2)


def test_sqrt_rn_is_correctly_rounded():
    x = np.random.default_rng(8).uniform(0, 3000, 1_000_000).astype(
        np.float32)
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(pair_engine.sqrt_rn(t(x)).numpy(), ref)


def test_generic_floats_match_ieee_oracle():
    rng = np.random.default_rng(6)
    n, box = 400, 13.7
    cell = np.array([[box, 0, 0], [1.3, box * 1.1, 0], [0.7, -0.9, box]],
                    np.float32)
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    sp = rng.integers(0, 3, n).astype(np.int32)
    sp[390:] = -1
    got = rdf_kernel.rdf_counts(t(pos), t(cell), t(sp), 0.01, 3, 600).numpy()
    assert np.array_equal(got, _ieee_oracle(pos, cell, sp, 0.01, 3, 600))

