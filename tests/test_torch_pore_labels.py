"""Parity of the port's connectivity chain with the JAX package: the plain
flood-fill fixpoint (kernel #7's plain version, which
``grid_kernel.propagate_fixpoint`` runs for CPU tensors) against
``label_components``, ``propagate_channel`` and
``void_classification_mask`` of ``amof_tpu`` (its roll path: on the CPU
``_propagate_fixpoint`` takes no Pallas kernel), on random masks, open
and periodic, with odd and non-multiple-of-8 dims.

Tolerance: exact. Labels are voxel indices propagated as maxima, and the
classification is boolean; no float arithmetic is involved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu_torch.pore import grid_kernel

SHAPES = [(16, 12, 20), (9, 13, 7), (1, 17, 10), (24, 24, 24)]


def random_mask(shape, frac, seed):
    return np.random.default_rng(seed).random(shape) < frac


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frac", [0.3, 0.6])
@pytest.mark.parametrize("periodic", [False, True])
def test_labels_equal(shape, frac, periodic):
    mask = random_mask(shape, frac, sum(shape))
    ref = np.asarray(jgk.label_components(jnp.asarray(mask),
                                          periodic=periodic))
    got = grid_kernel.label_components(torch.from_numpy(mask),
                                       periodic=periodic)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_channel_propagation_equal(shape):
    rng = np.random.default_rng(3)
    mask = rng.random(shape) < 0.55
    seeds = mask & (rng.random(shape) < 0.02)
    ref = np.asarray(jgk.propagate_channel(jnp.asarray(seeds),
                                           jnp.asarray(mask)))
    got = grid_kernel.propagate_channel(torch.from_numpy(seeds),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frac", [0.35, 0.5])
def test_void_classification_equal(shape, frac):
    mask = random_mask(shape, frac, 11 + sum(shape))
    ref = jgk.void_classification_mask(jnp.asarray(mask))
    got = grid_kernel.void_classification_mask(torch.from_numpy(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    open_ref = jgk.label_components(jnp.asarray(mask), periodic=False)
    seeds_ref = jgk.winding_seeds(open_ref, jnp.asarray(mask))
    seeds = grid_kernel.winding_seeds(
        torch.from_numpy(np.array(open_ref)), torch.from_numpy(mask))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(seeds_ref))


def test_slab_percolates_and_pocket_does_not():
    """A z-slab of void percolates (accessible); a sealed cube is a
    pocket."""
    mask = np.zeros((20, 20, 20), bool)
    mask[:, :, 2:5] = True
    mask[8:12, 8:12, 10:14] = True
    _, acc, poc = grid_kernel.void_classification_mask(
        torch.from_numpy(mask))
    assert acc[:, :, 2:5].all() and not acc[8:12, 8:12, 10:14].any()
    assert poc[8:12, 8:12, 10:14].all() and not poc[:, :, 2:5].any()


def test_fixpoint_rejects_bad_input():
    with pytest.raises(ValueError):
        grid_kernel.propagate_fixpoint(torch.zeros((4, 4, 4)), True)
    with pytest.raises(ValueError):
        grid_kernel.propagate_fixpoint(
            torch.zeros((4, 4), dtype=torch.int32), True)
