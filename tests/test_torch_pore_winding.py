"""Parity of the port's exact winding analysis (``pore/winding.py``) with
``amof_tpu``'s: ``channel_analysis`` on open labels, ``face_test_is_exact``
on wrap-edge label pairs, and ``void_classification_exact`` (the port's
takes a torch mask, labels it with the flood fill's plain version on the
CPU and moves only the face labels to the host), on random masks with odd
and non-multiple-of-8 dims, single straight channels, and a two-segment
composite channel that winds only through the pair of segments, which the
same-label face test misses.

Tolerance: exact. Labels, channel counts, dimensionalities and the
classification are integers and booleans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu.pore import winding as jw
from amof_tpu_torch.pore import grid_kernel, winding

torch.set_num_threads(2)

SHAPES = [(16, 12, 20), (9, 13, 7), (24, 24, 24)]


def random_mask(shape, frac, seed):
    return np.random.default_rng(seed).random(shape) < frac


def composite_channel(shape=(16, 16, 8)):
    """Two open segments, A from (0, 0, 0) to (15, 8, 0) in the z = 0
    layer and B from (0, 8, 0) up to z = 4, across and down to
    (15, 0, 0): across the x face A's end meets B's start and B's end
    meets A's start, so A + B winds once per two cells in x, and no face
    position holds one label on both sides."""
    m = np.zeros(shape, bool)
    m[0:8, 0, 0] = True
    m[7, 0:9, 0] = True
    m[7:16, 8, 0] = True
    m[0, 8, 0:5] = True
    m[0:13, 8, 4] = True
    m[12, 0:9, 4] = True
    m[12:16, 0, 4] = True
    m[15, 0, 0:5] = True
    return m


def straight_channels(shape=(12, 10, 14)):
    """A channel along x, one along y and z crossing it (one 3-D
    channel), plus a closed pocket."""
    m = np.zeros(shape, bool)
    m[:, 2, 3] = True
    m[5, :, 3] = True
    m[5, 2, :] = True
    m[8:10, 6:8, 9:11] = True
    return m


def open_labels(mask):
    return np.array(jgk.label_components(jnp.asarray(mask),
                                         periodic=False))


def masks():
    cases = [random_mask(s, f, sum(s)) for s in SHAPES for f in (0.3, 0.6)]
    return cases + [composite_channel(), straight_channels()]


@pytest.mark.parametrize("i", range(len(masks())))
def test_channel_analysis_equal(i):
    labels = open_labels(masks()[i])
    ref = jw.channel_analysis(labels)
    got = winding.channel_analysis(labels)
    assert got["n_channels"] == ref["n_channels"]
    assert got["dims"] == ref["dims"]
    np.testing.assert_array_equal(got["accessible"], ref["accessible"])


@pytest.mark.parametrize("i", range(len(masks())))
def test_face_test_certificate_equal(i):
    mask = masks()[i]
    pairs = grid_kernel.face_label_pairs(torch.from_numpy(
        open_labels(mask))).numpy()
    np.testing.assert_array_equal(
        pairs, np.asarray(jgk.face_label_pairs(jnp.asarray(
            open_labels(mask)))))
    axis_ids = grid_kernel.face_axis_ids(mask.shape)
    np.testing.assert_array_equal(axis_ids, jgk.face_axis_ids(mask.shape))
    assert (winding.face_test_is_exact(pairs, axis_ids)
            == jw.face_test_is_exact(pairs, axis_ids))


@pytest.mark.parametrize("i", range(len(masks())))
def test_void_classification_exact_equal(i):
    mask = masks()[i]
    ref = jw.void_classification_exact(mask)
    got = winding.void_classification_exact(torch.from_numpy(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), r)


def test_composite_channel_is_missed_by_the_face_test_only():
    mask = composite_channel()
    labels = open_labels(mask)
    assert len(np.unique(labels[labels >= 0])) == 2
    pairs = grid_kernel.face_label_pairs(torch.from_numpy(labels)).numpy()
    assert not winding.face_test_is_exact(
        pairs, grid_kernel.face_axis_ids(mask.shape))
    res = winding.channel_analysis(labels)
    assert res["n_channels"] == 1 and res["dims"] == [1]
    _, acc_face, _ = grid_kernel.void_classification_mask(
        torch.from_numpy(mask))
    _, acc_exact, pocket = winding.void_classification_exact(
        torch.from_numpy(mask))
    assert not acc_face.any()
    assert torch.equal(acc_exact, torch.from_numpy(mask))
    assert not pocket.any()


def test_straight_channels_rank_three_and_a_pocket():
    mask = straight_channels()
    res = winding.channel_analysis(open_labels(mask))
    assert res["n_channels"] == 1 and res["dims"] == [3]
    _, acc, pocket = winding.void_classification_exact(
        torch.from_numpy(mask))
    assert int(pocket.sum()) == 8 and bool(acc[0, 2, 3])
