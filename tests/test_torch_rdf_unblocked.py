"""Kernel #2's redesign, held on the CPU: a plain twin of the kernel's
decomposition against the plain version.

The twin walks the same work items as ``csrc/rdf_hist.cu``'s
``rdf_any_kernel`` (a 256-atom i tile against one half of a 256-atom j
tile, upper tile triangle, in queue order, dealt to ``blocks`` blocks),
split among the block's four groups of 32 j slots; each block's folded
histogram is merged into one device histogram. Pads (species -1,
anywhere) and slots past n carry NaN coordinates, so their d2 fails the
cut; diagonal items alone keep only j slot > i slot, and a warp starts at
its first slot + 1. A pair is kept iff ``d2 < d2_cut`` and counted under
the folded key of its unordered species pair. The fold kernel's twin
writes [a, b] and [b, a] from the merged histogram, c + c on the
diagonal.
After that it must equal ``rdf_counts_plain`` (the half histogram plus
its transpose) bit for bit. Tolerance: exact (integer counts).
"""

import math

import numpy as np
import pytest
import torch

from amof_tpu.ops import pallas_rdf as jax_rdf
from amof_tpu_torch.ops import rdf_kernel
from amof_tpu_torch.ops.pair_engine import inverse_cell

torch.set_num_threads(2)

TILE = 256  # atoms per tile side
JSPAN = 128  # j slots of one work item (half a j tile)
GROUPS = 4  # groups of 128 threads a block, 32 j slots each


def tile_pair(b):
    """Queue item b >> 1 -> (it, jt), jt >= it, as the kernel's
    ``tile_pair``."""
    jt = (math.isqrt(8 * b + 1) - 1) // 2
    return b - jt * (jt + 1) // 2, jt


def fold_pair(a, b, s):
    """Index of the unordered species pair {a, b}, a <= b."""
    return a * s - a * (a - 1) // 2 + (b - a)


def key_table(s):
    """[S, S] folded key of (s_i, s_j), the kernel's shared key table."""
    return torch.tensor([[fold_pair(min(a, b), max(a, b), s)
                          for b in range(s)] for a in range(s)])


def any_twin_rows(pos, sp, cell, inv, dr, n_species, bins, ortho, blocks):
    """int64 [blocks, S(S+1)/2 * bins]: each block's folded histogram, the
    kernel's loop in plain PyTorch."""
    n = pos.shape[0]
    nt = -(-n // TILE)
    cut = rdf_kernel.d2_cut(dr, bins)
    inv_dr = float(np.float32(1.0 / dr))
    real = sp >= 0
    # pads and slots past n: NaN coordinates (the tail is never a j slot)
    x = torch.full((nt * TILE, 3), float("nan"))
    x[:n][real] = pos[real]
    s = torch.zeros(nt * TILE, dtype=torch.int64)
    s[:n][real] = sp[real].long()
    keys = key_table(n_species) * bins
    n_fold = n_species * (n_species + 1) // 2 * bins
    rows = torch.zeros(blocks, n_fold, dtype=torch.int64)
    k = torch.arange(TILE)
    warp_first = (k // 64) * 64  # a warp holds 32 lanes x 2 i slots
    for item in range(2 * nt * (nt + 1) // 2):
        it, jt = tile_pair(item >> 1)
        i0, j0, jlo = it * TILE, jt * TILE, (item & 1) * JSPAN
        for g in range(GROUPS):
            lo = g * (JSPAN // GROUPS)
            hi = min(lo + JSPAN // GROUPS, n - j0 - jlo)
            if hi <= lo:
                continue
            u = torch.arange(lo, hi)
            d2 = rdf_kernel.d2_plain(x[i0:i0 + TILE], x[j0 + jlo + u], cell,
                                     inv, ortho)
            keep = d2 < cut
            if it == jt:
                keep &= (u[None, :] >= (warp_first + 1 - jlo)[:, None]) \
                    & (jlo + u[None, :] > k[:, None])
            key = keys[s[i0:i0 + TILE][:, None], s[j0 + jlo + u][None, :]]
            key = key[keep] + rdf_kernel.bin_plain(d2[keep], inv_dr)
            rows[item % blocks] += torch.bincount(key, minlength=n_fold)
    return rows


def fold_out(rows, n_species, bins):
    """The fold kernel's twin: float32 [S, S, bins] from the rows' sum."""
    c = rows.sum(0).to(torch.float32).reshape(-1, bins)
    out = torch.empty(n_species, n_species, bins)
    for a in range(n_species):
        for b in range(a, n_species):
            v = c[fold_pair(a, b, n_species)]
            if a == b:
                out[a, a] = v + v
            else:
                out[a, b] = out[b, a] = v
    return out


def any_twin(pos, cell, sp, dr, n_species, bins, ortho, blocks=3):
    inv = inverse_cell(cell)
    return fold_out(any_twin_rows(pos, sp, cell, inv, dr, n_species, bins,
                                  ortho, blocks), n_species, bins)


def system(n, n_species, seed, box, triclinic=False, pads=0):
    """Random atoms in a random order; ``pads`` pad slots (species -1,
    position 0) at random places among them."""
    rng = np.random.default_rng(seed)
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, -box / 5
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    sp = rng.integers(0, n_species, n).astype(np.int32)
    if pads:
        at = rng.choice(n, pads, replace=False)
        sp[at], pos[at] = -1, 0.0
    return pos, cell, sp


def cases():
    """name -> (positions, cell, species, n_species, ortho, dr, bins)"""
    return {
        "S 1, cubic, n 700": (*system(700, 1, 1, 20.0), 1, True, 0.01, 1000),
        "S 2, triclinic, pads mid-array, dr 0.001": (
            *system(600, 2, 2, 18.0, triclinic=True, pads=40), 2, False,
            0.001, 9000),
        "S 4, cubic, pads mid-array, n 1100": (
            *system(1100, 4, 3, 24.0, pads=60), 4, True, 0.01, 1200),
        "S 4, dr 0.0001 to 2 A (the CN call)": (
            *system(900, 4, 4, 20.0, pads=10), 4, False, 0.0001,
            int(2.0 // 0.0001)),
        "S 6, triclinic, n 530": (*system(530, 6, 5, 16.0, triclinic=True,
                                          pads=3), 6, False, 0.01, 800),
        "S 4, general template on a cubic cell": (
            *system(513, 4, 6, 16.0, pads=1), 4, False, 0.02, 400),
    }


CASES = cases()


@pytest.mark.parametrize("name", list(CASES))
def test_twin_equals_plain(name):
    pos, cell, sp, s, ortho, dr, bins = CASES[name]
    p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
    ref = rdf_kernel.rdf_counts_plain(p, c, t, dr, s, bins, ortho)
    got = any_twin(p, c, t, dr, s, bins, ortho)
    assert float(ref.sum()) > 0
    assert torch.equal(got, ref)


def test_cases_reach_every_layout():
    """The cases hold n off a multiple of 256 (a partial last tile), with
    pads between real atoms and without."""
    shapes = {(len(v[2]) % TILE != 0, bool((v[2][:-1] < 0).any()))
              for v in CASES.values()}
    assert (True, True) in shapes and (True, False) in shapes


@pytest.mark.parametrize("blocks", [1, 2, 7, 64])
def test_blocks_rows_sum_alike(blocks):
    """Any number of blocks, each merging its histogram into the device
    histogram, gives the same fold."""
    pos, cell, sp, s, ortho, dr, bins = CASES[
        "S 4, cubic, pads mid-array, n 1100"]
    p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
    ref = rdf_kernel.rdf_counts_plain(p, c, t, dr, s, bins, ortho)
    assert torch.equal(any_twin(p, c, t, dr, s, bins, ortho, blocks), ref)


def pair_at(d2_target, box=64.0):
    """x offset (float32) whose kernel d2 in a cubic 64 A cell (exact
    inverse, exact wrap) is ``d2_target``, or None."""
    x0 = np.float32(np.sqrt(np.float64(d2_target)))
    for step in range(-8, 9):
        x = x0
        for _ in range(abs(step)):
            x = np.nextafter(x, np.float32(np.sign(step) * np.inf))
        if np.float32(x * x) == np.float32(d2_target):
            return x
    return None


@pytest.mark.parametrize("dr", [0.01, 0.001, 0.0001])
def test_pairs_at_the_cut(dr):
    """Pairs whose d2 is d2_cut exactly (dropped) and one ulp below it
    (kept in bin bins - 1), of two species in both orders, with a pad
    between them: the twin's cut and fold agree with the plain bin test."""
    box = 64.0
    for bins in range(int(15.0 // dr), int(15.0 // dr) + 400):
        cut = np.float32(rdf_kernel.d2_cut(dr, bins))
        below = np.nextafter(cut, np.float32(0))
        x_at, x_below = pair_at(cut), pair_at(below)
        if x_at is not None and x_below is not None:
            break
    else:
        pytest.fail("no exactly representable pair near the cut")
    pos = np.array([[0, 0, 0], [0, 5, 5], [x_at, 0, 0], [0, 32, 32],
                    [x_below, 32, 32], [0, 16, 48], [x_below, 16, 48]],
                   np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    sp = np.array([0, -1, 1, 1, 0, 0, 1], np.int32)
    p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
    inv = inverse_cell(c)
    assert float(rdf_kernel.d2_plain(p[:1], p[2:3], c, inv, True)[0, 0]) \
        == float(cut)
    ref = rdf_kernel.rdf_counts_plain(p, c, t, dr, 2, bins, True)
    got = any_twin(p, c, t, dr, 2, bins, True)
    assert float(ref[0, 1, bins - 1]) == 2.0  # (1, 0) and (0, 1) below
    assert float(ref[:, :, bins - 1].sum()) == 4.0  # the pair at is out
    assert torch.equal(got, ref)


def test_fold_matches_symmetrize_below_2_24():
    """The fold kernel's float32 of a folded count equals the plain
    version's float32 sum of the two orders while the count is below
    2^24; at 2^24 + 2 they round apart, as the wrapper's docstring
    says."""
    s, bins = 3, 4
    rng = np.random.default_rng(0)
    half = torch.from_numpy(rng.integers(0, 2 ** 23, (s, s, bins)))
    rows = torch.zeros(1, s * (s + 1) // 2 * bins, dtype=torch.int64)
    for a in range(s):
        for b in range(s):
            f = fold_pair(min(a, b), max(a, b), s)
            rows[0, f * bins:(f + 1) * bins] += half[a, b]
    assert torch.equal(fold_out(rows, s, bins),
                       rdf_kernel._symmetrize(half, s, bins))
    half = torch.zeros(2, 2, 1, dtype=torch.int64)
    half[0, 1], half[1, 0] = 2 ** 24 + 1, 1
    rows = torch.tensor([[0, 2 ** 24 + 2, 0]])
    assert float(fold_out(rows, 2, 1)[0, 1, 0]) == 2.0 ** 24 + 2
    assert float(rdf_kernel._symmetrize(half, 2, 1)[0, 1, 0]) == 2.0 ** 24


def test_modes_at_the_callers_shapes():
    """The bench frame's folded histogram (4 species, 2743 bins) fits two
    blocks an SM in shared memory; the CN call's 19999 bins take
    MODE_GLOBAL."""
    assert 4 * rdf_kernel.fold_ints(4, 2743) == 109_728  # 109,720 + pad
    assert rdf_kernel.smem_mode(4, 2743) == rdf_kernel.MODE_SMEM_ALL
    assert rdf_kernel.smem_mode(4, 19999) == rdf_kernel.MODE_GLOBAL
    assert rdf_kernel.fold_ints(6, 5) == 108


def test_twin_matches_pallas():
    """The twin against ``pallas_rdf_counts`` in interpret mode on dyadic
    inputs (1/32 A grid, power-of-two cubic box: every float32 step of
    the distance is exact), pads mid-array."""
    rng = np.random.default_rng(8)
    box = 16.0
    cell = np.eye(3, dtype=np.float32) * box
    pos = (np.round(rng.uniform(0, box, (256, 3)) * 32) / 32).astype(
        np.float32)
    sp = rng.integers(0, 3, 256).astype(np.int32)
    sp[100:110], pos[100:110] = -1, 0.0
    bins = int(8.0 // 0.01)
    ref = np.asarray(jax_rdf.pallas_rdf_counts(
        pos, cell, sp, 0.01, 3, bins, ti=128, tj=128, interpret=True))
    p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
    got = any_twin(p, c, t, 0.01, 3, bins, True).numpy()
    assert ref.sum() > 0
    assert np.array_equal(got, ref)
