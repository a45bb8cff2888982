"""Kernel #1's redesign, held on the CPU: the exact ``d2_cut`` and a plain
twin of the kernel's loop structure.

The twin walks the same work items as ``csrc/rdf_hist.cu``'s
``rdf_blocked_kernel`` (a 256-atom i tile against one half of a 256-atom j
tile, upper tile triangle): it checks the blocked contract per tile (the
real atoms are a prefix of one species), runs contract-holding items over
the real prefixes only with the diagonal rule ``j slot > i slot`` and one
species-pair key, takes the general per-pair path elsewhere, and keeps a
pair iff ``d2 < d2_cut``. It must equal ``rdf_half_plain`` (which tests
``bin < bins`` on every pair) bit for bit. Tolerance: exact (integer
counts).
"""

import numpy as np
import pytest
import torch

from amof_tpu_torch.ops import rdf_kernel
from amof_tpu_torch.ops.pair_engine import inverse_cell

torch.set_num_threads(2)

TILE = 256  # atoms per tile side
JSPAN = 128  # j slots of one work item (half a j tile)


def np_bin(d2, dr):
    """floor(f32(sqrt(d2)) * f32(1/dr)) with numpy: float64 root rounded
    once to float32 (correctly rounded), float32 product."""
    root = np.sqrt(np.float64(np.float32(d2))).astype(np.float32)
    return int(np.floor(root * np.float32(1.0 / dr)))


@pytest.mark.parametrize("dr", [0.01, 0.02, 0.05, 0.001])
@pytest.mark.parametrize("box", [54.87, 20.0])
@pytest.mark.parametrize("frac", [1.0, 0.5, 0.1])
def test_d2_cut_is_exact(dr, box, frac):
    """At the cut the bin is ``bins``; one float below, ``bins - 1``. Bins
    at the half-cell (the default rmax) and below."""
    bins = max(1, int(frac * (box / 2) // dr))
    cut = np.float32(rdf_kernel.d2_cut(dr, bins))
    below = np.nextafter(cut, np.float32(0))
    assert np_bin(cut, dr) == bins
    assert np_bin(below, dr) == bins - 1


def test_d2_cut_edges():
    assert rdf_kernel.d2_cut(0.01, 0) == 0.0
    assert np_bin(rdf_kernel.d2_cut(0.01, 1), 0.01) == 1
    big = 56320  # the most bins kernel #1 keeps in shared memory
    assert np_bin(rdf_kernel.d2_cut(0.001, big), 0.001) == big


def tile_contract(sp_tile):
    """(holds, first species, real count) of one tile's species, as the
    kernel's per-block check: real atoms a prefix, all of one species."""
    real = sp_tile >= 0
    r = int(real.sum())
    holds = bool(real[:r].all()) and (r == 0 or bool(
        (sp_tile[:r] == sp_tile[0]).all()))
    return holds, int(sp_tile[0]) if r else -1, r


def half_twin(pos, sp, cell, inv, dr, n_species, bins, ortho):
    """The kernel's loop structure in plain PyTorch: int64 half histogram
    keyed (s_i * S + s_j) * bins + b over unordered pairs i < j, item by
    item (an i tile against half of a j tile)."""
    n = pos.shape[0]
    nt = -(-n // TILE)
    cut = rdf_kernel.d2_cut(dr, bins)
    inv_dr = float(np.float32(1.0 / dr))
    sp_np = sp.numpy()
    half = torch.zeros(n_species * n_species * bins, dtype=torch.int64)
    items = [(it, jt, jlo) for jt in range(nt) for it in range(jt + 1)
             for jlo in (0, JSPAN)]
    for it, jt, jlo in items:
        i0, j0 = it * TILE, jt * TILE
        oki, si0, ri = tile_contract(sp_np[i0:i0 + TILE])
        okj, sj0, rj = tile_contract(sp_np[j0:j0 + TILE])
        if ri == 0 or rj == 0:
            continue
        if oki and okj:
            hi = min(jlo + JSPAN, rj)  # the item's real j prefix
            if hi <= jlo:
                continue
            d2 = rdf_kernel.d2_plain(pos[i0:i0 + ri], pos[j0 + jlo:j0 + hi],
                                     cell, inv, ortho)
            keep = d2 < cut
            if it == jt:  # j slot after i slot
                keep &= (torch.arange(jlo, hi)[None, :]
                         > torch.arange(ri)[:, None])
            b = rdf_kernel.bin_plain(d2[keep], inv_dr)
            base = (si0 * n_species + sj0) * bins
            half[base:base + bins] += torch.bincount(b, minlength=bins)
            continue
        lo, hi = j0 + jlo, min(j0 + jlo + JSPAN, n)
        if hi <= lo:
            continue
        xi, xj = pos[i0:i0 + TILE], pos[lo:hi]
        si, sj = sp[i0:i0 + TILE].long(), sp[lo:hi].long()
        d2 = rdf_kernel.d2_plain(xi, xj, cell, inv, ortho)
        gi = torch.arange(i0, i0 + len(xi))[:, None]
        gj = torch.arange(lo, hi)[None, :]
        keep = (si >= 0)[:, None] & (sj >= 0)[None, :] & (gj > gi) \
            & (d2 < cut)
        key = (si[:, None] * n_species + sj[None, :]) * bins
        half += torch.bincount(key[keep] + rdf_kernel.bin_plain(
            d2[keep], inv_dr), minlength=half.numel())
    return half


def system(n, n_species, seed, box, triclinic=False, pad_from=None):
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


def blocked(pos, sp, block=TILE):
    perm, sp_l = rdf_kernel.species_block_layout(sp, block, block)
    return rdf_kernel.apply_atom_layout(pos, perm), sp_l.astype(np.int32)


def cases():
    """name -> (positions, cell, species, n_species, ortho, dr, bins)"""
    out = {}
    pos, cell, sp = system(900, 3, 1, 24.0, pad_from=880)
    p, s = blocked(pos, sp)
    out["cubic, blocked, partial tiles"] = (p, cell, s, 3, True, 0.01, 1200)
    pos, cell, sp = system(700, 4, 2, 22.0, triclinic=True)
    p, s = blocked(pos, sp)
    out["triclinic, blocked"] = (p, cell, s, 4, False, 0.02, 500)
    pos, cell, sp = system(650, 1, 3, 20.0)
    out["single species, n not a multiple of 256"] = (pos, cell, sp, 1, True,
                                                      0.05, 200)
    pos, cell, sp = system(800, 3, 4, 24.0, pad_from=790)
    out["unblocked order (contract broken)"] = (pos, cell, sp, 3, True, 0.01,
                                                1200)
    pos, cell, sp = system(900, 3, 5, 24.0)
    p, s = blocked(pos, sp, block=128)  # two species in some 256-tiles
    out["128-atom groups (contract broken in some tiles)"] = (
        p, cell, s, 3, False, 0.01, 1200)
    return out


CASES = cases()


@pytest.mark.parametrize("name", list(CASES))
def test_twin_equals_plain(name):
    pos, cell, sp, s, ortho, dr, bins = CASES[name]
    p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
    inv = inverse_cell(c)
    ref = rdf_kernel.rdf_half_plain(p, t, c, inv, dr, s, bins, ortho)
    got = half_twin(p, t, c, inv, dr, s, bins, ortho)
    assert int(ref.sum()) > 0
    assert torch.equal(got, ref)


def test_contract_cases_take_both_paths():
    """The cases above reach the fast path and the general path."""
    kinds = set()
    for pos, cell, sp, *_ in CASES.values():
        nt = -(-len(sp) // TILE)
        for k in range(nt):
            holds, _, r = tile_contract(sp[k * TILE:(k + 1) * TILE])
            kinds.add((holds, 0 < r < TILE))
    assert {(True, True), (True, False), (False, False)} <= kinds


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


def test_pairs_at_the_cut():
    """Pairs whose d2 is d2_cut exactly (dropped) and the float below it
    (kept in bin bins - 1): the twin's cut and the plain bin test agree,
    on the fast path and on the general path."""
    dr, box = 0.01, 64.0
    for bins in range(1500, 1700):
        cut = np.float32(rdf_kernel.d2_cut(dr, bins))
        below = np.nextafter(cut, np.float32(0))
        x_at, x_below = pair_at(cut), pair_at(below)
        if x_at is not None and x_below is not None:
            break
    else:
        pytest.fail("no exactly representable pair near the cut")
    # atoms on the x axis: 0 and x_at; 1 A up, 0 and x_below (far apart in y
    # and z from the first pair beyond the cut)
    pos = np.array([[0, 0, 0], [x_at, 0, 0], [0, 32, 32],
                    [x_below, 32, 32]], np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    for sp in (np.zeros(4, np.int32), np.array([0, -1, 0, 0], np.int32)):
        p, c, t = (torch.from_numpy(np.array(a)) for a in (pos, cell, sp))
        inv = inverse_cell(c)
        d2 = rdf_kernel.d2_plain(p[:2], p[1:2], c, inv, True)
        assert float(d2[0, 0]) == float(cut)
        ref = rdf_kernel.rdf_half_plain(p, t, c, inv, dr, 1, bins, True)
        got = half_twin(p, t, c, inv, dr, 1, bins, True)
        assert int(ref[bins - 1]) == 1  # the pair below; the one at is out
        assert torch.equal(got, ref)
