"""CPU twin of kernel #7's tiled decomposition (``csrc/flood_fill.cu``).

``tiled_fixpoint`` runs the kernel's three steps in numpy, in an order
the kernel's blocks could take them: tile labels (each z run of a tile
row a star on its first voxel, then union-find over the +y/+x links, one
per overlapping pair of runs; local root = smallest index, the tile
maximum kept there), unions across the +x/+y/+z faces of occupied tiles
with the wrap rule and path halving, each link folding the maximum of the
root it hangs up the tree, and the gather, tile by tile, through
``parent[parent[v]]`` once local roots point at their global root.
Scratch starts as garbage, as ``torch.empty`` leaves it; links are taken
in a shuffled order.

At the kernel's tile (``grid_kernel.FLOOD_TILE``) and at a small one, its
output must equal the plain sweeps (``propagate_fixpoint_plain``) and
``amof_tpu``'s ``label_components`` / ``propagate_channel`` (their roll
path: on the CPU ``_propagate_fixpoint`` takes no Pallas kernel), on
ragged grids, axes of length 1 and 2, all-wall, all-open and one-voxel
grids, a one-voxel-wide serpentine, a component joined only across a
periodic face, and random masks at 0.8%, 50% and 60%, with linear-index
and {1, 0, -1} init, open and periodic.

Tolerance: exact. Labels are voxel indices or {1, 0, -1} propagated as
maxima; no float arithmetic is involved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu_torch.pore import grid_kernel

SMALL_TILE = (2, 2, 4)


# --------------------------------------------------------------------------
# The twin
# --------------------------------------------------------------------------

def _find(par, x):
    while par[x] != x:
        x = par[x]
    return x


def _find_halving(par, x):
    while True:
        p = par[x]
        if p == x:
            return x
        gp = par[p]
        if gp == p:
            return p
        par[x] = gp
        x = gp


def _unite(par, a, b, find, on_link=None):
    """Smaller index wins (the kernels' atomicMin link); ``on_link(b,
    a)`` runs where root b is hung under a."""
    while True:
        a, b = find(par, a), find(par, b)
        if a == b:
            return
        if a > b:
            a, b = b, a
        old = par[b]
        par[b] = min(old, a)
        if old == b:
            if on_link is not None:
                on_link(b, a)
            return
        b = old


def tiled_fixpoint(init, periodic, tile, seed=0):
    """Kernel #7's steps on the CPU: int32 out of the same shape."""
    rng = np.random.default_rng(seed)
    shape = init.shape
    flat = init.reshape(-1).astype(np.int64)
    n = flat.size
    masked = flat >= 0
    nt = [-(-g // t) for g, t in zip(shape, tile)]
    coords = np.indices(shape).reshape(3, -1)
    tcoord = coords // np.array(tile)[:, None]
    tile_of = (tcoord[0] * nt[1] + tcoord[1]) * nt[2] + tcoord[2]
    strides = (shape[1] * shape[2], shape[2], 1)
    z_prev = masked & (coords[2] % tile[2] > 0)  # masked, not a row start
    z_prev[z_prev] = masked[np.flatnonzero(z_prev) - 1]
    # scratch as torch.empty leaves it
    parent = list(rng.integers(-5, n + 5, n))
    out = rng.integers(-5, n + 5, n)
    flags = rng.integers(-5, 5, int(np.prod(nt)))

    # 1. tiles: each z run of a tile row a star on its first voxel, then
    # the +y/+x links, one per overlapping pair of runs; local root the
    # smallest index
    flags[:] = 0
    flags[tile_of[masked]] = 1
    out[~masked] = -1
    lab = list(range(n))
    for v in np.flatnonzero(z_prev):
        lab[v] = lab[v - 1]
    links = []
    for ax in (0, 1):
        a = np.flatnonzero(masked & (coords[ax] + 1 < shape[ax]))
        b = a + strides[ax]
        keep = masked[b] & (tile_of[a] == tile_of[b])
        keep &= ~(z_prev[a] & z_prev[b])  # the pair below joins these runs
        links += list(zip(a[keep], b[keep]))
    for k in rng.permutation(len(links)):
        _unite(lab, *links[k], _find_halving)
    vox = np.flatnonzero(masked)
    # every node with children is a run start: run starts point straight
    # at their local root, then each voxel's root is lab[lab[v]]
    for v in vox[~z_prev[vox]]:
        lab[v] = _find(lab, v)
    root = np.array([lab[lab[v]] for v in vox], np.int64)
    assert all(r == _find(lab, v) for v, r in zip(vox, root))
    local_max = np.full(n, -1, np.int64)
    np.maximum.at(local_max, root, flat[vox])
    for v, r in zip(vox, root):
        parent[v] = r
    out[vox] = np.where(root == vox, local_max[vox], -1)
    for v, r in zip(vox, root):  # the local root is its component's min
        assert r <= v and tile_of[r] == tile_of[v]

    # 2. faces: occupied tiles, +x/+y/+z, the last tile of a periodic
    # axis of length > 1 wrapping onto the first; one link per pair of
    # runs on the x and y faces; a link folds the maximum up
    def fold(b, a):
        m, r = out[b], a
        while True:
            out[r] = max(out[r], m)
            if parent[r] == r:
                return
            r = parent[r]

    pairs = []
    for ax in range(3):
        g, t = shape[ax], tile[ax]
        c = coords[ax]
        last = np.minimum((c // t) * t + t, g) - 1
        nxt = c + 1
        sel = c == last
        if periodic and g > 1:
            nxt = np.where(nxt == g, 0, nxt)
        else:
            sel &= nxt < g
        a = np.flatnonzero(sel)
        b = a + (nxt[a] - c[a]) * strides[ax]
        # a masked voxel across the face makes its tile an occupied one
        keep = (flags[tile_of[a]] == 1) & masked[a] & masked[b]
        if ax < 2:
            keep &= ~(z_prev[a] & z_prev[b])
        pairs += list(zip(a[keep], b[keep]))
    for k in rng.permutation(len(pairs)):
        a, b = pairs[k]
        _unite(parent, parent[a], parent[b], _find_halving, fold)

    # 3. gather, tile by tile: local roots (out >= 0) point at their
    # global root, then every masked voxel reads out[parent[parent[v]]]
    for b in rng.permutation(len(flags)):
        if flags[b] != 1:
            continue
        here = vox[tile_of[vox] == b]
        for v in here:
            if out[v] >= 0:
                parent[v] = _find(parent, v)
        for k in rng.permutation(len(here)):
            v = here[k]
            out[v] = out[parent[parent[v]]]
    return out.reshape(shape).astype(np.int32)


# --------------------------------------------------------------------------
# Cases
# --------------------------------------------------------------------------

def serpentine(shape):
    """A one-voxel-wide path: in each even x layer, full z rows at even y
    joined at alternate ends; layers joined through the odd x layer
    between them, alternately at the path's end and start."""
    gx, gy, gz = shape
    m = np.zeros(shape, bool)
    rows = list(range(0, gy, 2))
    for x in range(0, gx, 2):
        for j, y in enumerate(rows):
            m[x, y, :] = True
            if j + 1 < len(rows):
                m[x, y + 1, gz - 1 if j % 2 == 0 else 0] = True
        if x + 2 < gx:
            at_end = (x // 2) % 2 == 0
            y, z = ((rows[-1], gz - 1 if len(rows) % 2 else 0) if at_end
                    else (0, 0))
            m[x + 1, y, z] = True
    return m


def face_joined(shape, axis):
    """Two bars along ``axis`` that meet only across its periodic face."""
    m = np.zeros(shape, bool)
    g = shape[axis]
    at = [s // 2 for s in shape]
    for lo, hi in ((0, g // 4), (g // 2, g)):
        for c in range(lo, hi):
            at[axis] = c
            m[tuple(at)] = True
    return m


def pockets(shape, count, seed):
    """``count`` open 3 x 3 x 3 cubes at random places (some across tile
    faces, most tiles empty)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    for _ in range(count):
        x, y, z = (rng.integers(0, s - 2) for s in shape)
        m[x:x + 3, y:y + 3, z:z + 3] = True
    return m


def random_mask(shape, frac, seed):
    return np.random.default_rng(seed).random(shape) < frac


CASES = {
    "ragged (9, 13, 7)": lambda: random_mask((9, 13, 7), 0.5, 1),
    "ragged (17, 5, 33)": lambda: random_mask((17, 5, 33), 0.6, 2),
    "x of length 1": lambda: random_mask((1, 9, 21), 0.6, 3),
    "x of length 2": lambda: random_mask((2, 17, 19), 0.6, 4),
    "y of length 2": lambda: random_mask((9, 2, 35), 0.6, 5),
    "z of length 1": lambda: random_mask((11, 10, 1), 0.6, 6),
    "z of length 2": lambda: random_mask((10, 9, 2), 0.6, 7),
    "all walls": lambda: np.zeros((10, 9, 18), bool),
    "all open": lambda: np.ones((10, 9, 18), bool),
    "single voxel": lambda: np.ones((1, 1, 1), bool),
    "serpentine": lambda: serpentine((17, 20, 40)),
    "joined across the x face": lambda: face_joined((20, 9, 18), 0),
    "joined across the z face": lambda: face_joined((9, 10, 37), 2),
    "random 0.8%": lambda: random_mask((24, 24, 48), 0.008, 8),
    "pockets": lambda: pockets((40, 33, 50), 12, 11),
    "random 50%": lambda: random_mask((24, 20, 36), 0.5, 9),
    "random 60%": lambda: random_mask((20, 17, 33), 0.6, 10),
}


def make_init(mask, kind):
    if kind == "linear":
        return np.where(mask, np.arange(mask.size).reshape(mask.shape),
                        -1).astype(np.int32)
    seeds = mask & (np.random.default_rng(mask.size).random(mask.shape)
                    < 0.02)
    seeds.reshape(-1)[np.flatnonzero(mask)[:1]] = True  # at least one
    return np.where(seeds, 1, np.where(mask, 0, -1)).astype(np.int32)


_REFS = {}


def references(case, kind, periodic):
    """(init, plain sweeps, amof_tpu) for one case, computed once."""
    key = (case, kind, periodic)
    if key not in _REFS:
        mask = CASES[case]()
        init = make_init(mask, kind)
        plain = grid_kernel.propagate_fixpoint_plain(
            torch.from_numpy(init), periodic).numpy()
        if kind == "linear":
            ref = np.asarray(jgk.label_components(jnp.asarray(mask),
                                                  periodic=periodic))
        elif periodic:
            ref = np.asarray(jgk.propagate_channel(jnp.asarray(init == 1),
                                                   jnp.asarray(mask)))
        else:
            ref = np.asarray(jgk._propagate_fixpoint(jnp.asarray(init),
                                                     False, 8))
        _REFS[key] = (init, plain, ref)
    return _REFS[key]


@pytest.mark.parametrize("tile", [grid_kernel.FLOOD_TILE, SMALL_TILE],
                         ids=["kernel tile", "small tile"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kind", ["linear", "ternary"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_twin_equals_plain_and_amof_tpu(case, kind, periodic, tile):
    init, plain, ref = references(case, kind, periodic)
    got = tiled_fixpoint(init, periodic, tile, seed=len(case))
    np.testing.assert_array_equal(got, plain)
    if kind == "ternary" and periodic:
        np.testing.assert_array_equal(got == 1, ref)
    else:
        np.testing.assert_array_equal(got, ref)


def test_cases_are_what_they_say():
    """The serpentine is one path; the face-joined bars are two
    components when open and one when periodic; the 0.8% mask leaves
    small tiles empty, the pockets kernel tiles."""
    path = serpentine((17, 20, 40))
    lab = grid_kernel.propagate_fixpoint_plain(torch.from_numpy(
        make_init(path, "linear")), False).numpy()
    assert np.unique(lab[path]).size == 1 and path.sum() > 3000
    # a path: every voxel has at most two masked 6-neighbours
    pad = np.pad(path, 1)
    deg = sum(np.roll(pad, s, a) for a in range(3) for s in (1, -1))
    assert deg[1:-1, 1:-1, 1:-1][path].max() == 2
    for case in ("joined across the x face", "joined across the z face"):
        mask = CASES[case]()
        for periodic, count in ((False, 2), (True, 1)):
            lab = grid_kernel.propagate_fixpoint_plain(torch.from_numpy(
                make_init(mask, "linear")), periodic).numpy()
            assert np.unique(lab[mask]).size == count
    for case, tiles in (("random 0.8%", (12, 2, 12, 2, 12, 4)),
                        ("pockets", (5, 8, 5, 8, 4, 16))):
        mask = CASES[case]()
        pad = np.zeros([t * s for t, s in zip(tiles[::2], tiles[1::2])],
                       bool)
        pad[:mask.shape[0], :mask.shape[1], :mask.shape[2]] = mask
        occupied = pad.reshape(tiles).any(axis=(1, 3, 5))
        assert 0 < occupied.sum() < occupied.size / 2


def test_flood_tiles_count():
    assert grid_kernel.flood_tiles((112, 112, 112)) == 14 * 14 * 7
    assert grid_kernel.flood_tiles((16, 512, 512)) == 2 * 64 * 32
    assert grid_kernel.flood_tiles((9, 13, 7)) == 2 * 2 * 1
    assert grid_kernel.flood_tiles((1, 1, 1)) == 1
