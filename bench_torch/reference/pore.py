"""Plain PyTorch reference of the ``pore`` kind: Zeo++'s ``network -sa
<chan> <probe> <samples> -vol <chan> <probe> <samples>`` (Willems et
al., Micropor. Mesopor. Mater. 149, 2012) on every frame, as aMOF's
``Pore.from_trajectory`` runs it (coudertlab/amof ``amof/pore/core.py``),
with Zeo++'s Monte Carlo ``-vol`` estimator. Written from those
definitions, not from the program: float64 by default (``dtype`` lowers
it for the control), in blocks; it imports neither the program nor JAX.

A frame, with R_j the van der Waals radius of atom j (the
configuration's ``vdw_radius_A``), d_j(x) the minimum-image distance from
x to atom j (rounded fractional separations), V the cell's volume:

  * ``-vol``: ``num_samples`` points uniform in the cell, the same every
    frame (``numpy.random.default_rng(20240817).random((num_samples,
    3))``, fractional, float32), each tested against every atom: it fits
    where d_j >= R_j + probe for every j. AV = V (fitting points in
    channel voxels) / num_samples; NAV = V (the other fitting points) /
    num_samples.
  * channels: voxel centres ((i, j, k) + 1/2) / g of the connectivity
    grid are void where d_j >= R_j + chan for every j (each centre
    against every atom within R_j + chan of it: a stencil of voxels
    around each atom wider than that reach, so no farther atom is left
    to block). The void voxels' components are labelled with open faces
    (a union-find over 6-neighbour voxels, each named by its largest
    voxel index), then joined across the periodic faces by a union-find
    that carries each component's image shift. With ``winding`` "exact", a
    component that meets itself at another image winds round the cell
    and is a channel (Zeo++'s test); with "face", the option aMOF's users
    get by default from the port, a component is a channel where one of
    its open pieces meets itself across a periodic face (a channel that
    winds only through several open pieces is missed). The other void
    voxels are pocket voxels.
  * ``-sa``: K = max(8, num_samples // N) directions u_k a sphere (a
    Fibonacci sphere, rounded to float32), the points c_i + (R_i + probe)
    u_k of every atom, each tested against every other atom: valid where
    d_j > R_j + probe - 1e-4 for every j != i. A valid point is
    accessible where its voxel or that of the point 0.2 A further out
    along u_k is a channel voxel, else pocket where one of them is a
    pocket voxel. ASA = sum of 4 pi (R_i + probe)^2 / K over accessible
    points; NASA over pocket points.

Departures from Zeo++ (the program's too):
  * Zeo++ finds channels on the Voronoi network of the atoms (the nodes
    and edges a sphere of ``chan`` passes); here on voxels of about
    ``conn_resolution``, 6-connected: each cell length over it, rounded up
    to a multiple of 8 along a and b and of 4 along c (the port's
    connectivity grid). A passage narrower than about a voxel closes, one
    a voxel wide may open.
  * Zeo++ tells an accessible sample from a pocket one by the Voronoi
    node it reaches; here by its voxel (a surface point also by its
    voxel 0.2 A outward).
  * Zeo++ draws its samples at random, ``-sa`` ``samples`` on each atom;
    here the fixed points above, and ``num_samples // N`` directions an
    atom (at least 8), shared by every atom.
  * The minimum image rounds fractional separations: exact in the
    configuration's orthorhombic cells, where every reach (R_j + probe <
    3 A) is far below half a width.

``compare`` holds the program's four columns to these. Its numbers:
``vol_points_off``, the worst frame's count of MC points whose class
(accessible, pocket or blocked) must differ to explain the two AV / NAV
pairs (half the summed absolute changes of the three class counts);
``area_points_off``, the same for the surface points from ASA / NASA in
units of the largest point area 4 pi (R_max + probe)^2 / K (a lower bound
on the differing points); ``columns_rel``, the largest relative error of
the four columns where the reference's value is above 1% of the cell (of
its volume for AV and NAV, of the area of all probe spheres for ASA and
NASA), 0 where none is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MC_SEED = 20240817
NUDGE_A = 0.2
SURFACE_EPS_A = 1e-4
PAIR_BLOCK = 1 << 21   # (query, atom) entries a block
STENCIL_BLOCK = 1 << 20  # (voxel, atom) entries a block
SHARE = 0.01           # of the cell, for columns_rel


def grid_dims(lengths, resolution):
    """Voxels along a, b, c: the length over ``resolution`` rounded up
    (at least 8), then up to a multiple of 8 along a and b, of 4 along
    c."""
    out = []
    for axis, length in enumerate(lengths):
        g = max(8, int(np.ceil(length / resolution)))
        step = 8 if axis < 2 else 4
        out.append(-(-g // step) * step)
    return tuple(out)


def fibonacci_directions(k):
    """k unit vectors of a Fibonacci sphere, rounded to float32."""
    i = np.arange(k) + 0.5
    phi = np.pi * (1 + 5 ** 0.5) * i
    cos_t = 1 - 2 * i / k
    sin_t = np.sqrt(np.maximum(0, 1 - cos_t ** 2))
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t],
                    axis=-1).astype(np.float32)


def mc_points(num_samples):
    return np.random.default_rng(MC_SEED).random(
        (num_samples, 3)).astype(np.float32)


def _cart_d2(df, cell):
    """|minimum image|^2 of fractional separations df [..., 3]."""
    df = df - torch.round(df)
    d2 = 0
    for c in range(3):
        x = (df[..., 0] * cell[0, c] + df[..., 1] * cell[1, c]
             + df[..., 2] * cell[2, c])
        d2 = d2 + x * x
    return d2


def _clear_of_atoms(fq, owner, fa, thr2, cell, h_z, strict):
    """(bool [Q], blocking pairs): query point q (fractional fq [Q, 3]) is
    clear of every atom j, d_j^2 > thr2_j (``strict``) or >= thr2_j, atom
    ``owner[q]`` left out (-1: none); and the (q, j) pairs that are not
    clear, as a 0-d tensor. Queries go in blocks sorted by fractional z,
    each against every atom whose periodic fractional z lies within
    sqrt(max thr2) / h_z (+ 1e-6) of the block's z range (h_z the spacing
    of the cell's z planes): an atom farther has |d| >= h_z |dz| beyond
    every threshold and cannot block."""
    q, n = fq.shape[0], fa.shape[0]
    dev = fq.device
    out = torch.empty(q, dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.long, device=dev)
    if q == 0:
        return out, pairs
    w = math.sqrt(float(thr2.double().max().clamp(min=0))) / h_z + 1e-6
    order = torch.argsort(fq[:, 2])
    # atoms sorted by z with their copies one period down and up
    az = fa[:, 2].double()
    zs = torch.cat([az - 1, az, az + 1])
    z_sorted, perm = torch.sort(zs)
    atom = perm % n
    zq = fq[order, 2].double()
    # blocks spanning about w / 4 in z, of at most PAIR_BLOCK pairs
    n_win = max(1, int(n * min(1.0, 2.25 * w)))
    step = max(1, min(PAIR_BLOCK // n_win, int(q * w / 4)))
    for q0 in range(0, q, step):
        rows = order[q0:q0 + step]
        lo, hi = float(zq[q0]) - w, float(zq[min(q0 + step, q) - 1]) + w
        if hi - lo < 1.0:
            i0, i1 = torch.searchsorted(
                z_sorted, torch.tensor([lo, hi], dtype=torch.float64,
                                       device=dev)).tolist()
            near = atom[i0:i1]
        else:
            near = torch.arange(n, device=dev)
        d2 = _cart_d2(fq[rows, None, :] - fa[None, near, :], cell)
        clear = d2 > thr2[near] if strict else d2 >= thr2[near]
        clear |= owner[rows, None] == near
        out[rows] = clear.all(dim=1)
        pairs += (~clear).sum()
    return out, pairs


def _widths(cell64):
    """Perpendicular widths of the cell's three lattice planes."""
    h = cell64.cpu().numpy()
    vol = abs(np.linalg.det(h))
    return [vol / np.linalg.norm(np.cross(h[(a + 1) % 3], h[(a + 2) % 3]))
            for a in range(3)]


def void_voxels(fa, radii, chan, cell, cell64, grid):
    """(bool [gx, gy, gz], blocking pairs): voxel centres at d_j >= R_j +
    chan from every atom, each centre tested against every atom within
    that reach; and the (voxel, atom) pairs nearer, a 0-d tensor."""
    dev = fa.device
    g = torch.tensor(grid, device=dev)
    reach = float(radii.double().max()) + chan
    half = [int(math.ceil(reach / w * n)) + 1
            for w, n in zip(_widths(cell64), grid)]
    axes = [torch.arange(-s, s + 1, device=dev) for s in half]
    sten = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       -1).reshape(-1, 3)
    blocked = torch.zeros(grid[0] * grid[1] * grid[2], dtype=torch.bool,
                          device=dev)
    pairs = torch.zeros((), dtype=torch.long, device=dev)
    thr2 = (radii + chan) ** 2
    base = torch.floor(fa.double() * g).long()
    step = max(1, STENCIL_BLOCK // sten.shape[0])
    for a0 in range(0, fa.shape[0], step):
        vox = (base[a0:a0 + step, None, :] + sten[None]) % g  # [A, S, 3]
        centre = ((vox.to(fa.dtype) + 0.5) / g.to(fa.dtype))
        d2 = _cart_d2(centre - fa[a0:a0 + step, None, :], cell)
        hit = d2 < thr2[a0:a0 + step, None]
        lin = (vox[..., 0] * grid[1] + vox[..., 1]) * grid[2] + vox[..., 2]
        blocked[lin[hit]] = True
        pairs += hit.sum()
    return ~blocked.reshape(grid), pairs


def open_labels(void):
    """int64 [gx, gy, gz]: each void voxel's component (6-neighbours, no
    periodic wrap) named by its largest linear index; -1 elsewhere. A
    union-find on voxel indices: each round hooks the roots of every two
    void neighbours to the larger one, then jumps every voxel to its
    root, until no round changes anything."""
    lin = torch.arange(void.numel(), device=void.device)
    par = torch.where(void.reshape(-1), lin, torch.full_like(lin, -1))
    lin = lin.reshape(void.shape)
    u, v = [], []
    for ax in range(3):
        n = void.shape[ax]
        both = void.narrow(ax, 0, n - 1) & void.narrow(ax, 1, n - 1)
        u.append(lin.narrow(ax, 0, n - 1)[both])
        v.append(lin.narrow(ax, 1, n - 1)[both])
    u, v = torch.cat(u), torch.cat(v)
    while True:
        ru, rv = par[u], par[v]
        top = torch.maximum(ru, rv)
        new = par.clone()
        new.scatter_reduce_(0, ru, top, "amax")
        new.scatter_reduce_(0, rv, top, "amax")
        while True:  # every voxel to its root: parents only grow
            up = torch.where(new >= 0,
                             torch.maximum(new, new[new.clamp(min=0)]), new)
            if torch.equal(up, new):
                break
            new = up
        if torch.equal(new, par):
            return par.reshape(void.shape)
        par = new


def channel_voxels(void, exact=True):
    """bool [gx, gy, gz]: the void voxels of components that wind round
    the periodic cell (``exact``), or that hold an open piece meeting
    itself across a periodic face."""
    lab = open_labels(void)
    # union-find over open components; shift[x] = image of x less the
    # image of parent[x] (the copy of x that the parent's copy 0 touches)
    parent, shift, winds = {}, {}, set()

    def find(x):
        """(root, image of x less the image of the root)."""
        path = []
        while x in parent:
            path.append(x)
            x = parent[x]
        off = (0, 0, 0)
        for node in reversed(path):  # from the root's child down
            s = shift[node]
            off = (off[0] + s[0], off[1] + s[1], off[2] + s[2])
            parent[node], shift[node] = x, off
        return x, off

    for ax in range(3):
        a = lab.select(ax, lab.shape[ax] - 1).reshape(-1)
        b = lab.select(ax, 0).reshape(-1)
        ok = (a >= 0) & (b >= 0)
        if not bool(ok.any()):
            continue
        e = [0, 0, 0]
        e[ax] = 1
        for la, lb in torch.stack([a[ok], b[ok]], 1).unique(dim=0).tolist():
            # the copy of lb one image along ax touches la's copy
            ra, oa = find(la)
            rb, ob = find(lb)
            want = (oa[0] + e[0], oa[1] + e[1], oa[2] + e[2])
            if ra == rb:
                if ob != want and (exact or la == lb):
                    winds.add(ra)
            else:
                parent[rb] = ra
                shift[rb] = (want[0] - ob[0], want[1] - ob[1],
                             want[2] - ob[2])
                if rb in winds:
                    winds.add(ra)
    chan = sorted(x for x in set(parent) | winds if find(x)[0] in winds)
    if not chan:
        return torch.zeros_like(void)
    return torch.isin(lab, torch.tensor(chan, device=lab.device))


class Frame:
    """One frame's geometry in ``dtype``: fractional atoms ``fa`` [N, 3]
    in [0, 1), radii ``r``, ``cell`` and ``inv`` (``cell64`` float64),
    volume ``vol`` and the connectivity grid."""

    def __init__(self, pos, cell_f32, radii, opts, dtype, device):
        self.cell64 = torch.as_tensor(cell_f32, dtype=torch.float64,
                                      device=device)
        self.cell = self.cell64.to(dtype)
        self.inv = torch.linalg.inv(self.cell64).to(dtype)
        self.vol = float(abs(torch.linalg.det(self.cell64)))
        self.r = torch.as_tensor(radii, device=device).to(dtype)
        fa = torch.as_tensor(pos, device=device).to(dtype) @ self.inv
        self.fa = fa - torch.floor(fa)
        lengths = torch.linalg.norm(self.cell64, dim=1).cpu().numpy()
        self.grid = grid_dims(lengths, float(opts["conn_resolution"]))
        self.gvec = torch.tensor(self.grid, device=device)
        self.h_z = _widths(self.cell64)[2]
        self.dtype, self.device = dtype, device

    def voxel(self, fq):
        """Linear voxel index of fractional points fq [Q, 3]."""
        fq = fq - torch.floor(fq)
        idx = torch.minimum(torch.floor(fq * self.gvec.to(fq.dtype)).long(),
                            self.gvec - 1)
        g = self.grid
        return (idx[:, 0] * g[1] + idx[:, 1]) * g[2] + idx[:, 2]

    def surface_points(self, probe, k):
        """(fractional points [N K, 3], their atoms, outward unit steps
        [N K, 3] fractional) of the atoms' probe spheres."""
        dirs = torch.as_tensor(fibonacci_directions(k),
                               device=self.device).to(self.dtype)
        n = self.fa.shape[0]
        owner = torch.arange(n, device=self.device).repeat_interleave(k)
        fd = (dirs @ self.inv).repeat(n, 1)
        fp = self.fa[owner] + (self.r + probe)[owner][:, None] * fd
        return fp, owner, fd


def frame_pore(pos, cell_f32, radii, opts, dtype, device):
    """One frame's (ASA, NASA, AV, NAV) and the counts behind them."""
    probe, chan = float(opts["probe_radius"]), float(opts["chan_radius"])
    fr = Frame(pos, cell_f32, radii, opts, dtype, device)
    r, n = fr.r, fr.fa.shape[0]
    void, _ = void_voxels(fr.fa, r, chan, fr.cell, fr.cell64, fr.grid)
    access = channel_voxels(void, opts.get("winding", "face") == "exact")
    code = (access.to(torch.int8)
            + 2 * (void & ~access).to(torch.int8)).reshape(-1)

    # -vol
    m = int(opts["num_samples"])
    pts = torch.as_tensor(mc_points(m), device=device).to(dtype)
    none = torch.full((m,), -1, dtype=torch.long, device=device)
    fit, _ = _clear_of_atoms(pts, none, fr.fa, (r + probe) ** 2, fr.cell,
                             fr.h_z, False)
    in_chan = code[fr.voxel(pts)] == 1
    n_acc = int((fit & in_chan).sum())
    n_poc = int((fit & ~in_chan).sum())

    # -sa
    k = max(8, m // n)
    fp, owner, fd = fr.surface_points(probe, k)
    valid, _ = _clear_of_atoms(fp, owner, fr.fa,
                               (r + probe - SURFACE_EPS_A) ** 2, fr.cell,
                               fr.h_z, True)
    c1, c2 = code[fr.voxel(fp)], code[fr.voxel(fp + NUDGE_A * fd)]
    acc = valid & ((c1 == 1) | (c2 == 1))
    poc = valid & ~acc & ((c1 == 2) | (c2 == 2))
    area = (4 * math.pi) * (r.double() + probe) ** 2 / k  # a point's area
    per_point = area[owner]
    return {
        "asa": float((per_point * acc).sum()),
        "nasa": float((per_point * poc).sum()),
        "av": fr.vol * n_acc / m, "nav": fr.vol * n_poc / m,
        "volume": fr.vol, "n_acc": n_acc, "n_poc": n_poc,
        "sphere_area": float(area.sum()) * k,
        "point_area_max": float(area.max()),
    }


def radii_of(piece, elements):
    by_z = {int(e["Z"]): float(e["vdw_radius_A"]) for e in elements.values()}
    return np.array([by_z[int(z)] for z in piece["species"]])


def frames(piece, elements, options, dtype=torch.float64, device="cpu"):
    """Every frame's numbers: a dict of f64 [F] arrays, and
    ``num_samples``."""
    if options.get("vol_method") != "mc":
        raise ValueError("the reference is Zeo++'s Monte Carlo -vol: "
                         "vol_method must be 'mc'")
    radii = radii_of(piece, elements)
    rows = [frame_pore(piece["positions"][f], piece["cell"][f], radii,
                       options, dtype, device)
            for f in range(len(piece["positions"]))]
    out = {key: np.array([row[key] for row in rows], np.float64)
           for key in rows[0]}
    out["num_samples"] = int(options["num_samples"])
    return out


def compare(out, ref):
    """The numbers ``correct`` compares (each at most its limit)."""
    names = ("asa", "nasa", "av", "nav")
    got = {c: np.asarray(out[c], np.float64) for c in names}
    if any(got[c].shape != ref[c].shape for c in names):
        return {"vol_points_off": math.inf, "area_points_off": math.inf,
                "columns_rel": math.inf}
    m, vol = ref["num_samples"], ref["volume"]
    # the program's class counts of the MC points, from its columns
    d_acc = np.round(got["av"] * m / vol) - ref["n_acc"]
    d_poc = np.round(got["nav"] * m / vol) - ref["n_poc"]
    vol_off = (np.abs(d_acc) + np.abs(d_poc) + np.abs(d_acc + d_poc)) / 2
    d_asa, d_nasa = got["asa"] - ref["asa"], got["nasa"] - ref["nasa"]
    area_off = (np.abs(d_asa) + np.abs(d_nasa) + np.abs(d_asa + d_nasa)) \
        / (2 * ref["point_area_max"])
    rel = [0.0]
    for c in names:
        scale = vol if c in ("av", "nav") else ref["sphere_area"]
        big = ref[c] > SHARE * scale
        if big.any():
            rel.append(float(np.max(np.abs(got[c][big] - ref[c][big])
                                    / ref[c][big])))
    return {"vol_points_off": float(np.max(vol_off)),
            "area_points_off": float(np.max(area_off)),
            "columns_rel": max(rel)}


_WORK = {}  # id(positions) -> (weakref to it, the counts)


def work_counts(piece, elements, options, device="cpu"):
    """What the pore step's kernels have to do on ``piece``, whatever
    computes it (``work/*.py``), from float32 passes over every frame:
    sizes (``frames``, ``atoms``, ``points`` MC, ``dirs`` a sphere,
    ``voxels``, ``masks`` 1 or 2) and the pairs within reach, summed over
    the frames: ``mask_pairs`` (voxel centre, atom) at d < R_j + chan (and
    + probe, where it differs), ``fit_pairs`` (MC point, atom) at d < R_j
    + probe, ``surface_pairs`` (sphere point, other atom) at d < R_j +
    probe - 1e-4 for the points of candidate atoms (a point, or its step
    0.2 A out, on a channel-mask void voxel), ``void_faces`` (6-neighbour
    void pairs with open faces, then periodic: one per fixpoint pass).
    Cached for as long as the piece's positions array lives."""
    import weakref

    pos = piece["positions"]
    got = _WORK.get(id(pos))
    if got is not None and got[0]() is pos:
        return got[1]
    probe, chan = float(options["probe_radius"]), float(options["chan_radius"])
    m = int(options["num_samples"])
    n = pos.shape[1]
    k = max(8, m // n)
    f32 = torch.float32
    radii = radii_of(piece, elements)
    pts = torch.as_tensor(mc_points(m), device=device)
    none = torch.full((m,), -1, dtype=torch.long, device=device)
    tot = {"frames": len(pos), "atoms": n, "points": m, "dirs": k,
           "masks": 1 if probe == chan else 2}
    pairs = torch.zeros(4, dtype=torch.long, device=device)
    for f in range(len(pos)):
        fr = Frame(pos[f], piece["cell"][f], radii, options, f32, device)
        tot["voxels"] = fr.grid[0] * fr.grid[1] * fr.grid[2]
        void, mp = void_voxels(fr.fa, fr.r, chan, fr.cell, fr.cell64,
                               fr.grid)
        if probe != chan:
            mp = mp + void_voxels(fr.fa, fr.r, probe, fr.cell, fr.cell64,
                                  fr.grid)[1]
        _, fp_pairs = _clear_of_atoms(pts, none, fr.fa, (fr.r + probe) ** 2,
                                      fr.cell, fr.h_z, False)
        fp, owner, fd = fr.surface_points(probe, k)
        flat = void.reshape(-1)
        on_void = flat[fr.voxel(fp)] | flat[fr.voxel(fp + NUDGE_A * fd)]
        cand = torch.zeros(n, dtype=torch.bool, device=device)
        cand[owner[on_void]] = True
        sel = cand[owner]
        _, sp = _clear_of_atoms(fp[sel], owner[sel], fr.fa,
                                (fr.r + probe - SURFACE_EPS_A) ** 2,
                                fr.cell, fr.h_z, True)
        faces = sum((void.narrow(ax, 0, void.shape[ax] - 1)
                     & void.narrow(ax, 1, void.shape[ax] - 1)).sum()
                    for ax in range(3))
        wrap = sum((void.select(ax, 0) & void.select(ax, -1)).sum()
                   for ax in range(3))
        pairs += torch.stack([mp, fp_pairs, sp, 2 * faces + wrap])
    for key, v in zip(("mask_pairs", "fit_pairs", "surface_pairs",
                       "void_faces"), pairs.tolist()):
        tot[key] = v
    _WORK[id(pos)] = (weakref.ref(pos), tot)
    weakref.finalize(pos, _WORK.pop, id(pos), None)
    return tot
