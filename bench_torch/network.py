"""A bonded Zn(Im)2 network and its thermal motion, drawn from a seed.

Zn nodes sit on a diamond (dia) net: every Zn is bonded to four
imidazolates (C3N2H3), each of which bridges two Zn through its two N.
So the network has 17 atoms a Zn (Zn, 2 x (3 C, 2 N, 3 H)), every Zn
four N at the Zn-N bond length, and every ring its own C-N, C-C and C-H
bonds.

The net: the configuration's ``network.node_cell`` gives the node cell's
three edge vectors in units of dia's cubic edge (orthogonal rows, so the
node cell is orthorhombic); its nodes are strained onto the
configuration's cell divided by ``repeats``, and the cell holds
``repeats`` of them.

A linker on the edge from Zn A to Zn B (length L): the ring, with the
published bond lengths, lies in a plane through the edge, its N...N
chord parallel to the edge and centred on it, the C2 side towards the
edge's axis, at the offset that puts both Zn-N bonds at ``zn_n_A``
(L up to N...N + 2 Zn-N). The ring's plane turns about the edge, linker
by linker, to the angle (the best of every 5 degrees) that keeps it
farthest from the rings placed before it and from the other edges at A
and B; each piece adds a jitter from the seed.

Thermal motion a frame: every rigid unit (a Zn, a ring with its H)
moves by an Ornstein-Uhlenbeck process of stationary ``unit_sigma_A``
per axis, every atom by one of ``atom_sigma_A`` on top, both with the
frame-to-frame correlation ``frame_correlation``; the whole piece is
shifted by a uniform random vector and wrapped into the cell.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

# the dia net in its cubic cell (edge 1): an fcc lattice and its copy
# shifted by a quarter of the body diagonal; bonds are sqrt(3) / 4 long
_FCC = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
DIA = np.concatenate([_FCC, _FCC + .25])
DIA_BOND = math.sqrt(3) / 4


def dia_nodes(node_cell):
    """(fractional node positions f64 [M, 3] in the node cell, edges
    i64 [2M, 2] of node indices, edge image shifts i64 [2M, 3]: node j's
    copy bonded to node i lies at f_j + shift)."""
    v = np.asarray(node_cell, np.float64)
    if not np.allclose(v @ v.T, np.diag(np.diag(v @ v.T))):
        raise ValueError("node_cell rows must be orthogonal")
    inv = np.linalg.inv(v)
    span = int(np.abs(v).sum()) + 1
    found = []
    for t in itertools.product(range(-span, span + 1), repeat=3):
        f = (DIA + np.array(t)) @ inv
        keep = np.all((f > -1e-9) & (f < 1 - 1e-9), axis=1)
        found.append(f[keep])
    frac = np.concatenate(found)
    frac[np.abs(frac) < 1e-9] = 0.0
    m = len(frac)
    if m != round(8 * abs(np.linalg.det(v))):
        raise ValueError("node_cell is not a cell of the dia net")
    edges, shifts = [], []
    for i in range(m):
        d = frac - frac[i]
        shift = -np.round(d)
        cart = (d + shift) @ v
        near = np.abs(np.linalg.norm(cart, axis=1) - DIA_BOND) < 1e-6
        for j in np.nonzero(near)[0]:
            if i < j:
                edges.append((i, j))
                shifts.append(shift[j])
    edges = np.array(edges, np.int64)
    if len(edges) != 2 * m:
        raise ValueError("node_cell too small: a node meets its own copy")
    return frac, edges, np.array(shifts, np.int64)


def supercell(frac, edges, shifts, repeats):
    """The net repeated ``repeats`` times: (fractional positions in the
    whole cell [M R, 3], edges [2 M R, 2], shifts in whole cells)."""
    r = np.asarray(repeats, np.int64)
    cells = np.array(list(itertools.product(*map(range, r))), np.int64)
    m = len(frac)
    pos = ((frac[None] + cells[:, None]) / r).reshape(-1, 3)
    e_out, s_out = [], []
    for k, c in enumerate(cells):
        tgt = c + shifts  # the copy of node j, in node cells
        wrap = np.floor_divide(tgt, r)
        tgt_cell = tgt - wrap * r
        tk = (tgt_cell[:, 0] * r[1] + tgt_cell[:, 1]) * r[2] + tgt_cell[:, 2]
        e_out.append(np.stack([edges[:, 0] + k * m, edges[:, 1] + tk * m],
                              axis=1))
        s_out.append(wrap)
    return pos, np.concatenate(e_out), np.concatenate(s_out)


def ring_template(bonds):
    """Imidazolate in its plane, N...N chord on the u axis centred at 0,
    C2 at +w: dict of atom -> (u, w), and the chord's length."""
    nc2, nc4, cc, ch = (bonds[k] for k in ("N-C2", "N-C4", "C4-C5", "C-H"))
    half = math.radians(bonds["N-C2-N_deg"]) / 2
    n = 2 * nc2 * math.sin(half)
    c2 = np.array([0.0, nc2 * math.cos(half)])
    n1, n3 = np.array([-n / 2, 0.0]), np.array([n / 2, 0.0])
    w45 = -math.sqrt(nc4 ** 2 - (n / 2 - cc / 2) ** 2)
    c5, c4 = np.array([-cc / 2, w45]), np.array([cc / 2, w45])

    def hydrogen(c, a, b):
        d = -((a - c) / np.linalg.norm(a - c) + (b - c) / np.linalg.norm(b - c))
        return c + ch * d / np.linalg.norm(d)

    atoms = {"N1": n1, "N3": n3, "C2": c2, "C4": c4, "C5": c5,
             "H2": hydrogen(c2, n1, n3), "H4": hydrogen(c4, n3, c5),
             "H5": hydrogen(c5, c4, n1)}
    return atoms, n


RING_SPECIES = {"N1": "N", "N3": "N", "C2": "C", "C4": "C", "C5": "C",
                "H2": "H", "H4": "H", "H5": "H"}


def _perp_basis(e):
    """Two unit vectors perpendicular to each row of unit vectors ``e``."""
    ref = np.where(np.abs(e[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    p = np.cross(e, ref)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return p, np.cross(e, p)


def sites(config):
    """The net's geometry, deterministic (host, float64): Zn positions
    ``zn`` [M, 3]; per linker its start ``a``, its edge frame ``e1``,
    ``p``, ``q``, half its edge's length, the ring's offset ``h`` and the
    best angle ``psi``; the ring template ``ring``."""
    net = config["network"]
    repeats = np.asarray(net["repeats"])
    cell = np.asarray(config["cell_A"], np.float64)
    base = dia_nodes(net["node_cell"])
    geo = _linkers(net, *supercell(*base, repeats), cell)
    one = _linkers(net, *supercell(*base, [1, 1, 1]), cell / repeats)
    # every node cell alike: the angles of one, repeated
    geo["psi"] = np.tile(_ring_angles(one, cell / repeats),
                         int(np.prod(repeats)))
    return geo


def _linkers(net, frac, edges, shifts, cell):
    zn = frac * cell
    a = zn[edges[:, 0]]
    b = zn[edges[:, 1]] + shifts * cell
    d = b - a
    length = np.linalg.norm(d, axis=1)
    e1 = d / length[:, None]
    atoms, chord = ring_template(net["ring_A"])
    reach = (length - chord) / 2
    if np.any(np.abs(reach) > net["zn_n_A"]):
        raise ValueError("an edge is too long or short for its linker")
    h = np.sqrt(net["zn_n_A"] ** 2 - reach ** 2)
    p, q = _perp_basis(e1)
    return {"zn": zn, "edges": edges, "a": a, "e1": e1, "p": p, "q": q,
            "half_length": length / 2, "h": h, "ring": atoms}


def _ring_angles(geo, cell):
    """The greedy angle of each linker."""
    edges, a, e1, p, q = (geo[k] for k in ("edges", "a", "e1", "p", "q"))
    half, h = geo["half_length"], geo["h"]
    d = 2 * half[:, None] * e1
    # greedy, linker by linker: the angle (every 5 degrees) that keeps
    # the ring farthest from the rings placed so far within 9 A, and from
    # the first 3 A of the edges not yet placed at A and B
    mid = a + d / 2
    dm = mid[:, None] - mid[None]
    dm -= np.round(dm / cell) * cell
    close = np.linalg.norm(dm, axis=-1) < 9.0
    cand = np.deg2rad(np.arange(0, 360, 5.0))
    uw = np.array(list(geo["ring"].values()))  # [8, 2]
    best = np.full(len(edges), np.nan)
    placed = np.zeros((len(edges), len(uw), 3))
    stubs = np.array([1.0, 2.0, 3.0])[:, None]
    for k in range(len(edges)):
        e2 = (np.cos(cand)[:, None, None] * p[k]
              + np.sin(cand)[:, None, None] * q[k])  # [C, 1, 3]
        ring = (a[k] + (uw[:, :1] + half[k]) * e1[k]
                + (uw[:, 1:] - h[k]) * e2)  # [C, 8, 3]
        near = [placed[o] for o in np.nonzero(close[k])[0]
                if o != k and not np.isnan(best[o])]
        for o in np.nonzero(close[k])[0]:
            if o == k or not np.isnan(best[o]):
                continue
            for end, sign in ((edges[o, 0], 1.0), (edges[o, 1], -1.0)):
                if end in edges[k]:
                    start = a[o] if sign > 0 else a[o] + d[o]
                    near.append(start + sign * stubs * e1[o])
        near = np.concatenate(near)
        dv = ring[:, :, None] - near[None, None]
        dv -= np.round(dv / cell) * cell
        gap = np.linalg.norm(dv, axis=-1).min(axis=(1, 2))
        c = int(np.argmax(gap))
        best[k] = cand[c]
        placed[k] = ring[c]
    return best


def species_blocks(config):
    """Per element of the configuration (in its order), the atoms it
    takes: (element, ['Zn'] or the ring atom names of that element)."""
    order = list(config["elements"])
    blocks = {el: [] for el in order}
    blocks["Zn"].append("Zn")
    for name, el in RING_SPECIES.items():
        blocks[el].append(name)
    return [(el, blocks[el]) for el in order]


def check_counts(config, n_zn):
    """Raises unless the configuration's elements are Zn(C3N2H3)2 of the
    net's ``n_zn`` Zn."""
    want = {"Zn": n_zn, "N": 4 * n_zn, "C": 6 * n_zn, "H": 6 * n_zn}
    got = {el: e["count"] for el, e in config["elements"].items()}
    if got != want or config["atoms"] != 17 * n_zn:
        raise ValueError(f"element counts {got} are not Zn(C3N2H3)2 of "
                         f"{n_zn} Zn: {want}")


def rest_positions(config, geo, psi, device):
    """Positions at rest, torch f64 [N, 3] on ``device`` (element blocks,
    Zn in node order, each ring atom in linker order), and the unit of
    each atom (i64 [N]: Zn k is unit k, linker l unit M + l)."""
    import torch

    f64 = dict(dtype=torch.float64, device=device)
    a = torch.as_tensor(geo["a"], **f64)
    e1 = torch.as_tensor(geo["e1"], **f64)
    p = torch.as_tensor(geo["p"], **f64)
    q = torch.as_tensor(geo["q"], **f64)
    e2 = torch.cos(psi)[:, None] * p + torch.sin(psi)[:, None] * q
    half = torch.as_tensor(geo["half_length"], **f64)[:, None]
    h = torch.as_tensor(geo["h"], **f64)[:, None]
    m, n_link = len(geo["zn"]), len(geo["a"])
    parts, units = [], []
    for _, names in species_blocks(config):
        for name in names:
            if name == "Zn":
                parts.append(torch.as_tensor(geo["zn"], **f64))
                units.append(torch.arange(m, device=device))
                continue
            u, w = geo["ring"][name]
            parts.append(a + (u + half) * e1 + (w - h) * e2)
            units.append(m + torch.arange(n_link, device=device))
    return torch.cat(parts), torch.cat(units), m + n_link


def trajectory(config, geo, n_frames, gen, device):
    """One piece: positions f32 [F, N, 3] on ``device``, drawn from
    ``gen`` (a torch.Generator on ``device``)."""
    import torch

    net, th = config["network"], config["thermal"]
    cell = torch.as_tensor(config["cell_A"], dtype=torch.float64,
                           device=device)
    jitter = math.radians(net["ring_jitter_deg"])
    psi0 = torch.as_tensor(geo["psi"], dtype=torch.float64, device=device)
    u = torch.rand(psi0.shape, generator=gen, device=device,
                   dtype=torch.float64)
    rest, unit, n_units = rest_positions(config, geo,
                                         psi0 + (2 * u - 1) * jitter, device)
    rest = rest + torch.rand(3, generator=gen, device=device,
                             dtype=torch.float64) * cell
    n = len(rest)
    rho = float(th["frame_correlation"])
    kick = math.sqrt(1 - rho * rho)
    sig = torch.tensor([th["unit_sigma_A"], th["atom_sigma_A"]],
                       dtype=torch.float32, device=device)
    noise = torch.randn((n_frames, n_units + n, 3), generator=gen,
                        device=device)
    state = noise[0].clone()
    out = torch.empty((n_frames, n, 3), dtype=torch.float32, device=device)
    rest32, cell32 = rest.float(), cell.float()
    for f in range(n_frames):
        if f:
            state.mul_(rho).add_(noise[f], alpha=kick)
        move = state[:n_units][unit] * sig[0] + state[n_units:] * sig[1]
        out[f] = torch.remainder(rest32 + move, cell32)
    return out
