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

from amof_tpu_torch import tracing
from amof_tpu_torch.ops import (neighbor_kernel, pair_engine, rdf_kernel,
                                slab_table)


def launches(kernel):
    """Launches of ``kernel`` in this process (the registry's counter)."""
    return tracing.snapshot()["counts"].get("launch." + kernel, 0)


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


def bench_glass(n=10240, seed=0, triclinic=False):
    """10240 atoms of Zn(C3N2H3)2 at 0.062 atoms/A^3 (Zn 602, N 2408,
    C 3612, H 3618), as the bench trajectory's first frame is drawn."""
    counts = [n // 17, 4 * (n // 17), 6 * (n // 17)]
    counts.append(n - sum(counts))
    sp = np.concatenate([np.full(c, k, np.int32)
                         for k, c in enumerate(counts)])
    box = (n / 0.062) ** (1 / 3)
    rng = np.random.default_rng(seed)
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, -box / 5
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    return pos, cell, sp, int(box / 2 // 0.01)


def rdf_blocked_case(name):
    """(positions, cell, species, n_species, bins, ortho) of kernel #1's
    card cases; every grid holds more blocks than one wave of resident
    blocks (946 tile pairs at 10240 atoms in the blocked layout)."""
    pos, cell, sp, bins = bench_glass(triclinic=name == "triclinic")
    ortho = name in ("bench", "far from the origin")
    if name == "single species, n not a multiple of 256":
        return pos[:10001], cell, np.zeros(10001, np.int32), 1, bins, True
    if name == "contract broken (random order)":
        order = np.random.default_rng(1).permutation(len(sp))
        return pos[order], cell, sp[order], 4, bins, True
    if name == "far from the origin":  # the wrap's floors take floorf
        pos = pos + np.float32(1e8)
    perm, sp_l = rdf_kernel.species_block_layout(sp, 256, 256)
    return (rdf_kernel.apply_atom_layout(pos, perm), cell,
            sp_l.astype(np.int32), 4, bins, ortho)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "bench", "general template", "triclinic",
    "single species, n not a multiple of 256",
    "contract broken (random order)", "far from the origin"])
def test_rdf_blocked_kernel_matches_plain_at_bench_size(cuda, name):
    """Kernel #1 at the bench's 10240 atoms: the ortho and general
    templates, the contract-breaking path, a tile cut by n and the
    floorf wrap, each equal to the plain version."""
    pos, cell, sp, s, bins, ortho = rdf_blocked_case(name)
    p, c, t = on(cuda, pos, cell, sp)
    got = rdf_kernel.rdf_counts_blocked(p, c, t, 0.01, s, bins, ortho=ortho)
    ref = rdf_kernel.rdf_counts_plain(p, c, t, 0.01, s, bins, ortho=ortho)
    assert float(ref.sum()) > 0
    assert_same([got], [ref])
    geo = rdf_kernel.launch_geometry(rdf_kernel.MODE_BLOCKED, len(sp), s,
                                     bins, ortho)
    assert geo["blocks_per_sm"] > 0 and geo["registers"] > 0


@pytest.mark.cuda
def test_rdf_blocked_root_equals_sqrtf(cuda):
    """Kernel #1's root (IEEE fast path without the range test) equals
    sqrtf on every float32 in [2^-100, FLT_MAX], and the wrapper has made
    that check on the device before it launched there."""
    assert rdf_kernel.root_mismatches() == 0
    p, c, s = on(cuda, *case(600, 2, 3, 20.0))
    rdf_kernel.rdf_counts_blocked(p, c, s, 0.01, 2, 900)
    assert p.device.index in rdf_kernel._ROOT_CHECKED


@pytest.mark.cuda
def test_rdf_global_atomics_mode_matches_plain(cuda):
    """S*S*bins too large for shared memory: atomics to device memory."""
    pos, cell, sp = case(1000, 6, 2, 40.0)
    p, c, s = on(cuda, pos, cell, sp)
    got = rdf_kernel.rdf_counts(p, c, s, 0.001, 6, 2000)
    ref = rdf_kernel.rdf_counts_plain(p, c, s, 0.001, 6, 2000)
    assert_same([got], [ref])


def shuffled_with_pads(pos, sp, seed, n_pads):
    """A random order of the atoms with ``n_pads`` pad slots (species -1,
    position 0) at random places among them."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sp))
    pos, sp = pos[order], sp[order]
    at = np.sort(rng.choice(len(sp) + n_pads, n_pads, replace=False))
    keep = np.ones(len(sp) + n_pads, bool)
    keep[at] = False
    p = np.zeros((len(keep), 3), np.float32)
    s = np.full(len(keep), -1, np.int32)
    p[keep], s[keep] = pos, sp
    return p, s


# kernel #2's card shapes: (a) the bench frame at dr 0.01, (b) the
# RDF-integral CN's call (dr 0.0001, bins to 2 A, general template, device
# histogram), (c) a triclinic cell, (d) the 272-atom cell of the side run
UNBLOCKED_CASES = ["(a) bench, dr 0.01", "(b) CN, dr 0.0001",
                   "(c) triclinic, dr 0.01", "(d) 272 atoms, dr 0.01"]


def unblocked_case(name):
    """(positions, cell, species, n_species, dr, bins, ortho) of kernel
    #2's card cases, each in a random order with pads among the atoms."""
    n = 272 if name.startswith("(d)") else 10240
    pos, cell, sp, bins = bench_glass(n, triclinic=name.startswith("(c)"))
    pos, sp = shuffled_with_pads(pos, sp, 7, 17 if n == 272 else 200)
    if name.startswith("(b)"):
        return pos, cell, sp, 4, 0.0001, int(2.0 // 0.0001), False
    return pos, cell, sp, 4, 0.01, bins, name.startswith(("(a)", "(d)"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", UNBLOCKED_CASES)
def test_rdf_unblocked_kernel_matches_plain_at_bench_size(cuda, name):
    """Kernel #2 at the shapes of its callers, atoms in a random order with
    pads among them: equal to the plain version on ten repeated calls into
    memory the allocator last gave to a tensor of -1s (the kernel writes
    every output entry); ``launch_geometry`` is the launch's: the queue's
    items, 512 threads, the folded histogram and key table in shared
    memory (the key table alone in MODE_GLOBAL), at most one wave."""
    pos, cell, sp, s, dr, bins, ortho = unblocked_case(name)
    p, c, t = on(cuda, pos, cell, sp)
    ref = rdf_kernel.rdf_counts_plain(p, c, t, dr, s, bins, ortho=ortho)
    assert float(ref.sum()) > 0
    for _ in range(10):
        junk = torch.full((s, s, bins), -1.0, device=cuda)
        del junk
        assert_same([rdf_kernel.rdf_counts(p, c, t, dr, s, bins,
                                           ortho=ortho)], [ref])
    mode = rdf_kernel.smem_mode(s, bins)
    assert (mode == rdf_kernel.MODE_GLOBAL) == name.startswith("(b)")
    geo = rdf_kernel.launch_geometry(mode, len(sp), s, bins, ortho)
    nt = -(-len(sp) // 256)
    assert geo["items"] == nt * (nt + 1)
    assert geo["threads"] == 512 and geo["registers"] > 0
    hist = 0 if mode == rdf_kernel.MODE_GLOBAL else rdf_kernel.fold_ints(
        s, bins)
    assert geo["smem_bytes"] == 4 * (hist + s * s)
    assert geo["blocks"] == min(geo["items"],
                                geo["blocks_per_sm"] * geo["sms"])
    assert geo["blocks_per_sm"] >= 1 and geo["waves"] <= 1


@pytest.mark.cuda
def test_rdf_blocked_wrapper_past_smem_takes_kernel_2(cuda):
    """Kernel #1's wrapper with bins * 4 > SMEM_LIMIT launches kernel #2's
    MODE_GLOBAL, equal to the plain version."""
    pos, cell, sp = case(2000, 3, 4, 36.0, pad_from=1990)
    perm, sp_l = rdf_kernel.species_block_layout(sp, 256, 256)
    pos_l = rdf_kernel.apply_atom_layout(pos, perm)
    bins = 60000  # 240,000 B of bins, dr 0.0003: 18 A
    assert bins * 4 > rdf_kernel.SMEM_LIMIT
    p, c, t = on(cuda, pos_l, cell, sp_l)
    before = launches("rdf_counts_blocked")
    got = rdf_kernel.rdf_counts_blocked(p, c, t, 0.0003, 3, bins, ortho=True)
    assert launches("rdf_counts_blocked") == before + 1
    ref = rdf_kernel.rdf_counts_plain(p, c, t, 0.0003, 3, bins, ortho=True)
    assert float(ref.sum()) > 0
    assert_same([got], [ref])


@pytest.mark.cuda
def test_rdf_queues_left_zero_on_two_streams(cuda):
    """Kernels #1 and #2 launched on two streams: every queue and kernel
    #2's device histograms are zero again once the launches end."""
    pos, cell, sp = case(3000, 4, 6, 36.0, pad_from=2990)
    p, c, t = on(cuda, pos, cell, sp)
    ref = rdf_kernel.rdf_counts_plain(p, c, t, 0.01, 4, 1800)
    refg = rdf_kernel.rdf_counts_plain(p, c, t, 0.001, 4, 9000)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            for _ in range(3):
                outs.append((rdf_kernel.rdf_counts(p, c, t, 0.01, 4, 1800),
                             ref))
                outs.append((rdf_kernel.rdf_counts(p, c, t, 0.001, 4, 9000),
                             refg))
                outs.append((rdf_kernel.rdf_counts_blocked(
                    p, c, t, 0.01, 4, 1800), ref))
    torch.cuda.synchronize()
    for got, r in outs:
        assert_same([got], [r])
    for st in streams:
        mine = [q for k, q in rdf_kernel._QUEUES.items()
                if k[1] == st.cuda_stream]
        assert len(mine) == 1
        assert int(mine[0].abs().sum()) == 0
        hists = [b for k, b in rdf_kernel._HISTS.items()
                 if k[1] == st.cuda_stream]
        assert hists and all(int(b.abs().sum()) == 0 for b in hists)


# bench.py's cutoffs on bench_glass's species (Zn, N, C, H)
BENCH_CUT = np.zeros((4, 4), np.float32)
for _a, _b, _c in ((0, 1, 2.0), (2, 2, 1.75), (2, 1, 1.73), (2, 3, 1.3)):
    BENCH_CUT[_a, _b] = BENCH_CUT[_b, _a] = _c

SLAB_CASES = [("4096 atoms, 3 species", 4), ("4096 atoms, 3 species", 16),
              ("4096 atoms, 3 species", 128), ("4096 atoms, 3 species", 1024),
              ("4096 atoms, 3 species", 4096),
              ("bench", 8), ("bench", 16), ("bench, triclinic", 8),
              ("bench, crowded", 16), ("empty runs", 8),
              ("whole-window runs", 8), ("overlapping runs", 8),
              ("unsorted keys", 8), ("staging flush", 8)]


def crowd_first_zn(pos, cell, sp):
    """Twenty N atoms of the bench glass moved within 1.0-1.7 A of the
    first Zn (cnt > 16 there)."""
    rng = np.random.default_rng(5)
    off = rng.normal(0, 1, (20, 3))
    off *= (rng.uniform(1.0, 1.7, 20) / np.linalg.norm(off, axis=1))[:, None]
    n_zn = int((sp == 0).sum())
    pos = pos.copy()
    pos[n_zn:n_zn + 20] = (pos[0] + off) % np.diag(cell)
    return pos


def slab_case(dev, name):
    """Kernel #3's inputs (centers, cand, starts, qbounds, cell, cutoff,
    chunk, window) on the card: a 4096-atom random system; the bench
    glass's 10240 atoms (cubic, triclinic, and with twenty N atoms within
    1.7 A of the first Zn); and the bench layout with hand-edited
    ``qbounds`` (empty and reversed ranges, ranges covering their whole
    window, run 1 repeating run 0), candidate columns in random key
    order, or a window of 3 x 512 columns all in range (more kept
    columns than one staging holds)."""
    if name.startswith("4096"):
        pos, cell, sp = case(4096, 3, 4, 40.0, pad_from=4000)
        cut = CUTOFF
    else:
        pos, cell, sp, _ = bench_glass(triclinic=name.endswith("triclinic"))
        cut = BENCH_CUT
        if name.endswith("crowded"):
            pos = crowd_first_zn(pos, cell, sp)
    plan = slab_table.slab_plan(cell, float(cut.max()), len(sp),
                                positions=pos[None], species_idx=sp)
    assert plan is not None
    p, c, s, ct = on(dev, pos, cell, sp, cut)
    centers, cand, starts, qb, _ = slab_table.build_slab_layout(p, s, c,
                                                                plan)
    w = plan.window
    rng = np.random.default_rng(len(name))
    pick = torch.from_numpy(rng.random(starts.shape[0]) < 0.5).to(dev)
    if name == "empty runs":
        qb[pick, 1, 1] = qb[pick, 1, 0]
        qb[~pick, 0, 0] = qb[~pick, 0, 1] + 1.0
    elif name == "whole-window runs":
        qb[pick, 0, 0] = -float("inf")
        qb[pick, 0, 1] = float("inf")
        qb[:, 2, 0] = -float("inf")
        qb[:, 2, 1] = float("inf")
    elif name == "overlapping runs":
        starts[pick, 1] = starts[pick, 0]
        qb[pick, 1] = qb[pick, 0]
        qb[~pick, 1, 0] -= 0.5
    elif name == "unsorted keys":
        perm = torch.from_numpy(rng.permutation(cand.shape[1])).to(dev)
        cand = cand[:, perm].contiguous()
    elif name == "staging flush":
        w = 512
        starts.clamp_(max=cand.shape[1] - w)
        qb[:, :, 0] = -float("inf")
        qb[:, :, 1] = float("inf")
    return centers, cand, starts, qb, c, ct, plan.chunk, w


@pytest.mark.cuda
@pytest.mark.parametrize("name,k", SLAB_CASES)
def test_slab_kernel_matches_plain(cuda, name, k):
    """Kernel #3 vs its plain version, all three outputs exact, on random
    and bench-glass layouts and the hand-edited ones of
    tests/test_torch_slab_compact.py (K 16, 128 and 1024: 4, 2 and 1
    centers a warp; K 4096: the output tile takes over 48 KB of shared
    memory); ten repeated calls into memory the allocator last gave to a
    tensor of -1s give equal outputs."""
    centers, cand, starts, qb, c, ct, chunk, w = slab_case(cuda, name)
    args = (centers, cand, starts, qb, c, ct, k, chunk, w)
    ref = neighbor_kernel.window_table_slab_plain(*args)
    assert int(ref[2].sum()) > 0
    if name.endswith("crowded"):
        assert int(ref[2].max()) > k
    m = centers.shape[0]
    for _ in range(11):
        junk = torch.full((m * (4 * k + 1),), -1, dtype=torch.int32,
                          device=cuda)
        del junk
        assert_same(neighbor_kernel.window_table_slab(*args), ref)


@pytest.mark.cuda
def test_slab_geometry_matches_wrapper(cuda):
    """Kernel #3's C launch shape (centers a block, staged columns, pass,
    dynamic shared bytes) is the one the twin and the wrapper assume."""
    for m, chunk, k, w, s in ((14688, 16, 8, 256, 4), (4096, 16, 1024, 256, 4),
                              (170, 17, 8, 384, 3), (1600, 16, 8, 512, 4),
                              (64, 16, 4096, 128, 2), (96, 24, 100, 256, 4),
                              (48, 48, 8, 256, 40)):
        geo = neighbor_kernel.window_table_slab_geometry(m, chunk, k, w, s)
        cpb = neighbor_kernel.slab_centers_per_block(chunk, k)
        cap = min(3 * w, neighbor_kernel.SLAB_PASS)
        assert geo["cpb"] == cpb and geo["blocks"] == m // cpb
        assert geo["cpw"] == (1 if cpb <= 4 else 2 if cpb <= 8 else 4)
        assert geo["cap"] == cap
        assert geo["pass_columns"] == neighbor_kernel.SLAB_PASS
        assert geo["smem_bytes"] == 20 * cap + 16 * cpb * k + 4 * s * s
        assert geo["registers"] > 0 and geo["blocks_per_sm"] > 0


def reach_edge(pos, cell, sp, cut, n_edge=120):
    """Atoms 2i and 2i + 1 (i < n_edge) made a pair of the largest cutoff
    rc: the center at fractional x 0.99 or 0.01, its partner rc (1 + d)
    away along the unit normal of the b x c plane (d from -2e-5 to 2e-5,
    a few position ulps apart), so the pair sits at the cut's reach and
    the partner lies outside the box."""
    pos, sp = pos.copy(), sp.copy()
    a, b = np.unravel_index(np.argmax(cut), cut.shape)
    nrm = np.cross(cell[1].astype(np.float64), cell[2])
    nrm /= np.linalg.norm(nrm)
    rng = np.random.default_rng(7)
    deltas = np.linspace(-2e-5, 2e-5, 41)
    for i in range(n_edge):
        frac = rng.uniform(0.2, 0.8, 3)
        frac[0] = 0.99 if i % 2 == 0 else 0.01
        sign = 1.0 if i % 2 == 0 else -1.0
        c = frac @ cell.astype(np.float64)
        pos[2 * i] = c
        pos[2 * i + 1] = c + sign * nrm * float(cut[a, b]) * (
            1 + deltas[i % len(deltas)])
        sp[2 * i], sp[2 * i + 1] = a, b
    return pos.astype(np.float32), sp


WINDOW_CASES = [("3000 atoms, triclinic", 2, 100, 300),
                ("3000 atoms, triclinic", 8, 256, 512),
                ("3000 atoms, triclinic", 40, 64, 200),
                ("3000 atoms, triclinic", 1024, 256, 512),
                ("bench", 16, 256, 1408), ("bench", 32, 256, 1408),
                ("bench", 16, 100, 1408), ("bench", 128, 256, 1408),
                ("bench, triclinic", 16, 256, 1408),
                ("bench, crowded", 16, 256, 1408),
                ("reach edge", 16, 256, 512),
                ("reach edge, triclinic", 16, 256, 512)]


def window_case(dev, name):
    """Kernel #4's inputs (pos_sorted, sp_sorted, cell, cutoff) on the
    card, sorted by fractional x: a random 3000-atom triclinic system with
    pads; the bench glass's 10240 atoms (cubic, triclinic, crowded); and
    pairs at the cut's reach, partners outside the box (``reach_edge``)."""
    if name.startswith("3000"):
        pos, cell, sp = case(3000, 3, 3, 36.0, triclinic=True, pad_from=2950)
        cut = CUTOFF
    elif name.startswith("bench"):
        pos, cell, sp, _ = bench_glass(triclinic=name.endswith("triclinic"))
        cut = BENCH_CUT
        if name.endswith("crowded"):
            pos = crowd_first_zn(pos, cell, sp)
    else:
        pos, cell, sp = case(3000, 3, 9, 36.0,
                             triclinic=name.endswith("triclinic"),
                             pad_from=2990)
        cut = CUTOFF
        pos, sp = reach_edge(pos, cell, sp, cut)
    p, c, s, ct = on(dev, pos, cell, sp, cut)
    inv = pair_engine.inverse_cell(c)
    _, pos_s, sp_s = pair_engine.sort_by_fractional_x(p, s, inv)
    return pos_s.contiguous(), sp_s.contiguous(), c, ct


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,chunk,window", WINDOW_CASES)
def test_window_kernel_matches_plain(cuda, name, k, chunk, window):
    """Kernel #4 vs its plain version, all three outputs exact: a random
    triclinic system with pads (K 2 to 1024, chunk 100 and 64: chunks 16
    does not divide), the bench glass at the fused reruns' chunk 256 and
    W 1408 (K 16, 32, 128; chunk 100, which leaves a short last chunk;
    triclinic; crowded, cnt > K) and pairs at the cut's reach with
    partners outside the box; ten repeated calls into memory the
    allocator last gave to a tensor of -1s give equal outputs; the C
    launch shape is the one ``window_table_geometry`` reports and the
    twin assumes."""
    pos_s, sp_s, c, ct = window_case(cuda, name)
    args = (pos_s, sp_s, c, ct, k, chunk, window)
    ref = neighbor_kernel.window_table_plain(*args)
    assert int(ref[2].sum()) > 0
    if name.endswith("crowded") or k <= 2:
        assert int(ref[2].max()) > k
    n = pos_s.shape[0]
    for _ in range(10):
        junk = torch.full((n * (4 * k + 1),), -1, dtype=torch.int32,
                          device=cuda)
        del junk
        assert_same(neighbor_kernel.window_table(*args), ref)
    geo = neighbor_kernel.window_table_geometry(n, chunk, k, window,
                                                ct.shape[0])
    cpb = neighbor_kernel.window_centers_per_block(chunk, k)
    first, _, _ = neighbor_kernel.window_blocks(n, chunk, k)
    assert geo["cpb"] == cpb and geo["blocks"] == first.numel()
    assert geo["bpc"] == -(-chunk // cpb)
    assert geo["cpw"] == (1 if cpb <= 4 else 2 if cpb <= 8 else 4)
    assert geo["cap"] == min(chunk + 2 * window, neighbor_kernel.SLAB_PASS)
    assert geo["smem_bytes"] == (32 * geo["cap"] + 16 * cpb * k
                                 + 4 * ct.shape[0] ** 2)
    assert geo["registers"] > 0 and geo["blocks_per_sm"] > 0


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_inputs(cuda):
    pos, cell, sp = case(512, 2, 5, 20.0)
    p, c, s = on(cuda, pos, cell, sp)
    before = launches("rdf_counts")
    rdf_kernel.rdf_counts(p, c, s, 0.05, 2, 100)
    assert launches("rdf_counts") == before + 1
    rdf_kernel.rdf_counts_plain(p, c, s, 0.05, 2, 100)
    assert launches("rdf_counts") == before + 1
    with pytest.raises(ValueError):
        rdf_kernel.rdf_counts(p.double(), c, s, 0.05, 2, 100)
    with pytest.raises(ValueError):
        rdf_kernel.rdf_counts(p, c, s.long(), 0.05, 2, 100)
    for fn in (rdf_kernel.rdf_counts, rdf_kernel.rdf_counts_blocked):
        with pytest.raises(ValueError):
            fn(p, c, s, 2.0 ** -51, 2, 100)
    assert launches("rdf_counts") == before + 1

    centers, cand, starts, qb, c, ct, chunk, w = slab_case(cuda, "bench")
    args = [centers, cand, starts, qb, c, ct, 8, chunk, w]
    before = launches("window_table_slab")
    neighbor_kernel.window_table_slab(*args)
    assert launches("window_table_slab") == before + 1
    neighbor_kernel.window_table_slab_plain(*args)
    assert launches("window_table_slab") == before + 1
    for i, bad in ((0, centers.double()), (2, starts[:-1]),
                   (3, qb.transpose(1, 2)), (5, ct.cpu()),
                   (1, cand.t().contiguous().t())):
        with pytest.raises(ValueError):
            neighbor_kernel.window_table_slab(*args[:i], bad, *args[i + 1:])
    assert launches("window_table_slab") == before + 1

    pos_s, sp_s, c, ct = window_case(cuda, "3000 atoms, triclinic")
    args = [pos_s, sp_s, c, ct, 8, 256, 512]
    before = launches("window_table")
    neighbor_kernel.window_table(*args)
    assert launches("window_table") == before + 1
    neighbor_kernel.window_table_plain(*args)
    assert launches("window_table") == before + 1
    for i, bad in ((0, pos_s.double()), (1, sp_s.long()), (2, c.t()),
                   (3, ct.cpu()), (0, pos_s[:-1])):
        with pytest.raises(ValueError):
            neighbor_kernel.window_table(*args[:i], bad, *args[i + 1:])
    assert launches("window_table") == before + 1


@pytest.mark.cuda
def test_warmup_copy_matches_copy(cuda):
    """Kernel #9 vs ``dst.copy_(src)``, and the launch count."""
    import importlib

    wmod = importlib.import_module("amof_tpu_torch.warmup")
    src = torch.from_numpy(np.random.default_rng(6).normal(
        size=wmod.SHAPE).astype(np.float32)).to(cuda)
    before = launches("warmup_copy")
    got = wmod.warmup_copy(src)
    assert launches("warmup_copy") == before + 1
    assert_same([got], [wmod.warmup_copy_plain(src)])
    with pytest.raises(ValueError):
        wmod.warmup_copy(src.double())
    with pytest.raises(ValueError):  # contiguous but not 16-byte aligned
        wmod.warmup_copy(src.flatten()[1:1 + 512])


# --------------------------------------------------------------------------
# Pore kernels (#5 void masks, #6 surface blockers, #7 flood fill)
# --------------------------------------------------------------------------

def pore_system(n, box, seed, triclinic=False, squeeze=0.72):
    """Random atoms with a void slab (z squeezed) in a cubic or sheared
    cell: (frac f32[n, 3], cell f32[3, 3], radii f32[n])."""
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3)).astype(np.float32)
    frac[:, 2] *= squeeze
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 1.4, -0.9, 1.1
    radii = rng.uniform(1.1, 1.8, n).astype(np.float32)
    return frac, cell, radii


@pytest.mark.cuda
@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("probe,chan,window", [(1.2, 1.2, 256),
                                               (1.0, 1.3, 256),
                                               (1.2, 1.2, 40)])
def test_void_masks_kernel_matches_plain(cuda, triclinic, probe, chan,
                                         window):
    """Kernel #5 vs its plain version: masks, point fits and the missed
    flag (window 40 overflows: both read the same truncated runs)."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, cell, radii = pore_system(600, 20.0, 7, triclinic)
    pts = np.random.default_rng(8).random((4000, 3)).astype(np.float32)
    pts_tiled, _ = grid_kernel.assign_points_to_xytiles(
        pts, {"nbx": 5, "nby": 5})
    f, c, r, p = on(cuda, frac, cell, radii, pts_tiled)
    args = (f, c, r, (40, 40, 36), probe, chan, 5, 5, window)
    got = surface_kernel.void_masks_points(*args, pts_tiled=p)
    ref = grid_kernel.void_masks_columns(*args, pts_tiled=p)
    assert bool(ref[3]) == (window == 40)
    assert 0 < int(ref[1].sum()) < ref[1].numel()
    assert_same(got, ref)
    got = surface_kernel.void_masks_points(*args)
    assert got[2] is None
    assert_same(got[:2], ref[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("gz", [7, 20, 36, 64])
@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("probe,chan", [(1.2, 1.2), (1.0, 1.3)])
def test_void_masks_z_slabs_match_plain(cuda, gz, triclinic, probe, chan):
    """Kernel #5's z slabs (8 voxels; 7, 20 and 36 are no multiple) on the
    void-slab system in a tall cell, where the cut drops most rows: masks,
    point fits and the missed flag equal the plain version over every
    candidate, with MC points on and off."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, cell, radii = pore_system(900, 20.0, 20 + gz, triclinic)
    cell[2] *= 2.0
    pts = np.random.default_rng(gz).random((5000, 3)).astype(np.float32)
    pts_tiled, _ = grid_kernel.assign_points_to_xytiles(
        pts, {"nbx": 5, "nby": 5})
    f, c, r, p = on(cuda, frac, cell, radii, pts_tiled)
    args = (f, c, r, (40, 40, gz), probe, chan, 5, 5, 256)
    lay = grid_kernel.masks_layout(f, r, 5, 5, 256)
    keep = grid_kernel.void_masks_z_window(
        lay, c, (40, 40, gz), 5, 5, 256,
        grid_kernel.mask_thresholds(probe, chan)[0])
    _, ok = grid_kernel._gather_runs(lay.payload, lay.start, lay.count, 256)
    if gz >= 20:
        assert float(keep.sum()) < 0.6 * float(ok.sum()) * keep.shape[1]
    for points in (p, None):
        got = surface_kernel.void_masks_points(*args, pts_tiled=points)
        ref = grid_kernel.void_masks_columns(*args, pts_tiled=points)
        assert not bool(ref[3]) and 0 < int(ref[1].sum()) < ref[1].numel()
        assert (got[2] is None) == (points is None)
        assert_same([g for g in got if g is not None],
                    [q for q in ref if q is not None])


@pytest.mark.cuda
@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("k,window,col_cap,missed", [(8, 640, 192, False),
                                                     (28, 640, 192, False),
                                                     (8, 60, 64, True)])
def test_surface_kernel_matches_plain(cuda, triclinic, k, window, col_cap,
                                      missed):
    """Kernel #6 vs its plain version on a void-slab system, with and
    without the candidate prefilter, including too-small windows and
    column capacities; ten repeated calls give equal outputs, and rows
    outside the active slots are False / 0 though the outputs are not
    cleared before the launch."""
    from amof_tpu_torch.pore import grid_kernel

    frac, cell, radii = pore_system(900, 22.0, 9, triclinic)
    grid = (24, 24, 24)
    dirs = grid_kernel.fibonacci_sphere(k)
    cand = np.random.default_rng(3).random(grid) < 0.1
    f, c, r, d, m = on(cuda, frac, cell, radii, dirs, cand)
    for cand_mask in (None, m):
        args = (f, c, r, 1.2, d, grid, 3, 3, window, 64, col_cap)
        ref, active = check_surface(args, cand_mask)
        assert bool(ref[5]) == missed
        assert int(ref[0].sum()) > 0
        if missed:  # rows past n_z * chunk of an overfull column
            assert not bool(active.all())


def check_surface(args, cand_mask, repeats=10):
    """Kernel #6 against its plain version: equal outputs, also over
    ``repeats`` more calls into memory the allocator last gave to a
    tensor of -1s, and rows outside the active slots False / 0. Returns
    (plain outputs, bool[N] rows in active slots)."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    f, c, r, probe, d, grid, nbx, nby, window, chunk, col_cap = args
    ref = grid_kernel.surface_valid_columns(*args, cand_mask=cand_mask)
    n, k = ref[0].shape
    for _ in range(repeats + 1):
        junk = torch.full((3 * n * k,), -1, dtype=torch.int32, device=f.device)
        del junk
        assert_same(surface_kernel.surface_valid_columns(
            *args, cand_mask=cand_mask), ref)
    lay = grid_kernel.surface_layout(f, grid_kernel.host_inverse(c), r,
                                     probe, d, grid, nbx, nby, window,
                                     col_cap, cand_mask)
    _, los, his = grid_kernel.active_slots(lay, -(-col_cap // chunk), chunk)
    active = torch.zeros(n, dtype=torch.bool, device=f.device)
    for lo, hi in zip(los, his):
        active[lo:hi] = True
    assert not bool(ref[0][~active].any())
    assert not bool(ref[1][~active].any() or ref[2][~active].any())
    return ref, active


@pytest.mark.cuda
@pytest.mark.parametrize("squeeze", [1.0, 0.72])
@pytest.mark.parametrize("k", [8, 28])
def test_surface_kernel_on_crowded_columns(cuda, squeeze, k):
    """Kernel #6 on 4608 atoms at the bench glass's density (0.062 / A^3)
    in 3 x 3 columns of over 64 centers (ten slots of 64 a column), dense
    and with a void slab, with and without the prefilter; ten repeated
    calls."""
    from amof_tpu_torch.pore import grid_kernel

    frac, cell, radii = pore_system(4608, 42.0, 21, squeeze=squeeze)
    grid = (24, 24, 24)
    dirs = grid_kernel.fibonacci_sphere(k)
    cand = np.random.default_rng(22).random(grid) < 0.05
    f, c, r, d, m = on(cuda, frac, cell, radii, dirs, cand)
    args = (f, c, r, 1.2, d, grid, 3, 3, 2048, 64, 640)
    lay = grid_kernel.surface_layout(f, grid_kernel.host_inverse(c), r, 1.2,
                                     d, grid, 3, 3, 2048, 640)
    assert int((lay.c_bounds[1:] - lay.c_bounds[:-1]).min()) > 64
    for cand_mask in (None, m):
        ref, _ = check_surface(args, cand_mask)
        assert not bool(ref[5]) and int(ref[0].sum()) > 0


def serpentine(shape):
    """A one-voxel-wide path through many of kernel #7's tiles (as in
    tests/test_torch_flood_tiles.py): full z rows at even y of each even x
    layer, joined at alternate ends; layers joined through the odd x layer
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


FLOOD_CASES = [(shape, frac) for shape in ((16, 12, 20), (9, 13, 7),
                                           (1, 33, 64), (40, 40, 40))
               for frac in (0.3, 0.6)] + [
    ((17, 5, 33), 0.6), ((2, 17, 19), 0.6), ((9, 2, 35), 0.6),
    ((17, 20, 40), "serpentine"), ((112, 112, 112), 0.008),
    ((112, 112, 112), 0.23)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,frac", FLOOD_CASES)
@pytest.mark.parametrize("periodic", [False, True])
def test_flood_fill_kernel_matches_plain(cuda, shape, frac, periodic):
    """Kernel #7 vs the plain sweeps: linear-index init (component
    labels) and {1, 0, -1} init (channel propagation), on random masks
    (ragged, with axes of length 1 and 2; the bench grid at 0.8% and 23%)
    and a serpentine path; ten repeated calls give equal outputs, whatever
    order the atomics land in."""
    from amof_tpu_torch.pore import grid_kernel

    rng = np.random.default_rng(sum(shape))
    mask = (serpentine(shape) if frac == "serpentine"
            else rng.random(shape) < frac)
    lin = np.where(mask, np.arange(mask.size).reshape(shape), -1)
    seeds = mask & (rng.random(shape) < 0.01)
    tern = np.where(seeds, 1, np.where(mask, 0, -1))
    for init in (lin, tern):
        (t,) = on(cuda, init.astype(np.int32))
        got = grid_kernel.propagate_fixpoint(t, periodic)
        ref = grid_kernel.propagate_fixpoint_plain(t, periodic)
        assert_same([got], [ref])
        for _ in range(10):
            assert_same([grid_kernel.propagate_fixpoint(t, periodic)], [got])


@pytest.mark.cuda
def test_flood_fill_geometry_matches_wrapper(cuda):
    """The CUDA source's tile and scratch size are the wrapper's."""
    from amof_tpu_torch.pore import grid_kernel

    for shape in ((112, 112, 112), (16, 512, 512), (9, 13, 7)):
        geo = grid_kernel.flood_fill_geometry(shape)
        assert geo["tile"] == grid_kernel.FLOOD_TILE
        assert geo["scratch_ints"] == (np.prod(shape)
                                       + grid_kernel.flood_tiles(shape))
        for step in grid_kernel.FLOOD_STEPS:
            assert geo[step]["blocks"] == grid_kernel.flood_tiles(shape)
            assert geo[step]["registers"] > 0
            assert geo[step]["blocks_per_sm"] > 0


def bench_glass_frame(n_atoms=10240, squeeze=None, density=0.062, seed=0):
    """(frac, cell, radii) of frame 0 of the bench glass (the bench
    recipe: Zn(C3N2H3)2 at the ZIF-4 number density, default vdW radii),
    z optionally squeezed (the void slab)."""
    from amof_tpu_torch.data import elements

    rng = np.random.default_rng(seed)
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate([np.full(c, z) for z, c in counts.items()])
    box = (n_atoms / density) ** (1 / 3)
    frac = rng.uniform(0, box, (n_atoms, 3)).astype(np.float32) / box
    if squeeze is not None:
        frac[:, 2] *= squeeze
    cell = np.eye(3, dtype=np.float32) * np.float32(box)
    radii = elements.vdw_radius_array()[species].astype(np.float32)
    return frac.astype(np.float32), cell, radii


def assert_flood_matches_plain(mask, dev):
    """Kernel #7 vs the plain sweeps on ``mask``: component labels open
    and periodic, and channel propagation from 1% seeds."""
    from amof_tpu_torch.pore import grid_kernel

    m = torch.from_numpy(mask).to(dev)
    lin = torch.where(m, torch.arange(m.numel(), device=dev,
                                      dtype=torch.int32).reshape(m.shape),
                      torch.full(m.shape, -1, dtype=torch.int32,
                                 device=dev))
    seeds = m & (torch.rand(m.shape, device=dev) < 0.01)
    tern = torch.where(seeds, 1, torch.where(m, 0, -1)).to(torch.int32)
    for init, periodic in ((lin, False), (lin, True), (tern, True)):
        assert_same([grid_kernel.propagate_fixpoint(init, periodic)],
                    [grid_kernel.propagate_fixpoint_plain(init, periodic)])


@pytest.mark.cuda
@pytest.mark.parametrize("squeeze,probe", [(None, 1.2), (None, 0.6),
                                           (0.72, 1.2)])
def test_flood_fill_on_per_frame_bench_masks(cuda, squeeze, probe):
    """Kernel #7 on the per-frame path's masks: the bench glass at
    zeopp's default 0.2 A (276^3 voxels, the sorted-window field) at a
    1.2 A probe (no channel), a 0.6 A probe (percolating) and on the
    void slab."""
    from amof_tpu_torch.pore import grid_kernel, zeopp

    frac, cell, radii = bench_glass_frame(squeeze=squeeze)
    grid = zeopp._grid_dims(cell, 0.2)
    assert grid == (276, 276, 276)
    f, c, r = on(cuda, frac, cell, radii)
    dist, missed = grid_kernel.distance_grid_windowed(
        f, c, r, grid, dmax=2.201, dxa=0.075, chunk=2048, window=4096)
    assert not bool(missed)
    mask = (dist >= probe).cpu().numpy()
    assert mask.any() and not mask.all()
    assert_flood_matches_plain(mask, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(45, 37, 29), (33, 50, 27), (7, 61, 13),
                                  (64, 30, 81)])
def test_flood_fill_on_explicit_grid_masks(cuda, grid):
    """Kernel #7 on masks of odd, non-multiple-of-8 grids that an
    explicit ``grid=`` gives the per-frame path and BatchedPore's
    distance-field plans (a 2048-atom glass, z squeezed, full field)."""
    from amof_tpu_torch.pore import grid_kernel

    frac, cell, radii = bench_glass_frame(2048, squeeze=0.72, seed=3)
    f, c, r = on(cuda, frac, cell, radii)
    dist = grid_kernel.distance_grid(f, c, r, grid)
    for probe in (0.8, 1.2):
        assert_flood_matches_plain((dist >= probe).cpu().numpy(), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("sheared", [False, True])
def test_distance_fields_on_the_card_equal_the_cpu(cuda, sheared):
    """The per-frame path's torch fields (full, one-level and two-level
    window, MC points) and surface counts give the same bits on the card
    as on the CPU (IEEE sqrt, no contraction: each op is one kernel)."""
    from amof_tpu_torch.pore import grid_kernel

    frac, cell, radii = bench_glass_frame(2048, squeeze=0.72, seed=3)
    if sheared:
        cell[1, 0], cell[2, 0], cell[2, 1] = 2.0, -1.5, 1.75
    grid = (44, 40, 36)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        f, c, r = on(dev, frac, cell, radii)
        full = grid_kernel.distance_grid(f, c, r, grid)
        win = grid_kernel.distance_grid_windowed(
            f, c, r, grid, dmax=1.201, dxa=0.1, chunk=1024, window=1024)
        win2 = grid_kernel.distance_grid_windowed2(
            f, c, r, grid, dmax=1.201, dxa=0.1, dya=0.1, tvx=4, tvy=8,
            nbx=4, k_slabs=3, window=512)
        m = full >= 1.2
        dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(16)).to(dev)
        surf = grid_kernel.surface_point_classification(
            f, c, r, 1.2, dirs, m, ~m, grid)
        outs.append([t.cpu() for t in (full, *win, *win2, *surf)])
    for g, r in zip(*outs):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_pore_wrappers_count_launches(cuda):
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, cell, radii = pore_system(300, 16.0, 2)
    f, c, r = on(cuda, frac, cell, radii)
    before = launches("void_masks_points"), launches("flood_fill")
    m = surface_kernel.void_masks_points(f, c, r, (16, 16, 16), 1.2, 1.2,
                                         4, 4, 256)[1]
    grid_kernel.void_classification_mask(m)
    grid_kernel.void_masks_columns(f, c, r, (16, 16, 16), 1.2, 1.2, 4, 4, 256)
    assert launches("void_masks_points") == before[0] + 1
    assert launches("flood_fill") == before[1] + 2
    with pytest.raises(ValueError):
        surface_kernel.void_masks_points(f.double(), c, r, (16, 16, 16),
                                         1.2, 1.2, 4, 4, 256)
    with pytest.raises(ValueError):
        grid_kernel.propagate_fixpoint(m.to(torch.int64), True)


@pytest.mark.cuda
def test_pore_kernels_multi_pass_staging(cuda):
    """More candidate rows than one shared-memory pass holds. #5: 192 kept
    rows of a z slab; later passes AND into what the first wrote. #6:
    columns of over 1024 rows of small atoms, whose groups keep some
    hundreds of rows each after the z cut, and a cell 1 A thin in z where
    every group's reach covers all of z and keeps all 9000 rows of its
    runs, nine times the 1024 that the kernel stages at once: each later
    flush of the staging ANDs into what the first wrote."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, cell, radii = pore_system(6000, 20.0, 12, squeeze=1.0)
    radii = (radii * 0.5).astype(np.float32)
    pts = np.random.default_rng(13).random((3000, 3)).astype(np.float32)
    pts_tiled, _ = grid_kernel.assign_points_to_xytiles(
        pts, {"nbx": 4, "nby": 4})
    f, c, r, p = on(cuda, frac, cell, radii, pts_tiled)
    args = (f, c, r, (32, 32, 32), 0.6, 0.5, 4, 4, 2048)
    lay = grid_kernel.masks_layout(f, r, 4, 4, 2048)
    assert int(lay.count.sum(dim=1).min()) > 1024
    keep = grid_kernel.void_masks_z_window(lay, c, (32, 32, 32), 4, 4, 2048,
                                           0.6)
    assert int(keep.sum(dim=2).min()) > 192  # #5 stages 192 rows a pass
    got = surface_kernel.void_masks_points(*args, pts_tiled=p)
    ref = grid_kernel.void_masks_columns(*args, pts_tiled=p)
    assert not bool(ref[3])
    assert 0 < int(ref[0].sum()) < ref[0].numel()
    assert_same(got, ref)

    dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(8)).to(cuda)
    sv = (f, c, r, 0.5, dirs, (32, 32, 32), 3, 3, 4096, 64, 896)
    got = surface_kernel.surface_valid_columns(*sv)
    ref = grid_kernel.surface_valid_columns(*sv)
    lay = grid_kernel.surface_layout(f, grid_kernel.host_inverse(c), r, 0.5,
                                     dirs, (32, 32, 32), 3, 3, 4096, 896)
    assert int(lay.b_count.sum(dim=1).min()) > 1024
    assert not bool(ref[5]) and int(ref[0].sum()) > 0
    assert_same(got, ref)

    rng = np.random.default_rng(14)
    frac = rng.random((9000, 3)).astype(np.float32)
    cell = np.diag([36.0, 36.0, 1.0]).astype(np.float32)
    radii = rng.uniform(0.1, 0.2, 9000).astype(np.float32)
    f, c, r = on(cuda, frac, cell, radii)
    grid = (24, 24, 4)
    sv = (f, c, r, 0.1, dirs, grid, 3, 3, 3072, 64, 1088)
    lay = grid_kernel.surface_layout(f, grid_kernel.host_inverse(c), r, 0.1,
                                     dirs, grid, 3, 3, 3072, 1088)
    _, keep = grid_kernel.surface_z_window(
        lay, c, dirs, 0.1, 17, 64, grid_kernel.surface_group_size(8), 3072)
    assert int(keep.sum(dim=1).min()) == 9000 > 8 * 1024
    got = surface_kernel.surface_valid_columns(*sv)
    ref = grid_kernel.surface_valid_columns(*sv)
    assert not bool(ref[5]) and 0 < int(ref[0].sum()) < ref[0].numel()
    assert_same(got, ref)


# --------------------------------------------------------------------------
# The ring path's device stage: the all-pairs BFS (torch.matmul, no
# hand-written kernel) against a scipy oracle, and the census on the card
# against the CPU. The decorated diamond net is ring_fixtures.py's.
# --------------------------------------------------------------------------

def net_adjacency(reps):
    from ring_fixtures import RING_CUTOFFS, net_frames

    from amof_tpu_torch import atom
    from amof_tpu_torch.ring import core

    frame = net_frames(reps)[0]
    adjacency, _ = core._frame_adjacency(
        frame, atom.format_cutoff(RING_CUTOFFS, sort_pair=True))
    return frame, core.adjacency_matrix(adjacency)


def random_adjacency(n, degree, seed):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    u = rng.integers(0, n, n * degree // 2)
    v = rng.integers(0, n, n * degree // 2)
    adj[u, v] = adj[v, u] = True
    np.fill_diagonal(adj, False)
    return adj


@pytest.mark.cuda
@pytest.mark.parametrize("case,depth", [("net 4x4x4", 16), ("net 4x4x4", 32),
                                        ("random 4096", 12)])
def test_bfs_distances_match_scipy_oracle(cuda, case, depth):
    from ring_fixtures import scipy_bfs

    from amof_tpu_torch.ops import graph_kernel

    adj = (net_adjacency(4)[1] if case.startswith("net")
           else random_adjacency(4096, 3, 5))
    assert len(adj) in (1536, 4096)
    dist = graph_kernel.bfs_distances(torch.from_numpy(adj).to(cuda), depth)
    assert dist.device.type == "cuda" and dist.dtype == torch.int32
    got = graph_kernel.to_host_uint16(dist)
    ref = scipy_bfs(adj, depth)
    assert int((ref < graph_kernel.UNREACHED).sum()) > len(adj)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_ring_census_card_equals_cpu_on_3x3x3_net(cuda):
    from ring_fixtures import RING_CUTOFFS

    from amof_tpu_torch.ring import Ring

    frame, adj = net_adjacency(3)
    assert len(frame) == 648
    card = Ring(max_search_depth=24).census([frame], [RING_CUTOFFS], [0],
                                            device=cuda)
    cpu = Ring(max_search_depth=24).census([frame], [RING_CUTOFFS], [0],
                                           device="cpu")
    for dim in cpu[0].dims:
        np.testing.assert_array_equal(card[0].get_coord(dim),
                                      cpu[0].get_coord(dim))
    np.testing.assert_array_equal(np.asarray(card[0]), np.asarray(cpu[0]))
    assert card[1] == cpu[1]
    assert np.asarray(card[0].sel(ring_var="RC")).ravel().tolist() == [432.0]
    assert not card[1][0]["Supercell census"]


POISON = 0x7FFFFFFF  # an index past any grid


def poisoned(dev):
    """Leaves the caching allocator's free blocks full of ``POISON``:
    tensors of that value, 512 B to 4 MB (its small and large pools),
    freed, so that a row a kernel does not write holds an index past the
    grid."""
    junk = [torch.full((1 << e,), POISON, dtype=torch.int32, device=dev)
            for e in range(7, 21) for _ in range(8)]
    del junk


def glass_surface_case(dev, seed, top_atoms=8):
    """One frame of the benchmark's glass (``zif4-glass-9792``, bonded,
    from ``seed``) as the pore step hands it to kernel #6: (frac, cell,
    inverse, radii, directions, grid, surface plan, channel mask), with
    ``top_atoms`` atoms of the last surface column moved a float32 ulp
    below fz = 1."""
    from amof_tpu_torch import FrameBatch
    from amof_tpu_torch.data import elements
    from amof_tpu_torch.pore import BatchedPore, grid_kernel, surface_kernel
    from bench_torch import harness

    bench = harness.Bench()
    config = bench.config("zif4-glass-9792")
    piece = harness.make_pieces(config, {"frames_per_piece": 1,
                                         "pieces": 1}, seed, dev)[0]
    batch = FrameBatch(piece["positions"], piece["cell"], piece["species"],
                       piece["step"])
    _, _, meta = BatchedPore(probe_radius=1.2, chan_radius=1.2,
                             vol_method="mc", conn_resolution=0.5).prepare(
        batch, device=dev)
    cp, sp, grid = meta["col_plan"], meta["surf_plan"], meta["grid"]
    radii = elements.vdw_radius_array()[piece["species"]].astype(np.float32)
    c, r = on(dev, piece["cell"][0], radii)
    inv = grid_kernel.host_inverse(c)
    frac = torch.from_numpy(piece["positions"][0]).to(dev) @ inv
    frac = frac - torch.floor(frac)
    last = ((frac[:, 0] * sp["nbx"]).long() == sp["nbx"] - 1) & (
        (frac[:, 1] * sp["nby"]).long() == sp["nby"] - 1)
    top = torch.nonzero(last)[:top_atoms, 0]
    frac[top, 2] = 1.0 - 2.0**-24
    frac = frac.contiguous()
    dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(meta["k"])).to(dev)
    _, m_chan, _, _ = surface_kernel.void_masks_points(
        frac, c, r, grid, 1.2, 1.2, cp["nbx"], cp["nby"], cp["window"])
    return frac, c, inv, r, dirs, grid, sp, m_chan, top


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**41 + 15838, 2**42 + 104729])
@pytest.mark.parametrize("crowded", [False, True])
def test_surface_kernel_writes_every_row_on_the_glass(cuda, seed, crowded):
    """Kernel #6 on the glass's surface layout, atoms of its last column
    a float32 ulp below fz = 1 (where the layout's float32 sort key once
    put them past the last column), with and without a ``col_cap`` that
    leaves rows of every column past ``n_z * chunk``: launched into
    memory full of an index past the grid, every index lies in the grid
    and the outputs equal the plain version."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, c, inv, r, dirs, grid, sp, m_chan, top = glass_surface_case(
        cuda, seed)
    cand = grid_kernel.surface_candidate_mask(frac, inv, r, 1.2, dirs, grid,
                                              m_chan)
    assert bool((~cand[top]).any())  # a non-candidate at the top of z
    col_cap = 64 if crowded else sp["col_cap"]
    args = (frac, c, r, 1.2, dirs, grid, sp["nbx"], sp["nby"], sp["window"],
            sp["chunk"], col_cap)
    ref = grid_kernel.surface_valid_columns(*args, cand_mask=m_chan,
                                            inv_cell=inv)
    n_vox = grid[0] * grid[1] * grid[2]
    for _ in range(3):
        poisoned(cuda)
        got = surface_kernel.surface_valid_columns(*args, cand_mask=m_chan,
                                                   inv_cell=inv)
        torch.cuda.synchronize()
        for idx in got[1:3]:
            assert 0 <= int(idx.min()) and int(idx.max()) < n_vox
        assert_same(got, ref)
    assert bool(ref[5]) == crowded


@pytest.mark.cuda
def test_surface_kernel_clears_rows_outside_every_column(cuda):
    """A layout whose last column ends before its last rows (as the
    float32 sort key once left them): kernel #6 writes those rows False /
    0, as the plain version leaves them, into memory full of an index
    past the grid."""
    from amof_tpu_torch.pore import grid_kernel, surface_kernel

    frac, c, inv, r, dirs, grid, sp, m_chan, _ = glass_surface_case(
        cuda, 2**41 + 15838)
    nbx, nby, window, chunk = sp["nbx"], sp["nby"], sp["window"], sp["chunk"]
    n_z = -(-sp["col_cap"] // chunk)
    lay = grid_kernel.surface_layout(frac, inv, r, 1.2, dirs, grid, nbx,
                                     nby, window, sp["col_cap"], m_chan)
    cb = lay.c_bounds.clone()
    cb[-1] -= 5  # five rows outside every column
    lay = lay._replace(c_bounds=cb,
                       cand_end=torch.minimum(lay.cand_end, cb[1:]))
    ref = grid_kernel.surface_valid_tiles_plain(
        lay, c, inv, dirs, 1.2, grid, nbx, nby, window, n_z, chunk)
    n = ref[0].shape[0]
    for _ in range(3):
        poisoned(cuda)
        got = surface_kernel._launch_surface(lay, c, inv, dirs, 1.2, grid,
                                             nbx, nby, n_z, chunk)
        assert_same(got, ref)
    tail = slice(int(cb[-1]), n)
    assert not bool(ref[0][tail].any() or ref[1][tail].any())


@pytest.mark.cuda
@pytest.mark.parametrize("window_scale", [1.0, 0.25])
def test_pore_graphed_frames_equal_eager(cuda, monkeypatch, window_scale):
    """The pore step's column-plan frames replayed from one CUDA graph a
    call (``frame_table.FrameGraph``) give the records of the same frames
    run eagerly on the card, bit for bit, on 8 frames of the benchmark's
    glass with ``pore_32``'s options; window_scale 0.25 misses every frame
    and sends it up the retry ladder, each rung capturing its own graph."""
    from amof_tpu_torch import FrameBatch
    from amof_tpu_torch.ops import frame_table
    from amof_tpu_torch.pore import BatchedPore
    from bench_torch import harness

    bench = harness.Bench()
    config = bench.config("zif4-glass-9792")
    opts = dict(harness.load_traffic(bench.workload("glass9792.pore"))[
        "options"], window_scale=window_scale)
    piece = harness.make_pieces(config, {"frames_per_piece": 8,
                                         "pieces": 1}, 2**41 + 3, cuda)[0]
    batch = FrameBatch(piece["positions"], piece["cell"], piece["species"],
                       piece["step"])

    def run():
        before = tracing.snapshot()
        recs, _ = BatchedPore(**opts).run(batch, device=cuda)
        return recs, tracing.diff(tracing.snapshot(), before)["counts"]

    graphed, counts = run()
    missed = counts.get("pore.frames_missed", 0)
    assert missed == (0 if window_scale == 1.0 else 8)
    assert counts["pore.frames_graphed"] == 8 + counts.get(
        "pore.frames_retried", 0)
    assert (counts["pore.graph_captures"] == 1) == (missed == 0)

    class Eager(frame_table.FrameGraph):
        def __init__(self, *args, **kw):
            super().__init__(*args, **dict(kw, graphed=False, memory=None))

    monkeypatch.setattr(frame_table, "FrameGraph", Eager)
    eager, counts = run()
    assert counts.get("pore.frames_graphed", 0) == 0
    assert graphed == eager
