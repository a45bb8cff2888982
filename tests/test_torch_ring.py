"""Ring statistics in the port (``amof_tpu_torch.ring``, ``native``)
against ``amof_tpu``: the C++ census (the port's own copy of
``ringsearch.cpp``, built with g++ at first use) against its pure-Python
plain version and a networkx oracle; ``Ring.from_trajectory`` on a
hexagon, the cube graph, graphene, the 2x2x2 decorated diamond net and
the cell-spanning ring that needs the supercell census, and
``from_reduced_trajectory`` on the repo's ``example_reduced``: ring data,
report_search and the rstat / netCDF round trips exactly equal. The BFS
runs on the CPU here (``device="cpu"``). The decorated diamond net and
the spanning-ring frame are ``ring_fixtures.py``'s, which
``chip_smoke.py`` runs on the card."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import amof_tpu.ring as jring
import amof_tpu.trajectory as jtraj
from amof_tpu import native as jnative
from amof_tpu.core.frames import Frame as JFrame
import amof_tpu_torch.ring as tring
import amof_tpu_torch.trajectory as ttraj
from amof_tpu_torch import native, tracing
from amof_tpu_torch.core.frames import Frame as TFrame
from amof_tpu_torch.ring import core as tcore

import ring_fixtures

ROOT = pathlib.Path(__file__).resolve().parents[1]


def adjacency_from_edges(n, edges):
    adj = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    return adj


def cube_edges():
    return [(v, v ^ (1 << b)) for v in range(8) for b in range(3)
            if v ^ (1 << b) > v]


def random_edges(n, n_edges, seed):
    rng = np.random.default_rng(seed)
    edges = set()
    while len(edges) < n_edges:
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.add((int(min(u, v)), int(max(u, v))))
    return sorted(edges)


def nx_primitive_rings(adj, max_size):
    """Independent oracle: every simple cycle (networkx) that passes the
    shortest-path (no shortcut) test, canonicalized."""
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(range(len(adj)))
    g.add_edges_from((u, v) for u, nbrs in enumerate(adj) for v in nbrs)
    dist = dict(nx.all_pairs_shortest_path_length(g))
    out = set()
    for cyc in nx.simple_cycles(g, length_bound=max_size):
        m = len(cyc)
        if m < 3 or any(dist[cyc[i]][cyc[j]] < min(j - i, m - (j - i))
                        for i in range(m) for j in range(i + 1, m)):
            continue
        k = int(np.argmin(cyc))
        out.add(min(tuple(cyc[(k + i) % m] for i in range(m)),
                    tuple(cyc[(k - i) % m] for i in range(m))))
    return out


GRAPHS = {
    "hexagon": (6, [(i, (i + 1) % 6) for i in range(6)], 12),
    "cube": (8, cube_edges(), 12),
    "fused_squares": (6, [(0, 1), (1, 2), (2, 3), (3, 0), (1, 4), (4, 5),
                          (5, 2)], 12),
    "ten_ring_depth_8": (10, [(i, (i + 1) % 10) for i in range(10)], 8),
    "ten_ring_depth_10": (10, [(i, (i + 1) % 10) for i in range(10)], 10),
    "square_and_pentagon": (8, [(0, 1), (1, 2), (2, 3), (3, 0), (2, 4),
                                (4, 5), (5, 6), (6, 7), (7, 4)], 10),
    "random_0": (14, random_edges(14, 20, 0), 14),
    "random_1": (14, random_edges(14, 20, 1), 14),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_native_census_matches_plain_and_amof_tpu(name):
    n, edges, depth = GRAPHS[name]
    adj = adjacency_from_edges(n, edges)
    got = native.ring_census(adj, depth, max_paths=256)
    plain = native._ring_census_py(adj, depth, max_paths=256)
    ref = jnative.ring_census(adj, depth, max_paths=256)
    assert got == ref
    assert sorted(map(tuple, got[0])) == sorted(map(tuple, plain[0]))
    assert got[1:] == plain[1:]


@pytest.mark.parametrize("name", ["hexagon", "cube", "random_0", "random_1"])
def test_native_census_matches_networkx(name):
    n, edges, depth = GRAPHS[name]
    adj = adjacency_from_edges(n, edges)
    rings, _, _ = native.ring_census(adj, depth, max_paths=256)
    assert {tuple(r) for r in rings} == nx_primitive_rings(adj, depth)


def test_known_censuses():
    hexagon = native.ring_census(adjacency_from_edges(*GRAPHS["hexagon"][:2]),
                                 12)
    assert [len(r) for r in hexagon[0]] == [6] and hexagon[1:] == (0, 1)
    cube = sorted(len(r) for r in native.ring_census(
        adjacency_from_edges(8, cube_edges()), 12)[0])
    assert cube == [4] * 6 + [6] * 4
    rings, undiscovered, _ = native.ring_census(
        adjacency_from_edges(*GRAPHS["ten_ring_depth_8"][:2]), 8)
    assert rings == [] and undiscovered > 0


def test_native_census_with_distances_and_shifts_matches_plain():
    """The periodic path: edge shifts and a precomputed distance matrix
    (from the port's BFS), on the spanning-ring fixture's bond graph."""
    import torch

    from amof_tpu_torch.ops import graph_kernel

    frame, cutoffs = spanning_ring_frame()
    cd = tcore.amatom.format_cutoff(cutoffs, sort_pair=True)
    adjacency, shifts = tcore._frame_adjacency(frame, cd)
    dist = graph_kernel.to_host_uint16(graph_kernel.bfs_distances(
        torch.from_numpy(tcore.adjacency_matrix(adjacency)), 8))
    got = native.ring_census(adjacency, 8, dist=dist, shifts=shifts)
    plain = native._ring_census_py(adjacency, 8, dist=dist, shifts=shifts)
    ref = jnative.ring_census(adjacency, 8, dist=dist, shifts=shifts)
    assert got == ref
    assert sorted(map(tuple, got[0])) == sorted(map(tuple, plain[0]))
    assert got[1:] == plain[1:]


# --------------------------------------------------------------------------
# Frames
# --------------------------------------------------------------------------

def graphene(reps=2):
    a = 1.42
    base = np.array([[0, 0, 0], [a / 2, np.sqrt(3) * a / 2, 0],
                     [3 * a / 2, np.sqrt(3) * a / 2, 0], [2 * a, 0, 0]])
    cells = np.array([[i, j, 0] for i in range(reps) for j in range(reps)],
                     np.float64)
    unit = np.array([3 * a, np.sqrt(3) * a, 10.0])
    pts = (base[None] + (cells * unit)[:, None]).reshape(-1, 3)
    cell = np.diag([3 * a * reps, np.sqrt(3) * a * reps, 10.0])
    return pts, [6] * len(pts), cell


def hexagon():
    ang = 2 * np.pi * np.arange(6) / 6
    pts = np.stack([8 + 1.4 * np.cos(ang), 8 + 1.4 * np.sin(ang),
                    np.full(6, 8.0)], axis=1)
    return pts, [6] * 6, np.eye(3) * 16.0


def cube():
    pts = 6.0 + 2.0 * np.array([[(v >> b) & 1 for b in range(3)]
                                for v in range(8)], np.float64)
    return pts, [6] * 8, np.eye(3) * 16.0


def spanning_ring_frame():
    pos, numbers, cell, cutoffs = ring_fixtures.spanning_ring_frame()
    return TFrame(pos, numbers, cell), cutoffs


def diamond_2x2x2():
    pos, numbers, cell = ring_fixtures.decorated_diamond(2, 1, sigma=0.1,
                                                         seed=0)
    return pos[0], numbers, cell


def frames_of(system, n_frames=1):
    pos, numbers, cell = system
    return ([TFrame(pos, numbers, cell) for _ in range(n_frames)],
            [JFrame(pos, numbers, cell) for _ in range(n_frames)])


SYSTEMS = {
    # name: (system, cutoffs, max_search_depth, n_frames)
    "hexagon": (hexagon(), {"C-C": 1.6}, 12, 1),
    "cube": (cube(), {"C-C": 2.1}, 12, 1),
    "graphene": (graphene(), {"C-C": 1.6}, 16, 2),
    "diamond_2x2x2": (diamond_2x2x2(), {"Fr-Zn": 3.8}, 16, 1),
    "spanning_ring": (None, None, 8, 1),
}


def systems(name):
    system, cutoffs, depth, n_frames = SYSTEMS[name]
    if name == "spanning_ring":
        frame, cutoffs = spanning_ring_frame()
        system = (frame.positions, frame.numbers, frame.cell)
    return frames_of(system, n_frames), cutoffs, depth


def assert_rings_equal(got, ref):
    assert ("ring" in got.data) == ("ring" in ref.data)
    if "ring" in ref.data:
        g, r = got.data["ring"], ref.data["ring"]
        assert g.dims == r.dims
        for dim in r.dims:
            np.testing.assert_array_equal(g.get_coord(dim), r.get_coord(dim))
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert got.report_search.equals(ref.report_search)
    assert list(got.report_search.columns) == list(ref.report_search.columns)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_from_trajectory_matches_amof_tpu(name, tmp_path):
    pytest.importorskip("pandas")
    (tframes, jframes), cutoffs, depth = systems(name)
    got = tring.Ring.from_trajectory(
        tframes, cutoffs, max_search_depth=depth, delta_Step=10,
        write_rstat=tmp_path / "t", device="cpu")
    ref = jring.Ring.from_trajectory(
        jframes, cutoffs, max_search_depth=depth, delta_Step=10,
        write_rstat=tmp_path / "j")
    assert_rings_equal(got, ref)
    # rstat trees: byte-equal, and read back to the data
    t_files = sorted(p.relative_to(tmp_path / "t")
                     for p in (tmp_path / "t").rglob("*.dat"))
    assert t_files == sorted(p.relative_to(tmp_path / "j")
                             for p in (tmp_path / "j").rglob("*.dat"))
    assert len(t_files) == 2 * len(tframes)
    for rel in t_files:
        assert (tmp_path / "t" / rel).read_bytes() == (
            tmp_path / "j" / rel).read_bytes()
    arr = got.data["ring"]
    for step in arr.get_coord("Step"):
        rstat = tmp_path / "t" / f"Step-{int(step)}" / "rstat"
        back, undiscovered = got.read_rings_output(rstat)
        jback, jundiscovered = ref.read_rings_output(rstat)
        assert undiscovered == jundiscovered
        np.testing.assert_array_equal(np.asarray(back), np.asarray(jback))
        np.testing.assert_allclose(np.asarray(back),
                                   np.asarray(arr.sel(Step=step)),
                                   rtol=1e-9)  # rstat keeps 10 digits
    # netCDF + report_search.csv round trip
    got.write_to_file(tmp_path / "t.out")
    ref.write_to_file(tmp_path / "j.out")
    assert (tmp_path / "t.out.report_search.csv").read_bytes() == (
        tmp_path / "j.out.report_search.csv").read_bytes()
    back = tring.Ring.from_file(tmp_path / "t.out")
    jback = jring.Ring.from_file(tmp_path / "j.out")
    g, r = back.data["ring"], jback.data["ring"]
    assert list(g.get_coord("ring_var")) == list(r.get_coord("ring_var"))
    np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    np.testing.assert_array_equal(np.asarray(g), np.asarray(arr))


def test_known_frames():
    pytest.importorskip("pandas")
    (tframes, _), cutoffs, depth = systems("diamond_2x2x2")
    ring = tring.Ring.from_trajectory(tframes, cutoffs,
                                      max_search_depth=depth, device="cpu")
    arr = ring.data["ring"]
    assert list(arr.get_coord("ring_size")) == [12]
    assert arr.sel(ring_size=12, ring_var="RC").values.item() == 128
    assert arr.sel(ring_size=12, ring_var="PN").values.item() == 1.0
    rs = ring.report_search
    assert not rs["Supercell census"].iloc[0]
    assert rs["Final search_depth"].iloc[0] == 16
    (tframes, _), cutoffs, depth = systems("spanning_ring")
    ring = tring.Ring.from_trajectory(tframes, cutoffs,
                                      max_search_depth=depth, device="cpu")
    assert ring.report_search["Supercell census"].iloc[0]
    assert list(ring.data["ring"].get_coord("ring_size")) == [8]


@pytest.mark.parametrize("depth,discard", [(12, True), (12, False),
                                           (32, False)])
def test_adaptive_depth_and_discard_match(depth, discard):
    pytest.importorskip("pandas")
    n = 18
    ang = 2 * np.pi * np.arange(n) / n
    pts = np.stack([8 + 5 * np.cos(ang), 8 + 5 * np.sin(ang),
                    np.full(n, 8.0)], axis=1)
    (tf, jf) = frames_of((pts, [6] * n, np.eye(3) * 16.0))
    kw = dict(max_search_depth=depth,
              discard_if_potentially_undiscovered_rings=discard)
    got, ref = tring.Ring(**kw), jring.Ring(**kw)
    got.compute_ring(tf, [{"C-C": 2.0}], np.array([5]), device="cpu")
    ref.compute_ring(jf, [{"C-C": 2.0}], np.array([5]))
    assert_rings_equal(got, ref)


@pytest.mark.parametrize("parallel", [False, 2])
def test_from_reduced_trajectory_matches(parallel, tmp_path):
    pytest.importorskip("pandas")
    got = tring.Ring.from_reduced_trajectory(
        ttraj.ReducedTrajectory.from_file(ROOT / "example_reduced"),
        parallel=parallel, write_rstat=tmp_path / "t", device="cpu")
    ref = jring.Ring.from_reduced_trajectory(
        jtraj.ReducedTrajectory.from_file(ROOT / "example_reduced"),
        write_rstat=tmp_path / "j")
    assert_rings_equal(got, ref)
    assert got.report_search["Supercell census"].iloc[0]
    for rel in ("Step-0/rstat/RINGS-res-3.dat", "Step-0/rstat/RINGS-res-5.dat"):
        assert (tmp_path / "t" / rel).read_bytes() == (
            tmp_path / "j" / rel).read_bytes()


def test_from_reduced_trajectory_without_valid_frames_matches():
    pd = pytest.importorskip("pandas")
    rs = pd.DataFrame({"Step": [0], "in_reduced_trajectory": [False]})
    rs = rs.set_index("Step")
    got = tring.Ring.from_reduced_trajectory(
        ttraj.ReducedTrajectory([], rs), device="cpu")
    ref = jring.Ring.from_reduced_trajectory(jtraj.ReducedTrajectory([], rs))
    assert "ring" not in got.data and "ring" not in ref.data
    assert got.report_search.equals(ref.report_search)


def test_census_is_the_pandas_free_half_of_compute_ring():
    pytest.importorskip("pandas")
    (tframes, _), cutoffs, depth = systems("graphene")
    ring = tring.Ring(max_search_depth=depth)
    stacked, reports = ring.census(tframes, [cutoffs] * 2, [0, 7],
                                   device="cpu")
    other = tring.Ring(max_search_depth=depth)
    other.compute_ring(tframes, [cutoffs] * 2, [0, 7], device="cpu")
    np.testing.assert_array_equal(np.asarray(stacked),
                                  np.asarray(other.data["ring"]))
    assert [r["Step"] for r in reports] == [0, 7]
    assert reports[1] == other.report_search.loc[7].to_dict() | {"Step": 7}


def test_census_split_sums_the_pieces_of_each_frame():
    (tframes, _), cutoffs, depth = systems("graphene")
    before = tracing.snapshot()
    tring.Ring(max_search_depth=depth).census(tframes, [cutoffs] * 2,
                                              [0, 7], device="cpu")
    spans = {k: v for k, v in tracing.diff(tracing.snapshot(),
                                           before)["spans"].items()
             if k.startswith("ring.")}
    assert set(spans) == {"ring.guard", "ring.adjacency", "ring.bfs_copy",
                          "ring.census"}
    assert all(calls >= 2 and secs > 0 for calls, secs, _ in spans.values())
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counts": {}}


def test_frame_census_with_the_torch_bfs_equals_the_engines_own():
    frame = TFrame(*diamond_2x2x2())
    cutoff_dict = tcore.amatom.format_cutoff(ring_fixtures.RING_CUTOFFS,
                                             sort_pair=True)
    rings, undiscovered, king = tcore.frame_ring_census(
        frame, cutoff_dict, 16, device="cpu")
    adjacency, shifts = tcore._frame_adjacency(frame, cutoff_dict)
    ref = native.ring_census(adjacency, 16, shifts=shifts)
    assert sorted(map(tuple, rings)) == sorted(map(tuple, ref[0]))
    assert (undiscovered, king) == ref[1:]
    assert len(rings) == 2 * len(frame) // 3


def test_ring_var_names_and_rings_output_match(tmp_path):
    from amof_tpu.labeled import DataArray as JArray
    from amof_tpu_torch.labeled import DataArray as TArray

    for alias in ("Rc(n)", " rc ", "Rn(n)", "P_N(n)", "P_max(n)", "pmin",
                  "unknown"):
        assert (tcore.normalize_ring_var(alias)
                == jring.core.normalize_ring_var(alias))
    assert tcore.RING_VARS == jring.core.RING_VARS
    vals = np.array([[3.0, 0.5, 0.25, 0.125], [7.0, 1.0, 0.75, 1 / 3]])
    coords = [("ring_size", np.array([4, 6])),
              ("ring_var", np.array(["RC", "PN", "Pmax", "Pmin"]))]
    tcore.write_rings_output(tmp_path / "t", TArray(vals, coords=coords), 2,
                             16)
    jring.core.write_rings_output(tmp_path / "j", JArray(vals, coords=coords),
                                  2, 16)
    for name in ("RINGS-res-3.dat", "RINGS-res-5.dat"):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()
    rs = tcore.ring_statistics([[0, 1, 2, 3], [2, 3, 4, 5, 6, 7]], 9, 8)
    jrs = jring.core.ring_statistics([[0, 1, 2, 3], [2, 3, 4, 5, 6, 7]], 9, 8)
    for g, r in zip(rs, jrs):
        np.testing.assert_array_equal(g, r)


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (tframes, _), cutoffs, depth = systems("hexagon")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tring.Ring.from_trajectory(tframes, cutoffs, max_search_depth=depth)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tcore.frame_ring_census(tframes[0], {(6, 6): 1.6}, 12)


def test_pandas_blocked_imports_and_census(tmp_path):
    """``ring.core``, ``trajectory`` and ``io.cp2k`` import with pandas
    absent, and ``Ring.census`` runs a census without it."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "import amof_tpu_torch.io.cp2k\n"
        "import amof_tpu_torch.trajectory\n"
        "import amof_tpu_torch.ring.core as rc\n"
        "from amof_tpu_torch.core.frames import Frame\n"
        "ang = 2 * np.pi * np.arange(6) / 6\n"
        "pts = np.stack([8 + 1.4 * np.cos(ang), 8 + 1.4 * np.sin(ang),\n"
        "                np.full(6, 8.0)], axis=1)\n"
        "f = Frame(pts, [6] * 6, np.eye(3) * 16.0)\n"
        "arr, rep = rc.Ring(max_search_depth=12).census(\n"
        "    [f], [{'C-C': 1.6}], [0], device='cpu')\n"
        "assert arr.sel(ring_size=6, ring_var='RC').values.item() == 1\n"
        "assert rep[0]['Final search_depth'] == 12\n"
        "assert not [m for m in sys.modules if m.startswith('pandas')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


# --------------------------------------------------------------------------
# The g++ build
# --------------------------------------------------------------------------

@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The native module with nothing loaded and an empty build dir."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_failing_gxx_raises_and_does_not_fall_back(fresh_native,
                                                    monkeypatch):
    bin_dir = fresh_native / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "g++"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler says no' >&2\n"
                    "echo ran >> \"$0.calls\"\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    adj = adjacency_from_edges(*GRAPHS["hexagon"][:2])
    with pytest.raises(native.NativeBuildError,
                       match="(?s)g\\+\\+ -O3.*fake compiler says no"):
        native.ring_census(adj, 12)
    with pytest.raises(native.NativeBuildError, match="fake compiler"):
        native.get_lib()  # remembered: g++ does not run again
    assert (bin_dir / "g++.calls").read_text().count("ran") == 1
    assert not list((fresh_native / "build").glob("*"))
    (tframes, _), cutoffs, depth = systems("hexagon")
    with pytest.raises(native.NativeBuildError):
        tring.Ring.from_trajectory(tframes, cutoffs, max_search_depth=depth,
                                   device="cpu")


def test_missing_gxx_raises(fresh_native, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_native))
    with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
        native.get_lib()


def test_concurrent_builds_leave_one_library(fresh_native):
    """Two processes building into one empty directory at once: both
    load, and only the finished library is left (no temporary file)."""
    code = (
        "import pathlib, sys\n"
        "from amof_tpu_torch import native, tracing\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "rings, _, _ = native.ring_census([[1, 5], [0, 2], [1, 3], [2, 4],\n"
        "                                  [3, 5], [4, 0]], 12)\n"
        "assert [len(r) for r in rings] == [6]\n"
        "print('built', 'build.gxx' in tracing.snapshot()['spans'])\n"
    )
    build = fresh_native / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(ROOT)) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert out.startswith("built")
    assert [p.name for p in build.iterdir()] == [native.library_path().name]
