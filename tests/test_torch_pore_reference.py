"""The pore deployment of the benchmark on the CPU: the port's
``pore_records`` against the benchmark's plain reference
(``bench_torch/reference/pore.py``), the pore step's spans and counters,
and the work counts behind the rooflines of kernels #5, #6 and #7.

  * ``pore_records`` at ``rehearse.small``'s size of the cell's
    configuration (``zif4-glass-9792-zeopp``; 1088 atoms, 4 frames) with ``pore_32``'s options, on the column plan
    as the card's cell, reads within the cell's limits
    (``bench_torch/limits/glass9792.pore.json``), and the reference in
    bfloat16 (the control) does not.
  * The counters ``pore.frames``, ``.frames_missed``, ``.frames_retried``
    and ``.frames_per_frame`` on forced misses (a ``window_scale`` below
    1, a crowded column) that reach the widened-window retry and the
    per-frame path.
  * The pore kind refuses a mix whose probe, channel radius, samples or
    ``-vol`` estimator differ from the configuration's ``zeopp`` group.
  * ``reference/pore.py`` imports nothing of the program or of JAX
    (``ast``), nor do the work files.
  * ``reference.pore.work_counts``' pairs against a brute-force count
    (numpy, float64, every voxel or point against every atom's 27 images)
    on a tiny grid and a handful of atoms.
"""

import ast
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from amof_tpu_torch import FrameBatch, tracing  # noqa: E402
from amof_tpu_torch.pore import BatchedPore  # noqa: E402
from amof_tpu_torch.pore.core import pore_records  # noqa: E402
from bench_torch import harness, rehearse  # noqa: E402
from bench_torch.kinds import pore as kind  # noqa: E402
from bench_torch.reference import pore as ref_pore  # noqa: E402

torch.set_num_threads(2)

BENCH = harness.Bench(ROOT)
CELL = "glass9792.pore"
LIMITS = json.loads((ROOT / "bench_torch" / "limits"
                     / f"{CELL}.json").read_text())


def small_cell(seed):
    cell = BENCH.workload(CELL)
    config, traffic = rehearse.small(BENCH.config(cell["config"]),
                                     harness.load_traffic(cell))
    return config, traffic, harness.make_pieces(config, traffic, seed,
                                                "cpu")[0]


@pytest.mark.parametrize("opt,value", [("probe_radius", 1.4),
                                       ("chan_radius", 1.0),
                                       ("num_samples", 10000),
                                       ("vol_method", "grid")])
def test_pore_kind_refuses_a_mix_off_its_configuration(opt, value):
    config, traffic, _ = small_cell(2**33 + 1)
    kind.Runner(config, traffic, "cpu")
    traffic["options"][opt] = value
    with pytest.raises(SystemExit, match=opt):
        kind.Runner(config, traffic, "cpu")


def test_pore_records_match_the_reference_at_the_small_size():
    config, traffic, piece = small_cell(2**35 + 7)
    opts = traffic["options"]
    batch = FrameBatch(piece["positions"], piece["cell"], piece["species"],
                       piece["step"])
    _, _, meta = BatchedPore(**opts).prepare(batch, device="cpu")
    assert meta["col_plan"] is not None
    before = tracing.snapshot()
    recs = pore_records(batch, piece["step"], device="cpu", **opts)
    got = tracing.diff(tracing.snapshot(), before)
    assert [r["Step"] for r in recs] == list(piece["step"])
    out = {c: np.array([r[k] for r in recs]) for c, k in kind.COLUMNS.items()}
    ref = kind.reference(config, traffic, piece, "cpu")
    assert ref["n_acc"].sum() + ref["n_poc"].sum() > 0  # the glass has void
    nums = kind.compare(out, ref, config, traffic)
    assert set(nums) == set(LIMITS)
    assert all(v <= LIMITS[k] for k, v in nums.items()), nums
    ctl = kind.reference(config, traffic, piece, "cpu", torch.bfloat16)
    nums = kind.compare(ctl, ref, config, traffic)
    assert any(not v <= LIMITS[k] for k, v in nums.items()), nums
    frames = len(piece["step"])
    assert got["counts"]["pore.frames"] == frames
    assert got["counts"].get("pore.frames_missed", 0) == 0
    assert got["spans"]["pore.frame"][0] == frames
    for name in ("pore.prepare", "pore.prepare.plan", "pore.prepare.upload",
                 "pore.download"):
        assert got["spans"][name][0] == 1, name
    for name in ("pore.masks", "pore.labels", "pore.surface"):
        assert got["spans"][name][0] == frames, name
    assert "pore.retry" not in got["spans"]


KW = dict(resolution=1.0, num_samples=20000, radii={"C": 1.5})


def slab(n_frames=2, n=1024, box=32.0, seed=23):
    """Carbon atoms in a cubic cell with a void slab (z squeezed), the
    smallest that takes the column plan."""
    rng = np.random.default_rng(seed)
    frac = rng.random((n_frames, n, 3))
    frac[..., 2] *= 0.72
    cells = np.tile(np.eye(3) * box, (n_frames, 1, 1)).astype(np.float32)
    pos = (frac * box).astype(np.float32)
    return FrameBatch(pos, cells, np.full(n, 6, np.int32),
                      np.arange(n_frames, dtype=np.int32))


def counts_of(batch, **kw):
    before = tracing.snapshot()
    BatchedPore(**{**KW, **kw}).run(batch, device="cpu")
    got = tracing.diff(tracing.snapshot(), before)
    return ({k: got["counts"].get(f"pore.{k}", 0) for k in (
        "frames", "frames_missed", "frames_retried", "frames_per_frame")},
        got["spans"])


def test_counters_on_the_retry_ladder():
    """window_scale 0.25 misses every frame; the 0.5x retry misses again
    and the 1x retry covers: two rungs of two frames."""
    counts, spans = counts_of(slab(), vol_method="mc", window_scale=0.25)
    assert counts == {"frames": 2, "frames_missed": 2, "frames_retried": 4,
                      "frames_per_frame": 0}
    assert spans["pore.retry"][0] == 2  # the first pass's, the 0.5x one's
    assert spans["pore.frame"][0] == 6
    assert spans["pore.prepare"][0] == 3


@pytest.mark.parametrize("kw,crowd", [
    (dict(vol_method="grid", window_scale=0.5), False),
    (dict(vol_method="mc", window_scale=4.0), True),
])
def test_counters_on_the_per_frame_path(kw, crowd):
    """Grid mode recomputes a missed frame with ``zeopp.analyze_frame``,
    and so does mc mode past 4x windows (600 atoms crowd one column)."""
    batch = slab(n_frames=1)
    if crowd:
        batch.positions[0, :600, :2] *= 0.15
    counts, _ = counts_of(batch, **kw)
    assert counts == {"frames": 1, "frames_missed": 1, "frames_retried": 0,
                      "frames_per_frame": 1}


BANNED = ("amof_tpu", "amof_tpu_torch", "jax", "jaxlib")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("rel", [
    "reference/pore.py", "work/void_masks_points.py",
    "work/surface_valid_columns.py", "work/propagate_fixpoint.py"])
def test_reference_and_work_import_no_program(rel):
    found = [m for m in imported_modules(ROOT / "bench_torch" / rel)
             if m.split(".")[0] in BANNED]
    assert not found, found


# --------------------------------------------------------------------------
# work counts against brute force
# --------------------------------------------------------------------------

TINY_OPTS = {"probe_radius": 1.2, "chan_radius": 1.2, "num_samples": 3000,
             "vol_method": "mc", "conn_resolution": 0.9, "winding": "face"}
TINY_ELEMENTS = {"C": {"Z": 6, "vdw_radius_A": 1.7},
                 "H": {"Z": 1, "vdw_radius_A": 1.09}}


def tiny_piece(seed, n=14, box=(9.0, 10.0, 8.0), frames=2):
    rng = np.random.default_rng(seed)
    cell = np.diag(np.asarray(box, np.float32))
    pos = (rng.random((frames, n, 3)) * np.asarray(box)).astype(np.float32)
    return {"positions": pos, "cell": np.tile(cell, (frames, 1, 1)),
            "species": np.where(np.arange(n) % 3 == 0, 1, 6).astype(np.int32),
            "step": np.arange(frames, dtype=np.int32)}


def min_image_d(points, atoms, box):
    """float64 |d| [P, N] over the 27 images (orthorhombic)."""
    img = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)], np.float64) * box
    d = points[:, None, None, :] - atoms[None, :, None, :] - img
    return np.sqrt((d * d).sum(-1)).min(axis=2)


def brute_counts(piece, opts):
    probe, chan = opts["probe_radius"], opts["chan_radius"]
    m = opts["num_samples"]
    n = piece["positions"].shape[1]
    k = max(8, m // n)
    radii = ref_pore.radii_of(piece, TINY_ELEMENTS)
    out = {"mask_pairs": 0, "fit_pairs": 0, "surface_pairs": 0,
           "void_faces": 0}
    for f in range(len(piece["positions"])):
        box = np.diag(piece["cell"][f]).astype(np.float64)
        atoms = piece["positions"][f].astype(np.float64) % box
        grid = ref_pore.grid_dims(box, opts["conn_resolution"])
        idx = np.stack(np.meshgrid(*[np.arange(g) for g in grid],
                                   indexing="ij"), -1).reshape(-1, 3)
        centres = (idx + 0.5) / np.asarray(grid) * box
        near = min_image_d(centres, atoms, box) < radii + chan
        out["mask_pairs"] += int(near.sum())
        void = ~near.any(axis=1).reshape(grid)
        pts = ref_pore.mc_points(m).astype(np.float64) * box
        out["fit_pairs"] += int((min_image_d(pts, atoms, box)
                                 < radii + probe).sum())
        dirs = ref_pore.fibonacci_directions(k).astype(np.float64)
        owner = np.repeat(np.arange(n), k)
        p = atoms[owner] + (radii[owner] + probe)[:, None] * np.tile(dirs,
                                                                     (n, 1))
        step = p + 0.2 * np.tile(dirs, (n, 1))

        def on_void(x):
            v = np.minimum(((x / box) % 1.0 * grid).astype(int),
                           np.asarray(grid) - 1)
            return void[v[:, 0], v[:, 1], v[:, 2]]

        cand = np.zeros(n, bool)
        cand[owner[on_void(p) | on_void(step)]] = True
        sel = cand[owner]
        d = min_image_d(p[sel], atoms, box)
        d[np.arange(sel.sum()), owner[sel]] = np.inf
        out["surface_pairs"] += int((d < radii + probe - 1e-4).sum())
        faces = sum(int((np.take(void, range(g - 1), ax)
                         & np.take(void, range(1, g), ax)).sum())
                    for ax, g in enumerate(grid))
        wrap = sum(int((np.take(void, [0], ax)
                        & np.take(void, [g - 1], ax)).sum())
                   for ax, g in enumerate(grid))
        out["void_faces"] += 2 * faces + wrap
    return out, grid, k


@pytest.mark.parametrize("seed", [1, 2])
def test_work_pairs_match_brute_force(seed):
    piece = tiny_piece(seed)
    want, grid, k = brute_counts(piece, TINY_OPTS)
    got = ref_pore.work_counts(piece, TINY_ELEMENTS, TINY_OPTS)
    assert {key: got[key] for key in want} == want
    assert want["surface_pairs"] > 0 and want["void_faces"] > 0
    assert got["voxels"] == grid[0] * grid[1] * grid[2] and got["dirs"] == k
    # each work file's (bytes, operations) from those counts
    config = {"elements": TINY_ELEMENTS}
    traffic = {"options": TINY_OPTS}
    f, n, g = 2, 14, got["voxels"]
    expect = {
        "void_masks_points": (f * (16 * n + 13 * 3000 + g),
                              18 * (want["mask_pairs"] + want["fit_pairs"])),
        "surface_valid_columns": (f * (16 * n + 12 * k + g + 9 * n * k),
                                  18 * want["surface_pairs"]),
        "propagate_fixpoint": (f * 16 * g, want["void_faces"]),
    }
    for name, value in expect.items():
        mod = harness.load_file_module(harness.HERE / "work" / f"{name}.py",
                                       f"test_work_{name}")
        assert mod.work(None, piece, config, traffic) == value, name
