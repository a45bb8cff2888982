"""Parity of the port's ``BatchedPore`` (run on the CPU with the kernels'
plain versions) with ``amof_tpu``'s ``BatchedPore`` on its XLA engine
(``surface_engine="xla"``, one-device mesh), on the same numpy
trajectories: the column plan, the distance-field plans (explicit
``grid=``, ``window=None``, cells too small for the columns; voxel and MC
volumes), the window-miss ladder and its per-frame fallback, and
``winding="exact"`` with its per-frame recompute.

Tolerance for the records: rel 1e-5, the bound the JAX package's own
engine-parity test allows (``tests/test_surface_pallas.py``): per voxel,
point and atom the two agree (see the mask, label and surface parity
tests), but the sums run in another order (float64 over one row per atom
in the port, float32 over padded slots in ``amof_tpu``).

The systems are 2 frames of 1024 carbon atoms (vdW radius overridden to
1.5 A) in a 32 A cell with a void slab: the smallest that takes the
column plan (>= 4x4 mask columns, >= 3x3 surface columns with three
windows below the atom count); the distance-field plans also run on 256
atoms in a 16 A cell.
"""

import numpy as np
import pytest
import torch

from amof_tpu.core.frames import FrameBatch as JaxFrameBatch
from amof_tpu.parallel.mesh import analysis_mesh
from amof_tpu.pore.batch import BatchedPore as JaxBatchedPore
from amof_tpu.pore import winding as jwinding
from amof_tpu_torch import FrameBatch
from amof_tpu_torch.pore import BatchedPore, grid_kernel, winding

torch.set_num_threads(2)

KW = dict(resolution=1.0, num_samples=20000, radii={"C": 1.5})


def slab_glass(n_frames=2, n=1024, box=32.0, seed=23, triclinic=False):
    """Positions on a 1/32 A grid in a power-of-two cubic cell (exact
    float32 arithmetic), or a sheared NPT pair (frame f scaled by
    1 + f/16)."""
    rng = np.random.default_rng(seed)
    frac = rng.random((n_frames, n, 3))
    frac[..., 2] *= 0.72
    frac = np.round(frac * 1024) / 1024
    base = np.eye(3) * box
    if triclinic:
        base[1, 0], base[2, 0], base[2, 1] = 2.0, -1.5, 1.75
    cells = np.stack([base * (1 + f / 16 if triclinic else 1)
                      for f in range(n_frames)]).astype(np.float32)
    pos = np.einsum("fni,fij->fnj", frac, cells).astype(np.float32)
    return (pos, cells, np.full(n, 6, np.int32),
            np.arange(n_frames, dtype=np.int32))


def run_port(arrays, **kw):
    return BatchedPore(**{**KW, **kw}).run(FrameBatch(*arrays), device="cpu")


def assert_records_close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for key in a:
            assert a[key] == pytest.approx(b[key], rel=1e-5, abs=1e-6), key


@pytest.mark.parametrize("vol_method,triclinic", [("mc", False),
                                                  ("grid", False),
                                                  ("mc", True)])
def test_records_match_amof_tpu(vol_method, triclinic):
    arrays = slab_glass(triclinic=triclinic)
    ref, ref_meta = JaxBatchedPore(
        surface_engine="xla", vol_method=vol_method, **KW
    ).run(JaxFrameBatch(*arrays), mesh=analysis_mesh(1))
    got, meta = run_port(arrays, vol_method=vol_method)
    assert ref_meta["col_plan"] is not None
    for key in ("grid", "col_plan", "surf_plan", "k", "frames_per_call",
                "mass_amu"):
        assert meta[key] == ref_meta[key], key
    assert set(ref_meta) <= set(meta)
    assert_records_close(got, ref)
    assert all(r["ASA_A^2"] > 0 and r["AV_A^3"] > 0 for r in got)


def test_mc_window_miss_retries_at_2x_and_4x():
    """window_scale 0.25 misses; the 0.5x retry misses again; the 1x
    retry covers, so the records equal a straight run bit for bit."""
    arrays = slab_glass()
    bp = BatchedPore(vol_method="mc", window_scale=0.25, **KW)
    step_fn, args, _ = bp.prepare(FrameBatch(*arrays), device="cpu")
    assert step_fn(*args)[4].all()
    step_fn, args, _ = BatchedPore(
        vol_method="mc", window_scale=0.5, **KW
    ).prepare(FrameBatch(*arrays), device="cpu")
    assert step_fn(*args)[4].all()
    got, _ = bp.run(FrameBatch(*arrays), device="cpu")
    ref, _ = run_port(arrays, vol_method="mc")
    assert got == ref


def run_both(arrays, **kw):
    """(port records, port meta, amof_tpu records, amof_tpu meta)."""
    ref, ref_meta = JaxBatchedPore(surface_engine="xla", **{**KW, **kw}).run(
        JaxFrameBatch(*arrays), mesh=analysis_mesh(1))
    got, meta = run_port(arrays, **kw)
    return got, meta, ref, ref_meta


def test_miss_that_amof_tpu_recomputes_per_frame_raises():
    """Grid mode hands a missed frame to ``zeopp.analyze_frame`` (no
    window, the step's grid), and so does mc mode past 4x windows (the
    fine grid): the port does the same and its records equal
    ``amof_tpu``'s (the test's name is from when the port raised)."""
    got, _, ref, _ = run_both(slab_glass(n_frames=1), vol_method="grid",
                              window_scale=0.5)
    assert_records_close(got, ref)
    # 600 atoms crowd one coarse column: beyond 4x its capacity
    crowded = slab_glass(n_frames=1)
    crowded[0][0, :600, :2] *= 0.15
    got, _, ref, _ = run_both(crowded, vol_method="mc", window_scale=4.0)
    assert_records_close(got, ref)
    step_fn, args, _ = BatchedPore(vol_method="mc", window_scale=4.0,
                                   **KW).prepare(FrameBatch(*crowded),
                                                 device="cpu")
    assert step_fn(*args)[4].all()


def test_off_the_column_plan_raises():
    """Explicit grid=, window=None and a cell too small for the columns
    take the distance-field plan in both packages (the test's name is
    from when the port raised); a bad vol_method still raises."""
    arrays = slab_glass()
    for kw in (dict(grid=(32, 32, 32)), dict(window=None)):
        got, meta, ref, ref_meta = run_both(arrays, **kw)
        assert meta["col_plan"] is None and ref_meta["col_plan"] is None
        assert_records_close(got, ref)
    got, _, ref, _ = run_both(slab_glass(n=200, box=16.0))
    assert_records_close(got, ref)
    assert BatchedPore(winding="exact").winding == "exact"
    with pytest.raises(ValueError):
        BatchedPore(vol_method="voodoo")


FIELD_CASES = [
    (dict(n=256, box=16.0), dict()),
    (dict(n=256, box=16.0), dict(vol_method="mc", num_samples=6000)),
    (dict(n=256, box=16.0, triclinic=True), dict(window=None)),
    (dict(), dict(grid=(32, 32, 32), vol_method="mc")),
    (dict(triclinic=True), dict(grid=(32, 32, 32), probe_radius=1.0)),
    (dict(n=256, box=16.0), dict(grid=(16, 16, 16), window=128)),
]


@pytest.mark.parametrize("system,kw", FIELD_CASES)
def test_field_plans_match_amof_tpu(system, kw):
    """The distance-field plan: the same windows (one-level field, MC
    point window, surface window), directions and grid; the same
    records."""
    got, meta, ref, ref_meta = run_both(slab_glass(**system), **kw)
    for key in ("grid", "dist_window", "surf_window", "dist2", "k",
                "col_plan", "frames_per_call", "mass_amu"):
        assert meta[key] == ref_meta[key], key
    assert_records_close(got, ref)
    assert all(r["ASA_A^2"] > 0 and r["AV_A^3"] > 0 for r in got)


@pytest.mark.parametrize("system,kw", [
    (dict(), dict(vol_method="mc")),
    (dict(n=256, box=16.0), dict()),
])
def test_winding_exact_matches_amof_tpu(system, kw):
    """winding="exact" on the column plan and on the field plan: the face
    pairs of every frame certify the face test (no frame recomputed)."""
    arrays = slab_glass(**system)
    got, _, ref, _ = run_both(arrays, winding="exact", **kw)
    assert_records_close(got, ref)
    face, _ = run_port(arrays, **kw)
    assert got == face
    step_fn, args, meta = BatchedPore(winding="exact", **{**KW, **kw}
                                      ).prepare(FrameBatch(*arrays),
                                                device="cpu")
    faces = step_fn(*args)[5]
    assert faces.shape == (2, 2, len(grid_kernel.face_axis_ids(
        meta["grid"])))


def test_field_plan_with_a_partial_surface_chunk():
    """1000 atoms leave a partial last chunk of 32 sorted centres in the
    windowed surface pass (``amof_tpu``'s sum fails to broadcast there,
    ROADMAP Queue 3): the port's records equal its unwindowed run's."""
    arrays = slab_glass(n=1000)
    got, meta = run_port(arrays, grid=(32, 32, 32))
    assert meta["surf_window"] is not None
    full, meta = run_port(arrays, grid=(32, 32, 32), window=None)
    assert meta["surf_window"] is None
    assert_records_close(got, full)


def test_winding_exact_recomputes_a_flagged_frame(monkeypatch):
    """A frame the certificate refutes is recomputed by
    ``zeopp.analyze_frame`` in both packages (the refutation stubbed in
    both: a composite channel needs a contrived void)."""
    monkeypatch.setattr(jwinding, "face_test_is_exact", lambda p, a: False)
    monkeypatch.setattr(winding, "face_test_is_exact", lambda p, a: False)
    arrays = slab_glass(n=256, box=16.0)
    got, _, ref, _ = run_both(arrays, winding="exact", grid=(16, 16, 16))
    assert_records_close(got, ref)
    face, _ = run_port(arrays, grid=(16, 16, 16))
    assert got != face


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedPore(**KW).run(FrameBatch(*slab_glass()))
