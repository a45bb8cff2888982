"""Parity of the port's fused step (``FusedAnalysis``, monolithic and
chunked) and of ``pipelines.analyze`` with the JAX package's CPU
``FusedAnalysis`` (one-device mesh), on the same numpy trajectory.

The port runs its kernel path on the CPU: species-blocked RDF layout
(kernel #1's plain version), 2-level slab tables (kernel #3's), and in
the chunked case with K=2 the rerun ladder through the 1-level window
(kernel #4's). The JAX CPU reference runs its XLA paths.

Tolerances (see test_torch_rdf and test_torch_bad_msd for the reasons):
RDF counts, CN counts and overflow flags exact (the trajectory sits on the
dyadic grid in a 32 A box, so float32 sums of volume-weighted counts are
exact in both packages); BAD: exact totals, angles move at most one bin;
MSD: rtol 1e-4, plus 8 float32 ulps of the mean squared centered
position, the size of the terms that cancel in S(m) = S1(m) - 2 AC(m)
(see test_torch_bad_msd).
"""

import numpy as np
import pytest
import torch

from amof_tpu.core.frames import FrameBatch as JaxFrameBatch
from amof_tpu.parallel.mesh import analysis_mesh
from amof_tpu.parallel.pipeline import FusedAnalysis as JaxFused
from amof_tpu_torch import FrameBatch
from amof_tpu_torch.ops import neighbor_kernel
from amof_tpu_torch.parallel.pipeline import FusedAnalysis, resolve_device

from test_torch_bad_msd import assert_bins_within_one

torch.set_num_threads(2)

CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}


def glass(n_frames=6, n_atoms=2048, seed=0, box=32.0, clump_frame=None,
          triclinic=False):
    """bench.py's recipe (Zn(C3N2H3)2 stoichiometry, thermal random walk)
    at 2048 atoms in a 32 A box, positions on a 1/32 A grid. In
    ``clump_frame`` twelve N atoms crowd around the first Zn, which then
    has more than 8 neighbours. ``triclinic`` shears the cell (lower
    triangular, power-of-two diagonal: its float32 inverse stays exact)."""
    rng = np.random.default_rng(seed)
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate(
        [np.full(c, z, np.int32) for z, c in counts.items()])
    base = rng.uniform(0, box, (n_atoms, 3))
    disp = rng.normal(0, 0.1, (n_frames, n_atoms, 3))
    pos = (base[None] + np.cumsum(disp, axis=0)) % box
    if clump_frame is not None:
        n_zn = counts[30]
        off = rng.uniform(-1.0, 1.0, (12, 3))
        pos[clump_frame, n_zn:n_zn + 12] = (pos[clump_frame, 0] + off) % box
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, box / 4
        pos = pos / box @ cell
    pos = (np.round(pos * 32) / 32).astype(np.float32)
    cells = np.tile(cell, (n_frames, 1, 1))
    return pos, cells, species


def _batches(pos, cells, species):
    step = np.arange(len(pos), dtype=np.int32)
    return (FrameBatch(pos, cells, species, step),
            JaxFrameBatch(pos, cells, species, step))


KW = dict(dr=0.02, dtheta=0.5, chunk=128)


@pytest.fixture(scope="module")
def traj():
    return glass(clump_frame=4)


@pytest.fixture(scope="module")
def jax_ref(traj):
    _, jb = _batches(*traj)
    out, meta = JaxFused(CUTOFFS, max_neighbors=32, method="scatter",
                         **KW).run(jb, mesh=analysis_mesh(1))
    return {k: np.asarray(v) for k, v in out.items()}, meta


def msd_atol(pos):
    x = pos.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    return 8 * 2.0**-23 * float((x ** 2).sum(axis=-1).mean())


def _compare(out, ref, pos):
    assert not np.asarray(ref["bad_overflow"]).any()
    np.testing.assert_array_equal(out["bad_overflow"].astype(bool),
                                  np.asarray(ref["bad_overflow"]) != 0)
    assert out["rdf_counts"].shape == ref["rdf_counts"].shape
    np.testing.assert_array_equal(out["rdf_counts"], ref["rdf_counts"])
    np.testing.assert_array_equal(out["cn_counts"], ref["cn_counts"])
    assert float(ref["bad_center_any"].sum()) > 1000
    assert_bins_within_one(out["bad_concrete"], ref["bad_concrete"])
    assert_bins_within_one(out["bad_center_any"], ref["bad_center_any"])
    for key in ("msd", "msd_species"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4,
                                   atol=msd_atol(pos))


def test_monolithic_matches_jax(traj, jax_ref):
    batch, _ = _batches(*traj)
    out, meta = FusedAnalysis(CUTOFFS, max_neighbors=32, **KW).run(
        batch, device="cpu")
    assert meta["blocked"] and meta["ortho"]
    assert meta["bad_slab"] is not None  # the 2-level table ran
    _compare(out, jax_ref[0], traj[0])
    assert list(meta["bad_names"]) == list(jax_ref[1]["bad_names"])


def test_chunked_reruns_match_jax(traj, jax_ref, monkeypatch):
    """At K=8 only the clumped frame flags: it reruns alone at K=16 on
    the 1-level window (kernel #4's plain version), and the result must
    equal the JAX run at ample capacity."""
    calls = []
    plain = neighbor_kernel.window_table_plain
    monkeypatch.setattr(neighbor_kernel, "window_table_plain",
                        lambda *a, **k: calls.append(a[4]) or plain(*a, **k))
    batch, _ = _batches(*traj)
    fa = FusedAnalysis(CUTOFFS, max_neighbors=8, frames_per_call=3,
                       msd_atoms_per_call=512, **KW)
    out, meta = fa.run(batch, device="cpu")
    assert meta["frames_per_call"] == 3
    a_blk = meta["msd_atoms_per_call"]  # the largest divisor <= 512
    assert a_blk <= 512 and meta["n_atoms_padded"] % a_blk == 0
    assert a_blk < meta["n_atoms_padded"]  # MSD really ran in blocks
    assert calls == [16]  # one rerun at doubled K, on the window rung
    _compare(out, jax_ref[0], traj[0])


def test_chunked_matches_jax_chunked_small_k(traj):
    """Same K, same grouping in both packages: the rerun ladders agree."""
    batch, jb = _batches(*traj)
    kw = dict(max_neighbors=4, frames_per_call=2, with_msd=False, **KW)
    ref, _ = JaxFused(CUTOFFS, method="scatter", **kw).run(
        jb, mesh=analysis_mesh(1))
    out, _ = FusedAnalysis(CUTOFFS, **kw).run(batch, device="cpu")
    np.testing.assert_array_equal(out["rdf_counts"], ref["rdf_counts"])
    np.testing.assert_array_equal(out["cn_counts"], ref["cn_counts"])
    assert_bins_within_one(out["bad_center_any"], ref["bad_center_any"])


def test_triclinic_monolithic_matches_jax():
    """rmax stays below half the cell's smallest perpendicular width
    (15.49 A): past it a pair can sit at a fractional separation of
    exactly 1/2 (frequent on the grid), where the round-based minimum
    image picks the image by the sign of j - i, and the port's
    species-blocked atom order differs from the JAX CPU path's."""
    pos, cells, species = glass(n_frames=3, seed=4, triclinic=True)
    batch, jb = _batches(pos, cells, species)
    kw = dict(max_neighbors=32, with_msd=False, rmax=15.0, **KW)
    ref, _ = JaxFused(CUTOFFS, method="scatter", **kw).run(
        jb, mesh=analysis_mesh(1))
    out, meta = FusedAnalysis(CUTOFFS, **kw).run(batch, device="cpu")
    assert not meta["ortho"] and meta["bad_slab"] is not None
    np.testing.assert_array_equal(out["rdf_counts"], ref["rdf_counts"])
    np.testing.assert_array_equal(out["cn_counts"], ref["cn_counts"])
    assert_bins_within_one(out["bad_concrete"], ref["bad_concrete"])


def test_read_xyz_matches_jax():
    import pathlib

    from amof_tpu.io.xyz import read_xyz as jax_read
    from amof_tpu_torch.io.xyz import read_xyz

    path = pathlib.Path(__file__).resolve().parents[1] / "example_reduced.xyz"
    ref, got = jax_read(path, ":"), read_xyz(path, ":")
    assert len(got) == len(ref) > 0
    # single frames and a stepped selection
    got += [read_xyz(path, 0), read_xyz(path, -1), *read_xyz(path, "::2")]
    ref += [jax_read(path, 0), jax_read(path, -1), *jax_read(path, "::2")]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.positions, r.positions)
        np.testing.assert_array_equal(g.numbers, r.numbers)
        np.testing.assert_array_equal(g.cell, r.cell)


def test_unblocked_small_cell_matches_jax():
    """A 272-atom cell pads past 1.5x when species-blocked: the port takes
    kernel #2's path (and the full neighbour table)."""
    pos, cells, species = glass(n_frames=3, n_atoms=272, box=16.0, seed=3)
    batch, jb = _batches(pos, cells, species)
    kw = dict(dr=0.05, dtheta=1.0, chunk=64, max_neighbors=16)
    ref, _ = JaxFused(CUTOFFS, method="scatter", **kw).run(
        jb, mesh=analysis_mesh(1))
    out, meta = FusedAnalysis(CUTOFFS, **kw).run(batch, device="cpu")
    assert not meta["blocked"]
    np.testing.assert_array_equal(out["rdf_counts"], ref["rdf_counts"])
    np.testing.assert_array_equal(out["cn_counts"], ref["cn_counts"])
    assert_bins_within_one(out["bad_concrete"], ref["bad_concrete"])


def test_analyze_dataframes_match_jax(traj, tmp_path):
    from amof_tpu import pipelines as jax_pipelines
    from amof_tpu_torch import pipelines

    pos, cells, species = traj
    batch, jb = _batches(pos[:4], cells[:4], species)
    kw = dict(dr=0.05, dtheta=1.0, chunk=128, delta_time=1)
    ref = jax_pipelines.analyze(jb, CUTOFFS, mesh=analysis_mesh(1),
                                method="scatter", **kw)
    got = pipelines.analyze(batch, CUTOFFS, device="cpu", **kw)
    for key, atol in (("rdf", 0), ("cn", 0), ("msd", msd_atol(pos[:4]))):
        a, b = got[key].data, ref[key].data
        assert list(a.columns) == list(b.columns)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-4,
                                   atol=atol, err_msg=key)
    a, b = got["bad"].data, ref["bad"].data
    assert list(a.columns) == list(b.columns)
    np.testing.assert_allclose(a.sum().to_numpy(), b.sum().to_numpy(),
                               rtol=1e-6)
    got["rdf"].write_to_file(tmp_path / "out")
    from amof_tpu_torch.rdf import Rdf

    back = Rdf.from_file(tmp_path / "out")
    np.testing.assert_array_equal(back.data.to_numpy(),
                                  got["rdf"].data.to_numpy())


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    batch, _ = _batches(*glass(n_frames=2, n_atoms=64, box=8.0))
    with pytest.raises(RuntimeError, match="cuda"):
        FusedAnalysis(CUTOFFS).run(batch)  # device defaults to "cuda"
