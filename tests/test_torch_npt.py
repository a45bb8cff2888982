"""The fused step on flexible-cell (N,P,T) pieces, where every frame has
its own triclinic cell, and the ``half_cell`` cut at the cells' width.

  * the benchmark's NPT piece at its rehearsal size (``rehearse.small``,
    deformed by ``bench_torch/kinds/npt.py``) against the plain reference
    (``bench_torch/reference/npt.py``, float64), within the cell's limits
    and with CN counts equal;
  * on a sheared cell with the default ``rmax``, RDF counts that do not
    depend on the atoms' order: the cut at half the smallest width keeps
    every pair inside the domain where the minimum image by rounding is
    exact (at half the smallest length, pairs at a fractional separation
    of 1/2 took their image by the sign of j - i);
  * on diagonal cells the rule is the old one, half the smallest length,
    bit for bit, and so are the outputs;
  * the general-cell counter, and ``rdf_columns`` on the same bins.

Plain PyTorch versions on the CPU; no jax.
"""

import numpy as np
import pytest
import torch

from amof_tpu_torch import FrameBatch, tracing
from amof_tpu_torch.core import cellmath
from amof_tpu_torch.parallel.pipeline import FusedAnalysis
from amof_tpu_torch.rdf import rdf_columns
from bench_torch import harness, rehearse
from bench_torch.kinds import fused as fused_kind
from bench_torch.kinds import npt

torch.set_num_threads(2)

BENCH = harness.Bench()
CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}
KW = dict(dr=0.02, dtheta=0.5, chunk=128, max_neighbors=32,
          with_msd=False)


def dyadic_glass(n_frames=2, n_atoms=2048, box=32.0, seed=0,
                 sheared=True):
    """Zn(C3N2H3)2 stoichiometry at random in a 32 A box, positions on a
    1/32 A grid; ``sheared`` tilts the cell (lower triangular, dyadic
    entries, smallest width 30.98 A against lengths of 32 A and more), so
    that pairs at a fractional separation of exactly 1/2 are frequent."""
    rng = np.random.default_rng(seed)
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate(
        [np.full(c, z, np.int32) for z, c in counts.items()])
    frac = rng.uniform(0, 1, (n_frames, n_atoms, 3))
    cell = np.eye(3, dtype=np.float32) * box
    if sheared:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, box / 4
    pos = (np.round(frac @ cell * 32) / 32).astype(np.float32)
    return pos, np.tile(cell, (n_frames, 1, 1)), species


def batch_of(pos, cells, species):
    return FrameBatch(pos, cells, species,
                      np.arange(len(pos), dtype=np.int32))


@pytest.fixture(scope="module")
def small_npt():
    """The benchmark's NPT cell at its rehearsal size: one piece and the
    cell's config, traffic and limits."""
    cell = BENCH.workload("glass9792.npt")
    config, traffic = rehearse.small(BENCH.config(cell["config"]),
                                     harness.load_traffic(cell))
    piece = harness.make_pieces(config, traffic, 2**33 + 7, "cpu")[0]
    limits = harness.load_json(harness.HERE / "limits"
                               / "glass9792.npt.json")
    return config, traffic, piece, limits


def test_npt_piece_matches_the_reference(small_npt):
    config, traffic, piece, limits = small_npt
    before = tracing.snapshot()
    out = npt.Runner(config, traffic, "cpu").unit(piece)
    got = tracing.diff(tracing.snapshot(), before)["counts"]
    ref = npt.reference(config, traffic, piece, "cpu")
    nums = npt.compare(out, ref, config, traffic)
    assert set(nums) == set(limits)
    for name, value in nums.items():
        assert value <= limits[name], (name, value)
    np.testing.assert_array_equal(out["cn_counts"], ref["cn_counts"])
    cells = npt.deformed(piece, config["npt"])["cell"]
    assert len({c.tobytes() for c in cells}) == len(cells)  # a cell a frame
    assert out["rdf_counts"].shape[-1] == int(
        cellmath.half_cell(cells) // config["rdf_dr_A"])
    assert got["pipeline.prepares_width_cut"] == 1
    assert got["pipeline.frames_general_cell"] == len(cells)


def test_deformed_cells_follow_frame_zero(small_npt):
    """The cells come from the piece's frame 0 alone: a copy with frame 1
    altered gets the same cells, another piece other cells; the
    fractional coordinates are the diagonal cell's."""
    config, _, piece, _ = small_npt
    d = npt.deformed(piece, config["npt"])
    assert npt.deformed(piece, config["npt"]) is d  # cached
    pos = piece["positions"].copy()
    pos[1] = pos[1][::-1]
    other = npt.deformed(dict(piece, positions=pos), config["npt"])
    np.testing.assert_array_equal(other["cell"], d["cell"])
    shifted = dict(piece, positions=piece["positions"][::-1].copy())
    assert not np.array_equal(
        npt.deformed(shifted, config["npt"])["cell"], d["cell"])
    h = d["cell"].astype(np.float64)
    assert np.all(np.triu(h, 1) == 0)  # LAMMPS's lower triangle
    frac = np.einsum("fni,fij->fnj", d["positions"].astype(np.float64),
                     np.linalg.inv(h))
    diag = np.diagonal(piece["cell"], axis1=1, axis2=2).astype(np.float64)
    np.testing.assert_allclose(frac, piece["positions"] / diag[:, None],
                               atol=1e-6)


def test_sheared_rdf_counts_do_not_depend_on_atom_order():
    pos, cells, species = dyadic_glass()
    perm = np.random.default_rng(1).permutation(len(species))
    fa = FusedAnalysis(CUTOFFS, **KW)
    out, meta = fa.run(batch_of(pos, cells, species), device="cpu")
    out_p, meta_p = fa.run(batch_of(pos[:, perm], cells, species[perm]),
                           device="cpu")
    assert not meta["ortho"] and float(out["rdf_counts"].sum()) > 0
    np.testing.assert_array_equal(out_p["rdf_counts"], out["rdf_counts"])
    np.testing.assert_array_equal(out_p["cn_counts"], out["cn_counts"])
    assert meta["rmax"] == min(cellmath.cell_widths(cells)) / 2 < 16.0
    assert meta_p["bins"] == meta["bins"] == int(meta["rmax"] // 0.02)


@pytest.mark.parametrize("workload", ["glass9792.fused", "cell272.fused",
                                      "glass9792.entry"])
def test_diagonal_cells_keep_half_the_smallest_length(workload):
    """The three existing cells' configurations (diagonal cells): rmax
    and bins as the old rule gives them, half the smallest length."""
    config = BENCH.config(BENCH.workload(workload)["config"])
    cell = np.diag(np.asarray(config["cell_A"], np.float32))
    cells = np.tile(cell, (2, 1, 1))
    old = float(np.linalg.norm(cells.astype(np.float64), axis=2).min()) / 2
    assert cellmath.half_cell(cells) == old
    dr = config["rdf_dr_A"]
    species = harness.species_of(config)
    pos = (np.random.default_rng(3).uniform(0, 1, (2, len(species), 3))
           * np.diag(cell)).astype(np.float32)
    fa = FusedAnalysis(config["cutoffs_A"], dr=dr, with_msd=False)
    _, _, meta = fa.prepare(batch_of(pos, cells, species), "cpu")
    assert meta["ortho"] and meta["rmax"] == old
    assert meta["bins"] == int(old // dr)


def test_diagonal_outputs_equal_the_old_rules():
    """On a diagonal cell the default cut is the old rule's, 16 A, and
    every output is bit-equal to a run given that rmax."""
    pos, cells, species = dyadic_glass(n_frames=3, sheared=False)
    batch = batch_of(pos, cells, species)
    before = tracing.snapshot()
    out, meta = FusedAnalysis(CUTOFFS, **KW).run(batch, device="cpu")
    got = tracing.diff(tracing.snapshot(), before)["counts"]
    old, old_meta = FusedAnalysis(CUTOFFS, rmax=16.0, **KW).run(
        batch, device="cpu")
    assert meta["rmax"] == old_meta["rmax"] == 16.0
    assert out.keys() == old.keys()
    for name in out:
        np.testing.assert_array_equal(out[name], old[name], err_msg=name)
    assert "pipeline.frames_general_cell" not in got
    assert "pipeline.prepares_width_cut" not in got
    assert got["pipeline.frames"] == 3


@pytest.mark.parametrize("sheared", [True, False])
def test_general_cell_frames_are_counted(sheared):
    pos, cells, species = dyadic_glass(n_frames=3, sheared=sheared)
    before = tracing.snapshot()
    FusedAnalysis(CUTOFFS, frames_per_call=3, **KW).run(
        batch_of(pos, cells, species), device="cpu")
    got = tracing.diff(tracing.snapshot(), before)["counts"]
    assert got["pipeline.frames"] == 3
    assert got.get("pipeline.frames_general_cell", 0) == (3 if sheared
                                                          else 0)
    assert got.get("pipeline.prepares_width_cut", 0) == int(sheared)


def test_rdf_columns_take_the_fused_steps_bins_on_a_sheared_piece(
        small_npt):
    config, _, piece, _ = small_npt
    d = npt.deformed(piece, config["npt"])
    batch = fused_kind.batch_of(d)
    dr = config["rdf_dr_A"]
    cols = rdf_columns(batch, dr=dr, device="cpu")
    _, _, meta = FusedAnalysis(config["cutoffs_A"], dr=dr).prepare(
        batch, "cpu")
    lengths = np.linalg.norm(d["cell"].astype(np.float64), axis=2)
    assert meta["rmax"] < float(lengths.min()) / 2
    assert len(cols["r"]) == meta["bins"]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the general-cell path on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_npt_glass_graphs_every_frame_and_matches_the_reference(
        cuda, monkeypatch):
    """16 frames of the benchmark's NPT glass (9792 atoms, a triclinic
    cell a frame): the slab rung's graphs replay every first pass, equal
    the eager step bit for bit, and hold to the plain reference within
    the cell's limits, CN counts equal."""
    from test_torch_fused_graph import (assert_outputs_equal, counted,
                                        eager_chunked, step_parts)

    cell = BENCH.workload("glass9792.npt")
    config = BENCH.config(cell["config"])
    traffic = dict(harness.load_traffic(cell), frames_per_piece=16,
                   pieces=1)
    piece = harness.make_pieces(config, traffic, 2**31 + 5, "cpu")[0]
    fa = npt.Runner(config, traffic, cuda).fa
    batch = fused_kind.batch_of(npt.deformed(piece, config["npt"]))
    step_fn, args, meta, cfg, a_blk = step_parts(fa, batch, cuda,
                                                 monkeypatch)
    assert not meta["ortho"] and meta["bad_slab"] is not None
    out, counts = counted(lambda: step_fn(*args))
    assert counts["pipeline.frames_graphed"] == 16
    assert counts["pipeline.frames_general_cell"] == 16
    ref, reruns = eager_chunked(fa, cfg, a_blk, args)
    assert_outputs_equal(out, ref)
    assert meta["reruns"] == reruns
    limits = harness.load_json(harness.HERE / "limits"
                               / "glass9792.npt.json")
    plain = npt.reference(config, traffic, piece, cuda)
    for name, value in npt.compare(out, plain, config, traffic).items():
        assert value <= limits[name], (name, value)
    np.testing.assert_array_equal(out["cn_counts"], plain["cn_counts"])
