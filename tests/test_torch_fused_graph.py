"""The fused step's slab-rung first pass as one replayable frame
(``parallel/pipeline.py`` ``_FrameGraph``) and the sync-free forms it
needs, held to the forms they replace.

On the CPU: ``cn_from_table``, the slab layout's populations and
``missed``, and ``angle_histograms`` (with and without ``by_cn``, filler
centers and empty slots) equal the masked ``bincount`` / select-then-add
forms bit for bit; the chunked step's group accumulators (run eagerly
here) give the outputs of the chunked step as it ran frame by frame,
an escalated group included; a step function owns its graphs and RDF
sum, and refuses a call that starts while it runs.

On the card (``-m cuda``; skips without one) on the benchmark's bonded
glass network (9792 atoms): the graphed chunked step equals the eager
step bit for bit over two pieces with different ``SlabPlan``s and with a
crowded Zn that escalates a group; a slab-rung frame pass and a group's
replays run under ``torch.cuda.set_sync_debug_mode("error")``; the
counters ``pipeline.frames_graphed`` and ``launch.<kernel>`` count every
replay, and a 272-atom cell (no slab rung) replays nothing; no cycle
collection runs while a graph is captured.

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fused_graph.py -q
"""

import gc

import numpy as np
import pytest
import torch

from amof_tpu_torch import FrameBatch, tracing
from amof_tpu_torch.ops import bad_kernel, pair_engine, slab_table
from amof_tpu_torch.parallel import pipeline
from amof_tpu_torch.parallel.pipeline import RERUNS, FusedAnalysis

torch.set_num_threads(2)

CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}
KW = dict(dr=0.05, dtheta=1.0, chunk=128)


def glass(n_frames=4, n_atoms=1024, seed=0, crowd_frames=()):
    """Zn(C3N2H3)2 stoichiometry at the bench glass's density (1024 atoms
    in a 25.4 A box), a thermal random walk; in each of ``crowd_frames``
    twelve N atoms within 1.7 A of the first Zn."""
    rng = np.random.default_rng(seed)
    box = 25.4
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate(
        [np.full(c, z, np.int32) for z, c in counts.items()])
    base = rng.uniform(0, box, (n_atoms, 3))
    pos = (base[None] + np.cumsum(
        rng.normal(0, 0.1, (n_frames, n_atoms, 3)), axis=0)) % box
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    return crowd(FrameBatch(pos.astype(np.float32), cells, species,
                            np.arange(n_frames, dtype=np.int32)),
                 crowd_frames, int(counts[30]), rng)


def crowd(batch, frames, first_n, rng):
    """Twelve N atoms (rows ``first_n`` on) put within 1.0-1.7 A of atom
    0 (a Zn) in each of ``frames``: that Zn then has more than 8
    neighbours."""
    pos = np.array(batch.positions)
    box = np.diag(batch.cell[0]).astype(np.float64)
    for f in frames:
        off = rng.normal(0, 1, (12, 3))
        off *= (rng.uniform(1.0, 1.7, 12)
                / np.linalg.norm(off, axis=1))[:, None]
        pos[f, first_n:first_n + 12] = (pos[f, 0] + off) % box
    return batch._replace(positions=pos.astype(np.float32))


def step_parts(fa, batch, device, monkeypatch):
    """``fa.prepare`` with the chunked step's configuration kept: (step
    function, args, meta, cfg, MSD atom block)."""
    kept = {}
    make = fa._make_chunked_step

    def keep(cfg, meta, a_blk):
        kept.update(cfg=cfg, a_blk=a_blk)
        return make(cfg, meta, a_blk)

    monkeypatch.setattr(fa, "_make_chunked_step", keep)
    step_fn, args, meta = fa.prepare(batch, device)
    return step_fn, args, meta, kept["cfg"], kept["a_blk"]


def eager_chunked(fa, cfg, a_blk, args):
    """The chunked step as it ran before frame graphs: every first pass
    through ``_frame_pass``, each frame's RDF, CN, flag and flag-masked
    BAD counts added to the step's sums one frame at a time. Returns
    (outputs, rerun tallies)."""
    a = pipeline.StepArgs(*args)
    n_frames = a.positions.shape[0]
    fpc = next(d for d in range(min(fa.frames_per_call, n_frames), 0, -1)
               if n_frames % d == 0)
    reruns = dict.fromkeys(RERUNS, 0)
    sums = pipeline._Sums(cfg, n_frames, a.positions.device)
    rung0 = pipeline._first_rung(cfg)
    for i in range(0, n_frames, fpc):
        k_cap = fa.max_neighbors
        outs = [pipeline._frame_pass(cfg, a, f, k_cap, rung=rung0)
                for f in range(i, i + fpc)]
        for out in outs:
            sums.rdf += out[0].to(torch.float64)
        flags = torch.stack([o[4] for o in outs])
        while (int(flags.sum()) > fpc // 2
               and k_cap < pipeline.MAX_RERUN_CAPACITY):
            k_cap *= 2
            reruns["groups_escalated"] += 1
            outs = [pipeline._frame_pass(cfg, a, f, k_cap, with_rdf=False,
                                         rung=rung0)
                    for f in range(i, i + fpc)]
            flags = torch.stack([o[4] for o in outs])
        for f, out in zip(range(i, i + fpc), outs):
            sums.add(f, out, with_rdf=False)
    fa._rerun_flagged(cfg, a, sums, reruns)
    return fa._finish(a, sums, cfg.n_species, a_blk), reruns


def assert_outputs_equal(got, ref):
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def counted(fn):
    """(fn's result, the registry's counters that moved during it)."""
    before = tracing.snapshot()
    out = fn()
    return out, tracing.diff(tracing.snapshot(), before)["counts"]


# --------------------------------------------------------------------------
# The sync-free forms against the forms they replace (CPU)
# --------------------------------------------------------------------------

def cn_from_table_masked(nbr_sp, center_sp, n_species):
    """``cn_from_table`` as it was: the kept keys selected, then
    ``bincount``."""
    cs, ns = center_sp.long(), nbr_sp.long()
    keep = (cs >= 0)[:, None] & (ns >= 0)
    key = (cs[:, None] * n_species + ns)[keep]
    cn = torch.bincount(key, minlength=n_species * n_species)
    return cn.reshape(n_species, n_species).to(torch.float32)


def accumulate_masked(acc, keys, valid, spread):
    """``bad_kernel._accumulate`` as it was: the valid keys selected,
    then ones added."""
    del spread
    acc.index_add_(0, keys[valid], acc.new_ones(int(valid.sum())))


def random_table(m, k, n_species, seed, empty=0.5, fillers=0.3):
    """A K-slot table of ``m`` centers: species of each slot (-1 empty,
    about ``empty`` of them), of each center (-1 filler, about
    ``fillers``; a filler's slots are all empty), and positions (0 in
    empty slots and at fillers, as kernel #3 writes them) in a 12 A box."""
    rng = np.random.default_rng(seed)
    center_sp = rng.integers(0, n_species, m).astype(np.int32)
    center_sp[rng.uniform(size=m) < fillers] = -1
    nbr_sp = rng.integers(0, n_species, (m, k)).astype(np.int32)
    nbr_sp[rng.uniform(size=(m, k)) < empty] = -1
    nbr_sp[center_sp < 0] = -1
    center_pos = rng.uniform(0, 12, (m, 3)).astype(np.float32)
    center_pos[center_sp < 0] = 0
    nbr_pos = (center_pos[:, None] + rng.normal(0, 1.5, (m, k, 3))).astype(
        np.float32)
    nbr_pos[nbr_sp < 0] = 0
    return [torch.from_numpy(x) for x in (nbr_pos, nbr_sp, center_pos,
                                          center_sp)]


@pytest.mark.parametrize("n_species,k,seed", [(1, 2, 0), (3, 8, 1),
                                              (4, 16, 2), (6, 5, 3)])
def test_cn_from_table_equals_masked_bincount(n_species, k, seed):
    _, nbr_sp, _, center_sp = random_table(700, k, n_species, seed)
    got = pair_engine.cn_from_table(nbr_sp, center_sp, n_species)
    ref = cn_from_table_masked(nbr_sp, center_sp, n_species)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got, ref) and float(ref.sum()) > 0
    # an all-empty table reads zeros
    none = torch.full_like(nbr_sp, -1)
    assert torch.equal(pair_engine.cn_from_table(none, center_sp, n_species),
                       torch.zeros(n_species, n_species))


def test_slab_populations_equal_bincount():
    rng = np.random.default_rng(5)
    for nsx, n in ((3, 10), (18, 10240), (7, 1)):
        slab = torch.from_numpy(rng.integers(0, nsx, n).astype(np.int32))
        got = slab_table.slab_populations(slab, nsx)
        assert torch.equal(got, torch.bincount(slab.long(), minlength=nsx))


def bincount_populations(slab, nsx):
    return torch.bincount(slab.long(), minlength=nsx)


@pytest.mark.parametrize("clump", [False, True])
def test_slab_layout_equals_its_bincount_form(clump, monkeypatch):
    """The layout's five outputs (``missed`` among them) with the
    fixed-size populations equal those with ``bincount``'s, on a glass
    frame as the fused step lays it out and on one whose atoms crowd one
    slab past its capacity."""
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    _, args, meta, _, _ = step_parts(fa, glass(n_frames=1), "cpu",
                                     monkeypatch)
    plan = meta["bad_slab"]
    a = pipeline.StepArgs(*args)
    pos = a.positions[0].clone()
    if clump:
        pos[:300, 0] = pos[:300, 0] * 0.05  # 300 atoms into x < 1.3 A
    got = slab_table.build_slab_layout(pos, a.species_idx, a.cells[0], plan)
    monkeypatch.setattr(slab_table, "slab_populations", bincount_populations)
    ref = slab_table.build_slab_layout(pos, a.species_idx, a.cells[0], plan)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert bool(got[4]) == clump


@pytest.mark.parametrize("by_cn", [False, True])
@pytest.mark.parametrize("n_species,k,seed", [(1, 2, 0), (4, 8, 1),
                                              (3, 16, 2)])
def test_angle_histograms_equal_masked_form(by_cn, n_species, k, seed,
                                            monkeypatch):
    nbr_pos, nbr_sp, center_pos, center_sp = random_table(
        600, k, n_species, seed)
    cell = torch.eye(3) * 12.0
    inv = pair_engine.inverse_cell(cell)
    args = (nbr_pos, nbr_sp, center_pos, center_sp, cell, inv, n_species,
            0.5, 361)
    got = bad_kernel.angle_histograms(*args, by_cn=by_cn)
    # accumulating into ``out`` twice: the same counts doubled
    outs = [torch.zeros(t.shape, dtype=torch.float64) for t in got]
    bad_kernel.angle_histograms(*args, by_cn=by_cn, out=outs)
    bad_kernel.angle_histograms(*args, by_cn=by_cn, out=outs)
    monkeypatch.setattr(bad_kernel, "_accumulate", accumulate_masked)
    ref = bad_kernel.angle_histograms(*args, by_cn=by_cn)
    for g, r, o in zip(got, ref, outs):
        assert g.shape == r.shape and torch.equal(g, r)
        assert torch.equal(o, 2 * r.to(torch.float64))
    assert float(ref[1].sum()) > 0


def test_slab_frame_counts_equal_masked_forms(monkeypatch):
    """A whole slab-rung frame (filler centers and empty slots from the
    layout and kernel #3's plain version): BAD and CN equal the masked
    forms'."""
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    _, args, meta, cfg, _ = step_parts(fa, glass(n_frames=1), "cpu",
                                       monkeypatch)
    assert cfg.bad_slab is not None
    assert cfg.bad_slab.m_centers > meta["n_atoms_padded"]  # fillers
    a = pipeline.StepArgs(*args)
    got = pipeline._frame_pass(cfg, a, 0, 8, rung="slab")
    monkeypatch.setattr(bad_kernel, "_accumulate", accumulate_masked)
    monkeypatch.setattr(pair_engine, "cn_from_table", cn_from_table_masked)
    monkeypatch.setattr(slab_table, "cn_from_table", cn_from_table_masked)
    monkeypatch.setattr(slab_table, "slab_populations", bincount_populations)
    ref = pipeline._frame_pass(cfg, a, 0, 8, rung="slab")
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# --------------------------------------------------------------------------
# The group accumulators, run eagerly (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,crowded", [(8, ()), (8, (1,)), (2, (1,))])
def test_group_accumulators_equal_frame_by_frame_step(k, crowded,
                                                      monkeypatch):
    """Outputs and rerun tallies of the chunked step equal the frame-by-
    frame step's: no flag, a frame rerun on the window, and at K 2 a
    group escalated whole. The CPU replays nothing."""
    batch = glass(crowd_frames=crowded)
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=k, frames_per_call=2)
    step_fn, args, meta, cfg, a_blk = step_parts(fa, batch, "cpu",
                                                 monkeypatch)
    made = frame_graphs_made(monkeypatch)
    assert cfg.bad_slab is not None
    out, counts = counted(lambda: step_fn(*args))
    ref, reruns = eager_chunked(fa, cfg, a_blk, args)
    assert_outputs_equal(out, ref)
    assert meta["reruns"] == reruns
    assert (reruns["groups_escalated"] > 0) == (k == 2)
    assert (reruns["frames_rerun"] > 0) == bool(crowded)
    # the counter is there, at 0
    assert "pipeline.frames_graphed" not in counts
    assert tracing.snapshot()["counts"]["pipeline.frames_graphed"] == 0
    assert "pipeline.graph_captures" not in counts
    # a second call reuses the graphs (one a starting K: the escalated
    # group starts at 4 then) and the RDF sum, and its outputs are its
    # own (the first call's arrays do not move)
    kept = {name: v.copy() for name, v in out.items()}
    again = step_fn(*args)
    assert_outputs_equal(again, ref)
    assert_outputs_equal(out, kept)
    assert len(made) == (2 if k == 2 else 1)


def frame_graphs_made(monkeypatch):
    """The ``_FrameGraph``s made from now on, in a list."""
    made = []

    class Recorded(pipeline._FrameGraph):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(pipeline, "_FrameGraph", Recorded)
    return made


def test_each_prepare_owns_its_graphs(monkeypatch):
    """Two step functions of one object, called in turns, keep graphs and
    RDF sums of their own: each call's outputs equal those of a step
    function that ran alone."""
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    made = frame_graphs_made(monkeypatch)
    steps, alone = [], []
    for n_atoms in (1024, 1300):
        batch = glass(n_frames=2, n_atoms=n_atoms, seed=n_atoms)
        steps.append(fa.prepare(batch, "cpu")[:2])
        step_fn, args, _ = FusedAnalysis(
            CUTOFFS, **KW, max_neighbors=8, frames_per_call=2).prepare(
                batch, "cpu")
        alone.append(step_fn(*args))
    made.clear()
    for (step_fn, args), ref in zip(steps + steps, alone + alone):
        assert_outputs_equal(step_fn(*args), ref)
    assert len(made) == 2
    assert made[0].group.rdf is not made[1].group.rdf


def test_a_running_step_refuses_a_second_call(monkeypatch):
    """A call that starts while the step function runs raises and leaves
    the running call's outputs as they are; a call that raised frees the
    step function for the next."""
    batch = glass()
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    step_fn, args, _ = fa.prepare(batch, "cpu")
    ref = step_fn(*args)
    rerun = fa._rerun_flagged
    refused = []

    def reenter(*a):
        with pytest.raises(RuntimeError, match="running already"):
            step_fn(*args)
        refused.append(True)
        return rerun(*a)

    monkeypatch.setattr(fa, "_rerun_flagged", reenter)
    assert_outputs_equal(step_fn(*args), ref)
    assert refused == [True]

    def fail(*a):
        raise ValueError("planted")

    monkeypatch.setattr(fa, "_rerun_flagged", fail)
    with pytest.raises(ValueError, match="planted"):
        step_fn(*args)
    monkeypatch.setattr(fa, "_rerun_flagged", rerun)
    assert_outputs_equal(step_fn(*args), ref)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph replay vs the eager step)")
    return torch.device("cuda")


GLASS_FRAMES = 16


@pytest.fixture(scope="module")
def net_pieces():
    """Two 16-frame pieces of the benchmark's glass network (9792 atoms,
    drawn on the CPU from one seed) whose slab plans differ."""
    from bench_torch import harness
    from bench_torch.kinds.fused import batch_of

    bench = harness.Bench()
    config = bench.config("zif4-glass-9792")
    pieces = harness.make_pieces(
        config, {"frames_per_piece": GLASS_FRAMES, "pieces": 2}, 12345,
        "cpu")
    return config, [batch_of(p) for p in pieces]


def glass_analysis(config, **kw):
    return FusedAnalysis(config["cutoffs_A"], dr=config["rdf_dr_A"],
                         dtheta=config["bad_dtheta_deg"], chunk=256,
                         **{"max_neighbors": 8, "frames_per_call": 8, **kw})


@pytest.mark.cuda
def test_graphed_step_equals_eager_step_on_two_plans(cuda, net_pieces,
                                                     monkeypatch):
    config, batches = net_pieces
    fa = glass_analysis(config)
    plans = []
    for batch in batches + batches:  # the second round replays only
        step_fn, args, meta, cfg, a_blk = step_parts(fa, batch, cuda,
                                                     monkeypatch)
        plans.append(meta["bad_slab"])
        out, counts = counted(lambda: step_fn(*args))
        ref, reruns = eager_chunked(fa, cfg, a_blk, args)
        assert_outputs_equal(out, ref)
        assert meta["reruns"] == reruns == dict.fromkeys(RERUNS, 0)
        assert counts["pipeline.frames_graphed"] == GLASS_FRAMES
        assert counts["pipeline.frames"] == GLASS_FRAMES
        assert counts["pipeline.graph_captures"] == 1  # its own graph
    assert plans[0] != plans[1] and plans[:2] == plans[2:]


@pytest.mark.cuda
def test_graphed_step_equals_eager_step_with_an_escalated_group(
        cuda, net_pieces, monkeypatch):
    config, batches = net_pieces
    rng = np.random.default_rng(3)
    first_zn = int(np.flatnonzero(batches[0].species == 30)[0])
    first_n = int(np.flatnonzero(batches[0].species == 7)[0])
    pos = np.array(batches[0].positions)
    box = np.diag(batches[0].cell[0]).astype(np.float64)
    for f in range(1, 7):  # 6 of the first group's 8 frames
        off = rng.normal(0, 1, (12, 3))
        off *= (rng.uniform(1.0, 1.7, 12)
                / np.linalg.norm(off, axis=1))[:, None]
        pos[f, first_n:first_n + 12] = (pos[f, first_zn] + off) % box
    batch = batches[0]._replace(positions=pos.astype(np.float32))
    fa = glass_analysis(config)
    step_fn, args, meta, cfg, a_blk = step_parts(fa, batch, cuda,
                                                 monkeypatch)
    out, counts = counted(lambda: step_fn(*args))
    ref, reruns = eager_chunked(fa, cfg, a_blk, args)
    assert_outputs_equal(out, ref)
    assert meta["reruns"] == reruns
    assert reruns["groups_escalated"] >= 1
    assert not out["bad_overflow"].any()
    assert counts["pipeline.frames_graphed"] == GLASS_FRAMES


@pytest.mark.cuda
def test_slab_frame_pass_and_replays_never_wait_for_the_card(
        cuda, net_pieces, monkeypatch):
    config, batches = net_pieces
    fa = glass_analysis(config)
    step_fn, args, meta, cfg, a_blk = step_parts(fa, batches[0], cuda,
                                                 monkeypatch)
    step_fn(*args)  # first launches
    a = pipeline.StepArgs(*args)
    rdf = torch.zeros((cfg.n_species, cfg.n_species, cfg.bins),
                      dtype=torch.float64, device=cuda)
    graph = pipeline._FrameGraph(cfg, a.positions.shape[1], 8, 8, rdf)
    graph.first_pass(a, 0)  # the root check, the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline._frame_pass(cfg, a, 3, 8, rung="slab")
        graph.first_pass(a, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replays_count_frames_and_launches(cuda, net_pieces):
    from bench_torch import harness
    from bench_torch.kinds.fused import batch_of

    config, batches = net_pieces
    fa = glass_analysis(config)
    step_fn, args, _ = fa.prepare(batches[0], cuda)
    for rnd in range(2):
        _, counts = counted(lambda: step_fn(*args))
        captures = counts.get("pipeline.graph_captures", 0)
        assert captures == (1 if rnd == 0 else 0)  # the second replays
        assert counts["pipeline.frames_graphed"] == GLASS_FRAMES
        # every frame launches #1 and #3 once; a capture's eager pass
        # once more
        for name in ("rdf_counts_blocked", "window_table_slab"):
            assert counts["launch." + name] == GLASS_FRAMES + captures
    cell = harness.Bench().config("zif4-cell-272")
    small = harness.make_pieces(cell, {"frames_per_piece": 8, "pieces": 1},
                                7, "cpu")[0]
    fa = FusedAnalysis(cell["cutoffs_A"], dr=cell["rdf_dr_A"],
                       dtheta=cell["bad_dtheta_deg"], chunk=256,
                       max_neighbors=8, frames_per_call=4)
    (out, meta), counts = counted(lambda: fa.run(batch_of(small), cuda))
    assert meta["bad_slab"] is None
    assert counts["pipeline.frames"] == 8
    assert "pipeline.frames_graphed" not in counts
    assert "pipeline.graph_captures" not in counts


@pytest.mark.cuda
def test_no_cycle_collection_while_capturing(cuda, net_pieces, monkeypatch):
    """The collector is off from the capture's start to its end, and on
    again after: a cycle collected mid-capture that held another graph
    (here a step function left in a cycle) would free that graph,
    which CUDA forbids while a stream captures."""
    config, batches = net_pieces
    old = glass_analysis(config)
    step_fn, args, _ = old.prepare(batches[0], cuda)
    _, counts = counted(lambda: step_fn(*args))
    assert counts["pipeline.graph_captures"] == 1
    cycle = [step_fn]
    cycle.append(cycle)
    del old, step_fn, args, cycle
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def begin_and_look(self, *a, **kw):
        seen.append(gc.isenabled())
        begin(self, *a, **kw)
        if gc.isenabled():  # where the collector may run, run it now
            gc.collect()

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        begin_and_look)
    fa = glass_analysis(config)
    step_fn, args, _ = fa.prepare(batches[1], cuda)
    _, counts = counted(lambda: step_fn(*args))
    assert seen == [False] and gc.isenabled()
    assert counts["pipeline.graph_captures"] == 1
    assert counts["pipeline.frames_graphed"] == GLASS_FRAMES
