"""
Bond-angle distributions on the card.

Counterpart of ``amof_tpu/bad.py`` (API parity with amof/bad.py):
``Bad.from_trajectory(traj, nb_set_and_cutoff, dtheta=0.05,
normalization='total', parallel, device='cuda')`` with ``.data``
(density-normalized B-A-B columns over ``theta``), the wildcard "X"
enumeration (amof/bad.py:122-133), ``bins = int(180 // dtheta)``,
``theta = arange(bins+1)*dtheta + dtheta/2`` and the '.bad' feather
round-trip; ``BadByCn`` resolves the BAD per coordination number into a
labeled (atom_triple x cn x theta) array with 'total'/'partial'
normalization, serialized as netCDF (``labeled.py``); ``CoreBad.bad_BAB``
is the host-side per-frame helper.

``_compute_counts`` runs on the fused step's frame pass and ladder
(``ops/frame_table.py``): every frame once at K 16 on the table rule's
first rung, each adding its counts unless its flag is up, the flags read
once a call; then only the flagged frames go up the rerun ladder, K
doubling to 1024, after which it raises. Neighbour capacity overflow or
a window miss therefore never drops an angle silently. On the card's
slab rung the first pass replays one CUDA graph a frame, captured by
the call (``_first_pass``); the graph machinery is ``ops/frame_table.py``
``FrameGraph``, shared with the fused step. Counters ``bad.frames``
(first-pass frames), ``bad.frames_graphed`` (those replayed from a
graph), ``bad.graph_captures``; span ``bad.capture``.

The device work lives in pandas-free functions (``bad_columns``,
``bad_by_cn_dataset``); ``Bad`` wraps its columns in a DataFrame (pandas
is imported inside the class).
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

import amof_tpu_torch.files.path
from amof_tpu_torch import labeled, tracing
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.ops import bad_kernel, frame_table
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)

# calls of fewer frames run their first pass eagerly on the card too: a
# capture costs about two eager frames. Measured on an H100 80GB HBM3
# (700 W) with the 9792-atom glass (Zn-N, dtheta 0.05): a capture took
# 10.5-11.9 ms against 5.4-6.4 ms an eager frame, and whole calls of 2, 3
# and 4 frames took 1.33, 0.99 and 0.82 times as long graphed as eager
GRAPH_MIN_FRAMES = 4

def bad_table(counts, names, theta, dtheta):
    """Ordered BAD columns {"theta", one per spec with angles} from the
    spec counts [spec, cn, bins] (amof_tpu/bad.py:234-239)."""
    cols = {"theta": theta}
    angle_counts = np.asarray(counts, np.float64).sum(axis=1)  # over cn
    for s, name in enumerate(names):
        total = angle_counts[s].sum()
        if total > 0:
            cols[name] = angle_counts[s] / (total * dtheta)
    return cols


def _first_pass(plan, a, k_cap: int, dtheta: float, bins: int, by_cn: bool,
                sums):
    """Every frame once at K ``k_cap`` on the plan's first rung: its
    counts into a frame pair shaped as ``sums`` (zeroed first), added
    into the float64 ``sums`` unless its flag is up. Returns the frames'
    flags, bool [F], on the device.

    The frame's body runs through ``frame_table.FrameGraph``: on the
    card's slab rung, in a call of ``GRAPH_MIN_FRAMES`` frames or more,
    one graph replay a frame, captured by this call; eagerly otherwise.
    Counters ``bad.frames`` and ``bad.frames_graphed``."""
    n_frames, n_pad, _ = a.positions.shape
    dev = a.positions.device
    rung = plan.first_rung()
    x = {
        "pos": a.positions.new_zeros((n_pad, 3)),
        "cell": a.cells.new_zeros((3, 3)),
        "inv": a.inv_cells.new_zeros((3, 3)),
        "species": torch.zeros_like(a.species_idx),
        "cutoff": torch.zeros_like(a.cutoff_matrix),
        "slot": torch.zeros(1, dtype=torch.int64, device=dev),
    }
    frame = [torch.zeros_like(acc) for acc in sums]
    flags = torch.zeros(n_frames, dtype=torch.bool, device=dev)

    def body():
        for o in frame:
            o.zero_()
        flag = frame_table.frame_pass(
            plan, x["pos"], x["cell"], x["inv"], x["species"], x["cutoff"],
            k_cap, rung, dtheta, bins, by_cn=by_cn, out=frame)[2]
        frame_table.add_unflagged(*sums, *frame, flag)
        flags.index_copy_(0, x["slot"], flag[None])

    graphed = (dev.type == "cuda" and rung == "slab"
               and n_frames >= GRAPH_MIN_FRAMES)
    graph = frame_table.FrameGraph(
        body, x, (*sums, flags), "bad", graphed=graphed,
        memory=frame_table.capture_memory(dev) if graphed else None)
    graph.load({"species": a.species_idx, "cutoff": a.cutoff_matrix})
    slots = torch.arange(n_frames, device=dev)
    tracing.count("bad.frames", n_frames)
    graph.run({"pos": a.positions[f], "cell": a.cells[f],
               "inv": a.inv_cells[f], "slot": slots[f:f + 1]}
              for f in range(n_frames))
    return flags


def _compute_counts(batch, nb_set_and_cutoff, dtheta, by_cn=False,
                    device="cuda"):
    """Accumulated angle counts [n_specs, cn_slots, bins+1] over all
    frames, the spec names and theta. cn_slots == 1 unless by_cn (the
    BadByCn axis, K + 1 at the largest capacity a frame ended on)."""
    unique, z_to_idx, plan, a = frame_table.entry_table(
        batch, nb_set_and_cutoff, resolve_device(device), with_bad=True)
    pairs, names = frame_table.enumerate_specs(nb_set_and_cutoff, unique)
    specs = frame_table.spec_indices(pairs, z_to_idx)
    bins = int(180 // dtheta) + 1
    theta = np.arange(bins) * dtheta + dtheta / 2
    s = plan.n_species

    def histograms(k):
        """float64 (concrete, center_any) of a frame pass at K ``k``."""
        c = k + 1 if by_cn else 1
        return (a.positions.new_zeros((s, s, c, bins), dtype=torch.float64),
                a.positions.new_zeros((s, c, bins), dtype=torch.float64))

    k0 = frame_table.FIRST_CAPACITY
    sums = histograms(k0)
    flags = _first_pass(plan, a, k0, float(dtheta), bins, by_cn, sums)
    flagged = flags.nonzero().flatten().tolist()  # one wait

    # one buffer a round of the ladder: S^2 (K+1) bins at K 1024
    scratch = functools.lru_cache(maxsize=1)(histograms)

    def rerun(f, k, rung):
        """Frame ``f``'s counts at K ``k`` on ``rung`` into the round's
        buffer (zeroed first); its flag and window miss."""
        out = scratch(k)
        for o in out:
            o.zero_()
        _, _, flag, missed = frame_table.frame_pass(
            plan, a.positions[f], a.cells[f], a.inv_cells[f],
            a.species_idx, a.cutoff_matrix, k, rung, float(dtheta), bins,
            by_cn=by_cn, out=out)
        return flag, missed, out

    def keep(f, out):
        nonlocal sums
        wider = out[0].shape[-2] - sums[0].shape[-2]
        if wider:  # a frame that ends at a larger K: a wider cn axis
            sums = [torch.nn.functional.pad(acc, (0, 0, 0, wider))
                    for acc in sums]
        for acc, o in zip(sums, out):
            acc += o

    if frame_table.rerun_flagged(flagged, k0, plan.window, rerun, keep):
        raise RuntimeError(
            "neighbor capacity exceeded; cutoffs likely unphysical"
        )
    conc, center_any = (x.cpu().numpy() for x in sums)
    counts = np.stack(
        [bad_kernel.select_spec_counts(conc, center_any, sp) for sp in specs]
    )
    return counts, names, theta


def bad_columns(trajectory, nb_set_and_cutoff, dtheta=0.05, device="cuda"):
    """The BAD of a trajectory as ordered numpy columns (what
    ``Bad.from_trajectory`` puts in ``.data``)."""
    batch = as_frame_batch(trajectory)
    logger.info("Start computing bad for %s frames with dtheta = %s",
                batch.num_frames, dtheta)
    counts, names, theta = _compute_counts(batch, nb_set_and_cutoff, dtheta,
                                           device=device)
    return bad_table(counts, names, theta, dtheta)


def bad_by_cn_dataset(trajectory, nb_set_and_cutoff, dtheta=0.05,
                      normalization="total", device="cuda"):
    """BadByCn's ``labeled.Dataset``: variable "bad" over (atom_triple,
    cn, theta), one row per coordination number a spec has angles at;
    'partial' weighs each row by its share of the spec's angles
    (amof_tpu/bad.py:265-299)."""
    batch = as_frame_batch(trajectory)
    logger.info("Start computing bad by cn for %s frames with dtheta = %s",
                batch.num_frames, dtheta)
    counts, names, theta = _compute_counts(batch, nb_set_and_cutoff, dtheta,
                                           by_cn=True, device=device)
    # counts: [spec, cn(K+1), bins]
    per_spec = []
    kept_names = []
    for s, name in enumerate(names):
        cn_totals = counts[s].sum(axis=1)  # [K+1]
        cn_values = np.nonzero(cn_totals > 0)[0]
        if len(cn_values) == 0:
            continue
        num_angles_all = cn_totals.sum()
        rows = []
        for cn in cn_values:
            ratio = (cn_totals[cn] / num_angles_all
                     if normalization == "partial" else 1.0)
            rows.append(ratio * counts[s, cn] / (cn_totals[cn] * dtheta))
        per_spec.append(
            labeled.DataArray(
                np.array(rows),
                coords={"cn": cn_values.astype(np.int64), "theta": theta},
                dims=("cn", "theta"),
            )
        )
        kept_names.append(name)
    if not per_spec:
        return labeled.Dataset()
    arr = labeled.concat(per_spec, "atom_triple", labels=np.array(kept_names),
                         fill=np.nan)
    return labeled.Dataset({"bad": arr.rename("bad")})


class CoreBad:
    """Shared constructors (parity: amof/bad.py:33-59)."""

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, dtheta=0.05,
        normalization="total", parallel=False, device="cuda",
    ):
        """Args:
            nb_set_and_cutoff: dict, 'A-B' pair strings -> cutoff in Å.
            dtheta: bin width in degrees (0.05 default, as RINGS).
            normalization: 'total' or 'partial' (BadByCn only).
        """
        bad_class = cls()
        bad_class.compute_bad(
            trajectory, nb_set_and_cutoff, dtheta, normalization, parallel,
            device,
        )
        return bad_class

    @classmethod
    def from_file(cls, filename):
        bad_class = cls()
        bad_class.read_bad_file(filename)
        return bad_class

    @staticmethod
    def bad_BAB(atom, A, B, nl):
        """B-A-B angles of one frame from a per-atom neighbor-list dict
        (parity: amof/bad.py:71-101). Host-side compatibility helper: the
        analysis path runs the device tables instead.

        Args:
            atom: a Frame (or ASE-compatible) object.
            A, B: atomic numbers, or "X" wildcards.
            nl: {atom index: [neighbor indices]}.
        """
        import itertools

        numbers = atom.get_atomic_numbers()
        angles = []
        for a in range(len(numbers)):
            if A == "X" or numbers[a] == A:
                b_nb = [
                    i for i in nl[a] if B == "X" or numbers[i] == B
                ]
                angle_idx = [
                    [i, a, j] for i, j in itertools.combinations(b_nb, 2)
                ]
                if angle_idx:
                    angles += list(atom.get_angles(angle_idx, mic=True))
        return angles


class Bad(CoreBad):
    """Bond-angle distribution, density-normalized over all frames."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"theta": np.empty([0])})

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False, device="cuda"):
        import pandas as pd

        del normalization, parallel  # parity args; 'total' is the only mode
        self.data = pd.DataFrame(
            bad_columns(trajectory, nb_set_and_cutoff, dtheta, device))

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data.to_feather(filename)

    def read_bad_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "bad")
        self.data = pd.read_feather(path_to_data)


class BadByCn(CoreBad):
    """BAD resolved by coordination number (labeled atom_triple x cn x
    theta array; parity: amof/bad.py:172-309). Needs no pandas."""

    def __init__(self):
        self.data = labeled.Dataset()

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False, device="cuda"):
        del parallel
        self.data = bad_by_cn_dataset(trajectory, nb_set_and_cutoff, dtheta,
                                      normalization, device)

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data.to_netcdf(filename)

    def read_bad_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data = labeled.open_dataset(filename)
