"""
Ring statistics analysis.

API parity with amof/ring/core.py: ``Ring.from_trajectory(traj,
nb_set_and_cutoff, max_search_depth=32, ...)`` :64,
``from_reduced_trajectory`` :80 with the in_reduced_trajectory /
connectivity_constructible_with_cutoffs gating and stored-cutoff reuse
:92-104, the adaptive search-depth loop (start 16, +4 up to max while
rings potentially remain undiscovered) :251-265, the per-frame
report_search bookkeeping and discard policy :229-272, labeled
(Step x ring_size x ring_var) output with fillna(0) :133-149, and the
'.ring' netCDF + '.report_search.csv' round-trip :274-292.

The RINGS Fortran binary is replaced by: the bond graph from the host
pair search, all-pairs BFS distance matrices on the caller's device
(float32 0/1 matrix products, amof_tpu_torch/ops/graph_kernel.py) and a
C++ primitive/King ring enumerator (amof_tpu_torch/native/ringsearch.cpp,
built with g++ at first use) that implements the Le Roux & Jund (2010) /
Franzblau (1991) shortest-path ring definitions.

``device`` ("cuda" by default; "cpu" runs the same torch code on the
host) selects where the BFS runs. pandas is imported only where a
DataFrame is built or read (``compute_ring``, ``read_rings_output``, an
empty ``report_search``): ``Ring.census`` returns the stacked array and
the per-frame report dicts without it.

Ring variables (per ring size n, in nodes):
    RC   — number of primitive rings of size n in the cell
    PN   — fraction of nodes participating in >=1 ring of size n
    Pmax — fraction of nodes whose largest ring has size n
    Pmin — fraction of nodes whose smallest ring has size n
(the node-probability descriptors of Le Roux & Jund §2.4).
"""

from __future__ import annotations

import ast
import itertools
import logging

import numpy as np
import torch

import amof_tpu_torch.atom as amatom
import amof_tpu_torch.files.path as ampath
import amof_tpu_torch.trajectory
from amof_tpu_torch import labeled, native, tracing
from amof_tpu_torch.core.frames import as_frames
from amof_tpu_torch.ops import graph_kernel
from amof_tpu_torch.ops.neighbors_host import cutoff_dict_to_matrix, neighbor_pairs
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)

RING_VARS = ["RC", "PN", "Pmax", "Pmin"]

# The reference takes its ring_var coordinate verbatim from the
# RINGS-res-5.dat line-2 header (amof/ring/core.py:170-175), whose
# literal spellings vary across RINGS versions/outputs of the same
# quantities — Le Roux & Jund, Comput. Mater. Sci. 49 (2010) 70-83,
# §"connectivity profiles": Rc(n) rings per cell, P_N(n), P_max(n),
# P_min(n). This rebuild uses the canonical short names in RING_VARS
# and normalizes any alias spelling on read, so `.sel(ring_var=...)`
# code works against files written by either implementation.
_RING_VAR_CANONICAL = {
    "rc": "RC",
    "rn": "RC",
    "pn": "PN",
    "pmax": "Pmax",
    "pmin": "Pmin",
}


def normalize_ring_var(name: str) -> str:
    """Map a RINGS header spelling ('Rc(n)', ' P_N(n)', 'pmax', ...) to
    the canonical RING_VARS name; unknown names pass through."""
    key = str(name).strip().lower()
    if key.endswith("(n)"):
        key = key[:-3]
    key = key.replace("_", "")
    return _RING_VAR_CANONICAL.get(key, str(name))


def write_rings_output(rstat_path, ring_arr, potentially_undiscovered,
                       search_depth):
    """Write one frame's census as RINGS-compatible ``rstat`` files —
    the inverse of :meth:`Ring.read_rings_output`.

    Emits ``RINGS-res-5.dat`` (primitive rings: n, RC(n), PN(n),
    Pmax(n), Pmin(n)) and ``RINGS-res-3.dat`` (the
    potentially-undiscovered-rings header) in the literal formats the
    reference parses (amof/ring/core.py:165-173), so downstream tooling
    written against the Fortran binary's on-disk outputs keeps working.
    """
    import pathlib

    rstat_path = pathlib.Path(rstat_path)
    rstat_path.mkdir(parents=True, exist_ok=True)
    # exact spacing required by the reference's regex:
    # '# Number of rings with n >  (.*) nodes which potentialy exist: (.*)'
    (rstat_path / "RINGS-res-3.dat").write_text(
        f"# Number of rings with n >  {int(search_depth)} nodes which "
        f"potentialy exist: {float(potentially_undiscovered):.1f}\n"
    )
    var_axis = ring_arr._axis("ring_var")
    var_order = [normalize_ring_var(v) for v in ring_arr.get_coord("ring_var")]
    lines = [
        "# Primitive ring statistics\n",
        "# n  " + "  ".join(f"{v}(n)" for v in var_order) + "\n",
    ]
    sizes = ring_arr.get_coord("ring_size")
    values = np.moveaxis(np.asarray(ring_arr), var_axis, -1).reshape(
        len(sizes), len(var_order)
    )
    for n, row in zip(sizes, values):
        lines.append(
            f"{int(n)}  " + "  ".join(f"{float(v):.10g}" for v in row) + "\n"
        )
    (rstat_path / "RINGS-res-5.dat").write_text("".join(lines))


def _frame_adjacency(frame, cutoff_dict):
    """Edge-resolved adjacency + per-edge image shifts (periodic).

    Bonds through distinct periodic images are distinct edges; the ring
    engine uses the shifts to reject winding cycles (infinite periodic
    paths masquerading as rings in the quotient graph)."""
    cutoff_matrix = cutoff_dict_to_matrix(cutoff_dict)
    i_idx, j_idx, _, edge_shifts = neighbor_pairs(
        frame.get_positions(), frame.get_cell(), frame.pbc,
        cutoff_matrix, species=frame.get_atomic_numbers(),
    )
    adjacency = [[] for _ in range(len(frame))]
    shifts = [[] for _ in range(len(frame))]
    for i, j, s in zip(i_idx, j_idx, edge_shifts):
        adjacency[i].append(int(j))
        shifts[i].append((int(s[0]), int(s[1]), int(s[2])))
    return adjacency, shifts


def adjacency_matrix(adjacency) -> np.ndarray:
    """Dense bool [n, n] matrix of an adjacency list."""
    adj = np.zeros((len(adjacency), len(adjacency)), bool)
    for i, nbrs in enumerate(adjacency):
        adj[i, nbrs] = True
    return adj


def frame_ring_census(frame, cutoff_dict, max_size, device="cuda"):
    """Primitive-ring census of one frame: the bond graph on the host,
    the all-pairs BFS on ``device``, the enumeration in C++.

    Spans (``amof_tpu_torch.tracing``): ``ring.adjacency`` (the bond graph
    on the host and its copy to the device), ``ring.bfs_copy`` (the BFS
    call until its uint16 matrix is on the host), ``ring.census`` (the
    C++ enumeration), and on a card ``ring.bfs_device`` (the BFS's
    CUDA-event time).

    Returns (rings, potentially_undiscovered, king_count).
    """
    dev = resolve_device(device)
    dist = None
    with tracing.span("ring.adjacency"):
        adjacency, shifts = _frame_adjacency(frame, cutoff_dict)
        if len(frame) > 0:
            adj = torch.from_numpy(adjacency_matrix(adjacency)).to(dev)
    if len(frame) > 0:
        on_card = dev.type == "cuda"
        with tracing.span("ring.bfs_copy"):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            dist = graph_kernel.bfs_distances(adj, max_size)
            if on_card:
                end.record()
            dist = graph_kernel.to_host_uint16(dist)  # waits for the BFS
        if on_card:
            tracing.add_seconds("ring.bfs_device",
                                1e-3 * start.elapsed_time(end))
    with tracing.span("ring.census"):
        return native.ring_census(adjacency, max_size, dist=dist,
                                  shifts=shifts)


def ring_statistics(rings, n_nodes, max_size):
    """(sizes, RC, PN, Pmax, Pmin) arrays from a ring list."""
    sizes_present = sorted({len(r) for r in rings})
    node_sizes = [set() for _ in range(n_nodes)]
    counts = {}
    for r in rings:
        counts[len(r)] = counts.get(len(r), 0) + 1
        for v in r:
            node_sizes[v].add(len(r))
    rows = []
    for n in sizes_present:
        pn = sum(1 for s in node_sizes if n in s) / n_nodes
        pmax = sum(1 for s in node_sizes if s and max(s) == n) / n_nodes
        pmin = sum(1 for s in node_sizes if s and min(s) == n) / n_nodes
        rows.append([counts[n], pn, pmax, pmin])
    if not rows:
        return np.empty(0, np.int64), np.empty((0, len(RING_VARS)), np.float64)
    return np.array(sizes_present, np.int64), np.array(rows, np.float64)


class Ring:
    """Primitive-ring statistics over a trajectory."""

    def __init__(self, max_search_depth=None,
                 discard_if_potentially_undiscovered_rings=False,
                 supercell_fallback=True):
        self.data = labeled.Dataset()
        self.max_search_depth = max_search_depth
        self.discard_if_potentially_undiscovered_rings = (
            discard_if_potentially_undiscovered_rings
        )
        # quotient-graph shortcut distances are exact only for rings
        # smaller than the shortest winding cycle; when a frame's
        # certificate (ring/guard.py) does not cover max_search_depth,
        # rerun the census on a 2x2x2 supercell (RC scaled back by 8)
        # and flag report_search if even that is uncertified
        self.supercell_fallback = bool(supercell_fallback)
        self._report_search = None

    @property
    def report_search(self):
        """Per-frame search report (a DataFrame indexed by Step; empty
        until a census ran)."""
        if self._report_search is None:
            import pandas as pd

            self._report_search = pd.DataFrame({"Step": np.empty([0])})
        return self._report_search

    @report_search.setter
    def report_search(self, value):
        self._report_search = value

    @classmethod
    def from_trajectory(cls, trajectory, nb_set_and_cutoff,
                        max_search_depth=32, delta_Step=1, first_frame=0,
                        parallel=False, write_rstat=None, device="cuda"):
        """Args:
            nb_set_and_cutoff: dict 'A-B' -> cutoff (Å); pairs absent
                from the dict are not bonded.
            max_search_depth: largest ring size (nodes) to search.
            write_rstat: optional directory; when given, per-frame
                RINGS-compatible rstat trees are emitted there
                (see :meth:`write_rstat`).
            device: where the all-pairs BFS runs ("cuda" raises without
                a card; "cpu" runs it on the host).
        """
        ring_class = cls(max_search_depth=max_search_depth)
        frames = as_frames(trajectory)
        nb_list = [nb_set_and_cutoff for _ in range(len(frames))]
        step = amof_tpu_torch.trajectory.construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=len(frames),
        )
        ring_class.compute_ring(frames, nb_list, step, parallel, device)
        if write_rstat is not None:
            ring_class.write_rstat(write_rstat)
        return ring_class

    @classmethod
    def from_reduced_trajectory(cls, reduced_trajectory, max_search_depth=32,
                                discard_if_potentially_undiscovered_rings=False,
                                parallel=False, write_rstat=None,
                                device="cuda"):
        """Ring census of a coarse-grained trajectory, gated on the
        reduction diagnostics (parity: amof/ring/core.py:80-108)."""
        ring_class = cls(
            max_search_depth=max_search_depth,
            discard_if_potentially_undiscovered_rings=(
                discard_if_potentially_undiscovered_rings
            ),
        )
        criteria_to_compute_ring = ["connectivity_constructible_with_cutoffs"]
        criteria_enlarged = ["in_reduced_trajectory"] + criteria_to_compute_ring
        rs = reduced_trajectory.report_search
        rs_traj = rs[rs["in_reduced_trajectory"] == True]  # noqa: E712
        if len(rs_traj) != 0 and all(
            c in rs_traj.columns for c in criteria_to_compute_ring
        ):
            compute_ring = rs[criteria_enlarged].all(axis="columns")
            if np.sum(compute_ring) != 0:
                subset = rs_traj[criteria_to_compute_ring].all(axis="columns")
                nb_list = [
                    ast.literal_eval(i)
                    for i in rs[compute_ring]["nb_set_and_cutoff"]
                ]
                step = np.array(rs[compute_ring].index)
                traj = list(
                    itertools.compress(reduced_trajectory.trajectory, subset)
                )
                ring_class.compute_ring(traj, nb_list, step, parallel,
                                        device)
                if write_rstat is not None:
                    ring_class.write_rstat(write_rstat)
                return ring_class
        logger.info("No valid frame in reduced trajectory")
        return ring_class

    def compute_ring(self, frames, nb_set_and_cutoff_list, step,
                     parallel=False, device="cuda"):
        stacked, reports = self.census(frames, nb_set_and_cutoff_list, step,
                                       parallel, device)
        import pandas as pd

        self.report_search = pd.DataFrame(reports).set_index("Step")
        if stacked is not None:
            self.data = labeled.Dataset({"ring": stacked})

    def census(self, frames, nb_set_and_cutoff_list, step, parallel=False,
               device="cuda"):
        """The census of every frame, without pandas: (the labeled
        (Step x ring_size x ring_var) array of the kept frames, or None if
        none was kept; the per-frame report dicts, in frame order)."""
        logger.info("Start ring analysis for %s frames", len(frames))
        from amof_tpu_torch.parallel.host import parallel_map

        dev = resolve_device(device)
        native.get_lib()  # build/load the C++ enumerator once, outside the pool

        # the census releases the GIL inside the ctypes enumerator
        results = parallel_map(
            lambda args: self.compute_ring_for_frame(*args, device=dev),
            zip(frames, step, nb_set_and_cutoff_list),
            parallel,
        )
        list_report_search = []
        list_of_arrays = []
        kept_steps = []
        for (arr, report), step_i in zip(results, step):
            list_report_search.append(report)
            if arr is not None:
                list_of_arrays.append(arr)
                kept_steps.append(step_i)

        stacked = None
        if list_of_arrays:
            stacked = labeled.concat(
                list_of_arrays, "Step", labels=np.array(kept_steps),
                fill=np.nan,
            ).fillna(0).rename("ring")
        return stacked, list_report_search

    def compute_ring_for_frame(self, frame, step, nb_set_and_cutoff,
                               device="cuda"):
        """Census one frame with the adaptive-depth loop.

        Returns (labeled (ring_size x ring_var) array or None, report)."""
        report_search = {
            "Step": step,
            "Discarded frame": False,
            "max_search_depth": self.max_search_depth,
            "Discard if potentially undiscovered rings":
                self.discard_if_potentially_undiscovered_rings,
            "Rings statistics computed with potentially undiscovered rings":
                False,
        }
        cutoff_dict = amatom.format_cutoff(nb_set_and_cutoff, sort_pair=True)
        # pairs without a cutoff are not bonded (RINGS zero-fill
        # convention, amof/ring/core.py:234-240)

        # primitivity-regime guard (ring/guard.py): the quotient-graph
        # shortcut test is provably exact for ring sizes up to the
        # winding-girth certificate; cell-spanning rings beyond it need
        # the supercell fallback (the reference inherits this regime
        # from the RINGS binary unchecked, amof/ring/core.py:37-49)
        from amof_tpu_torch.ring import guard

        with tracing.span("ring.guard"):
            cutoff_matrix = cutoff_dict_to_matrix(cutoff_dict)
            cert, cert_super = guard.certified_max_ring_sizes(
                frame, cutoff_matrix, frame.get_atomic_numbers(),
                cap=self.max_search_depth,
            )
        census_frame, rc_div, cert_eff = frame, 1, cert
        if self.supercell_fallback and self.max_search_depth > cert:
            census_frame = guard.supercell_frame(frame, (2, 2, 2))
            rc_div, cert_eff = 8, cert_super
            logger.info(
                "primitivity certificate %s < depth %s: census on a "
                "2x2x2 supercell (certified to %s)",
                cert, self.max_search_depth, cert_super,
            )
        report_search["Primitive shortcut exact up to size"] = cert_eff
        report_search["Supercell census"] = rc_div > 1

        search_depth = min(16, self.max_search_depth)
        ring_arr = None
        potentially_undiscovered = np.inf
        while (search_depth <= self.max_search_depth
               and potentially_undiscovered > 0):
            rings, potentially_undiscovered, _king = frame_ring_census(
                census_frame, cutoff_dict, search_depth, device=device
            )
            sizes, rows = ring_statistics(
                rings, len(census_frame), search_depth
            )
            if rc_div > 1 and len(rows):
                rows = rows.copy()
                rows[:, RING_VARS.index("RC")] /= rc_div
            ring_arr = labeled.DataArray(
                rows,
                coords={"ring_size": sizes, "ring_var": np.array(RING_VARS)},
                dims=("ring_size", "ring_var"),
                name="ring",
            )
            report_search["Final search_depth"] = search_depth
            report_search["Potentially undiscovered rings"] = (
                potentially_undiscovered
            )
            search_depth += 4

        final_depth = report_search.get("Final search_depth", 0)
        report_search["Primitivity regime unguaranteed"] = bool(
            final_depth > cert_eff
        )
        if final_depth > cert_eff:
            logger.warning(
                "ring sizes in (%s, %s] are beyond the winding-girth "
                "certificate even on the supercell; quotient shortcut "
                "distances may reject cell-spanning rings",
                cert_eff, final_depth,
            )

        if potentially_undiscovered > 0:
            logger.warning(
                "Rings with n > %s nodes potentialy exist",
                self.max_search_depth,
            )
            report_search[
                "Rings statistics computed with potentially undiscovered rings"
            ] = True
            if self.discard_if_potentially_undiscovered_rings:
                report_search["Discarded frame"] = True
                ring_arr = None
        return ring_arr, report_search

    def write_rstat(self, directory):
        """Emit per-frame RINGS-compatible ``rstat`` trees under
        ``directory/Step-<step>/rstat/`` (see :func:`write_rings_output`;
        the reference leaves these trees in per-frame tempdirs that
        vanish, amof/ring/core.py:242-256 — here they are opt-in
        persistent for tooling that consumes the Fortran binary's
        outputs). Round-trips through :meth:`read_rings_output`."""
        import pathlib

        if "ring" not in self.data:
            return
        directory = pathlib.Path(directory)
        arr = self.data["ring"]
        for step in arr.get_coord("Step"):
            row = self.report_search.loc[step]
            write_rings_output(
                directory / f"Step-{int(step)}" / "rstat",
                arr.sel(Step=step),
                row["Potentially undiscovered rings"],
                row["Final search_depth"],
            )

    def read_rings_output(self, rstat_path):
        """Parse a RINGS ``rstat`` output directory into the same
        (DataArray, potentially_undiscovered_rings) pair the in-process
        search produces (parity: amof/ring/core.py:151-175): primitive
        rings from ``RINGS-res-5.dat`` (literal header names normalized
        to RING_VARS), undiscovered-ring diagnostic from the
        ``RINGS-res-3.dat`` header. Interop for stored outputs of the
        external Fortran binary."""
        import pathlib
        import re

        import pandas as pd

        rstat_path = pathlib.Path(rstat_path)
        with open(rstat_path / "RINGS-res-3.dat") as f:
            first_line = f.readline()
        match = re.search(
            r"# Number of rings with n >\s*(.*) nodes which potentialy "
            r"exist:\s*(.*)", first_line, re.M | re.I,
        )
        potentially_undiscovered = round(float(match.group(2)))

        df = pd.read_csv(
            rstat_path / "RINGS-res-5.dat", header=1, escapechar="#",
            sep=r"\s+",
        )
        df = df.set_index(df.columns[0])
        arr = labeled.DataArray(
            df.to_numpy(),
            coords=[
                ("ring_size", df.index.to_numpy().astype(np.int64)),
                ("ring_var",
                 [normalize_ring_var(str(c).strip()) for c in df.columns]),
            ],
        )
        return arr, potentially_undiscovered

    def write_to_file(self, filename):
        self.data.to_netcdf(ampath.append_suffix(filename, "ring"))
        self.report_search.to_csv(
            ampath.append_suffix(filename, "report_search.csv")
        )

    @classmethod
    def from_file(cls, filename):
        ring_class = cls()
        ring_class.read_ring_file(filename)
        return ring_class

    def read_ring_file(self, filename):
        filename = ampath.append_suffix(filename, "ring")
        self.data = labeled.open_dataset(filename)
        # files written by the reference carry the literal RINGS header
        # spellings in the ring_var coordinate (amof/ring/core.py:
        # 170-175); normalize them so .sel(ring_var=...) code written
        # against either implementation works on both outputs
        for da in self.data.data_vars.values():
            if "ring_var" in da.coords:
                da.coords["ring_var"] = np.array(
                    [normalize_ring_var(v) for v in da.coords["ring_var"]]
                )
