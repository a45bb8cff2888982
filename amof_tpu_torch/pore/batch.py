"""
Batched pore analysis: Zeo++'s ``-sa -vol`` over every frame of a
trajectory on one device.

Counterpart of ``amof_tpu/pore/batch.py`` ``BatchedPore``. Two plans:

  * the sorted-xy-column plan (the production path at the bench's 10240
    atoms), where the cell holds >= 4x4 reach-wide mask columns and >= 3x3
    surface columns and the caller gave neither ``grid=`` nor
    ``window=None``: probe/channel void masks and MC point fits (kernel
    #5), the channel/pocket classification through two flood-fill
    fixpoints (kernel #7), ``-vol`` from the MC points (or voxel counts),
    the candidate prefilter, the surface blocker pass (kernel #6), the
    point classification and the ASA/NASA sums;
  * the distance-field plan otherwise: the clamped field on a two-level
    (x slab, y window) or one-level sorted window, or the full field
    (``window=None``), its classification (kernel #7), ``-vol`` from the
    voxels or from MC points tested on a sorted window, and per-atom
    surface sampling (sorted window or full).

Frames run in groups of ``frames_per_call``; each group moves one stacked
[5, frames] array to the host. On the card's column plan each frame is
one replay of a CUDA graph of the frame pass (``ops/frame_table.py``
``FrameGraph``, captured once a call), so the host queues a frame in a
few launches instead of ~400 and never waits for the card between
frames; elsewhere the same pass runs eagerly. Grid dims, windows and
sample counts are static per trajectory (computed over all frames, so
NPT cells work); a window miss is flagged exactly per frame. In ``mc``
mode those frames rerun with 2x, then 4x windows; past that, and in
``grid`` mode, they are recomputed by ``zeopp.analyze_frame`` with no
window. With ``winding="exact"`` each frame's wrap-edge label pairs come
to the host and ``winding.face_test_is_exact`` certifies the face test; a
frame with a composite channel the test missed is recomputed the same
way.

Spans and counters (``amof_tpu_torch.tracing``): ``pore.prepare``
(children ``.plan``, ``.upload``), ``pore.frame`` (one frame, first pass
or retry: its inputs' copies and a replay, or an eager pass, whose
children on the column plan are ``pore.masks``, ``pore.labels`` and
``pore.surface``), ``pore.capture``, ``pore.download`` (a group's copy
to the host, which waits for the card) and ``pore.retry`` (the miss
ladder of ``run``); counters ``pore.frames`` (first-pass frames of
``run``), ``pore.frames_missed`` (those the first pass flagged),
``pore.frames_retried`` (frames sent to a widened-window retry, once a
rung), ``pore.frames_per_frame`` (frames recomputed by
``zeopp.analyze_frame``), ``pore.frames_graphed`` and
``pore.graph_captures``.
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.core.cellmath import cell_widths
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import frame_table
from amof_tpu_torch.ops.pair_engine import matvec3
from amof_tpu_torch.pore import grid_kernel, surface_kernel, winding, zeopp
from amof_tpu_torch.pore.zeopp import (
    A2_PER_A3_TO_M2_PER_CM3,
    A2_TO_M2,
    A3_TO_CM3,
    AMU_TO_G,
    DEFAULT_CHAN_RADIUS,
    DEFAULT_NUM_SAMPLES,
    DEFAULT_PROBE_RADIUS,
    _grid_dims,
)
from amof_tpu_torch.warmup import after_warmup, resolve_device, warmup

logger = logging.getLogger(__name__)

_F32 = torch.float32
_F64 = torch.float64
_FOUR_PI = float(np.float32(4.0 * np.pi))


class _Static(NamedTuple):
    """What every frame of one trajectory shares on the column plan
    (device tensors)."""
    radii: torch.Tensor           # f32 [N]
    dirs: torch.Tensor            # f32 [K, 3]
    col_plan: dict
    surf_plan: dict
    probe: float
    chan: float
    pts_tiled: Optional[torch.Tensor]  # f32 [T, P, 3] (mc) or None
    weights: Optional[torch.Tensor]    # f32 [T, P] (mc) or None
    n_real: float


class _FieldStatic(NamedTuple):
    """What every frame shares on the distance-field plan."""
    radii: torch.Tensor           # f32 [N]
    dirs: torch.Tensor            # f32 [K, 3]
    grid: tuple
    probe: float
    chan: float
    dist_window: Optional[int]
    dxa: float
    surf_window: Optional[int]
    mc: Optional[tuple]   # (pts f32 [M, 3] x-sorted, lo f32 [C], hi, window)
    dist2: Optional[tuple]  # (tvx, tvy, nbx, k_slabs, window2, dya)


def _volume(st: _Static, volume, m_probe, accessible, pocket, fit_pts):
    """(AV, NAV) in A^3, float64: the MC estimate (probe fits at the
    sample points, accessibility from the connectivity grid) or voxel
    counts."""
    grid = st.col_plan["grid"]
    vol = volume.to(_F64)
    if st.pts_tiled is not None:
        acc_pt = grid_kernel.grid_lookup(accessible, st.pts_tiled, grid)
        real = st.weights > 0
        n_acc = torch.sum(fit_pts & acc_pt & real).to(_F64)
        n_poc = torch.sum(fit_pts & ~acc_pt & real).to(_F64)
        return vol * n_acc / st.n_real, vol * n_poc / st.n_real
    if st.probe != st.chan:
        acc_fit, poc_fit = m_probe & accessible, m_probe & ~accessible
    else:
        acc_fit, poc_fit = accessible, pocket
    n_vox = grid[0] * grid[1] * grid[2]
    return (torch.sum(acc_fit).to(_F64) * vol / n_vox,
            torch.sum(poc_fit).to(_F64) * vol / n_vox)


def _surface_sums(st: _Static, valid, i_pt, i_nu, gis, rs, accessible,
                  pocket):
    """(ASA, NASA) in A^2, float64: classified valid points times each
    atom's sphere area over K."""
    acc_c, nacc_c = grid_kernel.classify_surface_points(
        valid, i_pt, i_nu, accessible, pocket)
    t = rs + st.probe
    areas = torch.where(gis >= 0, _FOUR_PI * (t * t),
                        torch.zeros_like(rs)).to(_F64)
    k = st.dirs.shape[0]
    return (torch.sum(areas * acc_c) / k, torch.sum(areas * nacc_c) / k)


def _frac(pos, inv):
    frac = matvec3(pos, inv)
    return frac - torch.floor(frac)


def _frame(st: _Static, pos, cell, inv, volume, emit_faces: bool):
    """(f64 [5] = (ASA, NASA, AV, NAV, missed), face label pairs or None)
    of one frame on the column plan."""
    cp, sp = st.col_plan, st.surf_plan
    frac = _frac(pos, inv)
    with tracing.span("pore.masks"):
        m_probe, m_chan, fit_pts, miss_d = surface_kernel.void_masks_points(
            frac, cell, st.radii, cp["grid"], probe=st.probe, chan=st.chan,
            nbx=cp["nbx"], nby=cp["nby"], window=cp["window"],
            pts_tiled=st.pts_tiled)
    with tracing.span("pore.labels"):
        cls = grid_kernel.void_classification_mask(m_chan, emit_faces)
    _, accessible, pocket = cls[:3]
    av, nav = _volume(st, volume, m_probe, accessible, pocket, fit_pts)
    # exact prefilter: points can only count on void voxels, which are
    # exactly m_chan; slots without a candidate atom skip the blockers
    with tracing.span("pore.surface"):
        valid, i_pt, i_nu, gis, rs, miss_s = (
            surface_kernel.surface_valid_columns(
                frac, cell, st.radii, st.probe, st.dirs, cp["grid"],
                nbx=sp["nbx"], nby=sp["nby"], window=sp["window"],
                chunk=sp["chunk"], col_cap=sp["col_cap"], cand_mask=m_chan,
                inv_cell=inv))
        asa, nasa = _surface_sums(st, valid, i_pt, i_nu, gis, rs,
                                  accessible, pocket)
    out = torch.stack([asa, nasa, av, nav, (miss_d | miss_s).to(_F64)])
    return out, (cls[3] if emit_faces else None)


def _frame_field(st: _FieldStatic, pos, cell, inv, volume,
                 emit_faces: bool):
    """(f64 [5] = (ASA, NASA, AV, NAV, missed), face label pairs or None)
    of one frame on the distance-field plan."""
    grid, probe, chan = st.grid, st.probe, st.chan
    dmax = max(probe, chan) + 1e-3
    frac = _frac(pos, inv)
    no_miss = torch.zeros((), dtype=torch.bool, device=pos.device)
    if st.dist2 is not None:
        tvx, tvy, nbx, k_slabs, window2, dya = st.dist2
        dist, miss_d = grid_kernel.distance_grid_windowed2(
            frac, cell, st.radii, grid, dmax=dmax, dxa=st.dxa, dya=dya,
            tvx=tvx, tvy=tvy, nbx=nbx, k_slabs=k_slabs, window=window2)
    elif st.dist_window is not None:
        dist, miss_d = grid_kernel.distance_grid_windowed(
            frac, cell, st.radii, grid, dmax=dmax, dxa=st.dxa,
            chunk=2048 if st.dist_window <= 2048 else 1024,
            window=st.dist_window)
    else:
        dist, miss_d = grid_kernel.distance_grid(frac, cell, st.radii,
                                                 grid), no_miss
    cls = grid_kernel.void_classification(dist, chan, emit_faces)
    _, accessible, pocket = cls[:3]
    if probe != chan:
        fit = dist >= probe
        acc_fit, poc_fit = fit & accessible, fit & ~accessible
    else:
        acc_fit, poc_fit = accessible, pocket

    vol = volume.to(_F64)
    if st.mc is not None:
        # probe fits exactly at the MC points; only the accessible/pocket
        # split comes from the (possibly coarse) connectivity grid
        pts, lo, hi, pwin = st.mc
        d_pts, miss_p = grid_kernel.point_distance_windowed(
            frac, cell, st.radii, pts, lo, hi, dmax=probe + 1e-3,
            dxa=st.dxa, chunk=2048, window=pwin)
        miss_d = miss_d | miss_p
        fit_pt = d_pts >= probe
        acc_pt = grid_kernel.grid_lookup(accessible, pts, grid)
        m_tot = pts.shape[0]
        av = vol * torch.sum(fit_pt & acc_pt).to(_F64) / m_tot
        nav = vol * torch.sum(fit_pt & ~acc_pt).to(_F64) / m_tot
    else:
        n_vox = grid[0] * grid[1] * grid[2]
        av = torch.sum(acc_fit).to(_F64) * vol / n_vox
        nav = torch.sum(poc_fit).to(_F64) * vol / n_vox

    n = st.radii.shape[0]
    if st.surf_window is not None:
        a_s, n_s, _, r_s, miss_s = (
            grid_kernel.surface_point_classification_windowed(
                frac, cell, st.radii, probe, st.dirs, accessible, pocket,
                grid, window=st.surf_window))
        # counts of the sorted atoms, then the chunk's padding rows
        a_s, n_s = a_s[:n], n_s[:n]
    else:
        a_s, n_s = grid_kernel.surface_point_classification(
            frac, cell, st.radii, probe, st.dirs, accessible, pocket, grid)
        r_s, miss_s = st.radii, no_miss
    t = r_s + probe
    areas = (_FOUR_PI * (t * t)).to(_F64)
    k = st.dirs.shape[0]
    asa = torch.sum(areas * a_s) / k
    nasa = torch.sum(areas * n_s) / k
    out = torch.stack([asa, nasa, av, nav, (miss_d | miss_s).to(_F64)])
    return out, (cls[3] if emit_faces else None)


class BatchedPore:
    """-sa/-vol pore analysis over a FrameBatch on one device."""

    def __init__(
        self,
        probe_radius: float = DEFAULT_PROBE_RADIUS,
        chan_radius: float = DEFAULT_CHAN_RADIUS,
        num_samples: int = DEFAULT_NUM_SAMPLES,
        radii: Optional[Dict[str, float]] = None,
        resolution: float = 0.2,
        grid: Optional[tuple] = None,
        window="auto",
        frames_per_call: int = 64,
        vol_method: str = "grid",
        conn_resolution: Optional[float] = None,
        window_scale: float = 1.0,
        winding: str = "face",
    ):
        self.probe_radius = float(probe_radius)
        self.chan_radius = float(chan_radius)
        self.num_samples = int(num_samples)
        self.radii = radii
        self.resolution = float(resolution)
        self.grid = grid
        self.window = window
        # "mc": -vol at num_samples MC points with exact probe-fit tests
        # (Zeo++'s own estimator); the grid then only decides the
        # accessible/pocket split and may be coarser (conn_resolution).
        # A coarse grid closes passages narrower than about one voxel.
        if vol_method not in ("grid", "mc"):
            raise ValueError(f"vol_method must be 'grid' or 'mc', got "
                             f"{vol_method!r}")
        self.vol_method = vol_method
        self.conn_resolution = (
            float(conn_resolution) if conn_resolution else None
        )
        self.frames_per_call = int(frames_per_call)
        # widened-window retry factor for frames whose sorted-run
        # capacities missed (run() escalates 1 -> 2 -> 4)
        self.window_scale = float(window_scale)
        # "face": the device same-label face test (exact for every
        # single-wrap channel); "exact": the face test certified per frame
        # by the host displacement-vector analysis, flagged frames
        # recomputed per frame
        if winding not in ("face", "exact"):
            raise ValueError(
                f"winding must be 'face' or 'exact', got {winding!r}"
            )
        self.winding = winding

    def _column_plans(self, cells, radii, n_at, grid):
        """(col_plan, surf_plan), or None off the column plan (explicit
        grid=, window=None, or a cell too small for the columns)."""
        if self.grid is not None or self.window is None:
            return None
        dmax = max(self.probe_radius, self.chan_radius) + 1e-3
        col_plan = grid_kernel.xycol_plan(
            cells, float(radii.max()), dmax, grid, n_at)
        if col_plan is None:
            return None
        surf_plan = grid_kernel.surface_plan(
            cells, float(radii.max()), self.probe_radius, n_at)
        if surf_plan is None:
            return None
        if self.window_scale != 1.0:
            col_plan["window"] = int(
                -(-col_plan["window"] * self.window_scale // 8) * 8)
            col_plan["n_zc"] = 0
            surf_plan["window"] = int(
                -(-surf_plan["window"] * self.window_scale // 8) * 8)
            surf_plan["col_cap"] = int(
                -(-surf_plan["col_cap"] * self.window_scale
                  // surf_plan["chunk"]) * surf_plan["chunk"])
        return col_plan, surf_plan

    def _field_plan(self, cells, radii, n_at, grid):
        """Static windows of the distance-field plan, conservative over
        the frames (the smallest slab widths): (dxa, dist_window,
        surf_window, dist2, mc sample set or None)."""
        dmax = max(self.probe_radius, self.chan_radius) + 1e-3
        dxa, dist_window, surf_window = grid_kernel.window_sizes(
            cells, float(radii.max()), n_at, grid, dmax, self.probe_radius,
            self.window, self.window_scale)

        # two-level (x slab, y window) field, engaged on a decisive (2x)
        # candidate-work advantage over the one-level window
        dist2 = None
        if self.window == "auto" and dist_window is not None:
            w0y = cell_widths(cells)[1]
            dya = float(np.ceil((dmax + float(radii.max())) / w0y / 5e-3)
                        * 5e-3)
            tvx = next((t for t in (8, 4) if grid[0] % t == 0), None)
            tvy = next((t for t in (16, 8, 4) if grid[1] % t == 0), None)
            if tvx and tvy:
                nbx = max(2, min(64, int(1 / (2 * dxa)) or 2))
                rx = (tvx - 1) / grid[0] + 2 * dxa
                ry = (tvy - 1) / grid[1] + 2 * dya
                k_slabs = int(np.ceil(rx * nbx)) + 1
                if ry < 0.99 and k_slabs <= nbx:
                    window2 = grid_kernel.ceil128(1.3 * n_at * ry / nbx + 64)
                    if k_slabs * window2 * 2 < dist_window:
                        dist2 = (tvx, tvy, nbx, k_slabs, window2, dya)

        mc = None
        if self.vol_method == "mc":
            # one seeded sample set, sorted by x, serves every frame
            chunk_pts = 2048
            m = -(-self.num_samples // chunk_pts) * chunk_pts
            rng = np.random.default_rng(20240817)
            pts = rng.random((m, 3)).astype(np.float32)
            pts = pts[np.argsort(pts[:, 0], kind="stable")]
            lo = np.ascontiguousarray(pts[::chunk_pts, 0])
            hi = np.ascontiguousarray(pts[chunk_pts - 1::chunk_pts, 0])
            pwin = grid_kernel.ceil128(
                1.3 * n_at * (float((hi - lo).max()) + 2 * dxa) + 64)
            mc = (pts, lo, hi, pwin)
        return dxa, dist_window, surf_window, dist2, mc

    def prepare(self, batch, device="cuda"):
        """Resolve static shapes and upload; returns (step_fn, args,
        meta). ``step_fn(*args)`` returns (asa, nasa, av, nav, missed),
        numpy arrays over frames, and with ``winding="exact"`` the face
        label pairs, i32 [frames, 2, n_face]."""
        with tracing.span("pore.prepare"):
            return self._prepare(batch, device)

    def _prepare(self, batch, device):
        dev = resolve_device(device)
        handle = warmup(device=dev)  # build + context overlap the plans
        with tracing.span("pore.prepare.plan"):
            batch = as_frame_batch(batch)
            cells = np.asarray(batch.cell, np.float64)
            rad_table = elements.vdw_radius_array(overrides=self.radii)
            radii = rad_table[np.asarray(batch.species)].astype(np.float32)
            n_at = len(radii)
            volumes = np.abs(np.linalg.det(cells)).astype(np.float32)
            mass_amu = float(np.sum(elements.mass_of(
                np.asarray(batch.species))))

            # static grid dims: conservative per-axis max over NPT frames
            if self.grid is None:
                res = (self.conn_resolution
                       if (self.vol_method == "mc" and self.conn_resolution)
                       else self.resolution)
                grid = _grid_dims(
                    np.linalg.norm(cells, axis=2).max(axis=0)[:, None]
                    * np.eye(3), res)
            else:
                grid = tuple(int(g) for g in self.grid)
            # directions per atom follow Zeo++'s allocation (num_samples
            # over all atom spheres), with a floor of 8
            k = max(8, self.num_samples // max(1, n_at))
            dirs = grid_kernel.fibonacci_sphere(k)
            meta = {"mesh": None, "device": str(dev), "k": k,
                    "mass_amu": mass_amu, "volumes": volumes,
                    "dist_window": None, "surf_window": None, "dist2": None,
                    "col_plan": None, "surf_plan": None}

            plans = self._column_plans(cells, radii, n_at, grid)
            pts_np = w_np = mc = None
            if plans is not None:
                col_plan, surf_plan = plans
                grid = col_plan["grid"]
                if self.vol_method == "mc":
                    rng = np.random.default_rng(20240817)
                    pts = rng.random((self.num_samples, 3)).astype(
                        np.float32)
                    pts_np, w_np = grid_kernel.assign_points_to_xytiles(
                        pts, col_plan)
                meta.update(col_plan=col_plan, surf_plan=surf_plan)
            else:
                dxa, dist_window, surf_window, dist2, mc = self._field_plan(
                    cells, radii, n_at, grid)
                meta.update(dist_window=dist_window, surf_window=surf_window,
                            dist2=dist2)

            # frames per group: the largest divisor of the frame count up
            # to frames_per_call
            n_frames = batch.num_frames
            fpc = next(d for d in range(min(max(self.frames_per_call, 1),
                                            n_frames), 0, -1)
                       if n_frames % d == 0)
            emit_faces = self.winding == "exact"

        with tracing.span("pore.prepare.upload"):
            radii_t = torch.from_numpy(radii).to(dev)
            dirs_t = torch.from_numpy(dirs).to(dev)
            if plans is not None:
                st = _Static(
                    radii=radii_t, dirs=dirs_t, col_plan=col_plan,
                    surf_plan=surf_plan, probe=self.probe_radius,
                    chan=self.chan_radius,
                    pts_tiled=(None if pts_np is None
                               else torch.from_numpy(pts_np).to(dev)),
                    weights=(None if w_np is None
                             else torch.from_numpy(w_np).to(dev)),
                    n_real=float(self.num_samples))
                frame_fn = _frame
            else:
                if mc is not None:
                    pts, lo, hi, pwin = mc
                    mc = (torch.from_numpy(pts).to(dev),
                          torch.from_numpy(lo).to(dev),
                          torch.from_numpy(hi).to(dev), pwin)
                st = _FieldStatic(
                    radii=radii_t, dirs=dirs_t, grid=grid,
                    probe=self.probe_radius, chan=self.chan_radius,
                    dist_window=dist_window, dxa=dxa,
                    surf_window=surf_window, mc=mc, dist2=dist2)
                frame_fn = _frame_field
            cells_t = torch.from_numpy(cells.astype(np.float32))
            args = (
                torch.from_numpy(np.asarray(batch.positions,
                                            np.float32)).to(dev),
                cells_t.to(dev),
                grid_kernel.host_inverse(cells_t).to(dev),
                torch.from_numpy(volumes).to(dev),
            )

        # each frame's pass into column f of ``res`` (and its face pairs
        # into ``faces[f]``): on the card's column plan one CUDA graph
        # replay a frame, captured at the first, no wait for the card in
        # between; eagerly otherwise
        x = {"pos": args[0].new_zeros(args[0].shape[1:]),
             "cell": args[1].new_zeros((3, 3)),
             "inv": args[2].new_zeros((3, 3)),
             "volume": args[3].new_zeros(()),
             "slot": torch.zeros(1, dtype=torch.int64, device=dev)}
        res = torch.zeros((5, n_frames), dtype=_F64, device=dev)
        faces = None
        if emit_faces:
            n_face = len(grid_kernel.face_axis_ids(grid))
            faces = torch.zeros((n_frames, 2, n_face), dtype=torch.int32,
                                device=dev)

        def body():
            out, pairs = frame_fn(st, x["pos"], x["cell"], x["inv"],
                                  x["volume"], emit_faces)
            res.index_copy_(1, x["slot"], out[:, None])
            if emit_faces:
                faces.index_copy_(0, x["slot"], pairs[None])

        graphed = dev.type == "cuda" and frame_fn is _frame
        graph = frame_table.FrameGraph(
            body, x, (res,) if faces is None else (res, faces), "pore",
            graphed=graphed,
            memory=frame_table.capture_memory(dev) if graphed else None)
        slots = torch.arange(n_frames, device=dev)

        def step_fn(positions, cells_f, inv_f, volumes_f):
            groups = []
            for g0 in range(0, n_frames, fpc):
                graph.run(({"pos": positions[f], "cell": cells_f[f],
                            "inv": inv_f[f], "volume": volumes_f[f],
                            "slot": slots[f:f + 1]}
                           for f in range(g0, g0 + fpc)), span="pore.frame")
                with tracing.span("pore.download"):
                    groups.append(res[:, g0:g0 + fpc].cpu().numpy())
            stacked = np.concatenate(groups, axis=1)
            out = tuple(stacked[j] for j in range(4)) + (stacked[4] != 0,)
            if emit_faces:
                out += (faces.cpu().numpy(),)
            return out

        meta.update(grid=grid, frames_per_call=fpc)
        return after_warmup(handle, step_fn), args, meta

    def _per_frame(self, batch, i: int, meta, device):
        """``zeopp.analyze_frame`` -sa/-vol of frame ``i`` with no window:
        grid mode on the step's grid, mc mode on the fine grid (it
        converges to the MC value)."""
        tracing.count("pore.frames_per_frame")
        out = zeopp.analyze_frame(
            batch.frame(int(i)), sa=True, vol=True,
            probe_radius=self.probe_radius, chan_radius=self.chan_radius,
            num_samples=self.num_samples, radii=self.radii,
            resolution=self.resolution,
            grid=meta["grid"] if self.vol_method == "grid" else None,
            window=None, device=device)
        return out["ASA_A^2"], out["NASA_A^2"], out["AV_A^3"], out["NAV_A^3"]

    def _recompute(self, batch, idx, meta, device, cols):
        """The miss ladder: frames ``idx`` flagged by a window miss, their
        entries of ``cols`` (asa, nasa, av, nav) written in place."""
        asa, nasa, av, nav = cols
        if self.vol_method == "mc" and self.window_scale < 4:
            # widened-window retry keeps the -vol column one estimator
            logger.info(
                "sorted-run capacity missed on %d/%d frames; "
                "retrying them with %gx windows",
                len(idx), len(asa), self.window_scale * 2,
            )
            tracing.count("pore.frames_retried", len(idx))
            retry = BatchedPore(
                probe_radius=self.probe_radius,
                chan_radius=self.chan_radius,
                num_samples=self.num_samples, radii=self.radii,
                resolution=self.resolution, grid=self.grid,
                window=self.window,
                frames_per_call=self.frames_per_call,
                vol_method=self.vol_method,
                conn_resolution=self.conn_resolution,
                window_scale=self.window_scale * 2,
                winding=self.winding,
            )
            sub = batch._replace(
                positions=np.asarray(batch.positions)[idx],
                cell=np.asarray(batch.cell)[idx],
                step=np.asarray(batch.step)[idx],
            )
            sub_records, _ = retry._run(sub, device, first=False)
            for j, i in enumerate(idx):
                asa[i] = sub_records[j]["ASA_A^2"]
                nasa[i] = sub_records[j]["NASA_A^2"]
                av[i] = sub_records[j]["AV_A^3"]
                nav[i] = sub_records[j]["NAV_A^3"]
        else:
            # window misses are exact flags: recompute those frames with
            # no window
            logger.info(
                "sorted-window capacity missed on %d/%d frames; "
                "recomputing them exactly", len(idx), len(asa),
            )
            for i in idx:
                asa[i], nasa[i], av[i], nav[i] = self._per_frame(
                    batch, i, meta, device)

    def run(self, batch, device="cuda"):
        """Returns (records, meta): one dict of Zeo++ -sa/-vol output
        fields per frame."""
        return self._run(as_frame_batch(batch), device, first=True)

    def _run(self, batch, device, first):
        """``run``; ``first`` is False for a widened-window retry, whose
        frames the counters of first-pass frames leave out."""
        step_fn, args, meta = self.prepare(batch, device)
        out = step_fn(*args)
        del step_fn, args  # and the frame graph: a retry captures its own
        asa, nasa, av, nav, missed = (np.array(v) for v in out[:5])
        if first:
            tracing.count("pore.frames", len(missed))
            tracing.count("pore.frames_missed", int(missed.sum()))
        if missed.any():
            with tracing.span("pore.retry"):
                self._recompute(batch, np.nonzero(missed)[0], meta, device,
                                (asa, nasa, av, nav))

        if self.winding == "exact":
            # frames the miss handling recomputed already went through an
            # exact path (per frame, or a retry with its own certificate)
            axis_ids = grid_kernel.face_axis_ids(meta["grid"])
            flagged = [
                i for i in range(len(missed))
                if not missed[i]
                and not winding.face_test_is_exact(out[5][i], axis_ids)
            ]
            if flagged:
                logger.info(
                    "face test missed a composite channel on %d/%d "
                    "frames; recomputing them with the exact winding "
                    "analysis", len(flagged), len(missed),
                )
            for i in flagged:
                asa[i], nasa[i], av[i], nav[i] = self._per_frame(
                    batch, i, meta, device)

        volume = meta["volumes"].astype(np.float64)
        mass_g = meta["mass_amu"] * AMU_TO_G
        records = []
        for i in range(len(av)):
            records.append({
                "Unitcell_volume": float(volume[i]),
                "Density": mass_g / (float(volume[i]) * A3_TO_CM3),
                "ASA_A^2": float(asa[i]),
                "ASA_m^2/cm^3": float(asa[i]) / float(volume[i])
                * A2_PER_A3_TO_M2_PER_CM3,
                "ASA_m^2/g": float(asa[i]) * A2_TO_M2 / mass_g,
                "NASA_A^2": float(nasa[i]),
                "NASA_m^2/cm^3": float(nasa[i]) / float(volume[i])
                * A2_PER_A3_TO_M2_PER_CM3,
                "NASA_m^2/g": float(nasa[i]) * A2_TO_M2 / mass_g,
                "AV_A^3": float(av[i]),
                "AV_Volume_fraction": float(av[i]) / float(volume[i]),
                "AV_cm^3/g": float(av[i]) * A3_TO_CM3 / mass_g,
                "NAV_A^3": float(nav[i]),
                "NAV_Volume_fraction": float(nav[i]) / float(volume[i]),
                "NAV_cm^3/g": float(nav[i]) * A3_TO_CM3 / mass_g,
            })
        return records, meta
