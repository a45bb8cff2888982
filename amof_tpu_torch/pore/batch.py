"""
Batched pore analysis: Zeo++'s ``-sa -vol`` over every frame of a
trajectory on one device, on the sorted-xy-column path.

Counterpart of ``amof_tpu/pore/batch.py`` ``BatchedPore`` where its
column plan applies (the production path at the bench's 10240 atoms).
Per frame: probe/channel void masks and MC point fits (kernel #5), the
channel/pocket classification through two flood-fill fixpoints (kernel
#7), ``-vol`` from the MC points (or voxel counts), the candidate
prefilter, the surface blocker pass (kernel #6), the point classification
and the ASA/NASA sums. Frames run in groups of ``frames_per_call``; each
group moves one stacked [5, frames] array to the host.

Grid dims, windows and sample counts are static per trajectory (computed
over all frames, so NPT cells work); a window miss is flagged exactly per
frame, and in ``mc`` mode those frames rerun with 2x, then 4x windows.
Frames that ``amof_tpu`` would hand to its per-frame path
(``zeopp.analyze_frame``: grid mode, or a miss past 4x) raise instead:
that path is not ported yet. So do inputs off the column plan.
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops.pair_engine import matvec3
from amof_tpu_torch.parallel.pipeline import resolve_device
from amof_tpu_torch.pore import grid_kernel, surface_kernel
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
from amof_tpu_torch.warmup import after_warmup, warmup

logger = logging.getLogger(__name__)

_F32 = torch.float32
_F64 = torch.float64
_FOUR_PI = float(np.float32(4.0 * np.pi))


class _Static(NamedTuple):
    """What every frame of one trajectory shares (device tensors)."""
    radii: torch.Tensor           # f32 [N]
    dirs: torch.Tensor            # f32 [K, 3]
    col_plan: dict
    surf_plan: dict
    probe: float
    chan: float
    pts_tiled: Optional[torch.Tensor]  # f32 [T, P, 3] (mc) or None
    weights: Optional[torch.Tensor]    # f32 [T, P] (mc) or None
    n_real: float


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


def _frame(st: _Static, pos, cell, inv, volume):
    """f64 [5] = (ASA, NASA, AV, NAV, missed) of one frame."""
    cp, sp = st.col_plan, st.surf_plan
    frac = matvec3(pos, inv)
    frac = frac - torch.floor(frac)
    m_probe, m_chan, fit_pts, miss_d = surface_kernel.void_masks_points(
        frac, cell, st.radii, cp["grid"], probe=st.probe, chan=st.chan,
        nbx=cp["nbx"], nby=cp["nby"], window=cp["window"],
        pts_tiled=st.pts_tiled)
    _, accessible, pocket = grid_kernel.void_classification_mask(m_chan)
    av, nav = _volume(st, volume, m_probe, accessible, pocket, fit_pts)
    # exact prefilter: points can only count on void voxels, which are
    # exactly m_chan; slots without a candidate atom skip the blockers
    valid, i_pt, i_nu, gis, rs, miss_s = surface_kernel.surface_valid_columns(
        frac, cell, st.radii, st.probe, st.dirs, cp["grid"], nbx=sp["nbx"],
        nby=sp["nby"], window=sp["window"], chunk=sp["chunk"],
        col_cap=sp["col_cap"], cand_mask=m_chan, inv_cell=inv)
    asa, nasa = _surface_sums(st, valid, i_pt, i_nu, gis, rs, accessible,
                              pocket)
    return torch.stack([asa, nasa, av, nav, (miss_d | miss_s).to(_F64)])


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
        if winding not in ("face", "exact"):
            raise ValueError(
                f"winding must be 'face' or 'exact', got {winding!r}"
            )
        if winding == "exact":
            raise NotImplementedError(
                "winding='exact' needs the host winding analysis "
                "(pore/winding.py) and the per-frame path, which are not "
                "ported yet; use winding='face'"
            )
        self.winding = winding

    def _plans(self, cells, radii, n_at):
        """(grid, col_plan, surf_plan); raises NotImplementedError off
        the column plan."""
        if self.grid is not None:
            raise NotImplementedError(
                "an explicit grid= takes the non-column pore path, which "
                "is not ported yet (the column plan chooses its own dims)"
            )
        if self.window is None:
            raise NotImplementedError(
                "window=None takes the unwindowed pore path, which is not "
                "ported yet"
            )
        res = (self.conn_resolution
               if (self.vol_method == "mc" and self.conn_resolution)
               else self.resolution)
        grid = _grid_dims(
            np.linalg.norm(cells, axis=2).max(axis=0)[:, None] * np.eye(3),
            res,
        )
        probe, chan = self.probe_radius, self.chan_radius
        dmax = max(probe, chan) + 1e-3
        col_plan = grid_kernel.xycol_plan(
            cells, float(radii.max()), dmax, grid, n_at)
        surf_plan = None
        if col_plan is not None:
            surf_plan = grid_kernel.surface_plan(
                cells, float(radii.max()), probe, n_at)
        if col_plan is None or surf_plan is None:
            raise NotImplementedError(
                "the cell is too small for the column plan (>= 4x4 "
                "reach-wide mask columns and >= 3x3 surface columns, with "
                "three windows below the atom count); the non-column pore "
                "path is not ported yet"
            )
        if self.window_scale != 1.0:
            col_plan["window"] = int(
                -(-col_plan["window"] * self.window_scale // 8) * 8)
            col_plan["n_zc"] = 0
            surf_plan["window"] = int(
                -(-surf_plan["window"] * self.window_scale // 8) * 8)
            surf_plan["col_cap"] = int(
                -(-surf_plan["col_cap"] * self.window_scale
                  // surf_plan["chunk"]) * surf_plan["chunk"])
        return col_plan["grid"], col_plan, surf_plan

    def prepare(self, batch, device="cuda"):
        """Resolve static shapes and upload; returns (step_fn, args,
        meta). ``step_fn(*args)`` returns (asa, nasa, av, nav, missed),
        numpy arrays over frames."""
        dev = resolve_device(device)
        handle = warmup(device=dev)  # build + context overlap the plans
        batch = as_frame_batch(batch)
        cells = np.asarray(batch.cell, np.float64)
        rad_table = elements.vdw_radius_array(overrides=self.radii)
        radii = rad_table[np.asarray(batch.species)].astype(np.float32)
        n_at = len(radii)
        volumes = np.abs(np.linalg.det(cells)).astype(np.float32)
        mass_amu = float(np.sum(elements.mass_of(np.asarray(batch.species))))

        grid, col_plan, surf_plan = self._plans(cells, radii, n_at)
        # directions per atom follow Zeo++'s allocation (num_samples over
        # all atom spheres), with a floor of 8
        k = max(8, self.num_samples // max(1, n_at))
        dirs = grid_kernel.fibonacci_sphere(k)
        pts_tiled = weights = None
        if self.vol_method == "mc":
            rng = np.random.default_rng(20240817)
            pts = rng.random((self.num_samples, 3)).astype(np.float32)
            pts_np, w_np = grid_kernel.assign_points_to_xytiles(
                pts, col_plan)
            pts_tiled = torch.from_numpy(pts_np).to(dev)
            weights = torch.from_numpy(w_np).to(dev)
        st = _Static(
            radii=torch.from_numpy(radii).to(dev),
            dirs=torch.from_numpy(dirs).to(dev),
            col_plan=col_plan, surf_plan=surf_plan,
            probe=self.probe_radius, chan=self.chan_radius,
            pts_tiled=pts_tiled, weights=weights,
            n_real=float(self.num_samples),
        )

        # frames per group: the largest divisor of the frame count up to
        # frames_per_call
        n_frames = batch.num_frames
        fpc = next(d for d in range(min(max(self.frames_per_call, 1),
                                        n_frames), 0, -1)
                   if n_frames % d == 0)

        cells_t = torch.from_numpy(cells.astype(np.float32))
        args = (
            torch.from_numpy(np.asarray(batch.positions, np.float32)).to(dev),
            cells_t.to(dev),
            grid_kernel.host_inverse(cells_t).to(dev),
            torch.from_numpy(volumes).to(dev),
        )

        def step_fn(positions, cells_f, inv_f, volumes_f):
            groups = []
            for g0 in range(0, n_frames, fpc):
                out = torch.stack([
                    _frame(st, positions[f], cells_f[f], inv_f[f],
                           volumes_f[f])
                    for f in range(g0, g0 + fpc)
                ], dim=1)  # [5, fpc]
                groups.append(out.cpu().numpy())
            stacked = np.concatenate(groups, axis=1)
            return tuple(stacked[j] for j in range(4)) + (stacked[4] != 0,)

        meta = {
            "grid": grid, "mesh": None, "device": str(dev),
            "frames_per_call": fpc, "col_plan": col_plan,
            "surf_plan": surf_plan, "k": k, "mass_amu": mass_amu,
            "volumes": volumes, "dist_window": None, "surf_window": None,
            "dist2": None,
        }
        return after_warmup(handle, step_fn), args, meta

    def run(self, batch, device="cuda"):
        """Returns (records, meta): one dict of Zeo++ -sa/-vol output
        fields per frame."""
        batch = as_frame_batch(batch)
        step_fn, args, meta = self.prepare(batch, device)
        asa, nasa, av, nav, missed = (np.array(v) for v in step_fn(*args))
        if missed.any():
            idx = np.nonzero(missed)[0]
            if self.vol_method == "mc" and self.window_scale < 4:
                # widened-window retry keeps the -vol column one estimator
                logger.info(
                    "sorted-run capacity missed on %d/%d frames; "
                    "retrying them with %gx windows",
                    len(idx), len(missed), self.window_scale * 2,
                )
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
                sub_records, _ = retry.run(sub, device=device)
                for j, i in enumerate(idx):
                    asa[i] = sub_records[j]["ASA_A^2"]
                    nasa[i] = sub_records[j]["NASA_A^2"]
                    av[i] = sub_records[j]["AV_A^3"]
                    nav[i] = sub_records[j]["NAV_A^3"]
            else:
                raise NotImplementedError(
                    f"frames {idx.tolist()} overflowed their sorted-run "
                    f"capacity ({self.vol_method} mode, window scale "
                    f"{self.window_scale:g}); amof_tpu recomputes such "
                    f"frames through the per-frame path "
                    f"(zeopp.analyze_frame), which is not ported yet"
                )

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
