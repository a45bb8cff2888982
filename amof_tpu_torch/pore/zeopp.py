"""
In-process Zeo++-style pore analysis of one frame.

Counterpart of ``amof_tpu/pore/zeopp.py``: the options of the ``network``
binary that the reference shells out to (amof/pore/pysimmzeopp.py:52-158)
with the same defaults and output field names, computed from a distance
field and periodic flood fills:

  -sa  -> ASA_*, NASA_* (per-atom sphere sampling classified by void
          accessibility)
  -vol -> AV_*, NAV_* (voxel integration of the probe-fit region)
  -res -> Included_diameter, Free_diameter, Included_along_free
  -chan -> Number_of_channels, Channel_dimensionality
  -psd -> PSD_* (-dAV/dr histogram) and PSD_GG_* (covering spheres, FFT)
  -volpo -> POAV_*, PONAV_*
  -block -> Number_of_blocking_spheres, Blocking_spheres
  -ray_atom -> RayAtom_* (sphere-marched chords)
  -mass -> per-element mass overrides; extra -> -gridG/-gridBOV,
          -strinfo, -oms, -axs (other flags raise)

The fields, masks, surface tests, FFT and ray march are torch ops on
``device`` ("cuda" by default; "cpu" runs the same ops, and the flood
fill's plain version, on the host); the labels come from kernel #7 on the
card. Scalars come back as Python floats and arrays as numpy arrays, as
in ``amof_tpu``. Radii default to the Zeo++ CSD table
(``data/elements.py``), overridable per element.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from amof_tpu_torch.core import cellmath
from amof_tpu_torch.data import elements
from amof_tpu_torch.warmup import resolve_device

DEFAULT_PROBE_RADIUS = 1.2
DEFAULT_CHAN_RADIUS = 1.2
DEFAULT_NUM_SAMPLES = 50000

# unit conversions
A2_PER_A3_TO_M2_PER_CM3 = 1.0e4
AMU_TO_G = 1.66053906660e-24
A2_TO_M2 = 1.0e-20
A3_TO_CM3 = 1.0e-24


def _grid_dims(cell, resolution):
    """Voxel counts per cell axis for a target spacing, rounded up to
    multiples of 4 (at least 8)."""
    lengths = np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)
    return tuple(
        int(-(-max(8, int(np.ceil(l / resolution))) // 4) * 4)
        for l in lengths
    )


def _frame_inputs(frame, radii, device):
    """(cell f32 numpy, atom radii f32 numpy, and on ``device``: frac
    f32 [N, 3] wrapped into [0, 1), cell, radii)."""
    cell = frame.get_cell().astype(np.float32)
    rad_table = elements.vdw_radius_array(overrides=radii)
    atom_radii = rad_table[frame.get_atomic_numbers()].astype(np.float32)
    frac = cellmath.cart_to_frac(frame.get_positions(), cell).astype(
        np.float32)
    frac = frac - np.floor(frac)
    on = (torch.from_numpy(a).to(device) for a in (frac, cell, atom_radii))
    return (cell, atom_radii, *on)


def analyze_frame(
    frame,
    probe_radius: float = DEFAULT_PROBE_RADIUS,
    chan_radius: float = DEFAULT_CHAN_RADIUS,
    num_samples: int = DEFAULT_NUM_SAMPLES,
    sa: bool = False,
    vol: bool = False,
    res: bool = False,
    psd: bool = False,
    volpo: bool = False,
    chan: bool = False,
    block: bool = False,
    ray_atom: bool = False,
    radii: Optional[Dict[str, float]] = None,
    mass: Optional[Dict[str, float]] = None,
    resolution: float = 0.2,
    grid: Optional[tuple] = None,
    window="auto",
    device="cuda",
) -> Dict[str, float]:
    """Run the requested pore analyses on one frame; returns a flat dict
    keyed by the Zeo++ output-field names.

    ``window`` controls the sorted-window distance field
    (``grid_kernel.distance_grid_windowed``): "auto" sizes it from the
    density when only threshold consumers are requested (-res, -psd,
    -block and -ray_atom need the unclamped field), an int forces that
    width, None disables it. A window miss is detected exactly and falls
    back to the full O(V*N) field."""
    from amof_tpu_torch.pore import grid_kernel, winding

    dev = resolve_device(device)
    cell, atom_radii, frac_t, cell_t, radii_t = _frame_inputs(
        frame, radii, dev)
    volume = cellmath.volume(cell)
    masses = frame.get_masses().astype(np.float64)
    if mass:  # per-element overrides (the Zeo++ -mass file option)
        symbols = np.array(frame.get_chemical_symbols())
        for sym, m in mass.items():
            masses[symbols == sym] = float(m)
    mass_amu = float(np.sum(masses))
    density_g_cm3 = mass_amu * AMU_TO_G / (volume * A3_TO_CM3)

    if grid is None:
        grid = _grid_dims(cell, resolution)
    grid = tuple(int(g) for g in grid)
    dmax = float(max(probe_radius, chan_radius)) + 1e-3
    dxa, dist_window, surf_window = grid_kernel.window_sizes(
        cell, float(atom_radii.max()), len(atom_radii), grid, dmax,
        float(probe_radius), window)
    dist = None
    if dist_window is not None and not res and not psd and not block \
            and not ray_atom:
        # threshold-only consumers: the clamped sorted-window field is
        # exact below dmax
        d_w, missed = grid_kernel.distance_grid_windowed(
            frac_t, cell_t, radii_t, grid, dmax=dmax, dxa=dxa,
            chunk=2048 if dist_window <= 2048 else 1024, window=dist_window)
        if not bool(missed):
            dist = d_w
    if dist is None:
        dist = grid_kernel.distance_grid(frac_t, cell_t, radii_t, grid)
    voxel_volume = volume / (grid[0] * grid[1] * grid[2])

    # accessibility is defined by the channel probe (Zeo++ -sa/-vol pass
    # chan_radius first: pysimmzeopp.py:126-128), with the general
    # displacement-vector winding test
    _, accessible, pocket, chan_dims = winding.void_classification_exact(
        dist >= chan_radius, return_dims=True)
    if probe_radius != chan_radius:
        fit = dist >= probe_radius
        acc_fit = fit & accessible
        poc_fit = fit & ~accessible
    else:
        acc_fit, poc_fit = accessible, pocket

    out: Dict[str, float] = {
        "Unitcell_volume": volume,
        "Density": density_g_cm3,
    }

    if sa:
        acc_counts, nacc_counts, k = _surface_counts(
            frac_t, cell_t, radii_t, atom_radii, cell, float(probe_radius),
            num_samples, accessible, pocket, grid, surf_window)
        sphere_areas = 4 * np.pi * (atom_radii + probe_radius) ** 2
        asa = float(np.sum(sphere_areas * acc_counts / k))
        nasa = float(np.sum(sphere_areas * nacc_counts / k))
        out["ASA_A^2"] = asa
        out["ASA_m^2/cm^3"] = asa / volume * A2_PER_A3_TO_M2_PER_CM3
        out["ASA_m^2/g"] = asa * A2_TO_M2 / (mass_amu * AMU_TO_G)
        out["NASA_A^2"] = nasa
        out["NASA_m^2/cm^3"] = nasa / volume * A2_PER_A3_TO_M2_PER_CM3
        out["NASA_m^2/g"] = nasa * A2_TO_M2 / (mass_amu * AMU_TO_G)

    if vol:
        av = int(acc_fit.sum()) * voxel_volume
        nav = int(poc_fit.sum()) * voxel_volume
        out["AV_A^3"] = av
        out["AV_Volume_fraction"] = av / volume
        out["AV_cm^3/g"] = av * A3_TO_CM3 / (mass_amu * AMU_TO_G)
        out["NAV_A^3"] = nav
        out["NAV_Volume_fraction"] = nav / volume
        out["NAV_cm^3/g"] = nav * A3_TO_CM3 / (mass_amu * AMU_TO_G)

    if res or chan:
        d_max = float(dist.max())
        di = 2.0 * d_max
        # largest free sphere: bisection on the percolation threshold; the
        # float32 field is compared with the threshold rounded to float32
        # (numpy 2's rule for a Python float against a float32 array)
        lo, hi = 0.0, d_max
        for _ in range(20):
            mid = (lo + hi) / 2
            _, acc_mid, _ = winding.void_classification_exact(
                dist >= float(np.float32(mid)))
            if bool(acc_mid.any()):
                lo = mid
            else:
                hi = mid
        df = 2.0 * lo
        _, acc_df, _ = winding.void_classification_exact(
            dist >= float(np.float32(max(lo - 1e-6, 0))))
        dif = 2.0 * float(dist[acc_df].max()) if bool(acc_df.any()) else 0.0
        if res:
            out["Included_diameter"] = di
            out["Free_diameter"] = df
            out["Included_along_free"] = dif
        if chan:
            # channels: winding periodic components at chan_radius, each
            # with the rank of its winding lattice (the classification's
            # own union-find)
            out["Number_of_channels"] = float(len(chan_dims))
            out["Channel_dimensionality"] = float(max(chan_dims, default=0))

    if psd:
        # -dAV/dr over probe radius: histogram of field values on the
        # accessible void, 1000 bins of 0.1 A (pysimmzeopp.py:76)
        d_acc = dist[acc_fit].cpu().numpy()
        hist, edges = np.histogram(2.0 * d_acc,
                                   bins=np.arange(0, 100.1, 0.1))
        out["PSD_bin_A"] = edges[:-1]
        out["PSD_dAV_A^3"] = hist * voxel_volume
        # Gelb-Gubbins covering-sphere PSD: volume per pore-diameter bin
        # of 0.1 A, plus the cumulative curve
        d_max = float(dist.max())
        n_lev = min(-(-(int(np.ceil(d_max / 0.05)) + 1) // 16) * 16, 1001)
        levels = 0.05 * np.arange(n_lev)
        counts = grid_kernel.covering_volume_counts(
            dist, accessible, acc_fit, cell_t, levels.astype(np.float32),
            grid).cpu().numpy()
        vols = np.zeros(1001)
        vols[:n_lev] = counts * voxel_volume
        out["PSD_GG_bin_A"] = 0.1 * np.arange(1000)
        out["PSD_GG_dV_A^3"] = vols[:-1] - vols[1:]
        out["PSD_GG_cum_A^3"] = vols[:-1]

    if ray_atom:
        # -ray_atom (pysimmzeopp.py:133-134): chords of random rays
        # through the accessible void from uniform points in it, sphere-
        # marched on the field; start points and directions from
        # default_rng(12345) on the host
        chords = _ray_chords(dist, acc_fit, cell_t, grid, int(num_samples))
        hist_r, edges_r = np.histogram(chords,
                                       bins=np.arange(0, 100.1, 0.1))
        out["RayAtom_bin_A"] = edges_r[:-1]
        out["RayAtom_hist"] = hist_r.astype(np.float64)
        out["RayAtom_mean_A"] = (float(chords.mean()) if len(chords)
                                 else 0.0)
        out["RayAtom_samples"] = float(len(chords))

    if volpo:
        # probe-occupiable volume: void voxels within probe_radius of a
        # probe-centre voxel (6-neighbour dilation sweeps), split by the
        # accessibility of the seeding centres
        steps = [
            int(np.ceil(probe_radius / (np.linalg.norm(cell[k]) / grid[k])))
            for k in range(3)
        ]
        n_sweeps = max(steps)
        occ = dist >= 0
        po_acc = grid_kernel.dilate(acc_fit, n_sweeps) & occ
        po_nacc = grid_kernel.dilate(poc_fit, n_sweeps) & occ & ~po_acc
        poav = int(po_acc.sum()) * voxel_volume
        ponav = int(po_nacc.sum()) * voxel_volume
        out["POAV_A^3"] = poav
        out["POAV_Volume_fraction"] = poav / volume
        out["POAV_cm^3/g"] = poav * A3_TO_CM3 / (mass_amu * AMU_TO_G)
        out["PONAV_A^3"] = ponav
        out["PONAV_Volume_fraction"] = ponav / volume
        out["PONAV_cm^3/g"] = ponav * A3_TO_CM3 / (mass_amu * AMU_TO_G)

    if block:
        # blocking spheres (Zeo++ -block): cover every inaccessible probe-
        # centre voxel with spheres seeded greedily at the pocket's field
        # maxima: (fractional centre, radius [A]) each
        labels = grid_kernel.label_components(poc_fit, True).cpu().numpy()
        spheres = _blocking_spheres(labels, dist.cpu().numpy(), cell, grid)
        out["Number_of_blocking_spheres"] = float(len(spheres))
        out["Blocking_spheres"] = np.array(
            spheres, dtype=np.float64).reshape(-1, 4)

    return out


def _surface_counts(frac_t, cell_t, radii_t, atom_radii, cell, probe,
                    num_samples, accessible, pocket, grid, surf_window):
    """(acc, nacc) int32 numpy [N] surface-point counts and K, the
    directions per atom: the sorted-window classification where there is
    a window (``surf_window``) and nothing misses, else the full one."""
    from amof_tpu_torch.pore import grid_kernel

    n = len(atom_radii)
    k = max(50, int(num_samples) // max(1, n))
    dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(k)).to(
        frac_t.device)
    if surf_window is not None:
        a_s, n_s, gis, _, missed = (
            grid_kernel.surface_point_classification_windowed(
                frac_t, cell_t, radii_t, probe, dirs, accessible, pocket,
                grid, window=surf_window))
        if not bool(missed):
            gis = gis.cpu().numpy()
            real = gis >= 0
            acc = np.zeros(n, np.int32)
            nacc = np.zeros(n, np.int32)
            acc[gis[real]] = a_s.cpu().numpy()[real]
            nacc[gis[real]] = n_s.cpu().numpy()[real]
            return acc, nacc, k
    acc, nacc = grid_kernel.surface_point_classification(
        frac_t, cell_t, radii_t, probe, dirs, accessible, pocket, grid)
    return acc.cpu().numpy(), nacc.cpu().numpy(), k


def _ray_chords(dist, acc_fit, cell_t, grid, n_rays):
    """f32 numpy chords of up to ``n_rays`` rays from uniform points of
    the accessible void (rejection sampling on the host grid)."""
    from amof_tpu_torch.pore import grid_kernel

    rng = np.random.default_rng(12345)
    acc_np = acc_fit.cpu().numpy()
    gvec = np.array(grid)
    pts = np.zeros((0, 3), np.float32)
    acc_frac = float(acc_np.mean())
    for _ in range(64 if acc_frac > 0 else 0):
        if len(pts) >= n_rays:
            break
        draw = min(int((n_rays - len(pts)) / acc_frac * 1.2) + 64,
                   4_000_000)
        cand = rng.random((draw, 3)).astype(np.float32)
        idx = np.minimum((cand * gvec).astype(int), gvec - 1)
        keep = acc_np[idx[:, 0], idx[:, 1], idx[:, 2]]
        pts = np.concatenate([pts, cand[keep]])
    pts = pts[:n_rays]
    if not len(pts):
        return np.zeros(0, np.float32)
    dirs = rng.normal(size=(len(pts), 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dev = dist.device
    return grid_kernel.ray_chord_lengths(
        dist, torch.from_numpy(pts).to(dev), torch.from_numpy(dirs).to(dev),
        cell_t, 0.0, grid).cpu().numpy()


def _blocking_spheres(labels, dist, cell, grid):
    """Greedy cover of each periodic pocket component (host float64): the
    uncovered voxel with the largest field value seeds a sphere of that
    radius, which covers every voxel of the component within it plus half
    a voxel diagonal."""
    d_np = np.asarray(dist, dtype=np.float64)
    gxyz = np.array(grid, dtype=np.float64)
    cell64 = cell.astype(np.float64)
    voxel_diag = float(
        np.linalg.norm((1.0 / gxyz)[:, None] * cell64, axis=1).max())
    spheres = []
    for lab in np.unique(labels[labels >= 0]):
        idx = np.argwhere(labels == lab)
        fracs = (idx + 0.5) / gxyz
        dvals = d_np[idx[:, 0], idx[:, 1], idx[:, 2]]
        covered = np.zeros(len(idx), bool)
        for _ in range(len(idx)):
            if covered.all():
                break
            i = int(np.argmax(np.where(covered, -np.inf, dvals)))
            c = fracs[i]
            r = float(dvals[i])
            df = fracs - c
            df -= np.round(df)
            dcart = np.linalg.norm(df @ cell64, axis=1)
            covered |= dcart <= r + 0.5 * voxel_diag
            covered[i] = True  # guarantee progress
            spheres.append((c[0], c[1], c[2], r))
    return spheres


def network(frame_or_file, **kwargs) -> Dict[str, float]:
    """Functional counterpart of pysimm's ``network(input, sa=True,
    vol=True, ...)``, in-process: takes a Frame (or an xyz or CIF path) and
    returns the result dict instead of writing .sa/.vol files (parity:
    amof/pore/pysimmzeopp.py:52-158). ``device`` is one of the kwargs
    ("cuda" by default)."""
    frame = frame_or_file
    if isinstance(frame_or_file, str):
        if str(frame_or_file).endswith(".cif"):
            from amof_tpu_torch.io.cif import read_cif

            frame = read_cif(frame_or_file)
        else:
            from amof_tpu_torch.io.xyz import read_xyz

            frame = read_xyz(frame_or_file, 0)
    # translate pysimm kwarg names
    kwargs.pop("ha", None)  # grid resolution already 'high accuracy'
    kwargs.pop("atype_name", None)
    extra = kwargs.pop("extra", None)
    for opt in ("radii", "mass"):
        if opt in kwargs and isinstance(kwargs[opt], str):
            raise ValueError(
                f"{opt} files are not supported; pass a "
                f"{{symbol: value}} dict"
            )
    result = analyze_frame(frame, **kwargs)
    if extra:
        result.update(_run_extra_options(frame, extra, kwargs))
    return result


def _run_extra_options(frame, extra: str, kwargs) -> Dict[str, float]:
    """The in-process subset of the free-form ``extra`` passthrough
    (amof/pore/pysimmzeopp.py:77,136-137): -gridG / -gridBOV (the full
    distance field, returned as an array), -strinfo (structure summary),
    -oms (open-metal-site count), -axs (per-atom accessibility array).
    Any other flag raises NotImplementedError naming it."""
    from amof_tpu_torch.pore import grid_kernel

    out: Dict[str, float] = {}
    tokens = extra.split()
    i = 0
    while i < len(tokens):
        flag = tokens[i]
        if flag in ("-gridG", "-gridBOV"):
            dev = resolve_device(kwargs.get("device", "cuda"))
            cell, _, frac_t, cell_t, radii_t = _frame_inputs(
                frame, kwargs.get("radii"), dev)
            grid = kwargs.get("grid") or _grid_dims(
                cell, kwargs.get("resolution", 0.2))
            grid = tuple(int(g) for g in grid)
            out["Distance_grid"] = grid_kernel.distance_grid(
                frac_t, cell_t, radii_t, grid).cpu().numpy()
            out["Distance_grid_shape"] = np.array(grid, dtype=np.float64)
            i += 1
        elif flag == "-oms":
            # an open metal site: a metal atom with at least one
            # accessible surface sample point at the analysis probe
            out.update(_count_open_metal_sites(frame, kwargs))
            i += 1
        elif flag == "-axs":
            # per-atom accessibility (Zeo++ -axs <probe> <file>) as a bool
            # array; a numeric token sets the probe radius, a file name is
            # accepted and ignored
            i += 1
            axs_kwargs = dict(kwargs)
            while i < len(tokens) and not tokens[i].startswith("-"):
                try:
                    axs_kwargs["probe_radius"] = float(tokens[i])
                except ValueError:
                    pass  # output file name: in-process, ignored
                i += 1
            out["Atom_accessibility"] = _atom_accessibility(frame,
                                                            axs_kwargs)
        elif flag == "-strinfo":
            syms, counts = np.unique(frame.get_chemical_symbols(),
                                     return_counts=True)
            out["Formula"] = "".join(f"{s}{c}" for s, c in zip(syms, counts))
            out["Number_of_atoms"] = float(len(frame))
            out["Unitcell_volume"] = cellmath.volume(frame.get_cell())
            i += 1
        else:
            raise NotImplementedError(
                f"extra Zeo++ option {flag!r} is not supported "
                f"(supported: -gridG, -gridBOV, -strinfo, -oms, -axs)"
            )
    return out


# non-metals excluded from -oms (everything else counts as metal, the
# same breadth as Zeo++'s metal table)
_NON_METALS = frozenset(
    [1, 2, 5, 6, 7, 8, 9, 10, 14, 15, 16, 17, 18, 33, 34, 35, 36,
     52, 53, 54, 85, 86]
)


def _atom_accessibility(frame, kwargs) -> np.ndarray:
    """bool[N]: does the probe reach each atom's surface? (Zeo++ -axs; also
    the -oms exposure test.) Full field and full surface classification."""
    from amof_tpu_torch.pore import grid_kernel, winding

    probe = float(kwargs.get("probe_radius", DEFAULT_PROBE_RADIUS))
    chan = float(kwargs.get("chan_radius", DEFAULT_CHAN_RADIUS))
    num_samples = int(kwargs.get("num_samples", DEFAULT_NUM_SAMPLES))
    dev = resolve_device(kwargs.get("device", "cuda"))
    cell, atom_radii, frac_t, cell_t, radii_t = _frame_inputs(
        frame, kwargs.get("radii"), dev)
    grid = kwargs.get("grid") or _grid_dims(
        cell, kwargs.get("resolution", 0.2))
    grid = tuple(int(g) for g in grid)
    dist = grid_kernel.distance_grid(frac_t, cell_t, radii_t, grid)
    _, accessible, pocket = winding.void_classification_exact(dist >= chan)
    k = max(50, num_samples // max(1, len(atom_radii)))
    dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(k)).to(dev)
    acc_counts, _ = grid_kernel.surface_point_classification(
        frac_t, cell_t, radii_t, probe, dirs, accessible, pocket, grid)
    return acc_counts.cpu().numpy() > 0


def _count_open_metal_sites(frame, kwargs) -> Dict[str, float]:
    """Count metal atoms with probe-accessible surface (-oms)."""
    numbers = frame.get_atomic_numbers()
    is_metal = ~np.isin(numbers, list(_NON_METALS))
    open_sites = is_metal & _atom_accessibility(frame, kwargs)
    return {
        "Number_of_open_metal_sites": float(open_sites.sum()),
        "Number_of_metal_sites": float(is_metal.sum()),
    }
