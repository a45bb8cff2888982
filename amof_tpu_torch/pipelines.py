"""
One-call multi-analysis: the fused step with the reference's output
formats.

Counterpart of ``amof_tpu/pipelines.py``: ``analyze(trajectory,
nb_set_and_cutoff, ...)`` runs RDF + CN + BAD + windowed MSD in one pass
on one device and returns the same objects the individual
reference-parity classes hold (``Rdf``/``CoordinationNumber``/``Bad``/
``WindowMsd`` with their ``.data`` / ``write_to_file`` contracts).
"""

from __future__ import annotations

import numpy as np

import amof_tpu_torch.bad as ambad
import amof_tpu_torch.cn as amcn
import amof_tpu_torch.msd as ammsd
import amof_tpu_torch.rdf as amrdf
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.core.step import construct_step
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import bad_kernel
from amof_tpu_torch.parallel.pipeline import FusedAnalysis
from amof_tpu_torch.rdf import shell_volumes


def analyze(
    trajectory,
    nb_set_and_cutoff,
    dr=0.01,
    rmax=None,
    dtheta=0.05,
    delta_Step=1,
    first_frame=0,
    delta_time=100,
    max_time="half",
    timestep=1,
    device="cuda",
    **fused_kwargs,
):
    """Fused RDF+CN+BAD+MSD over a trajectory on ``device``.

    Args mirror the individual classes (amof/rdf.py:38, cn.py:35,
    bad.py:39, msd.py:157). Returns a dict with keys 'rdf', 'cn', 'bad',
    'msd' holding the corresponding analysis objects.
    """
    import pandas as pd

    batch = as_frame_batch(trajectory)
    fa = FusedAnalysis(
        nb_set_and_cutoff, dr=dr, rmax=rmax, dtheta=dtheta,
        with_bad=True, with_msd=True, **fused_kwargs,
    )
    out, meta = fa.run(batch, device=device)
    unique = list(meta["unique"])
    n_frames = batch.num_frames
    n_atoms = batch.num_atoms
    species = np.asarray(batch.species)
    step = construct_step(
        delta_Step=delta_Step, first_frame=first_frame,
        number_of_frames=n_frames,
    )

    # ---- RDF (normalization identical to amof_tpu.rdf.Rdf) --------------
    rdf_obj = amrdf.Rdf()
    bins = meta["bins"]
    r = np.arange(bins) * dr
    counts = np.asarray(out["rdf_counts"], dtype=np.float64)
    v_shell = shell_volumes(bins, dr)
    n_per_species = np.array(
        [(species == z).sum() for z in unique], dtype=np.float64
    )
    data = pd.DataFrame({"r": r})
    data["X-X"] = counts.sum(axis=(0, 1)) / (
        n_frames * n_atoms * n_atoms * v_shell
    )
    partial = {}
    for i, za in enumerate(unique):
        for j, zb in enumerate(unique):
            name = f"{elements.symbol_of(za)}-{elements.symbol_of(zb)}"
            g = counts[i, j] / (n_frames * n_per_species[i] * n_atoms * v_shell)
            partial[(i, j)] = g
            data[name] = g
    for i, za in enumerate(unique):
        data[f"{elements.symbol_of(za)}-X"] = sum(
            partial[(i, j)] for j in range(len(unique))
        )
    rdf_obj.data = data

    # ---- CN ---------------------------------------------------------------
    cn_obj = amcn.CoordinationNumber()
    cn_counts = np.asarray(out["cn_counts"], dtype=np.float64)
    cn_data = {"Step": step}
    for nb_set in nb_set_and_cutoff:
        a, b = (elements.atomic_numbers[s] for s in nb_set.split("-"))
        ia, ib = unique.index(a), unique.index(b)
        with np.errstate(invalid="ignore"):
            cn_data[nb_set] = cn_counts[:, ia, ib] / n_per_species[ia]
    cn_obj.data = pd.DataFrame(cn_data)

    # ---- BAD ----------------------------------------------------------------
    bad_obj = ambad.Bad()
    bins_ref = int(180 // dtheta)
    theta = np.arange(bins_ref + 1) * dtheta + dtheta / 2
    conc = np.asarray(out["bad_concrete"], dtype=np.float64)
    center_any = np.asarray(out["bad_center_any"], dtype=np.float64)
    bad_data = pd.DataFrame({"theta": theta})
    for spec, name in zip(meta["bad_specs"], meta["bad_names"]):
        spec_counts = bad_kernel.select_spec_counts(conc, center_any, spec)
        angle_counts = spec_counts.sum(axis=0)  # over the cn axis
        total = angle_counts.sum()
        if total > 0:
            bad_data[name] = angle_counts / (total * dtheta)
    bad_obj.data = bad_data

    # ---- MSD (reference window construction, amof/msd.py:174-182) --------
    msd_obj = ammsd.WindowMsd()
    half_time = (n_frames // 2) * timestep
    if max_time == "half" or max_time > half_time:
        max_time = half_time
    delta_m = max(1, delta_time // timestep)
    window = np.arange(0, max_time // timestep, delta_m)
    msd_sp = np.asarray(out["msd_species"], dtype=np.float64)
    msd_all = np.asarray(out["msd"], dtype=np.float64)
    msd_data = pd.DataFrame({"Time": timestep * window})
    for i, z in enumerate(unique):
        msd_data[elements.symbol_of(z)] = msd_sp[window, i]
    msd_data["X"] = msd_all[window]
    msd_obj.data = msd_data

    return {"rdf": rdf_obj, "cn": cn_obj, "bad": bad_obj, "msd": msd_obj}
