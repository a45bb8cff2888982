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
from amof_tpu_torch.ops import bad_kernel
from amof_tpu_torch.ops.frame_table import species_table
from amof_tpu_torch.parallel.pipeline import FusedAnalysis


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
    species = np.asarray(batch.species)
    step = construct_step(
        delta_Step=delta_Step, first_frame=first_frame,
        number_of_frames=n_frames,
    )

    # ---- RDF, CN, BAD: the columns of the individual classes ---------------
    rdf_obj = amrdf.Rdf()
    rdf_obj.data = pd.DataFrame(amrdf.rdf_table(
        out["rdf_counts"], species, unique, n_frames, dr, meta["bins"]))
    cn_obj = amcn.CoordinationNumber()
    _, z_to_idx = species_table(species)
    cn_obj.data = pd.DataFrame(amcn.cn_table(
        out["cn_counts"], species, unique, z_to_idx, nb_set_and_cutoff, step))
    bad_obj = ambad.Bad()
    bins_ref = int(180 // dtheta)
    theta = np.arange(bins_ref + 1) * dtheta + dtheta / 2
    conc = np.asarray(out["bad_concrete"], dtype=np.float64)
    center_any = np.asarray(out["bad_center_any"], dtype=np.float64)
    counts = [bad_kernel.select_spec_counts(conc, center_any, spec)
              for spec in meta["bad_specs"]]
    bad_obj.data = pd.DataFrame(
        ambad.bad_table(counts, meta["bad_names"], theta, dtheta))

    # ---- MSD (reference window construction, amof/msd.py:174-182) --------
    msd_obj = ammsd.WindowMsd()
    window, time = ammsd.msd_windows(n_frames, delta_time, max_time,
                                     timestep, clamp=True)
    msd_obj.data = pd.DataFrame(ammsd.msd_table(
        np.asarray(out["msd"], dtype=np.float64),
        np.asarray(out["msd_species"], dtype=np.float64), unique, window,
        time))

    return {"rdf": rdf_obj, "cn": cn_obj, "bad": bad_obj, "msd": msd_obj}
