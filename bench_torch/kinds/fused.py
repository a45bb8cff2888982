"""Traffic kind ``fused``: ``FusedAnalysis`` (RDF + CN + BAD + MSD), one
trajectory piece a unit, as a user runs it: ``prepare`` (layout and
upload) then the step, numpy results on the host.

Mix parameters: ``analysis`` (FusedAnalysis keyword arguments besides
the configuration's cutoffs, dr and dtheta)."""

from __future__ import annotations

from bench_torch.harness import span
from bench_torch.reference import fused as ref_fused

REHEARSAL_FRAMES = 8


def batch_of(piece):
    from amof_tpu_torch import FrameBatch

    return FrameBatch(piece["positions"], piece["cell"], piece["species"],
                      piece["step"])


class Runner:
    def __init__(self, config, traffic, device):
        from amof_tpu_torch.parallel.pipeline import FusedAnalysis

        self.device = device
        self.fa = FusedAnalysis(config["cutoffs_A"], dr=config["rdf_dr_A"],
                                dtheta=config["bad_dtheta_deg"],
                                **traffic["analysis"])

    def unit(self, piece):
        with span("fused.prepare"):
            step_fn, args, _ = self.fa.prepare(batch_of(piece), self.device)
        with span("fused.step"):
            return step_fn(*args)


def reference(config, traffic, piece, device, dtype=None):
    import torch

    a = traffic["analysis"]
    return ref_fused.analyses(
        piece, config["elements"], config["cutoffs_A"], config["rdf_dr_A"],
        config["bad_dtheta_deg"], dtype or torch.float64, device,
        with_bad=a.get("with_bad", True), with_msd=a.get("with_msd", True))


def compare(out, ref, config=None, traffic=None):
    """The numbers ``correct`` compares (each at most its limit)."""
    nums = {
        "rdf_l1": ref_fused.l1_share(out["rdf_counts"], ref["rdf_counts"]),
        "cn_frame_l1": ref_fused.frame_l1_share(out["cn_counts"],
                                                ref["cn_counts"]),
    }
    if "bad_concrete" in ref:
        nums["bad_l1"] = max(
            ref_fused.l1_share(out["bad_concrete"], ref["bad_concrete"]),
            ref_fused.l1_share(out["bad_center_any"],
                               ref["bad_center_any"]))
    if "msd" in ref:
        # the lags a user's result holds: aMOF's MSD windows stop below
        # half the trajectory (amof/msd.py; ``pipelines.analyze`` builds
        # its WindowMsd so)
        lags = slice(1, len(ref["msd"]) // 2)
        nums["msd_rel"] = max(
            ref_fused.max_rel(out["msd"], ref["msd"], lags),
            ref_fused.max_rel(out["msd_species"], ref["msd_species"], lags))
    return nums
