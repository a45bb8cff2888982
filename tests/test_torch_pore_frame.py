"""Parity of the port's per-frame Zeo++-style path (``pore/zeopp.py``
``analyze_frame`` and ``network`` with every option and ``extra`` flag,
``mass=`` and ``radii=`` overrides, and ``Pore.from_trajectory`` with
per-frame options, serial and on two threads) with ``amof_tpu``'s on the
CPU, on the same seeded frames.

Systems: 256 atoms (C, N, Zn; vdW radii overridden to dyadic values) in a
16 A cubic cell at resolution 0.5 (a 32^3 grid), and 320 sparse atoms in
a 32 A cell at resolution 1.0, where the sorted windows of the field and
of the surface sampling engage; positions on a 1/1024 fractional grid
with z squeezed to 72% (a void slab, so every option has work).

Tolerances: arrays (histograms, the distance grid, blocking spheres,
per-atom accessibility) exact; scalars rel 1e-6 (the same counts and
fields, summed on the host in the same float64 order; they agree exactly
here); ``RayAtom_hist`` may move a chord between neighbouring bins (the
reference contracts the march's multiply-adds into FMAs on random start
points and directions): at most 1% of the samples, ``RayAtom_mean_A`` to
rel 1e-5.
"""

import numpy as np
import pytest
import torch

import amof_tpu.pore.core as jpore
from amof_tpu.core.frames import Frame as JaxFrame
from amof_tpu.pore import zeopp as jz
from amof_tpu_torch import _build
from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.pore import core as tpore
from amof_tpu_torch.pore import grid_kernel
from amof_tpu_torch.pore import zeopp

torch.set_num_threads(2)

RADII = {"C": 1.25, "N": 1.0, "Zn": 1.5}
DENSE = dict(resolution=0.5, num_samples=5000, radii=RADII)
SPARSE = dict(resolution=1.0, num_samples=20000, radii={"C": 0.5})


def arrays(n=256, box=16.0, seed=0, n_frames=1):
    rng = np.random.default_rng(seed)
    frac = rng.random((n_frames, n, 3))
    frac[..., 2] *= 0.72
    frac = np.round(frac * 1024) / 1024
    cell = np.eye(3) * box
    numbers = np.full(n, 6)
    numbers[::4], numbers[1::4] = 30, 7
    return frac @ cell, numbers, cell


def frames(n=256, box=16.0, seed=0, n_frames=1):
    pos, numbers, cell = arrays(n, box, seed, n_frames)
    return ([Frame(p, numbers, cell) for p in pos],
            [JaxFrame(p, numbers, cell) for p in pos])


def assert_results_equal(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        if key == "RayAtom_hist":
            moved = np.abs(g - r).sum() / 2
            assert moved <= 0.01 * max(r.sum(), 1), moved
        elif key == "RayAtom_mean_A":
            assert g == pytest.approx(r, rel=1e-5)
        elif isinstance(r, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype, key
            np.testing.assert_array_equal(g, r, err_msg=key)
        elif isinstance(r, str):
            assert g == r
        else:
            assert isinstance(g, float), key
            assert g == pytest.approx(r, rel=1e-6, abs=1e-12), key


OPTIONS = [
    ("dense", dict(sa=True, vol=True)),
    ("dense", dict(sa=True, vol=True, window=None, probe_radius=1.0)),
    ("dense", dict(res=True, chan=True, psd=True, volpo=True)),
    ("dense", dict(block=True, ray_atom=True, num_samples=3000)),
    ("dense", dict(sa=True, vol=True, mass={"Zn": 70.0, "C": 12.5},
                   radii={"C": 1.5, "N": 1.25, "Zn": 1.0})),
    ("dense", dict(volpo=True, chan=True, chan_radius=0.75,
                   probe_radius=1.0, grid=(32, 16, 32))),
    ("sparse", dict(sa=True, vol=True)),
    ("sparse", dict(sa=True, vol=True, window=128)),
]


@pytest.mark.parametrize("case,opts", OPTIONS)
def test_analyze_frame_matches_amof_tpu(case, opts):
    if case == "dense":
        (frame,), (jframe,) = frames()
        kw = {**DENSE, **opts}
    else:
        (frame,), (jframe,) = frames(n=320, box=32.0)
        kw = {**SPARSE, **opts}
    ref = jz.analyze_frame(jframe, **kw)
    got = zeopp.analyze_frame(frame, device="cpu", **kw)
    assert_results_equal(got, ref)
    if "sa" in opts:
        assert got["ASA_A^2"] > 0 and got["AV_A^3"] > 0


def test_analyze_frame_reports_channels_and_pockets():
    (frame,), _ = frames()
    out = zeopp.analyze_frame(frame, device="cpu", res=True, chan=True,
                              block=True, vol=True, **DENSE)
    assert out["Number_of_channels"] >= 1
    assert out["Channel_dimensionality"] == 2.0  # the void slab
    assert out["Free_diameter"] > 2 * 1.2
    assert out["Included_diameter"] >= out["Included_along_free"] > 0
    assert out["NAV_A^3"] > 0 and out["Number_of_blocking_spheres"] > 0


@pytest.mark.parametrize("extra", [
    "-gridG", "-gridBOV -strinfo", "-oms", "-axs 1.5 out.axs",
    "-axs -oms -strinfo"])
def test_network_extra_options_match_amof_tpu(extra):
    (frame,), (jframe,) = frames()
    kw = dict(resolution=0.5, num_samples=2000, radii=RADII, sa=True)
    ref = jz.network(jframe, extra=extra, ha=True, **kw)
    got = zeopp.network(frame, extra=extra, ha=True, device="cpu", **kw)
    assert_results_equal(got, ref)


def test_network_reads_xyz_and_refuses_what_amof_tpu_refuses(tmp_path):
    (frame,), _ = frames(n=128, box=16.0)
    path = tmp_path / "frame.xyz"
    lines = [str(len(frame)), 'Lattice="16 0 0 0 16 0 0 0 16" '
             'Properties=species:S:1:pos:R:3'] + [
        f"{s} {x:.10f} {y:.10f} {z:.10f}" for s, (x, y, z) in
        zip(frame.get_chemical_symbols(), frame.get_positions())]
    path.write_text("\n".join(lines) + "\n")
    kw = dict(sa=True, vol=True, resolution=0.5, num_samples=2000,
              radii=RADII)
    assert_results_equal(zeopp.network(str(path), device="cpu", **kw),
                         jz.network(str(path), **kw))
    from amof_tpu.io.cif import write_cif as jwrite_cif
    from amof_tpu_torch.io.cif import write_cif

    cif = tmp_path / "frame.cif"
    write_cif(cif, frame)
    jcif = tmp_path / "jframe.cif"
    jwrite_cif(jcif, frame)
    assert cif.read_text().splitlines()[1:] == (
        jcif.read_text().splitlines()[1:])
    assert_results_equal(zeopp.network(str(cif), device="cpu", **kw),
                         jz.network(str(cif), **kw))
    for opt in ("radii", "mass"):
        with pytest.raises(ValueError, match="files are not supported"):
            zeopp.network(frame, device="cpu", **{opt: "table.rad"})
    with pytest.raises(NotImplementedError, match="-psd2"):
        zeopp.network(frame, extra="-strinfo -psd2", device="cpu",
                      resolution=0.5)


@pytest.mark.parametrize("parallel", [False, 2])
def test_pore_per_frame_options_match_amof_tpu(parallel):
    tframes, jframes = frames(n_frames=3)
    kw = dict(psd=True, chan=True, mass={"Zn": 70.0}, **DENSE)
    got = tpore.Pore.from_trajectory(tframes, delta_Step=5, first_frame=10,
                                     parallel=parallel, device="cpu", **kw)
    ref = jpore.Pore.from_trajectory(jframes, delta_Step=5, first_frame=10,
                                     **kw)
    assert list(got.data.columns) == list(ref.data.columns)
    assert list(got.data["Step"]) == [10, 15, 20]
    for g, r in zip(got.data.to_dict("records"),
                    ref.data.to_dict("records")):
        assert g.pop("Step") == r.pop("Step")
        assert_results_equal(g, r)


def test_pore_drops_a_failing_frame_with_a_warning(caplog):
    """An analysis failure (here a keyword ``analyze_frame`` does not
    take, on a per-frame option set) drops each frame, as in
    ``amof_tpu``; ``.data`` keeps its empty Step column."""
    tframes, jframes = frames(n_frames=2)
    got = tpore.Pore.from_trajectory(tframes, device="cpu", psd=True,
                                     surface_engine="xla", **DENSE)
    ref = jpore.Pore.from_trajectory(jframes, psd=True,
                                     no_such_option=1, **DENSE)
    assert list(got.data.columns) == list(ref.data.columns) == ["Step"]
    assert len(got.data) == len(ref.data) == 0
    assert "Pore analysis failed" in caplog.text


def test_per_frame_path_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (frame,), _ = frames()
    with pytest.raises(RuntimeError, match="cuda"):
        zeopp.analyze_frame(frame, sa=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tpore.Pore.from_trajectory([frame], psd=True)


def test_a_kernel_error_is_never_a_dropped_frame(monkeypatch):
    (frame,), _ = frames()

    def fail(init, periodic):
        raise _build.KernelError("flood_fill: CUDA launch failed (stub)")

    monkeypatch.setattr(grid_kernel, "propagate_fixpoint", fail)
    with pytest.raises(_build.KernelError, match="stub"):
        tpore.get_surface_volume(frame, 0, "cpu", **DENSE)


@pytest.mark.parametrize("stage, option, error", [
    ("covering_volume_counts", "psd",
     "cuFFT error: CUFFT_INTERNAL_ERROR (stub)"),
    ("distance_grid", "res",
     "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED (stub)"),
])
def test_a_library_error_is_never_a_dropped_frame(monkeypatch, stage,
                                                  option, error):
    """A plain RuntimeError from a library call on the frame's tensors
    (cuFFT under -psd, a cuBLAS or device-side failure in the field)
    reaches the caller of ``get_surface_volume`` and of the per-frame
    ``Pore`` path; no frame is dropped."""
    (frame,), _ = frames()

    def fail(*args, **kwargs):
        raise RuntimeError(error)

    monkeypatch.setattr(grid_kernel, stage, fail)
    with pytest.raises(RuntimeError, match="stub"):
        tpore.get_surface_volume(frame, 0, "cpu", **{option: True},
                                 **DENSE)
    with pytest.raises(RuntimeError, match="stub"):
        tpore.Pore.from_trajectory([frame], device="cpu", **{option: True},
                                   **DENSE)
