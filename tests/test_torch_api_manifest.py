"""The API manifest of ``tests/test_api_parity.py`` (loaded by path),
mapped from ``amof_tpu.X`` to ``amof_tpu_torch.X``: every public symbol
and class method of every module the port has must resolve there. The
modules still to be ported are listed by name and must still be missing
(so a slice that ports one has to move it out of the list); the
keywords the port drops on purpose are listed as documented exclusions
and checked to be dropped."""

import importlib
import importlib.util
import inspect
import pathlib

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "_api_parity_manifest",
    pathlib.Path(__file__).resolve().parent / "test_api_parity.py")
_MANIFEST = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_MANIFEST)

# modules of amof_tpu with no counterpart in the port yet (ROADMAP Queue 1)
PENDING = (
    "coordination", "coordination.buildingunits", "coordination.core",
    "coordination.reduce", "coordination.zif", "elastic", "elastic.core",
    "elastic.elate", "structure", "files.molsys", "config", "plot",
    "profiling", "parallel.mesh",
)

# reference keywords the port drops on purpose (ROADMAP Queue 3): each
# selects a TPU engine, a device mesh or where the ring BFS runs.
#   (amof_tpu callable, port callable, dropped keyword, port's keyword)
EXCLUSIONS = [
    ("parallel.pipeline:FusedAnalysis.__init__",
     "parallel.pipeline:FusedAnalysis.__init__", "method", None),
    ("parallel.pipeline:FusedAnalysis.prepare",
     "parallel.pipeline:FusedAnalysis.prepare", "mesh", "device"),
    ("parallel.pipeline:FusedAnalysis.run",
     "parallel.pipeline:FusedAnalysis.run", "mesh", "device"),
    ("pore.batch:BatchedPore.__init__", "pore.batch:BatchedPore.__init__",
     "surface_engine", None),
    ("pore.batch:BatchedPore.prepare", "pore.batch:BatchedPore.prepare",
     "mesh", "device"),
    ("pore.batch:BatchedPore.run", "pore.batch:BatchedPore.run", "mesh",
     "device"),
    # the BFS always runs in torch, on ``device``; the census never
    # computes its own distances on this path
    ("ring.core:frame_ring_census", "ring.core:frame_ring_census",
     "use_device_bfs", "device"),
]


def port_name(name):
    assert name.startswith("amof_tpu.")
    return "amof_tpu_torch" + name[len("amof_tpu"):]


def is_pending(mod_name):
    rel = mod_name.split(".", 1)[1]
    return rel in PENDING


MODULES = sorted(_MANIFEST.MODULE_SYMBOLS)
PORTED = [m for m in MODULES
          if not is_pending(_MANIFEST.MODULE_SYMBOLS[m][0])]
CLASSES = sorted((k for k in _MANIFEST.CLASS_METHODS
                  if not is_pending(k[0])), key=str)


@pytest.mark.parametrize("ref_mod", PORTED)
def test_port_has_the_module_symbols(ref_mod):
    mod_name, symbols = _MANIFEST.MODULE_SYMBOLS[ref_mod]
    mod = importlib.import_module(port_name(mod_name))
    missing = [s for s in symbols if not hasattr(mod, s)]
    assert not missing, f"{port_name(mod_name)} lacks {missing}"


@pytest.mark.parametrize("key", CLASSES, ids=lambda k: f"{k[0]}.{k[1]}")
def test_port_has_the_class_methods(key):
    mod_name, cls_name = key
    cls = getattr(importlib.import_module(port_name(mod_name)), cls_name)
    missing = [m for m in _MANIFEST.CLASS_METHODS[key] if not hasattr(cls, m)]
    assert not missing, f"{port_name(mod_name)}.{cls_name} lacks {missing}"


@pytest.mark.parametrize("rel", PENDING)
def test_pending_modules_are_still_missing(rel):
    importlib.import_module(f"amof_tpu.{rel}")  # the reference has it
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(f"amof_tpu_torch.{rel}")


def test_the_manifest_covers_ported_and_pending():
    assert len(PORTED) + sum(
        is_pending(_MANIFEST.MODULE_SYMBOLS[m][0]) for m in MODULES
    ) == len(MODULES)
    assert "ring.core" in PORTED and "trajectory" in PORTED
    assert "coordination.core" not in PORTED


def _callable(spec, root):
    mod_name, attr = spec.split(":")
    obj = importlib.import_module(f"{root}.{mod_name}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("ref,port,dropped,instead", EXCLUSIONS,
                         ids=[f"{e[0]}:{e[2]}" for e in EXCLUSIONS])
def test_documented_exclusions(ref, port, dropped, instead):
    ref_params = inspect.signature(_callable(ref, "amof_tpu")).parameters
    port_params = inspect.signature(_callable(port, "amof_tpu_torch")
                                    ).parameters
    assert dropped in ref_params
    assert dropped not in port_params
    if instead is not None:
        assert instead in port_params


@pytest.mark.parametrize("cls,methods", [
    ("Ring", ["from_trajectory", "from_reduced_trajectory", "compute_ring"]),
])
def test_device_keyword_of_the_slice(cls, methods):
    from amof_tpu_torch.ring import core

    for name in methods:
        params = inspect.signature(getattr(getattr(core, cls), name)
                                   ).parameters
        assert params["device"].default == "cuda", name
