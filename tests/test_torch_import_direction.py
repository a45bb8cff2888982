"""The port's import direction, read from its sources with ``ast`` (lazy
imports inside functions included): the fused step's module
``parallel/pipeline.py`` sits at the top of the stack, so only
``pipelines.py`` imports it, and no module imports a private
(``_``-prefixed) name of the entry points ``rdf``, ``cn`` or ``bad``;
what they share lives below them (``ops/frame_table.py``,
``warmup.resolve_device``)."""

import ast
import pathlib

PKG = pathlib.Path(__file__).resolve().parent.parent / "amof_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
TOP = "amof_tpu_torch.parallel.pipeline"
ENTRY_POINTS = {f"amof_tpu_torch.{m}" for m in ("rdf", "cn", "bad")}


def module_name(path):
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def imports(path):
    """(module, imported name or None) of every import in ``path``,
    relative imports resolved."""
    package = module_name(path).split(".")
    if path.name != "__init__.py":
        package = package[:-1]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, None
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            for alias in node.names:
                # "from amof_tpu_torch.parallel import pipeline" names it
                yield mod, alias.name
                yield f"{mod}.{alias.name}", None


def test_imports_point_down():
    assert {TOP, "amof_tpu_torch.pipelines", "amof_tpu_torch.ops.frame_table",
            *ENTRY_POINTS} <= {module_name(p) for p in SOURCES}
    importers, private = [], []
    for path in SOURCES:
        me = module_name(path)
        found = set(imports(path))
        if any(mod == TOP for mod, _ in found):
            importers.append(me)
        private += sorted((me, f"{mod}.{name}") for mod, name in found
                          if mod in ENTRY_POINTS and name
                          and name.startswith("_"))
    assert importers == ["amof_tpu_torch.pipelines"]
    assert not private, f"private names of the entry points: {private}"
