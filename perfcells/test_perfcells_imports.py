"""By whole top-level module name: nothing of the benchmark imports JAX or
the JAX package, and the reference, with every module of the benchmark
it imports, imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(HERE.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path, skip=()) -> set:
    """Every module an import statement of ``path`` names (a relative
    import comes out as its dots and name), but those in the bodies of
    the functions named in ``skip``."""
    out = set()
    tree = ast.parse(path.read_text(), str(path))
    skipped = {id(n) for f in ast.walk(tree)
               if isinstance(f, ast.FunctionDef) and f.name in skip
               for n in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            out.add(mod)
            if mod.split(".")[0] == "perfcells":
                out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def source(mod: str):
    """The file of a module of the benchmark, or None (a name that an
    import takes from a module)."""
    rel = mod.split(".", 1)[1].replace(".", "/")
    for path in (HERE / f"{rel}.py", HERE / rel / "__init__.py"):
        if path.is_file():
            return path
    return None


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not {top(m) for m in imported(path)} & JAX, path


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's: a prefix match would
    # refuse it, a whole-name match must not
    assert top("repro_torch.serving") not in JAX
    assert top("repro.kernels") in JAX


def test_reference_imports_nothing_of_the_program():
    # the family files, which the reference loads by path, are walked
    # too; a family's build_engine is the program's side
    seen = set()
    todo = [(HERE / "reference.py", "perfcells.reference")]
    todo += [(p, f"perfcells.families.{p.stem}")
             for p in sorted((HERE / "families").glob("*.py"))]
    while todo:
        path, mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for m in imported(path, skip=("build_engine",)):
            assert top(m) not in JAX | {"repro_torch"}, (mod, m)
            assert not m.startswith("."), (mod, m)
            if top(m) == "perfcells" and m != "perfcells":
                found = source(m)
                if found is not None:
                    todo.append((found, m))
    assert {"perfcells.weights", "perfcells.traffic", "perfcells.families",
            "perfcells.families._shared"} <= seen


def test_nothing_reads_the_old_benchmarks():
    old = "bench" + "marks"
    for path in SOURCES:
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert f"{old}/" not in text and f"{old}." not in text, path


def test_the_run_refuses_forbidden_modules(monkeypatch):
    import sys

    from perfcells import run

    for name in [m for m in sys.modules if top(m) in JAX]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert run._loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run._loaded_forbidden() == ["jaxlib"]
