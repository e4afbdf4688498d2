"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``diffusiondepth_tpu_torch`` is the port, not
``diffusiondepth_tpu``); the reference imports nothing of the port either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "diffusiondepth_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[str(p.relative_to(BENCH / "reference")) for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "importlib", "math", "typing", "numpy",
                                       "torch"}


def test_guard_compares_whole_names():
    assert "diffusiondepth_tpu_torch" not in JAX_SIDE
    src = "import diffusiondepth_tpu_torch.ops\nfrom diffusiondepth_tpu import x\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names & JAX_SIDE == {"diffusiondepth_tpu"}
