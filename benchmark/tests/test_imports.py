"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program, compared by top-level module
name."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
JAX_ERA = {"jax", "jaxlib", "flax", "optax", "orbax", "multimodal_diffusion_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & JAX_ERA, f


def test_the_program_passes_by_its_whole_name():
    assert "multimodal_diffusion_torch" not in JAX_ERA
    assert top_level_imports(HERE / "drivers" / "sample.py") >= {"torch", "benchmark"}


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert top_level_imports(f) <= {"__future__", "math", "typing", "numpy", "torch"}, f
