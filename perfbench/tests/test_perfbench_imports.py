"""What the benchmark may import: never JAX or the JAX package (compared
by the whole top-level name, so the port ``repro_torch`` is not taken
for ``repro``), and the reference nothing of the program."""
import ast
from pathlib import Path

import tiny  # noqa: F401  (puts the harness on the path)

from benchlib import bench

ROOT = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f) & NEVER, f


def test_reference_imports_plain_torch_only():
    for f in sorted((ROOT / "reference").glob("*.py")):
        assert top_level_imports(f) <= {"__future__", "math", "torch",
                                         "numpy"}, f


def test_whole_names_are_compared():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.kernels",
                                    "jaxtyping", "torch"]) == []
    assert bench.forbidden_modules(["repro.core", "jax._src",
                                    "benchmarks.roofline"]) == [
        "benchmarks", "jax", "repro"]


def test_whole_names_match_in_the_scan(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.serving\n"
                     "from repro_torch import bridge\n")
    assert top_level_imports(probe) == {"repro_torch"}
    assert not top_level_imports(probe) & NEVER
