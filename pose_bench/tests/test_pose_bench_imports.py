"""No file of the benchmark imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the served program. Top-level module
names are compared whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "spacecraft_pose_estimation_tpu"}
PORT = "spacecraft_pose_estimation_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(top_level_imports(p) & JAX) for p in sources(BENCH)}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) > 20  # the walk sees the benchmark's files


def test_the_reference_imports_nothing_of_the_program():
    found = {str(p.relative_to(BENCH)): PORT in top_level_imports(p) for p in sources(BENCH / "reference")}
    assert found and not any(found.values())


def test_the_check_compares_whole_top_level_names():
    tree = "import spacecraft_pose_estimation_tpu_torch.serving\nfrom spacecraft_pose_estimation_tpu.ops import x\n"
    probe = BENCH / "tests" / "_probe_imports.txt"
    probe.write_text(tree)
    try:
        names = top_level_imports(probe)
    finally:
        probe.unlink()
    assert names & JAX == {"spacecraft_pose_estimation_tpu"}
    assert PORT in names
