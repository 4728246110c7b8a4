"""What the benchmark loads: never JAX or the JAX package (top-level
names compared whole: coslam_torch is not coslam_tpu), and a reference
that loads nothing of coslam_torch."""

import ast
import subprocess
import sys

import pytest

from slambench import run

REFERENCE = ["slambench.check", "slambench.scene",
             "slambench.roofline.klt_track", "slambench.roofline.build_pyramid",
             "slambench.reference.frozen.slam.fused",
             "slambench.reference.frozen.slam.steps",
             "slambench.reference.frozen.solvers.ba"]


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600,
        check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole():
    assert run.forbidden_modules(
        ["coslam_torch", "coslam_torch.slam.fused", "coslam_tpux", "jaxtyping",
         "jax.numpy", "coslam_tpu", "flax.linen", "jaxlib"]) == \
        ["coslam_tpu", "flax.linen", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    names = loaded_after(
        "from slambench.tests.tiny import cell\n"
        "from slambench.run import run_cell\n"
        "r = run_cell(cell('live', frames=16, warm=10), 5, 0, False,\n"
        "             device='cpu', max_frames=2)\n"
        "assert r['checks']")
    assert "coslam_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("\n".join(f"import {m}" for m in REFERENCE))
    assert "coslam_torch" not in names
    assert not names & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    p.relative_to(run.ROOT).as_posix()
    for p in (run.HERE / "reference").rglob("*.py")) + [
        "slambench/check.py", "slambench/scene.py", "slambench/trace.py"])
def test_reference_sources_import_nothing_of_the_program(path):
    tree = ast.parse((run.ROOT / path).read_text())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        for m in mods:
            assert m.split(".")[0] not in ("coslam_torch",) + run.FORBIDDEN, \
                (path, m)
