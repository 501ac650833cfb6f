"""No module of a run imports JAX, jaxlib, flax or the JAX package, and
the reference imports nothing of the port.  Top-level names are
compared whole: genomics_tpu_torch is the port, not the JAX package."""
import ast
import sys

from portbench import harness

BANNED = {"jax", "jaxlib", "flax", "genomics_tpu"}


def imported(path):
    """Top-level names a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        assert not imported(path) & BANNED, path


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert "genomics_tpu_torch" not in imported(path), path
        assert imported(path) <= {"__future__", "collections", "numpy",
                                  "torch", "portbench"}, path


def test_run_end_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "genomics_tpu_torch.fake", object())
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "genomics_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.banned_modules() == ["genomics_tpu.fake", "jaxlib"]


def test_harness_and_drivers_import_without_jax():
    for cell in harness.manifest()["workloads"]:
        run = harness.new_run(harness.manifest(), cell, 1, 1, False, "cpu")
        harness.driver_of(run.traffic)
    assert not [n for n in sys.modules if n.split(".")[0] in BANNED]
