"""The PyTorch port stands alone: it imports with JAX blocked, and no file
of it (nor chip_smoke.py) imports jax or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "genomics_tpu_torch"


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import genomics_tpu_torch\n"
        "from genomics_tpu_torch import _build\n"
        "from genomics_tpu_torch.core import encoding, golds, scoring\n"
        "from genomics_tpu_torch.ops import cuda_align, scan_align, tb_walk\n"
        "from genomics_tpu_torch.ops import scan_align_full\n"
        "from genomics_tpu_torch.runtime import dispatch\n"
        "from genomics_tpu_torch.runtime.dispatch import walk_start\n"
        "assert 'genomics_tpu' not in sys.modules\n"
        "print(genomics_tpu_torch.AlignEngine.__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "AlignEngine"


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "genomics_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_every_kernel_has_a_source_with_its_entry_point():
    from genomics_tpu_torch import _build

    for name in _build.KERNELS:
        src = _build.CSRC / f"{name}.cu"
        assert f'extern "C" int {name}_launch(' in src.read_text()


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    from genomics_tpu_torch import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_all_skips_fresh_kernels_and_cleans_up(monkeypatch, tmp_path):
    """A library newer than its source is not rebuilt; a stale one needs
    nvcc, and a failed start leaves no temporary file behind."""
    from genomics_tpu_torch import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text("")
    os.utime(csrc / "b.cu", (0, 0))
    (out / "liba.so").write_text("")
    (out / "libb.so").write_text("")
    os.utime(out / "liba.so", (0, 0))       # a's source is newer
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert _build.build_all(("b",)) == [out / "libb.so"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(("b", "a"))
    assert sorted(p.name for p in out.iterdir()) == ["liba.so", "libb.so"]
