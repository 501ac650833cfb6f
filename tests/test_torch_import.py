"""The PyTorch port stands alone: it imports with JAX blocked, and no file
of it (`__main__.py`, `models/` and `ops/` included, nor chip_smoke.py)
imports jax or the JAX package."""
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
        "from genomics_tpu_torch import _build, device\n"
        "from genomics_tpu_torch.core import encoding, golds, scoring\n"
        "from genomics_tpu_torch.ops import cuda_align, scan_align, tb_walk\n"
        "from genomics_tpu_torch.ops import scan_align_full\n"
        "from genomics_tpu_torch.ops import cuda_pairhmm, myers, scan_pairhmm\n"
        "from genomics_tpu_torch.models import aligner, pairhmm\n"
        "from genomics_tpu_torch.models import msa, nw, sw\n"
        "from genomics_tpu_torch.core import submat\n"
        "from genomics_tpu_torch.core import batch\n"
        "from genomics_tpu_torch.utils import fasta\n"
        "from genomics_tpu_torch import __main__\n"
        "from genomics_tpu_torch.runtime import dispatch\n"
        "from genomics_tpu_torch.runtime.dispatch import walk_start\n"
        "from genomics_tpu_torch.runtime import native\n"
        "from genomics_tpu_torch.index import fmindex, qgram, setbwt, wavelet\n"
        "from genomics_tpu_torch.ops import fm_search\n"
        "from genomics_tpu_torch.models import mapper, mapq\n"
        "from genomics_tpu_torch.utils import bamio, samio\n"
        "from genomics_tpu_torch.ops import lcs\n"
        "from genomics_tpu_torch.models import cluster, ngia\n"
        "from genomics_tpu_torch import parallel\n"
        "from genomics_tpu_torch.parallel import mesh, multihost\n"
        "from genomics_tpu_torch.models import alndiff, assembly, corrector\n"
        "from genomics_tpu_torch.index import bloom\n"
        "from genomics_tpu_torch.utils import profiling\n"
        "assert 'genomics_tpu' not in sys.modules\n"
        "print(genomics_tpu_torch.AlignEngine.__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "AlignEngine"


def test_every_module_is_checked_for_jax_imports():
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"__main__.py", "device.py", "models/pairhmm.py",
            "ops/cuda_pairhmm.py", "ops/myers.py", "ops/scan_pairhmm.py",
            "models/aligner.py", "core/batch.py", "utils/fasta.py",
            "models/nw.py", "models/sw.py", "models/msa.py",
            "core/submat.py", "index/qgram.py", "index/fmindex.py",
            "index/wavelet.py", "index/setbwt.py", "runtime/native.py",
            "ops/fm_search.py", "models/mapq.py", "models/mapper.py",
            "utils/samio.py", "utils/bamio.py", "ops/lcs.py",
            "models/cluster.py", "models/ngia.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/multihost.py",
            "models/corrector.py", "models/assembly.py",
            "models/alndiff.py", "index/bloom.py",
            "utils/profiling.py"} <= names


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


def test_every_entry_point_signature_matches_its_source():
    """The argtypes each wrapper hands ctypes name every C parameter of
    its entry point, the stream included, pointer for pointer and int for
    int: a missing one would pass a pointer as a 32-bit int."""
    import re

    from genomics_tpu_torch import _build
    from genomics_tpu_torch.models import msa, nw, sw
    from genomics_tpu_torch.ops import (
        cluster_filter,
        cuda_align,
        cuda_pairhmm,
        fm_search,
        lcs,
        myers,
        tb_walk,
    )

    sigs = dict(cuda_align._SIGNATURES)
    sigs["tb_walk", "tb_walk_launch"] = tb_walk._ARGS
    sigs["pairhmm_intertask", "pairhmm_intertask_launch"] = \
        cuda_pairhmm._INTERTASK_ARGS
    sigs["pairhmm_wavefront", "pairhmm_wavefront_launch"] = \
        cuda_pairhmm._WAVEFRONT_ARGS
    sigs["myers", "myers_launch"] = myers._ARGS
    sigs["nw_app", "nw_app_launch"] = nw._ARGS
    sigs["sw_app", "sw_app_launch"] = sw._ARGS
    sigs["msa_nw", "msa_nw_launch"] = msa._FILL_ARGS
    sigs["msa_nw", "msa_nw_backtrack_launch"] = msa._BACKTRACK_ARGS
    sigs["fm_search", "fm_search_launch"] = fm_search._ARGS
    sigs["cluster_lcs", "cluster_lcs_launch"] = lcs._CLUSTER_ARGS
    sigs["ngia_lcs", "ngia_lcs_launch"] = lcs._NGIA_ARGS
    sigs["cluster_filter", "cluster_filter_launch"] = cluster_filter._ARGS
    assert {lib for lib, _ in sigs} == set(_build.KERNELS)
    for (lib, sym), argtypes in sigs.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        m = re.search(rf'extern "C" int {sym}\((.*?)\)\s*\{{', src, re.S)
        assert m, sym
        params = [x.strip() for x in m.group(1).split(",")]
        want = ["void*" in x for x in params]
        got = [t is cuda_align._vp for t in argtypes]
        assert got == want, (sym, params)


def test_local_modes_match_the_kernel_source():
    """`_LOCAL_MODES` gives local_sw_launch the numbers of local_sw.cu's
    Mode enum (SECOND has its own entry point), and every local_sw mode
    has a launch count."""
    import re

    from genomics_tpu_torch import _build
    from genomics_tpu_torch.ops import cuda_align

    src = (_build.CSRC / "local_sw.cu").read_text()
    body = re.search(r"enum Mode \{(.*?)\}", src).group(1)
    enum = {k.lower(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}
    assert enum.pop("second") == 3
    assert enum == cuda_align._LOCAL_MODES
    assert {f"local_sw.{m}" for m in [*enum, "second"]} == {
        k for k in cuda_align.LAUNCHES if k.startswith("local_sw.")}
    # local_sw_launch dispatches the two 16-bit modes as the wrappers call
    # them: SCORE16 without the N compare, END16 with it
    assert "mode == SCORE16 && !with_n" in src
    assert "mode == END16 && with_n" in src


def test_layouts_give_every_launch_argument():
    """The PairHMM and Myers layouts hold one value per C parameter but
    the stream: PairHMM's inputs as they are ([B, R] / [B, C], no copy),
    the lanes a pair (inter-task) and rows a lane first, the handover
    scratch only in the global layout; Myers' masks and texts in place."""
    import numpy as np
    import torch

    from genomics_tpu_torch.ops import cuda_pairhmm, myers, scan_pairhmm

    B, R, C, W = 5, 11, 13, 2
    rng = np.random.default_rng(0)
    reads = torch.from_numpy(rng.integers(65, 85, (B, R)).astype(np.uint8))
    haps = torch.from_numpy(rng.integers(65, 85, (B, C)).astype(np.uint8))
    rlen = torch.full((B,), R, dtype=torch.int32)
    clen = torch.full((B,), C, dtype=torch.int32)
    p = scan_pairhmm.prepare_params(*(torch.from_numpy(
        rng.integers(5, 60, (B, R))) for _ in range(3)))
    for lay, lead, sig in (
            (cuda_pairhmm.intertask_layout(reads, haps, rlen, clen, p,
                                           shape=(4, 8)), (4, 8),
             cuda_pairhmm._INTERTASK_ARGS),
            (cuda_pairhmm.intertask_layout(reads, haps, rlen, clen, p,
                                           shape=(16, 10), force_global=True),
             (16, 10), cuda_pairhmm._INTERTASK_ARGS),
            (cuda_pairhmm.wavefront_layout(reads, haps, rlen, clen, p), (4,),
             cuda_pairhmm._WAVEFRONT_ARGS),
            (cuda_pairhmm.wavefront_layout(reads, haps, rlen, clen, p,
                                           rows_per_lane=8), (8,),
             cuda_pairhmm._WAVEFRONT_ARGS)):
        # R = 11 fits one round of every shape: no handover, even where the
        # global layout is forced
        assert len(lay) + 1 == len(sig)
        n = len(lead)
        assert lay[:n + 1] == (*lead, 1)
        for got, want in zip(lay[n + 1:n + 10], (
                reads, haps, rlen, clen,
                *(p[k] for k in cuda_pairhmm.PARAMS))):
            assert got.data_ptr() == want.data_ptr()
        assert lay[n + 10:n + 14] == (B, R, C, None)
        assert lay[-1].shape == (B,)
    # R = 40 takes two rounds of 4 x 8 rows: shared memory by the rule, the
    # [2, C, B] scratch where forced
    long_reads = torch.zeros((B, 40), dtype=torch.uint8)
    p40 = {k: torch.zeros((B, 40)) for k in cuda_pairhmm.PARAMS}
    lay = cuda_pairhmm.intertask_layout(long_reads, haps, rlen, clen, p40,
                                        shape=(4, 8), force_global=True)
    assert lay[2] == 0 and lay[-2].shape == (2, C, B)
    assert lay[-2].dtype == torch.float32
    lay = cuda_pairhmm.intertask_layout(long_reads, haps, rlen, clen, p40,
                                        shape=(4, 8))
    assert lay[2] == 1 and lay[-2] is None
    pats = rng.integers(0, 4, (B, 40)).astype(np.uint8)
    eq = torch.from_numpy(myers.build_eq_masks(
        pats, np.full(B, 40, np.int32), W).astype(np.int64))
    texts = torch.from_numpy(rng.integers(0, 4, (B, 50)).astype(np.uint8))
    lay = myers.myers_layout(eq, rlen, texts, clen)
    assert len(lay) + 1 == len(myers._ARGS)
    # read in place: the int64 masks' low words (every second int32 word)
    # and the texts' rows, 50 bytes apart
    assert lay[0].data_ptr() == eq.data_ptr() and lay[0].shape == (B, 4, 2 * W)
    assert lay[1] == 2 and lay[2] is texts and lay[3] == 50
    assert lay[6:10] == (B, W, 50, None)


def test_a_header_newer_than_a_library_rebuilds_it(tmp_path, monkeypatch):
    """A kernel library is stale when its source or any csrc/ header
    (pairhmm.cuh, which both PairHMM sources include) is newer than it:
    `_start` then starts the compiler (here a stand-in that does
    nothing), else it returns None."""
    import os

    from genomics_tpu_torch import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("\n")
    (build / "libk.so").write_text("")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc", lambda: "true")
    for f, t in (("k.cu", 100), ("k.cuh", 100), ("libk.so", 200)):
        os.utime(build / f if f.endswith(".so") else csrc / f, (t, t))
    assert _build._start("k") is None
    os.utime(csrc / "k.cuh", (300, 300))
    job = _build._start("k")
    assert job is not None
    job[0].wait()
    os.unlink(job[1])


def test_launch_checks_the_argument_count():
    from genomics_tpu_torch import _build

    with pytest.raises(TypeError, match="stream included"):
        _build.launch("myers", "myers_launch", (None,) * 3, "cuda", 1, 2, 3)


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
