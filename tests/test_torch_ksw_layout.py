"""Where ksw_extend keeps its row state, and what its wrapper hands the
kernel: the layout rule on Lq (shared memory up to a limit, a global
scratch beyond), the launch arguments for the [B, Lq] inputs read as the
engine holds them, and the kernel source's constants.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""
import re

import numpy as np
import pytest
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops.scan_align import ksw_align_batch

LIMIT = cuda_align.KSW_SHARED_MAX_LQ


@pytest.mark.parametrize("Lq", [1, 152, LIMIT, LIMIT + 1, 4096])
def test_ksw_layout_is_a_rule_on_lq(Lq):
    """Shared memory with the most threads (a multiple of 32, at most
    256) whose 9 (Lq + 1) bytes each fit 232,448 bytes, up to the limit;
    the global scratch at 128 threads beyond."""
    kind, threads = cuda_align.ksw_layout(Lq)
    per_thread = 9 * (Lq + 1)
    if Lq <= LIMIT:
        assert kind == "shared"
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert threads * per_thread <= 232_448
        assert threads == 256 or (threads + 32) * per_thread > 232_448
    else:
        assert (kind, threads) == ("global", 128)
        assert 32 * per_thread > 232_448


def test_ksw_layout_at_the_bench_shape():
    """At Lq 152: 160 threads, 220,320 bytes, one block of 5 warps per SM
    (the source note's numbers)."""
    assert cuda_align.ksw_layout(152) == ("shared", 160)
    assert 9 * 153 * 160 == 220_320
    assert LIMIT == 806


def test_ksw_source_constants_match_the_wrapper():
    src = (_build.CSRC / "ksw_extend.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxShared"]) == cuda_align.KSW_SHARED_BYTES
    assert int(consts["kMaxThreads"]) == cuda_align.KSW_MAX_THREADS
    assert int(consts["kGlobalThreads"]) == cuda_align.KSW_GLOBAL_THREADS
    assert "static_cast<size_t>(Lq + 1) * threads * 9" in src


def _inputs(B, Lq, Lt, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.uint8))
    t = torch.from_numpy(rng.integers(0, 4, (B, Lt)).astype(np.uint8))
    ql = torch.from_numpy(rng.integers(1, Lq + 1, B).astype(np.int32))
    tl = torch.from_numpy(rng.integers(1, Lt + 1, B).astype(np.int32))
    h0 = torch.from_numpy(rng.integers(0, 60, B).astype(np.int32))
    return q, t, ql, tl, h0


@pytest.mark.parametrize("mode,force_global", [
    ("end", False), ("score", False), ("end", True), ("score", True),
])
def test_ksw_launch_args_read_the_inputs_as_they_are(mode, force_global):
    """One value per C parameter but the stream; q and t passed as the
    [B, L] tensors themselves (no transpose), the layout flag and threads
    of `ksw_layout` unless forced, the [B, Lq + 1] int2 scratch only in
    the global layout, qend / tend only in END."""
    B, Lq, Lt = 5, 40, 48
    q, t, ql, tl, h0 = _inputs(B, Lq, Lt)
    p = AlignmentParams(algo=AlgoType.KSW, n_penalty=2)
    args = cuda_align.ksw_launch_args(mode, q, t, ql, tl, h0, p, True,
                                      force_global=force_global)
    sig = cuda_align._SIGNATURES["ksw_extend", "ksw_extend_launch"]
    assert len(args) + 1 == len(sig)
    kind, threads = (("global", 128) if force_global
                     else cuda_align.ksw_layout(Lq))
    assert args[:4] == (int(mode == "end"), 1, int(kind == "shared"),
                        threads)
    for got, want in zip(args[4:9], (q, t, ql, tl, h0)):
        assert got.data_ptr() == want.data_ptr()
    assert args[9:17] == (B, Lq, Lt, p.match, p.mismatch, -2, p.gap_oe,
                          p.gap_extend)
    eh = args[17]
    if kind == "global":
        assert eh.shape == (B, Lq + 1, 2) and eh.dtype == torch.int32
    else:
        assert eh is None
    assert all(x.shape == (B,) for x in args[18:] if x is not None)
    assert (args[19] is None) == (mode == "score")


def test_ksw_entry_points_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers never build the launch arguments: they
    return the plain version's results."""
    q, t, ql, tl, h0 = _inputs(7, 30, 40, seed=1)
    p = AlignmentParams(algo=AlgoType.KSW)
    before = dict(cuda_align.LAUNCHES)
    want = ksw_align_batch(q, t, ql, tl, h0, p)
    got = cuda_align.ksw_align(q, t, ql, tl, h0, p)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(cuda_align.ksw_align_scores(q, t, ql, tl, h0, p),
                       want.score)
    assert cuda_align.LAUNCHES == before
