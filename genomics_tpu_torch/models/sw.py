"""SW application (reference: CDP/SW): one small fragment aligned to a
large sequence split into overlapping windows; per-window local DP with
match=+1 / mismatch=0 (delta macro), linear gap -1, floor 0; greedy
traceback (M, then I, then D) and a global best-window reduction.  The
counterpart of `genomics_tpu/models/sw.py`.

All windows go into one batched call (`sw_matrix_batch`), which also
reduces each window's max, so only the winning window's H matrix comes
back to the host for the greedy walk (the reference also walks the full
matrix it kept in global memory, CDP/SW/main.cu:152-168).
`sw_matrix_batch` takes the plain version (a row scan, the left-gap
chain a `torch.cummax`, as sw.py:24-50) for tensors on the CPU and
launches `csrc/sw_app.cu` (replacing the jnp `sw_matrix_batch`, sw.py:24)
for tensors on a CUDA device; any other device raises.  The kernel cuts
each window's rows into stripes of ROWS rows, one block a stripe sweeping
the columns in tiles of TILE, each stripe waiting on a progress flag of
the one above (stripes taken from an atomic ticket): a call is one
memset of the flags and one kernel launch, whatever the shape.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.device import checked_device, on_cpu

# Kernel launches; the wrapper adds one where it calls the kernel's entry
# point, which makes `launches_per_call` CUDA launches.
LAUNCHES = {"sw_app": 0}
# csrc/sw_app.cu's kRows (rows a stripe, a block) and kTile (columns a tile)
ROWS, TILE = 12, 2048

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# x, windows, H, best, flags [W stripes + 1], n, W, L, max_grid, stream
_ARGS = (_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _vp)


def sw_matrix_batch_plain(x: torch.Tensor, windows: torch.Tensor):
    """The plain version of `sw_matrix_batch`, on the inputs' device: one
    row at a time over every window (sw.py:24-50)."""
    W, L = windows.shape
    n = x.shape[0]
    dev = windows.device
    jidx = torch.arange(L, dtype=torch.int32, device=dev)
    H = torch.zeros((W, n + 1, L + 1), dtype=torch.int32, device=dev)
    for i in range(n):
        prev = H[:, i]
        # row i+1: up and diagonal from row i; the left chain m[j] =
        # max(best[j], m[j-1] - 1) with boundary 0; since best >= 0 the
        # decayed boundary never wins, so m = cummax(best + j) - j exactly
        sub = (windows == x[i]).to(torch.int32)
        best = torch.maximum(prev[:, 1:] - 1, prev[:, :-1] + sub).clamp_min_(0)
        H[:, i + 1, 1:] = torch.cummax(best + jidx, 1).values - jidx
    best = (H.amax(dim=(1, 2)) if W
            else torch.zeros(0, dtype=torch.int32, device=dev))
    return H, best


def sw_matrix_batch(x: torch.Tensor, windows: torch.Tensor):
    """Batched SW app DP.

    x: [n] uint8 fragment bytes; windows: [W, L] uint8 window bytes
    (padded with 0, which the DP treats as a byte like any other).
    Returns (H [W, n+1, L+1] int32 full matrices, row i = x pos, col j =
    window pos, both 1-based like the reference's (lenX+1)x(len+1); best
    [W] int32, each window's largest cell), on the inputs' device."""
    if x.dim() != 1 or windows.dim() != 2:
        raise ValueError(f"x [n] and windows [W, L] expected; got "
                         f"{tuple(x.shape)}, {tuple(windows.shape)}")
    if x.dtype != torch.uint8 or windows.dtype != torch.uint8:
        raise TypeError(f"x and windows must be uint8; got {x.dtype}, "
                        f"{windows.dtype}")
    if x.device != windows.device:
        raise ValueError(f"inputs on {x.device} and {windows.device}")
    if on_cpu(x):
        return sw_matrix_batch_plain(x, windows)
    W, L = windows.shape
    n = x.shape[0]
    dev = x.device
    H = torch.empty((W, n + 1, L + 1), dtype=torch.int32, device=dev)
    best = torch.empty(W, dtype=torch.int32, device=dev)
    if W:
        launch_sw(x.contiguous(), windows.contiguous(), H, best)
    return H, best


def stripes(n: int) -> int:
    """Stripes a window: ceil(n / ROWS), and one for n = 0 (it writes row
    0 and the window's best)."""
    return max(1, -(-n // ROWS))


def flag_words(n: int, W: int) -> int:
    """The kernel's flags: the stripes' ticket and each stripe's progress."""
    return W * stripes(n) + 1


def launches_per_call(W: int) -> int:
    """CUDA launches of one `sw_matrix_batch` call on the card: the flags'
    memset and the kernel (none without windows)."""
    return 2 if W else 0


def launch_sw(x, windows, H, best, flags=None, grid=None):
    """Call csrc/sw_app.cu's entry point (W > 0) on contiguous inputs and
    count it; fills H and best.  `flags`, an int32 buffer of
    `flag_words(n, W)` (allocated here if None), is zeroed by the call;
    `grid` caps the kernel's blocks (card tests: fewer blocks than
    stripes, so that blocks take more than one ticket)."""
    W, L = windows.shape
    n = x.shape[0]
    if flags is None:
        flags = torch.empty(flag_words(n, W), dtype=torch.int32,
                            device=H.device)
    _build.launch("sw_app", "sw_app_launch", _ARGS, H.device, x, windows, H,
                  best, flags, n, W, L, grid or 0)
    LAUNCHES["sw_app"] += 1
    return H, best


def _greedy_walk(H: np.ndarray, x: bytes, window: bytes, start: int):
    """The reference's traceback (main.cu:152-168): greedy M / I / D."""
    best = int(H.max(initial=0))
    if best == 0:
        return 0, start + 1, ""
    # row-major first-strict-increase == first cell attaining the max
    flat = int(np.argmax(H == best))
    xc, yc = divmod(flat, H.shape[1])
    cig = []
    while H[xc, yc] > 0 and yc > 0:
        delta = 1 if (xc > 0 and yc > 0 and x[xc - 1] == window[yc - 1]) else 0
        if xc > 0 and yc > 0 and H[xc, yc] == H[xc - 1, yc - 1] + delta:
            cig.append("M")
            xc -= 1
            yc -= 1
        elif xc > 0 and H[xc, yc] == H[xc - 1, yc] - 1:
            cig.append("I")
            xc -= 1
        elif H[xc, yc] == H[xc, yc - 1] - 1:
            cig.append("D")
            yc -= 1
        else:
            break
    return best, yc + start + 1, "".join(cig)


def compress_cigar(cigar: str) -> str:
    """Run-length compression (reference compressCigar, main.cu:76-111)."""
    if not cigar:
        return ""
    out = []
    prev, count = cigar[0], 1
    for c in cigar[1:]:
        if c == prev:
            count += 1
        else:
            out.append(f"{count}{prev}")
            prev, count = c, 1
    out.append(f"{count}{prev}")
    return "".join(out)


def split_windows(y: bytes, lenX: int, window_size: int | None = None,
                  overlap: int | None = None):
    """The app driver's window decomposition of `y` (in main.cu:256-334):
    windows of `window_size` (default 3 lenX) bytes, each starting
    `window_size - overlap` (overlap default lenX) after the one before.
    Returns (starts, ends, windows [n_windows, L] uint8, 0-padded to the
    longest)."""
    lenY = len(y)
    overlap = overlap or lenX
    window_size = window_size or 3 * lenX
    n_windows = (lenY + window_size - 1) // window_size
    starts, ends = [], []
    prev_start = 0
    for i in range(n_windows):
        s = 0 if i == 0 else prev_start - overlap + window_size
        prev_start = s
        starts.append(s)
        ends.append(min(s + window_size, lenY))
    L = max(e - s for s, e in zip(starts, ends))
    wins = np.zeros((n_windows, L), np.uint8)
    for i, (s, e) in enumerate(zip(starts, ends)):
        wins[i, : e - s] = np.frombuffer(y[s:e], np.uint8)
    return starts, ends, wins


def align(
    x: str | bytes,
    y: str | bytes,
    window_size: int | None = None,
    overlap: int | None = None,
    device="cuda",
):
    """The app driver (main.cu:256-334): window decomposition, batched DP
    on `device` (the card unless told), traceback of the winning window,
    global best reduction.

    Returns dict(score, location, window, cigar, cigar_compressed)."""
    dev = checked_device(device)
    if isinstance(x, str):
        x = x.encode()
    if isinstance(y, str):
        y = y.encode()
    starts, ends, wins = split_windows(y, len(x), window_size, overlap)
    xa = np.frombuffer(x, np.uint8)
    Hd, best_d = sw_matrix_batch(torch.from_numpy(xa.copy()).to(dev),
                                 torch.from_numpy(wins).to(dev))
    # the windows' maxima come back, then ONLY the winning window's matrix
    scores = best_d.cpu().numpy()
    if scores.max(initial=0) <= 0:
        return dict(score=0, location=0, window=0, cigar="",
                    cigar_compressed="")
    i = int(np.argmax(scores))     # first window attaining the max (strict >)
    s, e = starts[i], ends[i]
    H = Hd[i].cpu().numpy()
    sc, loc, cig = _greedy_walk(H[:, : (e - s) + 1], x, y[s:e], s)
    best = dict(score=sc, location=loc, window=i, cigar=cig)
    best["cigar_compressed"] = compress_cigar(best["cigar"])
    return best
