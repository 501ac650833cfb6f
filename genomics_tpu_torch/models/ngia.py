"""nGIA greedy clustering (reference: CDP|Non-CDP/CLUSTER/cluster/, the
repository's MPI component): the port of `genomics_tpu/models/ngia.py`,
on one device or over the ranks of a `parallel.mesh.DataMesh`.

Reference flow (func.cu): reads sorted by length; each round the first
unclustered read is the representative (the MPI ranks' Gather + min +
Bcast, func.cu:306-318), and every unclustered read goes through the word
filter and the banded bit-parallel DP against it.  Reference quirks
replicated:
- kernel_makeWords' 4-mer seed has a C precedence bug
  (`r0<<4+r1<<2+r2` == `(r0 << (4+r1)) << (2+r2)`, func.cu:131) — kept;
- the filter threshold uses min(netLengths) but `length*(1-sim)*4` with
  the ORIGINAL formula (func.cu:335-338);
- banded DP: shift = ceil(ceil(text - query*sim)/32) WORDS around the
  word diagonal (func.cu:377-388); out-of-band words stay all-ones;
- accept: matched >= ceil(min(qnet, tnet)*sim) (func.cu:465-468, note
  >= vs the single-node CLUSTER's >).

A round is one launch of `ops/lcs.banded_lcs_accept` (`csrc/ngia_lcs.cu`
on the card) that writes the accepted reads' cluster in place; the
representative is `argmax(cluster == -1)` on the device, and the host
checks once every ROUNDS rounds whether any read is left, as the JAX
package's `rounds_step` folds up to 32 rounds into a dispatch; at each
check it sizes the next rounds' band from the reads still unclustered.
`speculate > 1` evaluates S candidate representatives against every
unclustered read in one launch (CDP kernel_iteration) and resolves them
on the host as the JAX package does: the same clustering.

With a mesh (the reference's MPI design, func.cu:306-318) each rank holds
a contiguous block of the sorted reads and one more row, the
representative's slot.  A round's representative is the lowest
unclustered global index, an all-reduce (min); its owner's row reaches
every rank's slot by an all-reduce (sum) of the row that only the owner
fills, a broadcast whose source only the device knows, so no round waits
on the host; then every rank runs `ngia_lcs.cu`'s round mode over its own
block.  The host checks every ROUNDS rounds, and the clusters are
all-gathered at the end (func.cu:520).  `speculate > 1` ignores the mesh,
as the JAX package's does (ngia.py:369, ROADMAP C2): the speculative
path runs on the mesh's device, with the same clustering.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomics_tpu_torch.device import checked_device
from genomics_tpu_torch.ops.lcs import (banded_lcs_accept, max_shift_of,
                                        pad_codes)
from genomics_tpu_torch.parallel import multihost
from genomics_tpu_torch.utils.fasta import read_fasta

_BASE_MAP = np.full(256, 255, np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)]:
    _BASE_MAP[ord(_c)] = _v
    _BASE_MAP[ord(_c.lower())] = _v

ROUNDS = 32   # rounds between two host checks (rounds_step's k_rounds)


def _prepare(seqs: list[str]):
    """(order, lengths, net, words, low, high, codes) as the JAX package's
    `_prepare` makes them, array for array, without its per-read loops:
    reads sorted by length (stable), de-gapped to 2-bit codes (anything
    but ACGTU dropped), the 256-bin 4-mer histogram with the seed quirk
    (a read of under 4 bases has none), the codes padded with 255 to the
    longest net, and the 2-bit planes of 32 bases a word."""
    N = len(seqs)
    lengths = np.array([len(s) for s in seqs], np.int64)
    order = np.argsort(-lengths, kind="stable")
    raw = [seqs[i].encode() for i in order]
    lengths = lengths[order]
    flat = _BASE_MAP[np.frombuffer(b"".join(raw), np.uint8)]
    rid = np.repeat(np.arange(N), [len(r) for r in raw])
    keep = flat != 255                           # de-gap (baseToNumber)
    flat, rid = flat[keep], rid[keep]
    net = np.bincount(rid, minlength=N).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(net)[:-1]]).astype(np.int64)
    pos = np.arange(len(flat)) - starts[rid]
    # histogram: base k >= 3 of a read bins the last four bases' codes,
    # where the first three enter through the quirky seed
    # temp0 = ((a0 << (4 + a1)) << (2 + a2)) & 0xFF, shifted two bits a
    # base and gone from the key from k = 6 on
    a = flat.astype(np.int64)
    at = np.nonzero(pos >= 3)[0]
    p = pos[at]
    key = np.zeros(len(at), np.int64)
    for d in range(4):
        key += np.where(p - d >= 3, a[at - d] << (2 * d), 0)
    s0 = starts[rid[at]]
    seed = ((a[s0] << (4 + a[s0 + 1])) << (2 + a[s0 + 2])) & 0xFF
    key += np.where(p <= 5, seed << (2 * np.minimum(p - 2, 3)), 0)
    key &= 0xFF
    hist = np.bincount(rid[at] * 256 + key, minlength=N * 256)
    words = np.minimum(hist, 0xFFFF).astype(np.uint16).reshape(N, 256)
    # pack 2-bit planes, 32 bases/word, little-endian bit order
    Lmax = int(net.max())
    W32 = Lmax // 32 + 1
    codes = np.full((N, Lmax), 255, np.uint8)
    codes[rid, pos] = flat
    pad = np.zeros((N, W32 * 32), np.uint8)
    pad[rid, pos] = flat
    pb = pad.reshape(N, W32, 32).astype(np.uint32)
    sh = np.arange(32, dtype=np.uint32)
    low = ((pb & 1) << sh).sum(2, dtype=np.uint64).astype(np.uint32)
    high = (((pb >> 1) & 1) << sh).sum(2, dtype=np.uint64).astype(np.uint32)
    return order, lengths, net, words, low, high, codes


@dataclasses.dataclass
class NgiaResult:
    cluster: np.ndarray
    order: np.ndarray
    n_clusters: int


def _device_arrays(net, words, low, high, codes, dev) -> dict:
    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).view(dtype)).to(dev)
    return {"words": put(words, np.int16), "net": put(net.astype(np.int32),
                                                      np.int32),
            "low": put(low, np.int32), "high": put(high, np.int32),
            "codes": put(pad_codes(codes), np.uint8)}


def _accept(arrays: dict, reps, jobs, sim, cluster=None, **bounds):
    a = arrays
    return banded_lcs_accept(a["words"], a["net"], a["low"], a["high"],
                             a["codes"], reps, jobs, sim, cluster, **bounds)


def cluster_distributed(
    seqs: list[str],
    similarity: float = 0.95,
    mesh=None,
    speculate: int = 1,
    device="cuda",
) -> NgiaResult:
    """Greedy nGIA clustering on `device` (the card unless told; "cpu"
    takes the plain versions), or, with `mesh` (a DataMesh), over its
    ranks, each on the mesh's device.  speculate=S > 1 evaluates S
    candidate representatives a launch with serial-equivalent host
    resolution: the same clustering (and ignores the mesh, C2)."""
    dev = mesh.device if mesh is not None else checked_device(device)
    order, lengths, net, words, low, high, codes = _prepare(seqs)
    N = len(seqs)
    if mesh is not None and speculate <= 1:
        cluster = _mesh_rounds(mesh, net, words, low, high, codes,
                               similarity)
        n = int((cluster == np.arange(N)).sum())
        return NgiaResult(cluster=cluster, order=order, n_clusters=n)
    arrays = _device_arrays(net, words, low, high, codes, dev)

    if speculate > 1:
        S = int(speculate)
        cluster = np.full(N, -1, np.int64)
        pos = 0
        while pos < N:
            cands = []
            k = pos
            while k < N and len(cands) < S:
                if cluster[k] == -1:
                    cands.append(k)
                k += 1
            if not cands:
                break
            cands_a = np.array(cands)
            jobs = np.nonzero(cluster == -1)[0]
            A = _accept(
                arrays, torch.from_numpy(cands_a.astype(np.int32)).to(dev),
                torch.from_numpy(jobs.astype(np.int32)).to(dev), similarity,
                max_words=int((net[cands_a].max() + 31) // 32),
                max_shift=max_shift_of(net[cands_a], net[jobs], similarity),
            ).cpu().numpy() != 0                         # [S, J]
            # serial-equivalent resolution (same rule as the CLUSTER
            # speculative path): candidates ascending; a candidate is a
            # valid rep iff no earlier valid rep accepted it
            for si, c in enumerate(cands_a):
                if cluster[c] != -1:
                    continue
                cluster[c] = c
                take = A[si] & (cluster[jobs] == -1)
                cluster[jobs[take]] = c
            pos = int(cands_a[-1]) + 1
        n = int((cluster == np.arange(N)).sum())
        return NgiaResult(cluster=cluster, order=order, n_clusters=n)

    max_words = int((net.max() + 31) // 32)
    cluster = torch.full((N,), -1, dtype=torch.int32, device=dev)
    every = torch.arange(N, dtype=torch.int32, device=dev)
    live = np.ones(N, bool)
    left = N
    while left:
        # the band's bucket holds every pair of the reads still unclustered
        # (the set only shrinks until the next check; a clustered job runs
        # no LCS), so a short read already clustered widens no later round
        max_shift = max_shift_of(net[live], net[live], similarity)
        # a round after the last read is clustered is a no-op: rep 0, and
        # no job is unclustered
        for _ in range(ROUNDS):
            rep = torch.argmax((cluster == -1).to(torch.uint8))
            _accept(arrays, rep.to(torch.int32).reshape(1), every,
                    similarity, cluster, max_words=max_words,
                    max_shift=max_shift)
        live = (cluster == -1).cpu().numpy()
        now = int(live.sum())
        if now == left:
            raise _no_progress(int(rep), net)
        left = now
    c_host = cluster.cpu().numpy()
    n = int((c_host == np.arange(N)).sum())
    return NgiaResult(cluster=c_host, order=order, n_clusters=n)


def _no_progress(rep: int, net) -> RuntimeError:
    # the representative failed its own word filter (a read of under 4
    # bases): the JAX package's loop never ends here (ROADMAP C21)
    return RuntimeError(
        f"nGIA made no progress in {ROUNDS} rounds: read {rep} of "
        f"{int(net[rep])} bases does not pass its own word filter")


def _row_words(a: dict, i) -> torch.Tensor:
    """Row i of every per-read array as one int32 vector (words, net, low,
    high, codes: the codes' rows are padded to 16 bytes)."""
    return torch.cat([a["words"][i].view(torch.int32), a["net"][i][None],
                      a["low"][i], a["high"][i],
                      a["codes"][i].view(torch.int32)])


def _put_row(a: dict, i: int, row: torch.Tensor) -> None:
    """`_row_words`' inverse: row i of every per-read array from `row`."""
    W, L4 = a["low"].shape[1], a["codes"].shape[1] // 4
    k = 0
    for key, n in (("words", 128), ("net", 1), ("low", W), ("high", W),
                   ("codes", L4)):
        dst = a[key][i]
        dst = dst.view(torch.int32) if key in ("words", "codes") else dst
        dst.copy_(row[k:k + n].view(dst.shape))
        k += n


def _mesh_rounds(mesh, net, words, low, high, codes, sim: float):
    """The serial rounds over `mesh`'s ranks: this rank's block [lo, hi)
    of the reads plus the representative's slot (row hi - lo) on its
    device; returns the global cluster array (host numpy, every rank)."""
    N = len(net)
    lo, hi = mesh.block(N)
    n = hi - lo
    dev = mesh.device

    def rows(x):       # this block and one zero row, the slot
        return np.concatenate([x[lo:hi], np.zeros((1, *x.shape[1:]),
                                                  x.dtype)])
    arrays = _device_arrays(rows(net), rows(words), rows(low), rows(high),
                            rows(pad_codes(codes)), dev)
    slot = torch.tensor([n], dtype=torch.int32, device=dev)
    jobs = torch.arange(n, dtype=torch.int32, device=dev)
    gidx = torch.arange(lo, hi + 1, dtype=torch.int32, device=dev)
    gidx[n] = N                      # the slot is no read: "none left"
    cluster = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    cluster[n] = N
    max_words = int((net.max() + 31) // 32)
    live = np.ones(N, bool)
    left = N
    while left:
        max_shift = max_shift_of(net[live], net[live], sim)
        for _ in range(ROUNDS):
            # the lowest unclustered global index: N once none is left
            rep = multihost.all_reduce(
                torch.where(cluster == -1, gidx, N).min(), "min")
            mine = (rep >= lo) & (rep < hi)
            row = _row_words(arrays,
                             (rep - lo).clamp(0, max(n - 1, 0)).long())
            _put_row(arrays, n, multihost.all_reduce(
                torch.where(mine, row, 0), "sum"))
            was = cluster == -1
            _accept(arrays, slot, jobs, sim, cluster, max_words=max_words,
                    max_shift=max_shift)
            # the kernel names the slot; the reads it took get the rep
            cluster = torch.where(was & (cluster != -1), rep, cluster)
        live = multihost.fetch(cluster[:n]) == -1
        now = int(live.sum())
        if now == left:
            raise _no_progress(int(rep), net)
        left = now
    return multihost.fetch(cluster[:n]).astype(np.int32)


def run_file(
    input_file: str,
    output_file: str | None = None,
    similarity: float = 0.95,
    mesh=None,
    device="cuda",
) -> NgiaResult:
    recs = read_fasta(input_file)
    res = cluster_distributed([r.seq for r in recs], similarity, mesh=mesh,
                              device=device)
    if output_file:
        with open(output_file, "w") as fh:
            for i in np.nonzero(res.cluster == np.arange(len(recs)))[0]:
                orig = recs[res.order[i]]
                fh.write(f">{orig.name}\n{orig.seq}\n")
    return res
