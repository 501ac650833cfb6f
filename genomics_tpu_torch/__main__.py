"""Command-line entry points of the port:

    python -m genomics_tpu_torch nw      -N 256 [--seed 0] [--device cuda|cpu]
    python -m genomics_tpu_torch sw      -s small.txt -l large.txt [-w W]
                                         [-o OVL] [--device cuda|cpu]
    python -m genomics_tpu_torch align   -q q.fasta -t t.fasta [-y local]
                                         [--tb] [-s] [--second-best]
                                         [-x HEAD TAIL] [-k K] [--limit N]
                                         [-a M -b X -c GO -d GE]
                                         [--device cuda|cpu]
    python -m genomics_tpu_torch pairhmm dataset.txt [--fakesize N] [--exact]
                                                     [--device cuda|cpu]
    python -m genomics_tpu_torch msa     in.fasta out.fasta [-p matrix.txt]
                                         [--device cuda|cpu]

The counterparts of `genomics_tpu/__main__.py`'s `nw`, `sw`, `align`,
`pairhmm` and `msa` subcommands, with their arguments and their output
lines; `--device` (default the card) picks the plain PyTorch versions
with `cpu`.  `msa` reads `-p` and does not pass it on, as the JAX
package's subcommand does, so its file is byte for byte that one's;
`models.msa.msa(seqs, matrix_path=)` scores with a matrix.  The other
subcommands of the JAX package are not ported yet."""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genomics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nw", help="NW demo app (random ref + mutated query)")
    p.add_argument("-N", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain version")

    p = sub.add_parser("sw", help="windowed Smith-Waterman")
    p.add_argument("-s", "--smallfile", required=True)
    p.add_argument("-l", "--largefile", required=True)
    p.add_argument("-w", "--windowsize", type=int, default=0)
    p.add_argument("-o", "--overlap", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain version")

    p = sub.add_parser("align", help="GASAL2-class batched aligner")
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-t", "--target", required=True)
    p.add_argument("-y", "--algo", default="local",
                   choices=["local", "global", "semi_global", "banded", "ksw"])
    p.add_argument("--tb", action="store_true", help="traceback/CIGAR "
                   "(GASAL2 -t; implies start computation via the walk)")
    p.add_argument("-s", "--start", action="store_true",
                   help="compute start positions (GASAL2 -s WITH_START)")
    p.add_argument("--second-best", action="store_true",
                   help="report second-best score/ends (GASAL2 "
                   "--second-best, WITHOUT_START only)")
    p.add_argument("-x", "--skip", nargs=2, default=["none", "none"],
                   metavar=("HEAD", "TAIL"),
                   help="semiglobal skipping (GASAL2 -x): "
                   "none|query|target|both")
    p.add_argument("-k", "--band", type=int, default=4,
                   help="band width in 8-tiles for -y banded (GASAL2 -k)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("-a", "--match", type=int, default=1)
    p.add_argument("-b", "--mismatch", type=int, default=4)
    p.add_argument("-c", "--gapo", type=int, default=6)
    p.add_argument("-d", "--gape", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    p = sub.add_parser("pairhmm", help="PairHMM forward likelihoods")
    p.add_argument("dataset")
    p.add_argument("--fakesize", type=int, default=None)
    p.add_argument("--exact", action="store_true",
                   help="bit-exact __fmaf_rn math (always so in this port)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain version")

    p = sub.add_parser("msa", help="center-star MSA")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-p", "--matrix", default=None,
                   help="read and not used, as in the JAX package's msa")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    args = ap.parse_args(argv)

    if args.cmd == "nw":
        from genomics_tpu_torch.models import nw

        score = nw.run(N=args.N, seed=args.seed, device=args.device)
        print(f"Verification succeeded; final score {score}")
    elif args.cmd == "sw":
        from genomics_tpu_torch.models import sw

        with open(args.smallfile) as fh:
            x = fh.readline().strip()
        with open(args.largefile) as fh:
            y = fh.readline().strip()
        res = sw.align(x, y, window_size=args.windowsize or None,
                       overlap=args.overlap or None, device=args.device)
        print(f"Best alignment found at {res['location']}")
        print(f"score {res['score']} cigar {res['cigar_compressed']}")
    elif args.cmd == "align":
        from genomics_tpu_torch.core.scoring import (
            AlignmentParams, AlgoType, SemiGlobalSkip,
        )
        from genomics_tpu_torch.models.aligner import align_fasta_pairs

        params = AlignmentParams(
            match=args.match, mismatch=args.mismatch,
            gap_open=args.gapo, gap_extend=args.gape,
            algo=AlgoType(args.algo),
            second_best=args.second_best,
            compute_start=args.start and not args.tb,
        )
        head = SemiGlobalSkip[args.skip[0].upper()]
        tail = SemiGlobalSkip[args.skip[1].upper()]
        jobs = align_fasta_pairs(args.query, args.target, params=params,
                                 with_tb=args.tb, limit=args.limit,
                                 head=head, tail=tail,
                                 band_width_tiles=args.band,
                                 device=args.device)
        for i, j in enumerate(jobs):
            line = f"{i}\tscore={j.score}\tqe={j.query_end}\tte={j.target_end}"
            if args.start or args.tb:
                line += f"\tqs={j.query_start}\tts={j.target_start}"
            if args.second_best:
                line += (f"\tscore2={j.score_second}"
                         f"\tqe2={j.query_end_second}"
                         f"\tte2={j.target_end_second}")
            if args.tb and j.cigar is not None:
                line += f"\tcigar={j.cigar_string}"
            print(line)
    elif args.cmd == "pairhmm":
        from genomics_tpu_torch.models import pairhmm

        res = pairhmm.run_dataset(args.dataset, fakesize=args.fakesize,
                                  exact=args.exact, device=args.device)
        print(f"  i=0  {res.likelihoods[0]:e}")
        print(f"GCUPS: {res.gcups:f}")
    elif args.cmd == "msa":
        from genomics_tpu_torch.models import msa

        aligned, cidx = msa.run_file(args.input, args.output,
                                     device=args.device)
        print(f"center sequence index: {cidx}; wrote {len(aligned)} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
