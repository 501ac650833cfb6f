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
    python -m genomics_tpu_torch cluster -i in.fasta [-o out.fasta]
                                         [-t 0.95] [-w WL] [-g S]
                                         [--device cuda|cpu]
    python -m genomics_tpu_torch ngia    -i in.fasta [-o out.fasta]
                                         [-s 0.95] [--device cuda|cpu]
    python -m genomics_tpu_torch index   -r ref.fasta -o out [--sa-rate R]
                                         [--set-bwt]
    python -m genomics_tpu_torch fmquery -x index.npz -p PATTERN ... [--locate]
    python -m genomics_tpu_torch fmserver -x index.npz [--locate-limit N]
    python -m genomics_tpu_torch extract -i in.bam|fastq|fasta -o out.txt
    python -m genomics_tpu_torch map     -r ref.fasta -q reads.fastq
                                         [-2 mates.fastq] -o out.sam|out.bam
                                         [--min-insert N] [--max-insert N]
                                         [--device cuda|cpu]
    python -m genomics_tpu_torch lighter -i reads.fa -o out.fa [-k 17]
                                         [-g G] [--alpha A] [--bloom-bits B]
    python -m genomics_tpu_torch assemble -r ref.fa -q reads.fa [-k 10]
                                          [--k-best 12] [--min-edge-weight 2]
                                          [--device cuda|cpu]
    python -m genomics_tpu_torch alndiff a.sam b.sam [--paired]
                                         [--report r.html] [--no-id-check]

The counterparts of all fifteen of `genomics_tpu/__main__.py`'s
subcommands, with their arguments, their output lines and their files
(an `.npz` index written by either package loads in the other);
`--device` (default the card) picks the plain PyTorch versions with
`cpu`.  `index`, `fmquery`, `fmserver` and `extract` run on the host in
both packages, and so do `lighter` (read by read through `correct()`)
and `alndiff`.  `msa` reads `-p` and does not pass it on, as the JAX
package's subcommand does, so its file is byte for byte that one's;
`models.msa.msa(seqs, matrix_path=)` scores with a matrix.  `cluster`
reads `-g` and drops it (the clustering is serial), and `ngia` prints
`cluster: N` where `cluster` prints `clusters: N`, both as the JAX
package's subcommands do.  `assemble` prints each haplotype's
likelihood as `score=`: the JAX package's subcommand reads a `score`
attribute that its Haplotype lacks and raises there (ROADMAP C24)."""
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

    p = sub.add_parser("cluster", help="greedy read clustering")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-t", "--threshold", type=float, default=0.95)
    p.add_argument("-w", "--wordlength", type=int, default=0)
    p.add_argument("-g", "--speculate", type=int, default=1,
                   help="read and not used, as in the JAX package's cluster")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    p = sub.add_parser("ngia", help="nGIA greedy clustering")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-s", "--similarity", type=float, default=0.95)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    p = sub.add_parser("index", help="build + save an FM-index (nvBWT/nvSSA)")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", required=True, help="output .npz prefix")
    p.add_argument("--sa-rate", type=int, default=None)
    p.add_argument("--set-bwt", action="store_true",
                   help="index the concatenated read SET (nvSetBWT)")

    p = sub.add_parser("fmquery", help="query a saved FM-index (nvFM-server)")
    p.add_argument("-x", "--index", required=True)
    p.add_argument("-p", "--patterns", required=True, nargs="+")
    p.add_argument("--locate", action="store_true")

    p = sub.add_parser(
        "fmserver",
        help="persistent FM-index query server (nvFM-server): one "
             "pattern per stdin line → count + hits; QUIT exits")
    p.add_argument("-x", "--index", required=True)
    p.add_argument("--locate-limit", type=int, default=20)

    p = sub.add_parser("extract", help="dump reads from BAM/FASTQ/FASTA (nvExtractReads)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("map", help="read mapping → SAM/BAM")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-q", "--reads", required=True)
    p.add_argument("-2", "--mates", default=None,
                   help="mate-2 file → paired-end FR mapping")
    p.add_argument("-o", "--output", required=True,
                   help=".sam or .bam extension selects the format")
    p.add_argument("--min-insert", type=int, default=0)
    p.add_argument("--max-insert", type=int, default=500)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    p = sub.add_parser("lighter",
                       help="Bloom-filter error correction (nvLighter)")
    p.add_argument("-i", "--reads", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-k", "--kmer", type=int, default=17)
    p.add_argument("-g", "--genome-size", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--bloom-bits", type=int, default=1 << 24)

    p = sub.add_parser(
        "assemble", help="local micro-assembly + variant calls "
        "(nvMicroAssembly)")
    p.add_argument("-r", "--reference", required=True,
                   help="FASTA with the reference window")
    p.add_argument("-q", "--reads", required=True,
                   help="FASTA/FASTQ of region reads")
    p.add_argument("-k", "--kmer", type=int, default=10)
    p.add_argument("--k-best", type=int, default=12)
    p.add_argument("--min-edge-weight", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")

    p = sub.add_parser(
        "alndiff", help="diff two SAM/BAM alignment files "
        "(nvbio-aln-diff)")
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("--paired", action="store_true")
    p.add_argument("--report", default=None, help="HTML report path")
    p.add_argument("--no-id-check", action="store_true")

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
    elif args.cmd == "cluster":
        from genomics_tpu_torch.models import cluster

        res = cluster.run_file(args.input, args.output,
                               threshold=args.threshold,
                               word_length=args.wordlength,
                               device=args.device)
        print(f"clusters: {res.n_clusters}")
    elif args.cmd == "ngia":
        from genomics_tpu_torch.models import ngia

        res = ngia.run_file(args.input, args.output,
                            similarity=args.similarity, device=args.device)
        print(f"cluster: {res.n_clusters}")
    elif args.cmd == "index":
        from genomics_tpu_torch.index.fmindex import FMIndex, save_index
        from genomics_tpu_torch.utils.fasta import read_fasta

        recs = read_fasta(args.reference)
        if args.set_bwt:
            # true string-set BWT (nvSetBWT): per-read terminators,
            # wavelet-tree rank over the 6-symbol alphabet
            from genomics_tpu_torch.index.setbwt import SetFMIndex

            sfm = SetFMIndex([r.seq for r in recs])
            sfm.save(args.output)
            print(f"set-BWT over {sfm.n_reads} reads "
                  f"({len(sfm.text)} symbols) → {args.output}")
        else:
            text = "".join(r.seq for r in recs)      # multi-contig concat
            fm = FMIndex(text, sa_rate=args.sa_rate)
            save_index(fm, args.output)
            print(f"indexed {len(text)} bp ({len(recs)} sequences, "
                  f"sa_rate={fm.sa_rate}) → {args.output}.npz"
                  if not args.output.endswith('.npz') else args.output)
    elif args.cmd == "fmserver":
        import sys as _sys

        from genomics_tpu_torch.index import setbwt as _sb

        idx = _sb.load_any_index(args.index)
        print("ready", flush=True)
        _sb.serve(idx, _sys.stdin, _sys.stdout,
                  locate_limit=args.locate_limit)
    elif args.cmd == "fmquery":
        import numpy as np

        from genomics_tpu_torch.index.qgram import encode2
        from genomics_tpu_torch.index.setbwt import SetFMIndex, load_any_index

        fm = load_any_index(args.index)
        if isinstance(fm, SetFMIndex):
            for pat in args.patterns:
                cnt = fm.count(pat)
                line = f"{pat}\t{cnt}"
                if args.locate and cnt:
                    line += "\t" + ",".join(
                        f"{r}:{o}" for r, o in fm.locate(pat))
                print(line)
            return
        L = max(len(p_) for p_ in args.patterns)
        Q = np.full((len(args.patterns), L), 255, np.uint8)
        ql = np.zeros(len(args.patterns), np.int64)
        for i, pat in enumerate(args.patterns):
            e = encode2(pat)
            Q[i, : len(e)] = e
            ql[i] = len(e)
        lo, hi = fm.backward_search(Q, ql)
        for pat, l, h in zip(args.patterns, lo, hi):
            cnt = max(int(h - l), 0)
            line = f"{pat}\t{cnt}"
            if args.locate and cnt:
                pos = fm.locate(int(l), int(h))[:20]
                line += "\t" + ",".join(str(int(x)) for x in pos)
            print(line)
    elif args.cmd == "extract":
        from genomics_tpu_torch.utils.fasta import read_fasta, read_fastq

        if args.input.endswith(".bam"):
            from genomics_tpu_torch.utils.bamio import read_bam

            _h, _r, recs = read_bam(args.input)
            seqs = [r.seq for r in recs]
        elif args.input.endswith((".fastq", ".fq")):
            seqs = [r.seq for r in read_fastq(args.input)]
        else:
            seqs = [r.seq for r in read_fasta(args.input)]
        with open(args.output, "w") as fh:
            for s_ in seqs:
                fh.write(s_ + "\n")
        print(f"extracted {len(seqs)} reads → {args.output}")
    elif args.cmd == "map":
        from genomics_tpu_torch.models.mapper import ReadMapper
        from genomics_tpu_torch.utils import bamio, samio
        from genomics_tpu_torch.utils.fasta import read_fasta, read_fastq

        def _load(path):
            if path.endswith((".fastq", ".fq")):
                return read_fastq(path)
            return read_fasta(path)

        refs = read_fasta(args.reference)
        reads = _load(args.reads)
        contigs = [(r.name.split()[0] or f"ctg{i}", r.seq)
                   for i, r in enumerate(refs)]
        mapper = ReadMapper(contigs, device=args.device)
        # single-contig callers keep the old header shape; multi-contig
        # headers list every @SQ line
        rname = (contigs[0][0] if len(contigs) == 1
                 else [(n, len(s)) for n, s in contigs])
        bam = args.output.endswith(".bam")
        if args.mates:
            mates = _load(args.mates)
            pairs = mapper.map_pairs(
                [r.seq for r in reads], [r.seq for r in mates],
                min_insert=args.min_insert, max_insert=args.max_insert)
            recs = [(r.name.split()[0], r.seq, a, s.seq, b)
                    for r, s, (a, b) in zip(reads, mates, pairs)]
            (bamio.write_bam_pairs if bam else samio.write_sam_pairs)(
                args.output, rname, len(contigs[0][1]), recs)
            mapped = sum(a.pos >= 0 for a, _ in pairs) + sum(
                b.pos >= 0 for _, b in pairs)
            proper = sum(a.proper_pair for a, _ in pairs)
            print(f"mapped {mapped}/{2 * len(pairs)} "
                  f"({proper} proper pairs) → {args.output}")
        else:
            maps = mapper.map_batch([r.seq for r in reads])
            recs = [(r.name.split()[0], r.seq, m)
                    for r, m in zip(reads, maps)]
            (bamio.write_bam if bam else samio.write_sam)(
                args.output, rname, len(contigs[0][1]), recs)
            mapped = sum(m.pos >= 0 for m in maps)
            print(f"mapped {mapped}/{len(reads)} → {args.output}")
    elif args.cmd == "lighter":
        from genomics_tpu_torch.models.corrector import LighterCorrector
        from genomics_tpu_torch.utils.fasta import read_fasta, read_fastq

        recs = (read_fastq(args.reads)
                if args.reads.endswith((".fastq", ".fq")) else
                read_fasta(args.reads))
        corr = LighterCorrector(k=args.kmer, genome_size=args.genome_size,
                                alpha=args.alpha, bloom_bits=args.bloom_bits)
        corr.build([r.seq for r in recs])
        fixed = unreliable = 0
        with open(args.output, "w") as fh:
            for r in recs:
                f, c = corr.correct(r.seq)
                fixed += max(c, 0)
                unreliable += c < 0
                fh.write(f">{r.name}\n{f}\n")
        print(f"corrected {fixed} bases, {unreliable} unreliable reads "
              f"→ {args.output}")
    elif args.cmd == "assemble":
        from genomics_tpu_torch.models.assembly import local_assembly
        from genomics_tpu_torch.utils.fasta import read_fasta, read_fastq

        ref = read_fasta(args.reference)[0].seq
        reads = (read_fastq(args.reads)
                 if args.reads.endswith((".fastq", ".fq")) else
                 read_fasta(args.reads))
        haps, variants = local_assembly(
            ref, [r.seq for r in reads], k=args.kmer, k_best=args.k_best,
            min_edge_weight=args.min_edge_weight, device=args.device)
        for i, h in enumerate(haps):
            print(f"hap {i}\tscore={h.likelihood:.4g}\t{h.seq}")
        for v in variants:
            print(f"variant\t{v.pos}\t{v.kind}\t{v.ref}>{v.alt}")
        print(f"{len(haps)} haplotypes, {len(variants)} variants")
    elif args.cmd == "alndiff":
        from genomics_tpu_torch.models.alndiff import diff

        analyzer = diff(args.file1, args.file2, paired=args.paired,
                        report=args.report, id_check=not args.no_id_check)
        print(f"analyzed {analyzer.n} alignments"
              + (f"; report → {args.report}" if args.report else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
