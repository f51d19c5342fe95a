"""Standalone all-pairs aligner -> PAF (the reference's simple_align
binary): every ordered pair aligned forward and reverse-complemented by the
port's runner, the better orientation kept, written as PAF with cg:Z:
CIGARs.

  python -m seqrush_tpu_torch.tools.simple_align in.fa out.paf [--device cpu]

The default device is cuda (the kernels); ``--device cpu`` runs their plain
versions.
"""

from __future__ import annotations

import argparse

from ..align.pairs import all_ordered_pairs
from ..align.runner import RunnerConfig, WfaAligner
from ..io.paf import alignment_to_paf
from ..scores import AlignmentScores
from ..sequences import load_fasta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simple_align")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-S", "--scores", default="0,5,8,2,24,1")
    p.add_argument("-d", "--max-divergence", type=float, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the kernels, cpu their plain versions")
    ns = p.parse_args(argv)
    seqs = load_fasta(ns.input)
    cfg = RunnerConfig(scores=AlignmentScores.parse(ns.scores), max_divergence=ns.max_divergence,
                       verbose=ns.verbose)
    results = WfaAligner(seqs, cfg, device=ns.device).align_pairs(all_ordered_pairs(len(seqs)))
    with open(ns.output, "w") as fh:
        for r in results:
            fh.write(alignment_to_paf(r, seqs).to_line() + "\n")
    if ns.verbose:
        print(f"Wrote {len(results)} alignments to {ns.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
