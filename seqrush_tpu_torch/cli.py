"""Command-line interface — the same flags as ``python -m seqrush_tpu``, plus
``--device``:

  python -m seqrush_tpu_torch -s in.fa -o out.gfa

Flags whose code paths are not ported yet are accepted and raise
``NotImplementedError`` naming their ROADMAP item (wide pairs of long
sequences need --wide-route full).
"""

from __future__ import annotations

import argparse

from .config import Args
from .pipeline import run_seqrush


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seqrush",
        description="Dynamic pangenome graph construction (PyTorch/CUDA)",
    )
    p.add_argument("-s", "--sequences", required=True, help="Input FASTA file")
    p.add_argument("-p", "--paf", default=None, help="Input PAF file (skip alignment)")
    p.add_argument("-o", "--output", default="output.gfa", help="Output GFA file")
    p.add_argument("-t", "--threads", type=int, default=4, help="Parallelism hint")
    p.add_argument("-k", "--min-match-length", type=int, default=0, dest="min_match_length")
    p.add_argument(
        "-S", "--scores", default="0,5,8,2,24,1",
        help="match,mismatch,gap_open,gap_extend[,gap2_open,gap2_extend]",
    )
    p.add_argument("--orientation-scores", default="0,1,1,1", dest="orientation_scores")
    p.add_argument("-d", "--max-divergence", type=float, default=None, dest="max_divergence")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--test-mode", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--no-compact", action="store_true", dest="no_compact")
    p.add_argument(
        "-x", "--sparsify", default="none", dest="sparsification",
        help="none | auto | random:F | connectivity:F | tree:N[,S[,R[,K]]]",
    )
    p.add_argument("--output-alignments", default=None, dest="output_alignments")
    p.add_argument("--validate-paf", action="store_true", default=True, dest="validate_paf")
    p.add_argument(
        "--paf-strand-convention", choices=("seqrush", "standard"),
        default="seqrush", dest="paf_convention",
        help="'-' record query-coordinate convention for -p input: 'seqrush' "
        "(RC-space, reference-faithful, matches --output-alignments) or "
        "'standard' (minimap2-style original-strand coords)",
    )
    p.add_argument("--seqwish-style", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--no-sort", action="store_true", dest="no_sort")
    p.add_argument("--skip-sgd", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--skip-groom", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--skip-topo", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sgd-iter-max", type=int, default=100, help=argparse.SUPPRESS)
    p.add_argument("--sgd-eta-max", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--sgd-theta", type=float, default=0.99, help=argparse.SUPPRESS)
    p.add_argument("--sgd-eps", type=float, default=0.01, help=argparse.SUPPRESS)
    p.add_argument("--sgd-cooling-start", type=float, default=0.5, help=argparse.SUPPRESS)
    p.add_argument(
        "--topo-mode", choices=("best", "stable", "bubble", "odgi"), default="best",
        dest="topo_mode",
        help="final Ygs ordering: 'best' (lowest-RMSE of up to six candidates), "
        "'stable' (SGD-stable bounded topo), 'bubble' (path-anchor "
        "bubble-chain), 'odgi' (reference-exact 's')",
    )
    # deprecated flags, accepted for compatibility
    p.add_argument("--sort-groom-sort", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--iterative-groom", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--odgi-groom", action="store_true", dest="odgi_style_groom", help=argparse.SUPPRESS)
    p.add_argument("--sgd-sort", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--groom", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--aligner", default="allwave", choices=["allwave", "sweepga"])
    p.add_argument("-f", "--frequency", type=int, default=None)
    p.add_argument("--iterative", action="store_true")
    p.add_argument("--band-slack", type=int, default=128, dest="band_slack")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--profile", default=None, metavar="FILE",
        help="write a JSON run profile (phase timings, aligner stats, graph counts)",
    )
    p.add_argument("--inversion-aware", action="store_true", dest="inversion_aware")
    p.add_argument(
        "--mesh-devices", type=int, default=None, dest="mesh_devices",
        help="shard alignment batches over N local devices",
    )
    p.add_argument(
        "--save-checkpoint", default=None, dest="save_checkpoint", metavar="NPY",
        help="persist the converged union-find parent array after alignment "
        "(graph-phase checkpoint; the reference can only replay PAFs)",
    )
    p.add_argument(
        "--load-checkpoint", default=None, dest="load_checkpoint", metavar="NPY",
        help="restore a parent-array checkpoint and skip alignment entirely",
    )
    p.add_argument(
        "--wide-route", default="anchored", choices=["anchored", "full"],
        dest="wide_route",
        help="divergent/wide-band pairs: 'anchored' = chain + piecewise "
        "window DP (fast), 'full' = monster-band sweep",
    )
    p.add_argument(
        "--wide-verify", action="store_true", dest="wide_verify",
        help="certify every anchored stitch against a score-only sweep at "
        "the certified band (falls back to the full route on mismatch)",
    )
    p.add_argument(
        "--memory-budget-bytes", type=int, default=None, dest="memory_budget_bytes",
        help="device memory per alignment dispatch; with --mesh-devices, a "
        "pair whose traceback alone exceeds this routes through the "
        "band-sharded kernel (sequence parallelism)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: 'cuda' runs the alignment kernels, 'cpu' their "
        "plain PyTorch versions (no fallback between the two)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)
    args = Args(**{k: v for k, v in vars(ns).items() if hasattr(Args, k)})
    run_seqrush(args)
    print(f"Graph written to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
