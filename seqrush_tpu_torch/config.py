"""Run configuration — the full flag surface of the reference CLI.

Mirrors the reference ``Args`` struct (reference src/seqrush.rs:17-152)
including hidden and deprecated flags, so scripts written against seqrush
translate directly.  Copied from seqrush_tpu/config.py, plus ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Args:
    sequences: str = ""
    paf: str | None = None
    output: str = "output.gfa"
    threads: int = 4  # device/batch parallelism hint (rayon analog)
    min_match_length: int = 0
    scores: str = "0,5,8,2,24,1"
    orientation_scores: str = "0,1,1,1"
    max_divergence: float | None = None
    verbose: bool = False
    test_mode: bool = False  # accepted, vestigial (reference seqrush.rs:60-62)
    no_compact: bool = False
    sparsification: str = "none"
    output_alignments: str | None = None
    validate_paf: bool = True
    seqwish_style: bool = False
    no_sort: bool = False
    skip_sgd: bool = False
    skip_groom: bool = False
    skip_topo: bool = False
    sgd_iter_max: int = 100
    sgd_eta_max: float | None = None
    sgd_theta: float = 0.99
    sgd_eps: float = 0.01
    sgd_cooling_start: float = 0.5
    # deprecated, accepted for compatibility
    sort_groom_sort: bool = False
    iterative_groom: int | None = None
    odgi_style_groom: bool = False
    sgd_sort: bool = False
    groom: bool = False
    aligner: str = "allwave"
    frequency: int | None = None
    iterative: bool = False
    # PAF '-'-strand coordinate convention for -p input:
    #  'seqrush'  — reference-faithful: query_start/end of '-' records are in
    #               REVERSE-COMPLEMENT space and the CIGAR walks the RC'd
    #               query (seqrush.rs:594-601 + process_alignment RC
    #               read-back).  Nonstandard but required for replaying
    #               --output-alignments files.
    #  'standard' — minimap2-style: query coords of '-' records are on the
    #               ORIGINAL strand (q_start_rc = qlen - q_end); use this to
    #               replay externally produced PAFs.
    paf_convention: str = "seqrush"
    # extensions beyond the reference
    band_slack: int = 64
    seed: int = 42
    # final Ygs ordering: 'best' = pick the lowest-RMSE of four candidate
    # orderings (quality default, layout/ygs.py), 'stable' =
    # bounded-displacement SGD-stable topo, 'odgi' = reference/ODGI 's'
    topo_mode: str = "best"
    # graph-phase checkpointing beyond the reference's PAF replay (SURVEY.md
    # §5 checkpoint/resume: "graph-phase state is never checkpointed" in
    # the reference): persist / restore the converged union-find parent
    # array, skipping the whole alignment phase on resume
    save_checkpoint: str | None = None
    load_checkpoint: str | None = None
    inversion_aware: bool = False  # reference inversion_aware_seqrush mode
    mesh_devices: int | None = None  # shard alignment batches over N devices
    # write a machine-readable run profile (phase timings, aligner stats,
    # graph counts) to this JSON path — structured observability the
    # reference lacks (SURVEY.md §5: stdout summary lines only)
    profile: str | None = None
    # device memory per alignment chunk; None = RunnerConfig's default
    # (single source of truth — align/runner.py RunnerConfig.memory_budget_bytes)
    memory_budget_bytes: int | None = None
    max_chunk_pairs: int = 0  # cap pairs per chunk (0 = memory budget only)
    # wide-pair route: 'anchored' (default) = exact-match chain + piecewise
    # window DP for divergent pairs; 'full' = monster-band sweep
    # (align/runner.py RunnerConfig.wide_route)
    wide_route: str = "anchored"
    # certify every anchored stitch against a score-only sweep at the
    # certified band (a stitch that is not optimal takes the full route)
    wide_verify: bool = False
    # torch device for the alignment kernels and the union-find: 'cuda'
    # (default) or 'cpu' (the plain PyTorch versions; no fallback between them)
    device: str = "cuda"
