"""Time kernels C and D (the row-major sweep and walk) at chosen batch sizes and widths on one GPU.

    python3 seqrush_tpu_torch/tools/rows_shapes.py [--shapes B:Wr,...]
        [--int16] [--root DIR]

The pairs are sweep_shapes.py's synthetic gene-length haplotypes (seed 0,
~3,300 bases), packed as the runner packs a chunk (lengths rounded up to
256: R = 3,584 query rows), with the headline scoring 0,5,8,2,24,1 and
band (Wr - 1) / 2.  For each shape B:Wr it prints one JSON line with the
time of ``nw_align_rows`` (the planner's strip) and of ``nw_walk_rows`` on
its traceback (CUDA-event medians of 5 runs after a warm-up; for the walk
also its kernel's mean device time from the profiler over 20 calls, since
the host's time to issue a call is near the kernel's own), the sweep's
microseconds a row, and a sha256 of the sweep's scores and traceback and
one of the walk's steps, gap rows, lengths and counts, to hold two builds
to each other.

--root imports seqrush_tpu_torch from another checkout, such as an earlier
commit unpacked with ``git archive``; only ``nw_align_rows`` and
``nw_walk_rows`` are used, so two versions of the kernels can be timed on
one card in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from sweep_shapes import LENGTH, PENALTIES, REPS, cuda_ms, device_ms, make_pairs, pack


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="576:1023,48:3071")
    ap.add_argument("--int16", action="store_true")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rows_shapes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from seqrush_tpu_torch.ops import nw_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for spec in args.shapes.split(","):
        B, Wr = (int(x) for x in spec.split(":"))
        band = (Wr - 1) // 2
        (Q, T, ql, tl), _tmax = pack(make_pairs(B, LENGTH, 0), dev)
        kw = dict(PENALTIES, band=band, int16=args.int16)
        s_k, tb_k = nw_cuda.nw_align_rows(Q, T, ql, tl, **kw)
        R = Q.shape[1]
        ms = cuda_ms(lambda: nw_cuda.nw_align_rows(Q, T, ql, tl, **kw), REPS)
        digest = hashlib.sha256(s_k.cpu().numpy().tobytes())
        digest.update(tb_k.cpu().numpy().tobytes())
        walk = nw_cuda.nw_walk_rows(tb_k, ql, tl, band=band)
        walk_ms = cuda_ms(lambda: nw_cuda.nw_walk_rows(tb_k, ql, tl, band=band), REPS)
        walk_dev_ms = device_ms(lambda: nw_cuda.nw_walk_rows(tb_k, ql, tl, band=band), "nw_rows_walk_kernel", 20)
        walk_digest = hashlib.sha256()
        for a in walk:
            walk_digest.update(a.cpu().numpy().tobytes())
        row = {"root": str(args.root), "B": B, "R": R, "Wr": Wr, "int16": args.int16, "card": smi,
               "nw_align_rows_ms": ms, "us_per_row": ms * 1e3 / R,
               "plan": list(nw_cuda.rows_plan(Wr)), "sha256": digest.hexdigest()[:16],
               "nw_walk_rows_ms": walk_ms, "nw_walk_rows_device_ms": walk_dev_ms,
               "walk_sha256": walk_digest.hexdigest()[:16]}
        print(json.dumps(row), flush=True)
        del s_k, tb_k, walk, Q, T, ql, tl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
