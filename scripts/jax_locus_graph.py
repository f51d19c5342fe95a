#!/usr/bin/env python3
"""The JAX package's --no-sort graph of chip_smoke.py's 8 x 60 kb locus.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_locus_graph.py

Writes chip_smoke.synth_locus() (8 sequences of ~60 kb, all 56 ordered pairs
above the long-pair threshold) and runs the JAX package's CLI on it with
``--no-sort``.  Prints one JSON line with the graph's counts, the long and
anchored routes' counters and the sha256 of the GFA file: the digest that
chip_smoke.py holds the port's locus run to (LOCUS_GFA_SHA256).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import synth_locus, write_fasta  # noqa: E402

KEYS = ("long_pairs", "anchored_pairs", "dropped", "band_escalations")


def main() -> int:
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    with tempfile.TemporaryDirectory(prefix="jax_locus_graph_") as tmp:
        work = Path(tmp)
        fa, gfa, prof = work / "locus.fa", work / "locus.gfa", work / "locus.json"
        write_fasta(fa, synth_locus())
        t0 = time.time()
        subprocess.run([sys.executable, "-m", "seqrush_tpu", "-s", str(fa), "-o", str(gfa),
                        "--no-sort", "--profile", str(prof)],
                       cwd=ROOT, env=env, check=True, stdout=subprocess.DEVNULL)
        rep = json.loads(prof.read_text())
        st = rep["stats"]["aligner"]
        print(json.dumps({
            "seconds": round(time.time() - t0, 2), "graph": rep["graph"],
            "alignments": rep["counters"]["alignments"], **{k: st.get(k) for k in KEYS},
            "gfa_sha256": hashlib.sha256(gfa.read_bytes()).hexdigest(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
