#!/usr/bin/env python3
"""The JAX package's graphs of the headline corpus on both wide routes.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_route_graphs.py

Writes chip_smoke.py's headline corpus (25 synthetic HLA-like sequences of
~3.3 kb, one inversion carrier, all 600 ordered pairs) and runs the JAX
package's CLI on it with ``--no-sort``: once with no route flag (off a TPU
its wide pairs take the anchored route) and once with ``--wide-route full``.
Prints one JSON line per run with the graph's counts, the anchored route's
counters and the sha256 of the GFA file; chip_smoke.py prints the same
digests for the port's runs on the card.
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

from chip_smoke import synth_hla, write_fasta  # noqa: E402

RUNS = (("default", ()), ("full", ("--wide-route", "full")))
KEYS = ("anchored_pairs", "anchored_windows", "host_windows", "anchored_fallbacks")


def main() -> int:
    env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    with tempfile.TemporaryDirectory(prefix="jax_route_graphs_") as tmp:
        work = Path(tmp)
        fa = work / "hla25.fa"
        write_fasta(fa, synth_hla())
        for tag, flags in RUNS:
            gfa, prof = work / f"{tag}.gfa", work / f"{tag}.json"
            t0 = time.time()
            subprocess.run([sys.executable, "-m", "seqrush_tpu", "-s", str(fa), "-o", str(gfa),
                            "--no-sort", "--profile", str(prof), *flags],
                           cwd=ROOT, env=env, check=True, stdout=subprocess.DEVNULL)
            rep = json.loads(prof.read_text())
            st = rep["stats"]["aligner"]
            print(json.dumps({
                "route": tag, "flags": list(flags), "seconds": round(time.time() - t0, 2),
                "graph": rep["graph"], "alignments": rep["counters"]["alignments"],
                **{k: st.get(k) for k in KEYS},
                "gfa_sha256": hashlib.sha256(gfa.read_bytes()).hexdigest(),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
