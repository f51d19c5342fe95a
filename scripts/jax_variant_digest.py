#!/usr/bin/env python3
"""The JAX package's alignments of the headline corpus under the RunnerConfig
options of chip_smoke.py's phase 9 (int16, rows, fold, band tiling on the
full wide route, and their combinations with int16).

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_variant_digest.py [name ...]

For each option of chip_smoke.VARIANTS (all, or the names given) it aligns
every ordered pair of chip_smoke.synth_hla() (600 pairs), or of
chip_smoke.wfa_subset() (30 pairs) for the options in VARIANT_ON_SUBSET,
with the JAX package's WfaAligner (scoring 0,5,8,2,24,1) and prints one JSON
line: the sha256 of the sorted (query, target, reverse, score, CIGAR)
records (chip_smoke.records_digest), the counters of VARIANT_COUNTERS, the
seconds and the peak resident memory (5.7 GB for the band-tiling options).  chip_smoke.py holds the port's runs
on the card to these (VARIANT_DIGESTS).
"""

from __future__ import annotations

import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    SCORES, VARIANT_COUNTERS, VARIANT_ON_SUBSET, VARIANTS, records_digest, synth_hla, wfa_subset,
)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from seqrush_tpu.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu.scores import AlignmentScores
    from seqrush_tpu.sequences import make_sequence_set

    for name in sys.argv[1:] or list(VARIANTS):
        named = wfa_subset() if name in VARIANT_ON_SUBSET else synth_hla()
        n = len(named)
        pairs = np.array([(i, j) for i in range(n) for j in range(n) if i != j])
        al = WfaAligner(make_sequence_set(named), RunnerConfig(
            scores=AlignmentScores.parse(SCORES), **VARIANTS[name]))
        t0 = time.time()
        res = al.align_pairs(pairs)
        print(json.dumps({
            "variant": name, "pairs": len(pairs), "aligned": len(res),
            "seconds": round(time.time() - t0, 2),
            "records_sha256": records_digest(res),
            "counters": {k: al.stats[k] for k in VARIANT_COUNTERS},
            "max_rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
