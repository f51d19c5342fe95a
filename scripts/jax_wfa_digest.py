#!/usr/bin/env python3
"""The JAX package's wavefront (kernel='wfa') alignments of the WFA digest's
corpus.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_wfa_digest.py

Aligns every ordered pair of chip_smoke.wfa_subset() (the headline corpus's
first five sequences and its inversion carrier, 30 pairs) with the JAX
package's WfaAligner, RunnerConfig(kernel='wfa', band_slack=WFA_BAND_SLACK,
scoring 0,5,8,2,24,1), and prints one JSON line: the sha256 of the sorted
(query, target, reverse, score, CIGAR) records (chip_smoke.records_digest),
the scores, the escalations and the seconds.  chip_smoke.py holds the
port's run of the same pairs on the card to this digest
(WFA_SUBSET_SHA256).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SCORES, WFA_BAND_SLACK, records_digest, wfa_subset  # noqa: E402


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from seqrush_tpu.align.runner import RunnerConfig, WfaAligner
    from seqrush_tpu.scores import AlignmentScores
    from seqrush_tpu.sequences import make_sequence_set

    named = wfa_subset()
    n = len(named)
    pairs = np.array([(i, j) for i in range(n) for j in range(n) if i != j])
    al = WfaAligner(make_sequence_set(named), RunnerConfig(
        scores=AlignmentScores.parse(SCORES), kernel="wfa", band_slack=WFA_BAND_SLACK))
    t0 = time.time()
    res = al.align_pairs(pairs)
    print(json.dumps({
        "pairs": len(pairs), "aligned": len(res), "seconds": round(time.time() - t0, 2),
        "escalations": al.stats["escalations"], "dropped": al.stats["dropped"],
        "scores": sorted([r.query_idx, r.target_idx, int(r.is_reverse), r.score] for r in res),
        "records_sha256": records_digest(res),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
