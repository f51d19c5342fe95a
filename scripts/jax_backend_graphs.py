#!/usr/bin/env python3
"""The JAX package's graphs of the headline corpus in its default mode, under
the sweepga backend and under --inversion-aware.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_backend_graphs.py [--only default|sweepga|inversion_aware]

Writes chip_smoke.py's headline corpus (25 synthetic HLA-like sequences of
~3.3 kb, one inversion carrier, all 600 ordered pairs) and runs the JAX
package's CLI on it with ``--no-sort``: once with no mode flag, once with
``--aligner sweepga`` and once with ``--inversion-aware``.  Prints one JSON
line per run with the graph's counts, the aligner's counters (among them
``run_overflows``, the walks whose run tokens overflowed and were re-run
through opcodes), the sha256 of the GFA file and, for --inversion-aware,
the inversion window batch's [B, Lq, band, tmax]; chip_smoke.py holds the
port's runs on the card to these (SWEEPGA_GFA_SHA256, INVERSION_GFA_SHA256,
INVERSION_BATCH_SHAPE, RUN_OVERFLOWS).  The default run takes under a
minute, the sweepga run about 10 s, the inversion-aware run a few minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import synth_hla, write_fasta  # noqa: E402

RUNS = (("default", ()), ("sweepga", ("--aligner", "sweepga")),
        ("inversion_aware", ("--inversion-aware",)))
KEYS = ("chains", "filtered_1to1", "host_windows", "run_overflows", "band_escalations",
        "anchored_pairs", "anchored_fallbacks", "cells_true", "cells_padded")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=[tag for tag, _ in RUNS], default=None)
    ns = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import seqrush_tpu.align.inversion as inversion
    from seqrush_tpu import cli
    from seqrush_tpu.ops import nw

    # record the inversion window batch: the one nw_align_device call made
    # inside inversion_patch_alignments
    batches = []
    patch, align_device = inversion.inversion_patch_alignments, nw.nw_align_device

    def recording_align(Q, T, qlens, tlens, **kw):
        batches.append([int(Q.shape[0]), int(Q.shape[1]), kw["band"], kw["tmax"]])
        return align_device(Q, T, qlens, tlens, **kw)

    def recording_patch(*a, **kw):
        nw.nw_align_device = recording_align
        try:
            return patch(*a, **kw)
        finally:
            nw.nw_align_device = align_device

    inversion.inversion_patch_alignments = recording_patch
    with tempfile.TemporaryDirectory(prefix="jax_backend_graphs_") as tmp:
        work = Path(tmp)
        fa = work / "hla25.fa"
        write_fasta(fa, synth_hla())
        for tag, flags in RUNS:
            if ns.only and tag != ns.only:
                continue
            gfa, prof = work / f"{tag}.gfa", work / f"{tag}.json"
            batches.clear()
            t0 = time.time()
            cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort", "--profile", str(prof), *flags])
            rep = json.loads(prof.read_text())
            st = rep["stats"]["aligner"]
            print(json.dumps({
                "run": tag, "flags": list(flags), "seconds": round(time.time() - t0, 2),
                "graph": rep["graph"], "alignments": rep["counters"]["alignments"],
                **{k: st.get(k) for k in KEYS},
                "inversion_batches": list(batches),
                "gfa_sha256": hashlib.sha256(gfa.read_bytes()).hexdigest(),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
