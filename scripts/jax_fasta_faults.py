#!/usr/bin/env python3
"""The JAX package's --no-sort runs of chip_smoke.fasta_faults().

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/jax_fasta_faults.py

Writes each of the three FASTA files (blanks after '>', a vertical tab and
a form feed on sequence lines, 70,000-byte headers) and runs the JAX
package's CLI on it with ``--no-sort``.  Prints one JSON line per file:
the sha256 of the GFA file, or, where the run raises (the blank names fail
the golden check), the sha256 of the exception's message and its first
line.  chip_smoke.py holds the port's runs on the card to these
(FASTA_FAULTS_JAX).  About 10 s in all.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import fasta_faults  # noqa: E402


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from seqrush_tpu import cli

    with tempfile.TemporaryDirectory(prefix="jax_fasta_faults_") as tmp:
        for tag, data in fasta_faults().items():
            fa, gfa = Path(tmp) / f"{tag}.fa", Path(tmp) / f"{tag}.gfa"
            fa.write_bytes(data)
            t0 = time.time()
            try:
                rc = cli.main(["-s", str(fa), "-o", str(gfa), "--no-sort"])
                out = {"tag": tag, "rc": rc, "gfa_sha256": hashlib.sha256(gfa.read_bytes()).hexdigest()}
            except RuntimeError as exc:
                msg = str(exc)
                out = {"tag": tag, "error_sha256": hashlib.sha256(msg.encode()).hexdigest(),
                       "error": msg.splitlines()[0]}
            out["seconds"] = round(time.time() - t0, 2)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
