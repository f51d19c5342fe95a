"""The headline corpus and its scoring, shared by ``chip_smoke.py``, the
JAX package's digest scripts under ``scripts/`` (through ``chip_smoke``) and
``tools/wfa_shapes.py``."""

from __future__ import annotations

import numpy as np

SCORES = "0,5,8,2,24,1"
# RunnerConfig's band_slack on the kernel='wfa' route (chip_smoke.py phase 8b,
# scripts/jax_wfa_digest.py, tools/wfa_shapes.py)
WFA_BAND_SLACK = 128


def synth_hla(n_seqs=25, length=3300, seed=7):
    """HLA-like corpus: one base, ~2% SNPs and a few indels per sample, the
    last sample's middle third reverse-complemented (the JAX bench's
    headline generator)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=length)]
    out = [("gene*00", base.tobytes())]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for k in range(1, n_seqs):
        s = bytearray(base.tobytes())
        for pos in rng.integers(0, len(s), size=int(0.02 * len(s))):
            s[pos] = bases[rng.integers(0, 4)]
        for _ in range(rng.integers(2, 6)):
            pos = int(rng.integers(0, len(s) - 50))
            ln = int(rng.integers(1, 30))
            if rng.random() < 0.5:
                del s[pos : pos + ln]
            else:
                s[pos:pos] = bases[rng.integers(0, 4, size=ln)].tobytes()
        if k == n_seqs - 1:
            a, b = len(s) // 3, 2 * len(s) // 3
            s[a:b] = bytes(s[a:b]).translate(comp)[::-1]
        out.append((f"gene*{k:02d}", bytes(s)))
    return out
