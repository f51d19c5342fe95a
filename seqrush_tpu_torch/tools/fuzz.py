"""Randomized full-pipeline fuzzer.

Generates random sequence families (SNPs, indels, tandem duplications,
inversions), runs the complete pipeline under random mode combinations
(--no-compact / --no-sort / --inversion-aware / --seqwish-style / -k /
--wide-verify), and checks the golden invariant plus structural consistency
on every trial (the port of ``seqrush_tpu/tools/fuzz.py``; trial t draws the
same family and modes in both packages).

  python -m seqrush_tpu_torch.tools.fuzz --seconds 120
  python -m seqrush_tpu_torch.tools.fuzz --trials 50 --seed-base 1 --device cpu

The default device is cuda (the kernels); ``--device cpu`` runs their plain
versions.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def mutate(rng: np.random.Generator, s: bytes) -> bytes:
    s = bytearray(s)
    for _ in range(int(rng.integers(0, 8))):
        if len(s) < 30:
            break
        op = rng.integers(0, 5)
        pos = int(rng.integers(0, len(s) - 20))
        if op == 0:
            s[pos] = BASES[rng.integers(0, 4)]
        elif op == 1:
            del s[pos : pos + int(rng.integers(1, 15))]
        elif op == 2:
            s[pos:pos] = BASES[rng.integers(0, 4, size=int(rng.integers(1, 15)))].tobytes()
        elif op == 3:  # tandem duplication
            ln = int(rng.integers(3, 20))
            s[pos:pos] = bytes(s[pos : pos + ln])
        else:  # inversion
            ln = min(int(rng.integers(10, 60)), len(s) - pos)
            s[pos : pos + ln] = bytes(s[pos : pos + ln]).translate(COMP)[::-1]
    return bytes(s)


def trial_case(trial: int) -> tuple[list[tuple[str, bytes]], dict]:
    """Trial ``trial``'s family and Args options (without output/device)."""
    rng = np.random.default_rng(trial * 7919)
    n = int(rng.integers(2, 7))
    L = int(rng.integers(40, 500))
    wide_trial = rng.random() < 0.15
    if wide_trial:
        # long, heavily diverged family: drives the anchored wide route
        # (chain + host window DP + stitch + fallbacks), which small trials
        # never reach (wide_min_len gate)
        n = int(rng.integers(2, 4))
        L = int(rng.integers(2100, 4200))
    base = BASES[rng.integers(0, 4, size=L)].tobytes()
    fam = [(f"s{k}", mutate(rng, base) if k else base) for k in range(n)]
    if wide_trial:
        # every non-base haplotype gets a large inverted block (10-40%)
        fam2 = [fam[0]]
        for name, s in fam[1:]:
            b = bytearray(s)
            frac = rng.uniform(0.1, 0.4)
            a = int(rng.uniform(0.05, 0.9 - frac) * len(b))
            e = a + int(frac * len(b))
            b[a:e] = bytes(b[a:e]).translate(COMP)[::-1]
            fam2.append((name, bytes(b)))
        fam = fam2
    opts = dict(seed=trial)
    if wide_trial and rng.random() < 0.5:
        opts["wide_verify"] = True  # runtime certification of every stitch
    r = rng.integers(0, 4)
    if r == 1:
        opts["no_compact"] = True
    if r == 2:
        opts["no_sort"] = True
    if r == 3:
        opts["inversion_aware"] = True
    if rng.random() < 0.3:
        opts["min_match_length"] = int(rng.integers(0, 20))
    if rng.random() < 0.2:
        opts["seqwish_style"] = True
    return fam, opts


def one_trial(trial: int, workdir: str, device: str = "cuda") -> list[str]:
    from ..config import Args
    from ..pipeline import SeqRushTorch
    from ..sequences import make_sequence_set

    fam, opts = trial_case(trial)
    sr = SeqRushTorch(make_sequence_set(fam), Args(output=f"{workdir}/fuzz.gfa", device=device, **opts))
    sr.align_and_unite()
    g = sr.write_gfa()
    return sr.validate_paths_match_sequences(g) + g.validate_consistency()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fuzz")
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--trials", type=int, default=0, help="0 = run until --seconds")
    p.add_argument("--seed-base", type=int, default=1)
    p.add_argument("--workdir", default=None, help="default: a temporary directory")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the kernels, cpu their plain versions")
    ns = p.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="seqrush_fuzz_") as tmp:
        workdir = ns.workdir or tmp
        fails = 0
        t0 = time.time()
        trial = ns.seed_base - 1
        done = 0
        while True:
            trial += 1
            done += 1
            if ns.trials and done > ns.trials:
                break
            if not ns.trials and time.time() - t0 > ns.seconds:
                break
            try:
                errs = one_trial(trial, workdir, ns.device)
                if errs:
                    print(f"TRIAL {trial} INVARIANT FAIL: {errs[:2]}")
                    fails += 1
            except Exception as e:  # noqa: BLE001 -- every trial's fault is reported
                print(f"TRIAL {trial} EXCEPTION: {type(e).__name__}: {str(e)[:200]}")
                fails += 1
            if fails >= 5:
                break
    print(f"fuzz: {done - 1} trials, {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
