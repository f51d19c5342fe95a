"""Time the wavefront kernel on the headline corpus's kernel='wfa' batches on one GPU.

    python3 seqrush_tpu_torch/tools/wfa_shapes.py [--root DIR]

Runs the 600 ordered pairs of the headline corpus (``headline.synth_hla``,
scoring 0,5,8,2,24,1) through ``WfaAligner(kernel='wfa', band_slack=128)``
once, to get the batches the runner launches, then times ``wfa_run`` on each
batch (a CUDA-event median of 5 runs after a warm-up) and the score-only
mode on the first.  It prints one JSON line per batch (its shape, score
steps, milliseconds and microseconds a step, and a sha256 of its scores and
history tensors, to hold two builds to each other) and one line with the
launches' sum, each with the card's name and power limit.

--root imports seqrush_tpu_torch from another checkout, such as an earlier
commit unpacked with ``git archive`` or a copy with one part of the kernel
changed, so versions can be timed in turns on one card in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from headline import SCORES, WFA_BAND_SLACK, synth_hla
from sweep_shapes import REPS, cuda_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wfa_shapes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from seqrush_tpu_torch.align.pairs import all_ordered_pairs
    from seqrush_tpu_torch.align.runner import RunnerConfig, WfaAligner, _quantized_pack
    from seqrush_tpu_torch.ops import wfa
    from seqrush_tpu_torch.scores import AlignmentScores
    from seqrush_tpu_torch.sequences import make_sequence_set

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    scores = AlignmentScores.parse(SCORES)
    named = synth_hla()
    pairs = all_ordered_pairs(len(named))
    al = WfaAligner(make_sequence_set(named),
                    RunnerConfig(scores=scores, kernel="wfa", band_slack=WFA_BAND_SLACK), device=dev)
    al.align_pairs(pairs)
    pen = wfa.Penalties.from_scores(scores).kernel_kwargs()
    total, first = 0.0, None
    for d in (d for d in al.stats["dispatches"] if d["kind"] == "wfa"):
        qs, ts, caps = [], [], []
        for p, rc in d["jobs"]:
            qi, tj = pairs[p]
            q, t = (al.rc_codes[qi] if rc else al.codes[qi]), al.codes[tj]
            qs.append(q)
            ts.append(t)
            caps.append(al._pair_cap(q.size, t.size))
        Q, T, ql, tl = _quantized_pack(qs, ts)
        caps = np.minimum(np.array(caps + [0] * (len(ql) - len(caps)), np.int32), d["smax"])
        a = [torch.from_numpy(x).to(dev) for x in (Q, T, ql, tl, caps)]
        kw = dict(smax=d["smax"], band=d["band"], keep_history=True, **pen)
        s_k, h_k = wfa.wfa_run(*a, **kw)
        digest = hashlib.sha256(s_k.cpu().numpy().tobytes())
        for h in h_k:
            digest.update(h.cpu().numpy().tobytes())
        steps = max(int(s) if s >= 0 else int(c) for s, c in zip(s_k.tolist(), caps.tolist()))
        ms = cuda_ms(lambda: wfa.wfa_run(*a, **kw), REPS)
        total += ms
        first = first or (a, kw)
        print(json.dumps({"root": str(args.root), "B": len(ql), "band": d["band"], "smax": d["smax"],
                          "Lq": Q.shape[1], "steps": steps, "ms": ms, "us_per_step": ms * 1e3 / max(1, steps),
                          "sha256": digest.hexdigest()[:16], "card": smi}), flush=True)
        del s_k, h_k
    a, kw = first
    kw0 = dict(kw, keep_history=False)
    ms0 = cuda_ms(lambda: wfa.wfa_run(*a, **kw0), REPS)
    print(json.dumps({"root": str(args.root), "launches_ms": total, "score_only_first_batch_ms": ms0,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
