"""Two real processes of seqrush_tpu_torch (device='cpu') joined by a gloo
process group on a free localhost port: each aligns its stripe of the pair
list, the unite edges are gathered by both, and both write the same graph.
Their --no-sort GFA files must be byte-identical to each other, to a
single-process run and to the JAX package's single-process GFA."""

import os
import socket
import subprocess
import sys

import numpy as np

from seqrush_tpu.config import Args as JaxArgs
from seqrush_tpu.pipeline import run_seqrush as jax_run_seqrush

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_fasta(path: str) -> None:
    """tests/test_multihost.py's corpus: 5 x 220 bp, SNPs, one deletion."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = bases[rng.integers(0, 4, size=220)]
    with open(path, "w") as fh:
        fh.write(">s0\n" + base.tobytes().decode() + "\n")
        for k in range(1, 5):
            v = bytearray(base.tobytes())
            for pos in rng.integers(0, len(v), size=5):
                v[pos] = bases[rng.integers(0, 4)]
            if k == 3:
                del v[60:67]
            fh.write(f">s{k}\n" + bytes(v).decode() + "\n")


def _run(nproc: int, fasta: str, out: str) -> None:
    coord = f"127.0.0.1:{_free_port()}"
    # one intra-op thread a worker: the suite's workers share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cli_args = ["--", "-s", fasta, "-o", out, "--no-sort", "--device", "cpu", "-v"]
    procs = [subprocess.Popen([sys.executable, WORKER, coord, str(nproc), str(pid), *cli_args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            outs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, so, se in outs:
        assert rc == 0, f"worker failed:\n{so}\n{se}"
    if nproc > 1:
        assert "[multihost] process 1/2 aligns pairs [10:20) of 20" in outs[1][1]


def test_two_process_gfa_identical(tmp_path):
    fasta = str(tmp_path / "in.fa")
    _write_fasta(fasta)
    single, multi, jax = (str(tmp_path / f"{n}.gfa") for n in ("single", "multi", "jax"))
    _run(1, fasta, single)
    _run(2, fasta, multi)
    jax_run_seqrush(JaxArgs(sequences=fasta, output=jax, no_sort=True))
    gfa_h0 = open(multi).read()
    gfa_h1 = open(multi + ".host1").read()
    assert gfa_h0.startswith("H\tVN:Z:1.0")
    assert gfa_h0 == gfa_h1, "the processes disagree on the graph"
    assert gfa_h0 == open(single).read(), "two processes differ from one"
    assert gfa_h0 == open(jax).read(), "the port differs from the JAX package"
