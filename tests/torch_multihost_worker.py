"""One process of a multi-process run of seqrush_tpu_torch's CLI.

Usage: python tests/torch_multihost_worker.py COORD NPROC PID -- CLI-ARGS...

Joins a gloo process group of NPROC processes at COORD (host:port; process
0 listens there) as process PID, then runs ``python -m seqrush_tpu_torch
CLI-ARGS``: each process aligns its stripe of the pair list, the unite
edges are gathered by all, process 0 writes the output and process k
``<output>.hostk``.  NPROC 1 is a plain single-process run.  Used by
tests/test_torch_multihost.py (on the CPU) and by chip_smoke.py (two
processes on one card).
"""

import sys
from pathlib import Path


def main() -> int:
    coord, nproc, pid = sys.argv[1:4]
    argv = sys.argv[4:]
    if argv[:1] == ["--"]:
        argv = argv[1:]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch.distributed as dist

    from seqrush_tpu_torch import cli
    from seqrush_tpu_torch.parallel.distributed import initialize

    rank, world = initialize(coord, int(nproc), int(pid))
    assert world == int(nproc), (world, nproc)
    try:
        rc = cli.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[worker {rank}/{world}] done")
    return rc


if __name__ == "__main__":
    sys.exit(main())
