"""Multi-process runs: processes joined by torch.distributed (gloo).

The port of ``seqrush_tpu/parallel/distributed.py``.  Every process loads
the same FASTA; the global pair list is cut into contiguous stripes, one a
process (``host_stripe``); each process aligns its stripe on its own
device(s) and turns the results into unite edges; the edge lists are
gathered by every process (``allgather_edge_lists``) and each applies the
same deterministic unite, so the parent array, and with it the graph, is
the same on every process.  The edge lists are host arrays, so the gloo
backend serves every device type; nothing else is exchanged.

Nothing on a machine announces a cluster: the caller gives ``initialize``
the coordinator's address (``host:port``; process 0 listens there), the
process count and this process's index.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join a gloo process group when num_processes > 1; returns
    (process_index, process_count).  Nothing to do for one process."""
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator's address and this process's index")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    return process_index(), process_count()


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    return dist.get_world_size() if _joined() else 1


def host_stripe(n_items: int, process_index: int, process_count: int) -> slice:
    """Contiguous stripe of the pair list owned by this host."""
    per = -(-n_items // process_count)
    return slice(process_index * per, min((process_index + 1) * per, n_items))


def allgather_edge_lists(u: np.ndarray, v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather every process's unite edge lists (in process order) on every
    process.  The lists' lengths differ, so the lengths are gathered first,
    every payload is padded to the longest, and each process's valid prefix
    is cut back out after the gather.  With one process this is the
    identity.  A collective: every process must call it."""
    if process_count() == 1:
        return u, v
    world = process_count()
    n = torch.tensor([u.size], dtype=torch.int64)
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lengths, n)
    lengths = [int(x.item()) for x in lengths]
    lmax = max(max(lengths), 1)
    payload = torch.zeros((2, lmax), dtype=torch.int64)
    payload[0, : u.size] = torch.from_numpy(np.asarray(u, dtype=np.int64))
    payload[1, : v.size] = torch.from_numpy(np.asarray(v, dtype=np.int64))
    gathered = [torch.zeros((2, lmax), dtype=torch.int64) for _ in range(world)]
    dist.all_gather(gathered, payload)
    us = [g[0, :k].numpy() for g, k in zip(gathered, lengths)]
    vs = [g[1, :k].numpy() for g, k in zip(gathered, lengths)]
    return np.concatenate(us), np.concatenate(vs)
