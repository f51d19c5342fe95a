"""Alternate 1-D layout strategies.

Equivalents of the reference's auxiliary SGD variants (src/linear_sgd.rs,
src/simple_sgd.rs): a simplified Zipf-free linear SGD and a local
neighbor-attraction relaxation.  The production layout is layout/sgd.py
(path-guided SGD); these exist for experimentation and parity of surface.
Copied from seqrush_tpu/layout/variants.py (host numpy, over the port's
PathIndex).
"""

from __future__ import annotations

import numpy as np

from ..graph.bigraph import BidirectedGraph
from .sgd import PathIndex


def linear_sgd_order(graph: BidirectedGraph, iterations: int = 30, seed: int = 0) -> list[int]:
    """Simplified linear SGD: uniform random step pairs, fixed learning-rate
    decay, numpy host implementation (graphs are small post-compaction)."""
    index = PathIndex.from_graph(graph)
    node_ids = sorted(graph.nodes)
    if not node_ids or index.total_steps < 2:
        return [nid << 1 for nid in node_ids]
    id_to_idx = {nid: k for k, nid in enumerate(node_ids)}
    lens = np.array([len(graph.nodes[nid]) for nid in node_ids], dtype=np.float64)
    x = np.concatenate([[0.0], np.cumsum(lens)[:-1]])
    node_of_step = np.array([id_to_idx[int(h) >> 1] for h in index.step_handle])

    rng = np.random.default_rng(seed)
    S = index.total_steps
    per_iter = max(S, 32)
    for it in range(iterations):
        eta = max(0.05, 1.0 * (1.0 - it / iterations))
        a = rng.integers(0, S, size=per_iter)
        pid = index.step_path[a]
        cnt = index.path_count[pid]
        b = index.path_first[pid] + rng.integers(0, np.maximum(cnt, 1))
        d = np.abs(index.step_pos[a] - index.step_pos[b]).astype(np.float64)
        ok = (d > 0) & (a != b)
        i, j = node_of_step[a[ok]], node_of_step[b[ok]]
        dx = x[i] - x[j]
        dx = np.where(dx == 0, 1e-9, dx)
        mu = np.minimum(eta / d[ok], 1.0)
        delta = mu * (np.abs(dx) - d[ok]) / 2.0
        r = delta / np.abs(dx) * dx
        np.subtract.at(x, i, r)
        np.add.at(x, j, r)
    order = sorted(range(len(node_ids)), key=lambda k: (x[k], node_ids[k]))
    return [node_ids[k] << 1 for k in order]


def simple_sgd_order(graph: BidirectedGraph, iterations: int = 50) -> list[int]:
    """Neighbor-attraction relaxation: each node moves toward the mean of its
    path neighbors (reference simple_sgd.rs idea), then order by position."""
    node_ids = sorted(graph.nodes)
    if not node_ids:
        return []
    id_to_idx = {nid: k for k, nid in enumerate(node_ids)}
    lens = np.array([len(graph.nodes[nid]) for nid in node_ids], dtype=np.float64)
    x = np.concatenate([[0.0], np.cumsum(lens)[:-1]])
    pairs = []
    for p in graph.paths:
        ids = [id_to_idx[int(h) >> 1] for h in p.steps]
        pairs.extend(zip(ids[:-1], ids[1:]))
    if not pairs:
        return [nid << 1 for nid in node_ids]
    pa = np.array([a for a, _ in pairs])
    pb = np.array([b for _, b in pairs])
    gap = lens[pa]
    for _ in range(iterations):
        target_b = x[pa] + gap
        target_a = x[pb] - gap
        acc = np.zeros_like(x)
        cnt = np.zeros_like(x)
        np.add.at(acc, pb, target_b)
        np.add.at(cnt, pb, 1)
        np.add.at(acc, pa, target_a)
        np.add.at(cnt, pa, 1)
        upd = cnt > 0
        x[upd] = 0.5 * x[upd] + 0.5 * (acc[upd] / cnt[upd])
    order = sorted(range(len(node_ids)), key=lambda k: (x[k], node_ids[k]))
    return [node_ids[k] << 1 for k in order]
