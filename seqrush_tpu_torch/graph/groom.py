"""Grooming (the 'g' phase of Ygs): remove spurious inverting links.

Behavioral port of the reference's ODGI-style BFS groom (reference 
src/groom.rs:49-313, 613-685):

* seeds = head nodes (fallback: lowest node id, forward);
* BFS follows stored edges whose ``from`` equals the current handle exactly
  (no implied complements), in sorted edge order;
* first visit wins: a node reached via its reverse orientation is flipped;
* apply = reverse-complement flipped node sequences and XOR orientations in
  edges and path steps; node order is unchanged (reorder=False in Ygs).
"""

from __future__ import annotations

from collections import deque

from .bigraph import BidirectedGraph


def groom_order(graph: BidirectedGraph) -> list[int]:
    """Returns handles in current node order with flip bits set for nodes
    whose first visit was via reverse orientation."""
    # sorted outgoing adjacency on stored edges (groom.rs:285-291)
    out_adj: dict[int, list[int]] = {}
    for (f, t) in sorted(graph.edges):
        out_adj.setdefault(f, []).append(t)

    visited: set[int] = set()
    flipped: set[int] = set()

    seeds = graph.find_head_nodes()
    if not seeds and graph.nodes:
        seeds = [min(graph.nodes) << 1]

    all_ids = sorted(graph.nodes)
    current_seeds = list(seeds)
    while len(visited) < len(all_ids):
        if not current_seeds:
            for nid in all_ids:
                if nid not in visited:
                    current_seeds = [nid << 1]  # forward, like ODGI
                    break
            if not current_seeds:
                break
        _bfs(current_seeds, out_adj, visited, flipped)
        current_seeds = []

    return [
        (nid << 1) | 1 if nid in flipped else (nid << 1) for nid in all_ids
    ]


def _bfs(seeds, out_adj, visited, flipped) -> None:
    queue = deque()
    for seed in seeds:
        nid = seed >> 1
        if nid not in visited:
            queue.append(seed)
            visited.add(nid)
            if seed & 1:
                flipped.add(nid)
    while queue:
        current = queue.popleft()
        for nxt in out_adj.get(current, ()):
            nid = nxt >> 1
            if nid not in visited:
                visited.add(nid)
                if nxt & 1:
                    flipped.add(nid)
                queue.append(nxt)


def apply_grooming(
    graph: BidirectedGraph, groomed_handles: list[int], reorder: bool = False
) -> None:
    """Flip the marked nodes; optionally renumber by traversal order
    (groom.rs apply_grooming_with_reorder; Ygs uses reorder=False)."""
    flips = {h >> 1 for h in groomed_handles if h & 1}
    graph.flip_nodes(flips)
    if reorder:
        graph.apply_ordering(groomed_handles)


def groom(graph: BidirectedGraph) -> None:
    apply_grooming(graph, groom_order(graph))


# -- variants (reference groom.rs DFS / coverage-weighted DFS / iterative) ----


def groom_order_dfs(graph: BidirectedGraph, use_coverage: bool = False) -> list[int]:
    """DFS grooming variant; with use_coverage, neighbors are explored in
    descending path-coverage order (groom.rs:422-488)."""
    coverage: dict[tuple[int, int], int] = {}
    if use_coverage:
        for path in graph.paths:
            for x, y in zip(path.steps[:-1], path.steps[1:]):
                key = (int(x), int(y))
                coverage[key] = coverage.get(key, 0) + 1

    out_adj: dict[int, list[int]] = {}
    for (f, t) in sorted(graph.edges):
        out_adj.setdefault(f, []).append(t)
    if use_coverage:
        for f, nbrs in out_adj.items():
            nbrs.sort(key=lambda t: (-coverage.get((f, t), 0), t))

    visited: set[int] = set()
    flipped: set[int] = set()
    all_ids = sorted(graph.nodes)
    seeds = graph.find_head_nodes() or ([all_ids[0] << 1] if all_ids else [])
    stack: list[int] = []
    while len(visited) < len(all_ids):
        if not stack:
            for seed in seeds:
                if (seed >> 1) not in visited:
                    stack.append(seed)
                    break
            else:
                for nid in all_ids:
                    if nid not in visited:
                        stack.append(nid << 1)
                        break
            if not stack:
                break
        h = stack.pop()
        nid = h >> 1
        if nid in visited:
            continue
        visited.add(nid)
        if h & 1:
            flipped.add(nid)
        for nxt in reversed(out_adj.get(h, ())):
            if (nxt >> 1) not in visited:
                stack.append(nxt)
    return [(nid << 1) | 1 if nid in flipped else (nid << 1) for nid in all_ids]


def iterative_groom(graph: BidirectedGraph, max_iterations: int = 10) -> int:
    """Groom repeatedly until no node flips (groom.rs:543-605 fixpoint).
    Returns iterations performed."""
    for it in range(max_iterations):
        order = groom_order(graph)
        flips = {h >> 1 for h in order if h & 1}
        if not flips:
            return it
        apply_grooming(graph, order)
    return max_iterations


def sort_groom_sort(graph: BidirectedGraph) -> None:
    """Deprecated strategy kept for compatibility: toposort, groom, toposort."""
    from .toposort import exact_odgi_topological_order

    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
    groom(graph)
    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))
