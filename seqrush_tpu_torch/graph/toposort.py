"""Exact-ODGI topological ordering (the 's' phase of Ygs).

Line-for-behavior reimplementation of the reference's modified Kahn's
algorithm (reference src/bidirected_ops.rs:1390-1599), which itself
replicates ``odgi sort`` 's':

* heads (no incoming edges to either orientation) seed the ready set,
  sorted by earliest path position then node id (bidirected_ops.rs:1345-1352);
* the ready set pops the minimum handle (BTreeSet semantics = handle code
  order: node id, then orientation);
* edges are treated exactly as stored (no implied complements), iterated in
  sorted (from, to) order;
* when the ready set drains with nodes left (cycles), seeds discovered during
  traversal are taken in node-id order, then an arbitrary minimum unvisited
  handle (forward before reverse);
* nodes are emitted as forward handles at first visit.

Indexed adjacency replaces the reference's O(V*E) full edge rescans while
preserving identical iteration order.
"""

from __future__ import annotations

import heapq

import numpy as np

from .bigraph import BidirectedGraph


def exact_odgi_topological_order(
    graph: BidirectedGraph,
    use_heads: bool = True,
    use_tails: bool = False,
) -> list[int]:
    if not graph.nodes:
        return []

    edges = sorted(graph.edges)  # (from, to) ascending == reference sort order
    out_adj: dict[int, list[int]] = {}  # from-handle -> edge indices
    in_adj: dict[int, list[int]] = {}  # to-handle -> edge indices
    for idx, (f, t) in enumerate(edges):
        out_adj.setdefault(f, []).append(idx)
        in_adj.setdefault(t, []).append(idx)
    masked = np.zeros(len(edges), dtype=bool)
    in_count = {h: len(v) for h, v in in_adj.items()}  # unmasked incoming per handle

    sorted_out: list[int] = []
    visited_nodes: set[int] = set()
    unvisited: set[int] = set()
    for nid in graph.nodes:
        unvisited.add(nid << 1)
        unvisited.add((nid << 1) | 1)

    ready: list[int] = []  # heap of handles (BTreeSet min-pop)
    in_ready: set[int] = set()
    seeds: list[int] = []

    def push_ready(h: int) -> None:
        if h not in in_ready:
            heapq.heappush(ready, h)
            in_ready.add(h)
        unvisited.discard(h)
        unvisited.discard(h ^ 1)

    if use_heads:
        for h in graph.find_head_nodes():
            push_ready(h)
    elif use_tails:
        for h in graph.find_tail_nodes():
            push_ready(h)

    while unvisited or ready:
        if not ready:
            # break into a cycle: seeds in (node id, orientation) order first
            found = False
            if seeds:
                seeds.sort(key=lambda h: (h >> 1, h & 1))
                h = seeds.pop(0)
                if h in unvisited:
                    push_ready(h)
                    found = True
            if not found and not ready and unvisited:
                h = min(unvisited, key=lambda x: (x >> 1, x & 1))
                push_ready(h)

        while ready:
            handle = heapq.heappop(ready)
            in_ready.discard(handle)

            nid = handle >> 1
            if nid not in visited_nodes:
                visited_nodes.add(nid)
                sorted_out.append(nid << 1)  # emit forward orientation

            # mask incoming edges of this handle
            for idx in in_adj.get(handle, ()):  # already in sorted edge order
                if not masked[idx]:
                    masked[idx] = True
                    in_count[handle] -= 1

            # follow outgoing edges
            for idx in out_adj.get(handle, ()):
                if masked[idx]:
                    continue
                masked[idx] = True
                nxt = edges[idx][1]
                in_count[nxt] -= 1
                if nxt in unvisited:
                    if in_count.get(nxt, 0) <= 0:
                        push_ready(nxt)
                    else:
                        if nxt not in seeds:
                            seeds.append(nxt)

    return sorted_out


def apply_exact_odgi_ordering(graph: BidirectedGraph) -> None:
    graph.apply_ordering(exact_odgi_topological_order(graph, True, False))


def sgd_stable_topological_order(
    graph: BidirectedGraph, stall_bound: int = 8
) -> list[int]:
    """Bounded-displacement topological order over path-flow constraints —
    the quality-first alternative to the ODGI 's' phase (beats the
    reference; exact_odgi_topological_order remains the parity mode).

    Motivation (measured on the synthetic zoo): Kahn's algorithm AMPLIFIES
    SGD tail errors — one mis-ranked predecessor stalls a whole run of
    correctly-placed successors, displacing hundreds of nodes by hundreds
    of ranks (the p90 displacement on zoo genes was ~125 ranks, and the
    final sort cost 10-60 bp of RMSE).  The reference's own design doc
    proposes bubble-chain decomposition to bound this
    (the povu sorting note in the reference docs); this is a simpler
    mechanism with the same guarantee: a node stalled more than
    ``stall_bound`` ranks past its SGD rank is force-emitted, turning its
    unmet in-constraints into back-edges — exactly what they would be in
    the pure SGD order.

    Constraints come from PATH flow, not stored edges: each consecutive
    step pair votes for its node order, and only the majority direction of
    each node pair constrains (an inverted haplotype's back-traversal
    cannot override the forward majority).  Deterministic: ties break by
    node id (= SGD rank after the Y phase renumbering); the ready set is a
    min-heap on rank."""
    if not graph.nodes:
        return []
    # vectorized vote accumulation: one packed-key unique over every
    # consecutive step pair (the python dict loop dominated host time on
    # large graphs)
    keys = []
    nbits = max(int(n).bit_length() for n in graph.nodes) + 1
    for p in graph.paths:
        ns = (np.asarray(p.steps) >> 1).astype(np.int64)
        if ns.size < 2:
            continue
        a, b = ns[:-1], ns[1:]
        m = a != b
        keys.append((a[m] << nbits) | b[m])
    votes: dict[tuple[int, int], int] = {}
    if keys:
        uniq, counts = np.unique(np.concatenate(keys), return_counts=True)
        mask = (1 << nbits) - 1
        votes = {
            (int(k) >> nbits, int(k) & mask): int(c)
            for k, c in zip(uniq, counts)
        }
    out: dict[int, list[int]] = {n: [] for n in graph.nodes}
    indeg: dict[int, int] = {n: 0 for n in graph.nodes}
    for (a, b), w in votes.items():
        wr = votes.get((b, a), 0)
        if w > wr or (w == wr and a < b):
            out[a].append(b)
            indeg[b] += 1

    remaining_heap = sorted(graph.nodes)  # ranks == node ids post-Y
    heapq.heapify(remaining_heap)
    ready = [n for n in graph.nodes if indeg[n] == 0]
    heapq.heapify(ready)
    remaining = set(graph.nodes)
    order: list[int] = []
    rank = {n: k for k, n in enumerate(sorted(graph.nodes))}

    def emit(n: int) -> None:
        remaining.discard(n)
        order.append(n << 1)
        for b in out[n]:
            if b in remaining:
                indeg[b] -= 1
                if indeg[b] == 0:
                    heapq.heappush(ready, b)

    while remaining:
        while remaining_heap and remaining_heap[0] not in remaining:
            heapq.heappop(remaining_heap)
        n0 = remaining_heap[0]
        if rank[n0] <= len(order) - stall_bound:
            emit(n0)  # stalled past the bound: force-emit
            continue
        while ready and ready[0] not in remaining:
            heapq.heappop(ready)
        if ready:
            emit(heapq.heappop(ready))
        else:
            emit(n0)  # cycle: break at the lowest rank
    return order


# -----------------------------------------------------------------------------
# Legacy node-level analysis utilities (reference graph_ops.rs)
# -----------------------------------------------------------------------------


def _node_adjacency(graph: BidirectedGraph) -> dict[int, list[int]]:
    """Node-level directed adjacency (orientation collapsed): stored edge
    (from_handle, to_handle) contributes from>>1 -> to>>1, neighbor lists
    sorted for determinism (graph_ops.rs builds the same unidirected view
    for its SCC/topo analyses, :437-452)."""
    adj: dict[int, list[int]] = {nid: [] for nid in graph.nodes}
    for f, t in graph.edges:
        adj[f >> 1].append(t >> 1)
    for nid in adj:
        adj[nid] = sorted(set(adj[nid]))
    return adj


def strongly_connected_components(graph: BidirectedGraph) -> list[list[int]]:
    """Tarjan SCCs of the node-level view — the reference's legacy cycle
    diagnostic (reference src/graph_ops.rs:347-430: deterministic
    sorted root order, components emitted in completion order).  Iterative
    (no recursion limit); singleton components are acyclic nodes, larger
    ones mark cycles (tandem repeats / unite corruption)."""
    adj = _node_adjacency(graph)
    index: dict[int, int] = {}
    lowlink: dict[int, int] = {}
    on_stack: set[int] = set()
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = 0

    for root in sorted(adj):
        if root in index:
            continue
        # iterative strongconnect: (node, neighbor cursor) work stack
        work = [(root, 0)]
        while work:
            v, ci = work[-1]
            if ci == 0:
                index[v] = lowlink[v] = counter
                counter += 1
                stack.append(v)
                on_stack.add(v)
            advanced = False
            neighbors = adj[v]
            while ci < len(neighbors):
                w = neighbors[ci]
                ci += 1
                if w not in index:
                    work[-1] = (v, ci)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on_stack:
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


def cycle_tolerant_topological_order(graph: BidirectedGraph) -> list[int]:
    """The legacy multi-pass node-level sort (reference src/
    graph_ops.rs:431-517): Kahn's algorithm with ready nodes biased by
    their mean path position, then any cycle leftovers appended
    deterministically via DFS from the sorted remaining nodes.  Returns
    every node id exactly once (superseded for layout by the exact-ODGI
    handle-level sort; kept as the diagnostic/analysis utility)."""
    adj = _node_adjacency(graph)
    indeg: dict[int, int] = {nid: 0 for nid in adj}
    for nid, outs in adj.items():
        for w in outs:
            indeg[w] += 1
    # mean position of each node over all path visits
    pos_sum: dict[int, int] = {}
    pos_cnt: dict[int, int] = {}
    for path in graph.paths:
        for p, h in enumerate(path.steps):
            n = int(h) >> 1
            pos_sum[n] = pos_sum.get(n, 0) + p
            pos_cnt[n] = pos_cnt.get(n, 0) + 1

    def mean_pos(n: int) -> int:
        c = pos_cnt.get(n)
        return pos_sum[n] // c if c else (1 << 62)

    order: list[int] = []
    visited: set[int] = set()
    ready: list[tuple[int, int]] = []  # (mean_pos, nid) min-heap
    for nid in sorted(adj):
        if indeg[nid] == 0:
            heapq.heappush(ready, (mean_pos(nid), nid))
    while ready:
        _mp, n = heapq.heappop(ready)
        if n in visited:
            continue
        order.append(n)
        visited.add(n)
        for w in adj[n]:
            indeg[w] -= 1
            if indeg[w] == 0 and w not in visited:
                heapq.heappush(ready, (mean_pos(w), w))
    # cycle leftovers: DFS from sorted remaining roots (graph_ops.rs
    # dfs_visit over `remaining.sort()`)
    remaining = sorted(n for n in adj if n not in visited)
    for root in remaining:
        if root in visited:
            continue
        work = [root]
        while work:
            n = work.pop()
            if n in visited:
                continue
            visited.add(n)
            order.append(n)
            for w in reversed(adj[n]):
                if w not in visited:
                    work.append(w)
    return order
