"""GFA graph-isomorphism comparator (modulo node IDs).

The project's goal is output "bit-identical modulo node IDs (isomorphic)
to reference SeqRush" (BASELINE.md), and the port's sorted graphs are held
to the JAX package's the same way.  This tool decides isomorphism for
path-covered bidirected graphs — the only graphs any of the implementations
emits, since every node is induced by a path position (the reference's graph
induction walks sequences, as the induction here does) and the golden
invariant guarantees full path coverage.

Canonicalization: sort paths by name; walk their steps in order; the first
visit of a node assigns its canonical ID (dense, 1..N) and canonical
orientation (first-visit orientation = forward).  Two graphs are isomorphic
iff their canonical forms — node sequences, canonical edge sets, canonical
path step lists — are equal.  For path-covered graphs with identical path
name sets this canonical form is a complete invariant: the relabeling is
uniquely determined by the paths themselves.

Usage: python -m seqrush_tpu_torch.tools.isomorphic a.gfa b.gfa
Exit 0 if isomorphic, 1 with a first-difference report otherwise.
"""

from __future__ import annotations

import sys

from ..graph.bigraph import BidirectedGraph, parse_gfa
from ..pos import reverse_complement


def canonical_form(g: BidirectedGraph):
    """(node_seqs, edge_set, path_steps) under path-first-visit relabeling."""
    relabel: dict[int, int] = {}  # old id -> canonical id
    flipped: dict[int, bool] = {}  # old id -> canonical orientation flip
    next_id = 1
    paths = sorted(g.paths, key=lambda p: p.name)
    for path in paths:
        for h in path.steps:
            nid, rev = int(h) >> 1, bool(int(h) & 1)
            if nid not in relabel:
                relabel[nid] = next_id
                flipped[nid] = rev  # first visit defines forward
                next_id += 1
    leftovers = sorted(set(g.nodes) - set(relabel))
    for nid in leftovers:  # unreachable-by-path nodes: deterministic order
        relabel[nid] = next_id
        flipped[nid] = False
        next_id += 1

    def canon_handle(h: int) -> int:
        nid, rev = int(h) >> 1, bool(int(h) & 1)
        return (relabel[nid] << 1) | (rev ^ flipped[nid])

    node_seqs = {}
    for nid, seq in g.nodes.items():
        s = bytes(seq.tobytes())
        if flipped[nid]:
            s = bytes(reverse_complement(g.nodes[nid]).tobytes())
        node_seqs[relabel[nid]] = s

    # edges: complement-closed canonical representation
    def canon_edge(f: int, t: int):
        a = (canon_handle(f), canon_handle(t))
        b = (canon_handle(t) ^ 1, canon_handle(f) ^ 1)  # complement rule
        return min(a, b)

    edge_set = {canon_edge(f, t) for (f, t) in g.edges}
    path_steps = {
        p.name: tuple(canon_handle(h) for h in p.steps) for p in paths
    }
    return node_seqs, edge_set, path_steps


def isomorphic(a: BidirectedGraph, b: BidirectedGraph) -> tuple[bool, str]:
    """(equal, first-difference description)."""
    na, ea, pa = canonical_form(a)
    nb, eb, pb = canonical_form(b)
    if set(pa) != set(pb):
        only_a = sorted(set(pa) - set(pb))[:3]
        only_b = sorted(set(pb) - set(pa))[:3]
        return False, f"path name sets differ (only-a={only_a}, only-b={only_b})"
    for name in sorted(pa):
        if pa[name] != pb[name]:
            for k, (x, y) in enumerate(zip(pa[name], pb[name])):
                if x != y:
                    return False, (
                        f"path '{name}' diverges at step {k}: "
                        f"{x >> 1}{'-' if x & 1 else '+'} vs {y >> 1}{'-' if y & 1 else '+'}"
                    )
            return False, (
                f"path '{name}' lengths differ: {len(pa[name])} vs {len(pb[name])}"
            )
    if na != nb:
        for nid in sorted(set(na) | set(nb)):
            if na.get(nid) != nb.get(nid):
                return False, (
                    f"canonical node {nid} sequences differ: "
                    f"{na.get(nid)!r} vs {nb.get(nid)!r}"
                )
    if ea != eb:
        only_a = sorted(ea - eb)[:3]
        only_b = sorted(eb - ea)[:3]
        return False, f"edge sets differ (only-a={only_a}, only-b={only_b})"
    return True, "isomorphic"


def isomorphic_gfa(text_a: str, text_b: str) -> tuple[bool, str]:
    return isomorphic(parse_gfa(text_a), parse_gfa(text_b))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m seqrush_tpu_torch.tools.isomorphic a.gfa b.gfa", file=sys.stderr)
        return 2
    with open(argv[0]) as fa, open(argv[1]) as fb:
        ok, msg = isomorphic_gfa(fa.read(), fb.read())
    print(msg)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
