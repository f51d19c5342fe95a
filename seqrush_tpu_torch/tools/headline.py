"""The headline corpus and its scoring, shared by ``chip_smoke.py``, the
JAX package's digest scripts under ``scripts/`` (through ``chip_smoke``) and
``tools/wfa_shapes.py``; ``synth_variation_graph``, the layout's graph at
1,000 haplotypes (``chip_smoke.py`` phase 3, ``tools/sgd_timing.py``); and
``synth_flush_edges``, a union-find flush at that scale (``chip_smoke.py``
phase 12b); ``walk_gap_corpus``, the traceback walk's gap corpus
(``chip_smoke.py`` phases 8a and 10b, ``tools/walk_timing.py``, the tests);
and ``translocation_pair``, the over-budget pair of the band-sharded route
and of kernel A's wide route (``chip_smoke.py`` phases 11a and 11e,
``tools/wide_timing.py``)."""

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


def synth_variation_graph(n_paths=1000, length=3300, n_sites=900, seed=11, loop_visits=0):
    """A BidirectedGraph of one locus of ``length`` bp and ``n_paths``
    haplotypes, built directly (no alignment): ``n_sites`` biallelic sites,
    92% SNPs, 4% deletions and 4% insertions of 1-4 bp, each with its own
    alternate allele frequency (uniform in [0.02, 0.5]); every haplotype is
    a path through the reference segments between the sites (each at least
    1 bp) and, at each site, the allele it carries (a deletion's carriers
    skip its reference node, an insertion's non-carriers have no node
    there).  Node ids run 1..N in reference order.  At the defaults: 2,639
    nodes and 1,770,128 path steps, the headline graph's shape at 40 x its
    25 paths, at the top of the 1k-haplotype range users build.  With
    ``loop_visits`` K > 0 one more node, a 2 bp repeat unit, follows the
    middle backbone segment and every path visits it K times in a row (a
    collapsed tandem repeat: a node of K x n_paths steps and a self-loop
    edge)."""
    from seqrush_tpu_torch.graph.bigraph import BidirectedGraph

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    kind = rng.choice(3, size=n_sites, p=[0.92, 0.04, 0.04])  # 0 SNP, 1 deletion, 2 insertion
    indel = rng.integers(1, 5, size=n_sites)
    ref_len = np.where(kind == 0, 1, np.where(kind == 1, indel, 0))
    spare = length - int(ref_len.sum()) - (n_sites + 1)
    if spare < 0:
        raise ValueError(f"{n_sites} sites do not fit {length} bp")
    seg_len = 1 + rng.multinomial(spare, np.full(n_sites + 1, 1.0 / (n_sites + 1)))
    freq = rng.uniform(0.02, 0.5, size=n_sites)
    g = BidirectedGraph()
    # the node of each slot: backbone segment k at 2k, site k's reference
    # and alternate alleles at columns 2k + 1 of ref_node / alt_node (0: none)
    ref_node = np.zeros(2 * n_sites + 1, np.int64)
    alt_node = np.zeros(2 * n_sites + 1, np.int64)
    nid = 0
    for k in range(n_sites + 1):
        nid += 1
        g.add_node(nid, bases[rng.integers(0, 4, seg_len[k])])
        ref_node[2 * k] = alt_node[2 * k] = nid
        if k == n_sites:
            break
        if kind[k] != 2:
            nid += 1
            ref = rng.integers(0, 4, ref_len[k])
            g.add_node(nid, bases[ref])
            ref_node[2 * k + 1] = nid
        if kind[k] == 0:  # the alternate base: one of the other three
            nid += 1
            g.add_node(nid, bases[[(ref[0] + rng.integers(1, 4)) % 4]])
            alt_node[2 * k + 1] = nid
        elif kind[k] == 2:
            nid += 1
            g.add_node(nid, bases[rng.integers(0, 4, indel[k])])
            alt_node[2 * k + 1] = nid
    carries = np.ones((n_paths, 2 * n_sites + 1), bool)
    carries[:, 1::2] = rng.random((n_paths, n_sites)) < freq
    slots = np.where(carries, alt_node, ref_node)
    cut, loop = 2 * (n_sites // 2) + 1, np.zeros(0, np.int64)
    if loop_visits > 0:
        nid += 1
        g.add_node(nid, bases[rng.integers(0, 4, 2)])
        loop = np.full(loop_visits, nid, np.int64)
    for p in range(n_paths):
        row = np.concatenate([slots[p, :cut], loop, slots[p, cut:]])
        g.add_path(f"hap{p:04d}", row[row > 0] << 1)
    g.verify_path_edges()
    return g


def synth_flush_edges(n_seqs=1000, length=3300, n_edges=50_000_000, min_run=20, max_run=400, seed=17):
    """The flush's edges at the top of the users' range: match runs of
    min_run..max_run consecutive positions between random pairs of distinct
    sequences, on both strands, as Pos pairs (offset << 1 | orientation)
    over n_seqs sequences of `length` bases, cut to n_edges edges (the
    pipeline flushes at 50,000,000 queued edges).  Long runs make long
    chains, the hard case for hooking.  Returns int64 (u, v)."""
    rng = np.random.default_rng(seed)
    n_runs = int(n_edges / ((min_run + max_run) / 2) * 1.1) + 16
    lens = rng.integers(min_run, max_run + 1, n_runs)
    ends = np.cumsum(lens)
    if ends[-1] < n_edges:
        raise ValueError("too few runs drawn")
    keep = int(np.searchsorted(ends, n_edges)) + 1
    lens = lens[:keep]
    lens[-1] -= int(ends[keep - 1]) - n_edges
    a = rng.integers(0, n_seqs, keep)
    b = (a + rng.integers(1, n_seqs, keep)) % n_seqs
    sa = rng.integers(0, length - lens + 1)
    sb = rng.integers(0, length - lens + 1)
    rc = rng.integers(0, 2, keep).astype(bool)
    run = np.repeat(np.arange(keep), lens)
    j = np.arange(n_edges) - np.repeat(np.cumsum(lens) - lens, lens)
    u = (a[run].astype(np.int64) * length + sa[run] + j) << 1
    t = sb[run] + j
    v = np.where(rc[run], ((b[run].astype(np.int64) * length + (length - 1 - t)) << 1) | 1,
                 (b[run].astype(np.int64) * length + t) << 1)
    return u, v


def deep_forest(n_slots, seed=5):
    """An uncompressed union-find forest of n_slots: each slot below a random
    smaller slot with probability 1/2, else a root; roots are minima of
    their trees, as a unite leaves them, and chains run a few hops deep.
    Returns an int32 parent array."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n_slots)
    parent = np.where(rng.random(n_slots) < 0.5, (rng.random(n_slots) * idx).astype(np.int64), idx)
    return parent.astype(np.int32)


def walk_gap_pairs(seed=19):
    """The pairs of walk_gap_corpus, (query, target) base codes: gap runs of
    1 to 200 steps (past a diagonal or gap ballot's 32 steps and a walk
    tile's 64 rows, their lane drifting out of a 32-lane window sideways),
    gaps in the band's corner (anti-diagonals up to K) and runs that carry
    the path to the band's edges (|i - j| near K = 199), walks that end
    inside a gap (a query-only or target-only prefix), a query-only and a
    target-only row, and a zero-length row last."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def snps(s, n):
        s = s.copy()
        if s.size:
            pos = rng.integers(0, s.size, n)
            s[pos] = (s[pos] + rng.integers(1, 4, n)) % 4
        return s

    pairs = []
    # one gap of each length in a pair of its own, in the middle: D (target
    # bases inserted) on even lengths' pairs, I (deleted) on odd; the run of
    # 200 beside an I run of 60, so that the pair's end stays in the band
    for n in (1, 3, 31, 33, 64, 65, 150, 200):
        q = rand(420)
        t = snps(q, 6)
        t = np.insert(t, 210, rand(n)) if n % 2 == 0 else np.delete(t, np.arange(180, 180 + n))
        if n == 200:
            t = np.delete(t, np.arange(100, 160))
        pairs.append((q, t))
    # many gaps in one pair, deletions (I runs) and insertions (D runs) in turn
    q = rand(640)
    t = q.copy()
    for p, n, ins in ((560, 40, False), (470, 12, True), (380, 90, True), (250, 5, False), (120, 70, False)):
        t = np.insert(t, p, rand(n)) if ins else np.delete(t, np.arange(p, p + n))
    pairs.append((q, snps(t, 8)))
    # gaps in the band's corner: within the first anti-diagonals
    q = rand(300)
    pairs.append((q, np.insert(snps(q, 3), 8, rand(60))))
    pairs.append((q, np.delete(snps(q, 3), np.arange(12, 57))))
    # to the band's edges, |i - j| near K: a D run of 190 (met first by the
    # walk) and an I run of 190 back; an I run of 185 that stays there
    q = rand(520)
    pairs.append((q, np.delete(np.insert(snps(q, 4), 400, rand(190)), np.arange(100, 290))))
    pairs.append((np.insert(q, 300, rand(185)), snps(q, 4)))
    # walks that end inside a gap: a query-only / target-only prefix
    core = rand(250)
    pairs.append((np.concatenate([rand(37), core]), snps(core, 2)))
    pairs.append((snps(core, 2), np.concatenate([rand(45), core])))
    # a query-only and a target-only row, and a zero-length row
    pairs.append((rand(50), np.zeros(0, np.uint8)))
    pairs.append((np.zeros(0, np.uint8), rand(70)))
    pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
    return pairs


def walk_gap_corpus(seed=19):
    """walk_gap_pairs packed at band 199 (W 200, rows 200 bytes apart: a
    row's 32-lane window starts at every offset of its 16-byte blocks).
    Returns (Q, T, qlens, tlens, band, tmax)."""
    pairs = walk_gap_pairs(seed)
    lq = -(-max(q.size for q, _ in pairs) // 16) * 16
    lt = -(-max(t.size for _, t in pairs) // 16) * 16
    Q = np.full((len(pairs), lq), 6, np.uint8)  # ops/nw.py's QPAD and TPAD
    T = np.full((len(pairs), lt), 7, np.uint8)
    for b, (q, t) in enumerate(pairs):
        Q[b, : q.size] = q
        T[b, : t.size] = t
    ql = np.array([q.size for q, _ in pairs], np.int32)
    tl = np.array([t.size for _, t in pairs], np.int32)
    tmax = -(-int((ql + tl).max()) // 512) * 512
    return Q, T, ql, tl, 199, tmax


def translocation_pair(seed=23, flank=4000, block=8000, snp_rate=0.005):
    """Two ~24 kb haplotypes that differ by a balanced translocation of an
    8 kb block (q = A X B C, t = A B X C, |A| = |C| = 4 kb, |X| = |B| = 8
    kb) and 0.5% SNPs on t: the optimal path leaves the main diagonal by 8
    kb, so its certified band is wide and its traceback exceeds the default
    2.6e9-byte budget (chip_smoke.py phase 11a)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    A, X, B, C = (acgt[rng.integers(0, 4, n)] for n in (flank, block, block, flank))
    q = np.concatenate([A, X, B, C])
    t = np.concatenate([A, B, X, C])
    hit = rng.random(t.size) < snp_rate
    t[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
    return [("hapA", q.tobytes()), ("hapB", t.tobytes())]


def long_deletion_pair(seed=29, flank=1000, deleted=28_000):
    """A ~30 kb haplotype and a 2 kb one that keeps only its two 1 kb
    flanks (a 28 kb deletion).  The runner's band for the pair (its length
    difference plus slack: W 28,160) passes 24,576 lanes, where kernel A's
    wide route runs each pair on a chain of two 16-CTA clusters.  The
    optimal alignment is the one gap of `deleted` bases: 28,024 at scoring
    0,5,8,2,24,1 (long_deletion_score)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    q = acgt[rng.integers(0, 4, 2 * flank + deleted)]
    t = np.concatenate([q[:flank], q[flank + deleted :]])
    return [("hapLong", q.tobytes()), ("hapShort", t.tobytes())]


def long_deletion_score(scores, deleted=28_000) -> int:
    """long_deletion_pair's optimal score under AlignmentScores `scores`:
    one gap of `deleted` bases, the cheaper of the two gap pieces."""
    cost = scores.gap1_open + scores.gap1_extend * deleted
    if scores.gap2_open is not None:
        cost = min(cost, scores.gap2_open + scores.gap2_extend * deleted)
    return cost
