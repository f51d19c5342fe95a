"""Pipeline orchestration: FASTA -> alignment -> union -> graph -> GFA.

The port of ``seqrush_tpu/pipeline.py``:

  load -> pre-unite F/R of every offset -> [PAF replay | batched banded
  alignment of all pairs (sparsified; --aligner sweepga: seed, chain, 1:1
  filter and gap fill) | iterative two-phase | --inversion-aware: every
  pair forward and reverse, then reverse-complement patches of the forward
  alignments' divergent gaps] -> bulk unite on the device -> induce graph
  -> compact and renumber (unless --no-compact) -> Ygs (unless --no-sort)
  -> validate that every path reconstructs its input -> GFA 1.0.

``--mesh-devices N`` splits each alignment chunk's rows over N devices
(and aligns a pair whose traceback alone exceeds the memory budget with its
band split over them).  Several processes joined by torch.distributed
(``parallel/distributed.py::initialize``) each align a contiguous stripe
of the pair list; the unite edges are gathered at points every process
reaches, so every process builds the same graph; process 0 writes the GFA
(and the PAF's first part), process k writes ``<output>.hostk``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque

import numpy as np

from .align import cigar as cigar_mod
from .align.base import runner_class
from .align.pairs import all_ordered_pairs, parse_sparsification, schedule_pairs
from .align.runner import RunnerConfig, WfaAligner
from .config import Args
from .graph.bigraph import BidirectedGraph
from .graph.builder import build_bidirected_graph
from .io.paf import alignment_to_paf, parse_paf_line
from .ops import unionfind as uf
from .parallel.distributed import allgather_edge_lists, host_stripe, process_count, process_index
from .parallel.mesh import make_mesh
from .scores import AlignmentScores
from .sequences import SequenceSet, load_fasta
from .utils import PhaseTimer, resolve_device

# iterative-mode stabilization constants (reference seqrush.rs:1038-1121):
# the component count is evaluated at every CHECK_INTERVAL-result boundary;
# STABILITY_THRESHOLD consecutive unchanged counts stop the random phase.
# ITER_DISPATCH pairs align per device dispatch — early-stop semantics are
# invariant to it (results are consumed in pair order either way).
CHECK_INTERVAL = 10
STABILITY_THRESHOLD = 10
ITER_DISPATCH = 250


class SeqRushTorch:
    def __init__(self, seqs: SequenceSet, args: Args | None = None):
        self.seqs = seqs
        self.args = args or Args()
        self.device = resolve_device(self.args.device)
        self.total_length = seqs.total_length
        self.timer = PhaseTimer()
        with self.timer.phase("pre_unite"):
            self.parent = uf.create((self.total_length << 1) + 2, self.device)
            # pre-unite F/R of every position
            i = np.arange(self.total_length, dtype=np.int64)
            self.parent = uf.unite_edges(self.parent, i << 1, (i << 1) | 1)
        self._edge_u: list[np.ndarray] = []
        self._edge_v: list[np.ndarray] = []
        self._edge_queued = 0
        self.stats: dict = {}

    # -- alignment phase -----------------------------------------------------

    def count_components(self) -> int:
        self._flush_unites()
        # self-root reduction, not root-unique: the iterative mode calls
        # this every CHECK_INTERVAL results
        return uf.count_components_fast(self.parent, self.total_length << 1)

    def _queue_unites(self, u: np.ndarray, v: np.ndarray) -> None:
        if u.size:
            self._edge_u.append(u)
            self._edge_v.append(v)
            self._edge_queued += int(u.size)
        # flush periodically to bound host memory.  With several processes a
        # flush is a collective, so it happens only at points every process
        # reaches, never because one process's buffer grew
        if process_count() == 1 and self._edge_queued > 50_000_000:
            self._flush_unites()

    def _flush_unites(self) -> None:
        """One device unite over every queued edge; with several processes
        over every process's edges (each process contributes its stripe's,
        an empty list too, and applies the same unite).  The JAX package
        unites on the host, where its parent lives; here the parent lives on
        the run's device, and the host library's uf_unite_bulk_native (the
        same parents) is slower once the copies are counted (chip_smoke.py
        phase 12b times both on the same edges)."""
        if process_count() == 1 and not self._edge_u:
            return
        u = np.concatenate(self._edge_u) if self._edge_u else np.zeros(0, np.int64)
        v = np.concatenate(self._edge_v) if self._edge_v else np.zeros(0, np.int64)
        self._edge_u, self._edge_v = [], []
        self._edge_queued = 0
        u, v = allgather_edge_lists(u, v)
        if u.size:
            self.parent = uf.unite_edges(self.parent, u, v)

    def _result_to_unites(self, res, min_match_length: int) -> None:
        """Match runs of one alignment -> queued Pos pairs."""
        runs = [
            (q + res.query_start, t + res.target_start, n)
            for q, t, n in _runs_of(res.cigar)
            if n >= max(min_match_length, 1)
        ]
        if not runs:
            return
        qseq = self.seqs[res.query_idx]
        tseq = self.seqs[res.target_idx]
        u, v = cigar_mod.runs_to_pos_pairs(
            runs, qseq.offset, tseq.offset, res.is_reverse, len(qseq.data)
        )
        self._queue_unites(u, v)

    # -- checkpoint / resume -------------------------------------------------
    # The converged parent array is the graph-phase checkpoint; the .npy is
    # the same format the JAX package writes, so either can resume the other.

    def save_checkpoint(self, path: str) -> None:
        self._flush_unites()
        np.save(path, self.parent.cpu().numpy())

    def load_checkpoint(self, path: str) -> None:
        if not os.path.exists(path) and os.path.exists(path + ".npy"):
            path += ".npy"  # np.save appends the suffix
        arr = np.load(path)
        if arr.size != (self.total_length << 1) + 2:
            raise ValueError(
                f"checkpoint size {arr.size} does not match sequence space "
                f"{(self.total_length << 1) + 2}"
            )
        self.parent = uf.unite_edges(
            uf.create(arr.size, self.device),
            np.arange(arr.size, dtype=np.int64),
            arr.astype(np.int64),
        )

    def align_and_unite(self) -> None:
        args = self.args
        if args.paf:
            self._align_from_paf(args.paf)
            return
        aligner_cls = runner_class(args.aligner)
        cfg_kw = {}
        if args.memory_budget_bytes is not None:
            cfg_kw["memory_budget_bytes"] = args.memory_budget_bytes
        mesh = make_mesh(args.mesh_devices, self.device) if args.mesh_devices else None
        cfg = RunnerConfig(
            scores=AlignmentScores.parse(args.scores),
            orientation_scores=AlignmentScores.parse_orientation(args.orientation_scores),
            max_divergence=args.max_divergence,
            band_slack=args.band_slack,
            verbose=args.verbose,
            max_chunk_pairs=args.max_chunk_pairs,
            threads=args.threads,
            frequency=args.frequency,
            wide_route=args.wide_route,
            wide_verify=args.wide_verify,
            mesh=mesh,
            **cfg_kw,
        )
        aligner = aligner_cls(self.seqs, cfg, device=self.device)
        n = len(self.seqs)

        spars = parse_sparsification(args.sparsification)
        sparsified = spars.kind != "none" or args.iterative
        kdist = None
        if spars.kind in ("tree", "auto", "connectivity") or args.iterative:
            # sketch distances feed tree sampling AND the MST connectivity
            # backbone of auto/connectivity schedules
            from .ops.kmer import kmer_distance_matrix

            kdist = kmer_distance_matrix(aligner.codes, spars.kmer_size or 16, self.device)

        self.timer.count("pairs_total", n * n)
        # PAF pre-pass: --output-alignments always records the full all-pairs
        # set, independent of sparsification (reference seqrush.rs:694-716
        # runs an unsparsified AllPairIterator just for the PAF)
        if args.output_alignments and sparsified:
            with self.timer.phase("paf_prepass"):
                self._paf_out(aligner.align_pairs(all_ordered_pairs(n)))

        if args.iterative:
            with self.timer.phase("align"):
                self._align_iterative(aligner, kdist, spars)
        else:
            pairs = schedule_pairs(n, spars, seed=args.seed, kmer_distances=kdist)
            if args.verbose:
                print(f"Total sequence pairs: {len(pairs)} (sparsification: {spars.kind})")
            pairs = self._host_stripe_pairs(pairs)
            if args.inversion_aware:
                self._align_inversion_aware(aligner, pairs, sparsified)
            else:
                with self.timer.phase("align"):
                    results = aligner.align_pairs(pairs)
                self.timer.count("alignments", len(results))
                if not sparsified:
                    self._paf_out(results)
                with self.timer.phase("unite"):
                    for res in results:
                        self._result_to_unites(res, args.min_match_length)
        with self.timer.phase("unite"):
            self._flush_unites()
        self.stats["aligner"] = aligner.stats

    def _host_stripe_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """With several processes, this process's contiguous stripe of the
        pair list (the flush in _flush_unites gathers every stripe's
        edges)."""
        pc = process_count()
        if pc <= 1:
            return pairs
        stripe = host_stripe(len(pairs), process_index(), pc)
        if self.args.verbose:
            print(f"[multihost] process {process_index()}/{pc} aligns pairs "
                  f"[{stripe.start}:{stripe.stop}) of {len(pairs)}")
        return pairs[stripe]

    def _align_inversion_aware(self, aligner: WfaAligner, pairs, sparsified: bool) -> None:
        """The reference's inversion-aware mode: every pair aligns forward
        AND fully reverse-complemented, and the divergent gaps of the forward
        alignments re-align as reverse-complement patches, accepted when
        their score is under half the forward score."""
        from .align.inversion import inversion_patch_alignments

        P = len(pairs)
        with self.timer.phase("align"):
            res_f = aligner.align_pairs_oriented(pairs, np.zeros(P, bool))
            res_r = aligner.align_pairs_oriented(pairs, np.ones(P, bool))
        results = res_f + res_r
        self.timer.count("alignments", len(results))
        if not sparsified:
            self._paf_out(results)
        with self.timer.phase("unite"):
            for res in results:
                self._result_to_unites(res, self.args.min_match_length)
        with self.timer.phase("inversion_patch"):
            u, v = inversion_patch_alignments(res_f, aligner, self.args.min_match_length)
        self._queue_unites(u, v)

    def _align_iterative(self, aligner: WfaAligner, kdist, spars) -> None:
        """Two-phase iterative alignment with stabilization detection
        (reference seqrush.rs:867-1132): tree pairs first (connectivity),
        then random pairs with component-count early stopping."""
        from .ops.kmer import tree_sampling_pairs

        k_near = spars.k_nearest or 3
        k_far = spars.k_farthest or 1
        rand_frac = spars.rand_frac if spars.rand_frac > 0 else 1.0
        tree_pairs, random_pairs = tree_sampling_pairs(
            kdist, k_near, k_far, rand_frac, seed=self.args.seed
        )
        if self.args.verbose:
            print(f"[iterative] phase 1: {len(tree_pairs)} tree pairs")
        results = aligner.align_pairs(tree_pairs)
        self.stats["iterative_dispatches"] = 1 if len(tree_pairs) else 0
        for res in results:
            self._result_to_unites(res, self.args.min_match_length)
        components = self.count_components()
        if self.args.verbose:
            print(f"[iterative] after tree phase: {components} components")

        # The reference aligns pair-by-pair and checks the component count
        # after every 10 pairs (seqrush.rs:1038-1121).  Its early-stop
        # semantics depend on RESULT order, not dispatch size — so here the
        # random phase dispatches device-sized batches and then consumes the
        # results IN PAIR ORDER, evaluating the component count at every
        # 10-result boundary.  On stop, results not yet consumed are
        # discarded un-united, exactly as the reference never aligns the
        # remaining pairs.
        DISPATCH = max(CHECK_INTERVAL, ITER_DISPATCH)
        stable = 0
        prev = components
        stopped = False
        pair_counter = 0  # phase-global, like the reference's pair_idx
        for lo in range(0, len(random_pairs), DISPATCH):
            batch = random_pairs[lo : lo + DISPATCH]
            results = aligner.align_pairs(batch)
            self.stats["iterative_dispatches"] += 1
            # key results by pair so consumption follows BATCH order even if
            # the backend returned them in completion order
            by_pair: dict[tuple[int, int], deque] = {}
            for r in results:
                by_pair.setdefault((r.query_idx, r.target_idx), deque()).append(r)
            for i, j in batch:
                dq = by_pair.get((int(i), int(j)))
                while dq:
                    # all records of this pair (multi-chain backends emit
                    # several) unite before the pair advances the counter,
                    # as the reference's inner for-alignment loop does
                    self._result_to_unites(dq.popleft(), self.args.min_match_length)
                # else: the pair was dropped (divergence cap) — it still
                # advances the check counter, as in the reference
                pair_counter += 1
                if pair_counter % CHECK_INTERVAL == 0:
                    comp = self.count_components()
                    if comp == prev:
                        stable += 1
                        if stable >= STABILITY_THRESHOLD:
                            stopped = True
                            break
                    else:
                        stable = 0
                    prev = comp
            if stopped:
                if self.args.verbose:
                    print(f"[iterative] stabilized after {pair_counter} random pairs")
                break
        self.stats["iterative_random_pairs"] = pair_counter
        self.stats["iterative_tree_pairs"] = int(len(tree_pairs))
        self.stats["iterative_stabilized"] = stopped

    def _paf_out(self, results) -> None:
        if not self.args.output_alignments:
            return
        path = self.args.output_alignments
        if process_count() > 1:
            # each process records its own stripe: concatenate the parts
            path = f"{path}.host{process_index()}"
        with open(path, "w") as fh:
            for res in results:
                rec = alignment_to_paf(res, self.seqs)
                if self.args.validate_paf:
                    self._validate_paf_record(rec)
                fh.write(rec.to_line() + "\n")

    def _validate_paf_record(self, rec) -> None:
        """Record-level sanity as it is generated: coordinates within bounds,
        CIGAR consumes exactly the spans."""
        items = cigar_mod.parse_cigar(rec.cigar)
        q_consumed = sum(n for n, op in items if op in "MX=I")
        t_consumed = sum(n for n, op in items if op in "MX=D")
        ok = (
            0 <= rec.query_start <= rec.query_end <= rec.query_len
            and 0 <= rec.target_start <= rec.target_end <= rec.target_len
            and rec.query_end - rec.query_start == q_consumed
            and rec.target_end - rec.target_start == t_consumed
            and rec.strand in "+-"
        )
        if not ok:
            raise AssertionError(
                f"invalid PAF record generated for {rec.query_name}->{rec.target_name}: "
                f"cigar consumes q={q_consumed} t={t_consumed}, spans "
                f"q=[{rec.query_start},{rec.query_end}]/{rec.query_len} "
                f"t=[{rec.target_start},{rec.target_end}]/{rec.target_len}"
            )

    def _align_from_paf(self, paf_path: str) -> None:
        """Rebuild unites from a PAF file."""
        name_to_idx = self.seqs.name_to_index()
        count = 0
        with open(paf_path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                rec = parse_paf_line(line)
                if rec is None:
                    print(f"Warning: Invalid PAF line: {line.rstrip()}", file=sys.stderr)
                    continue
                qname, q_start, q_end, strand, tname, t_start, _t_end, cig = rec
                qi = name_to_idx.get(qname)
                ti = name_to_idx.get(tname)
                if qi is None or ti is None:
                    print(
                        f"Warning: Unknown sequence name(s) in PAF: {qname} or {tname}",
                        file=sys.stderr,
                    )
                    continue
                items = cigar_mod.parse_cigar(cig)
                qseq, tseq = self.seqs[qi], self.seqs[ti]
                if strand == "-" and self.args.paf_convention == "standard":
                    # minimap2-style '-' records give query coords on the
                    # original strand; the CIGAR processor expects RC-space
                    q_start = len(qseq.data) - q_end
                runs = cigar_mod.match_runs_from_cigar(
                    items,
                    qseq.data,
                    tseq.data,
                    strand == "-",
                    self.args.min_match_length,
                    q_start,
                    t_start,
                    validate=self.args.validate_paf,
                )
                u, v = cigar_mod.runs_to_pos_pairs(
                    runs, qseq.offset, tseq.offset, strand == "-", len(qseq.data)
                )
                self._queue_unites(u, v)
                count += 1
        self._flush_unites()
        if self.args.verbose:
            print(f"Processed {count} alignments from PAF file")

    # -- graph phase ---------------------------------------------------------

    def build_graph(self) -> BidirectedGraph:
        self._flush_unites()
        roots = self.parent.cpu().numpy()
        graph = build_bidirected_graph(
            self.seqs,
            roots,
            verbose=self.args.verbose,
            node_order="position" if self.args.seqwish_style else "traversal",
        )
        graph.verify_path_edges()
        return graph

    def write_gfa(self, graph: BidirectedGraph | None = None) -> BidirectedGraph:
        args = self.args
        t0 = time.time()
        if graph is None:
            with self.timer.phase("induce"):
                graph = self.build_graph()

        if not args.no_compact:
            from .graph.compact import compact

            before = graph.node_count()
            with self.timer.phase("compact"):
                compact(graph)
                graph.renumber_nodes_sequentially()
            if args.verbose:
                print(f"Compacted from {before} to {graph.node_count()} nodes")

        if not args.no_sort and graph.node_count() > 0:
            from .layout.ygs import YgsParams, ygs_sort

            params = YgsParams.from_graph(graph, verbose=args.verbose)
            params.iter_max = args.sgd_iter_max
            params.theta = args.sgd_theta
            params.eps = args.sgd_eps
            params.cooling_start = args.sgd_cooling_start
            params.topo_mode = args.topo_mode
            if args.sgd_eta_max is not None:
                params.eta_max = args.sgd_eta_max
            with self.timer.phase("layout"):
                sub: dict[str, float] = {}
                ygs_sort(
                    graph,
                    params,
                    use_sgd=not args.skip_sgd,
                    use_groom=not args.skip_groom,
                    use_topo=not args.skip_topo,
                    timings=sub,
                    device=self.device,
                )
                for k, v in sub.items():
                    self.timer.phases[f"layout_{k}"] = (
                        self.timer.phases.get(f"layout_{k}", 0.0) + v
                    )

        with self.timer.phase("validate"):
            errors = self.validate_paths_match_sequences(graph)
        if errors:
            raise RuntimeError("Path validation failed!\n" + "\n".join(errors))

        out_path = args.output
        if process_count() > 1 and process_index() != 0:
            # every process holds the same graph: process 0 writes the
            # canonical file, the others a .hostN twin
            out_path = f"{args.output}.host{process_index()}"
        with self.timer.phase("write"), open(out_path, "w") as fh:
            graph.write_gfa(fh)
        self.stats["write_wall_s"] = time.time() - t0
        if args.verbose:
            print(
                f"Graph written to {args.output}: {graph.node_count()} nodes, "
                f"{len(graph.edges)} edges, {len(graph.paths)} paths"
            )
        return graph

    def validate_paths_match_sequences(self, graph: BidirectedGraph) -> list[str]:
        """Golden invariant: every path reconstructs its input sequence
        byte-for-byte."""
        errors = []
        # first occurrence wins on duplicate names
        by_name: dict = {}
        for p in graph.paths:
            by_name.setdefault(p.name, p)
        for seq in self.seqs.sequences:
            path = by_name.get(seq.id)
            if path is None:
                errors.append(f"Path '{seq.id}' not found in graph")
                continue
            got = graph.path_sequence(path)
            if got.size != seq.data.size or not (got == seq.data).all():
                diff = "length mismatch"
                m = min(got.size, seq.data.size)
                neq = np.nonzero(got[:m] != seq.data[:m])[0]
                if neq.size:
                    i = int(neq[0])
                    diff = (
                        f"first difference at position {i}: "
                        f"'{chr(seq.data[i])}' (expected) vs '{chr(got[i])}' (got)"
                    )
                errors.append(
                    f"Path '{seq.id}' does not match original sequence "
                    f"({seq.data.size} bp vs {got.size} bp; {diff})"
                )
        return errors


def _runs_of(cigar_items):
    q = t = 0
    for n, op in cigar_items:
        if op == "=":
            yield (q, t, n)
            q += n
            t += n
        elif op in ("M", "X"):
            q += n
            t += n
        elif op == "I":
            q += n
        elif op == "D":
            t += n


def run_seqrush(args: Args) -> BidirectedGraph:
    """Top-level entry point: FASTA in, GFA out."""
    seqs = load_fasta(args.sequences)
    if args.verbose:
        print(f"Loaded {len(seqs)} sequences")
    sr = SeqRushTorch(seqs, args)
    if args.load_checkpoint:
        sr.load_checkpoint(args.load_checkpoint)
        if args.verbose:
            print(f"Restored union-find checkpoint from {args.load_checkpoint}")
    else:
        sr.align_and_unite()
    if args.save_checkpoint:
        sr.save_checkpoint(args.save_checkpoint)
        if args.verbose:
            print(f"Union-find checkpoint written to {args.save_checkpoint}")
    graph = sr.write_gfa()
    if args.profile:
        rep = sr.timer.report()
        rep["stats"] = {
            k: (dict(v) if isinstance(v, dict) else v) for k, v in sr.stats.items()
        }
        rep["graph"] = {
            "nodes": graph.node_count(),
            "edges": len(graph.edges),
            "paths": len(graph.paths),
        }
        rep["device"] = str(sr.device)
        with open(args.profile, "w") as fh:
            json.dump(rep, fh, indent=1)
        if args.verbose:
            print(f"Profile written to {args.profile}")
    return graph
