"""PAF interop: the de-facto checkpoint format of the pipeline.

The reference persists alignments with --output-alignments and can rebuild a
graph from them with -p without re-aligning (reference src/seqrush.rs:
510-609, 677-716).  Same here: PAF out mirrors allwave's record shape, PAF in
feeds the host CIGAR processor.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PafRecord:
    query_name: str
    query_len: int
    query_start: int
    query_end: int
    strand: str  # '+' or '-'
    target_name: str
    target_len: int
    target_start: int
    target_end: int
    residue_matches: int
    alignment_block_len: int
    mapq: int
    cigar: str

    def to_line(self) -> str:
        return "\t".join(
            str(x)
            for x in (
                self.query_name,
                self.query_len,
                self.query_start,
                self.query_end,
                self.strand,
                self.target_name,
                self.target_len,
                self.target_start,
                self.target_end,
                self.residue_matches,
                self.alignment_block_len,
                self.mapq,
                f"cg:Z:{self.cigar}",
            )
        )


def alignment_to_paf(result, seqs) -> PafRecord:
    """AlignmentResult -> PAF (global backends span full sequences, like
    allwave; local backends carry chain-span starts)."""
    q = seqs[result.query_idx]
    t = seqs[result.target_idx]
    matches = sum(n for n, op in result.cigar if op == "=")
    block = sum(n for n, op in result.cigar)
    q_consumed = sum(n for n, op in result.cigar if op in "=XMI")
    t_consumed = sum(n for n, op in result.cigar if op in "=XMD")
    qs = getattr(result, "query_start", 0)
    ts = getattr(result, "target_start", 0)
    return PafRecord(
        query_name=q.id,
        query_len=len(q.data),
        query_start=qs,
        query_end=qs + q_consumed,
        strand="-" if result.is_reverse else "+",
        target_name=t.id,
        target_len=len(t.data),
        target_start=ts,
        target_end=ts + t_consumed,
        residue_matches=matches,
        alignment_block_len=block,
        mapq=255,
        cigar=result.cigar_string,
    )


def parse_paf_line(line: str):
    """One PAF line -> (query_name, q_start, q_end, strand, target_name,
    t_start, t_end, cigar) or None for malformed records (warn-and-skip,
    reference seqrush.rs:536-576)."""
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 12:
        return None
    try:
        q_start, q_end = int(fields[2]), int(fields[3])
        t_start, t_end = int(fields[7]), int(fields[8])
    except ValueError:
        return None
    cigar = ""
    for f in fields[12:]:
        if f.startswith("cg:Z:"):
            cigar = f[5:]
            break
    return (fields[0], q_start, q_end, fields[4], fields[5], t_start, t_end, cigar)
