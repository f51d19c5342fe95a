"""Host-side CIGAR processing: parsing and match-run extraction.

Replicates the semantics of the reference's transitive-closure heart,
``SeqRush::process_alignment`` (reference src/seqrush.rs:1134-1481),
but vectorized: instead of a char-by-char walk, all aligned base pairs from
M/'=' ops are materialized as index arrays, compared in bulk, and maximal
match runs are found with a single diff pass.  Key behaviors preserved:

* 'M' may hide mismatches -> bases are compared individually;
* match runs accumulate ACROSS op boundaries and break only at a mismatch
  within an M op or at X/I/D ops;
* runs shorter than ``min_match_length`` are dropped;
* when the query was reverse-complemented for alignment, query bases are read
  back-to-front with on-the-fly complement (seqrush.rs:1162-1176), and the
  resulting runs are expressed in RC-local coordinates (the unite step applies
  the fwd = len-1-rc transform);
* uniting non-matching bases is impossible by construction; a paranoid check
  mirrors the reference's validate_match panic (seqrush.rs:1179-1207).
"""

from __future__ import annotations

import re

import numpy as np

from ..pos import complement_bytes

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHPX=])")


def parse_cigar(cigar: str | bytes) -> list[tuple[int, str]]:
    if isinstance(cigar, str):
        cigar = cigar.encode()
    return [(int(n), op.decode()) for n, op in _CIGAR_RE.findall(cigar)]


def cigar_to_string(items: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in items)


def match_runs_from_cigar(
    items: list[tuple[int, str]],
    query: np.ndarray,
    target: np.ndarray,
    query_is_rc: bool,
    min_match_length: int = 0,
    query_start: int = 0,
    target_start: int = 0,
    validate: bool = True,
) -> list[tuple[int, int, int]]:
    """Maximal exact-match runs -> [(q_local_start, t_local_start, len)].

    Coordinates are local to query/target starting at the given PAF starts;
    for query_is_rc the query coordinates are in RC space.
    """
    q_idx_parts, t_idx_parts = [], []
    q = query_start
    t = target_start
    for n, op in items:
        if op in ("M", "="):
            q_idx_parts.append(np.arange(q, q + n, dtype=np.int64))
            t_idx_parts.append(np.arange(t, t + n, dtype=np.int64))
            q += n
            t += n
        elif op == "X":
            q += n
            t += n
        elif op in ("I", "S"):
            q += n
        elif op in ("D", "N"):
            t += n
    if not q_idx_parts:
        return []
    qi = np.concatenate(q_idx_parts)
    ti = np.concatenate(t_idx_parts)

    # clip to bounds like the reference (it skips out-of-range M positions)
    qlen, tlen = len(query), len(target)
    ok = (qi < qlen) & (ti < tlen)
    qi, ti = qi[ok], ti[ok]
    if qi.size == 0:
        return []

    if query_is_rc:
        qbases = complement_bytes(query)[qlen - 1 - qi]
    else:
        qbases = np.asarray(query)[qi]
    eq = qbases == np.asarray(target)[ti]

    # run break when not equal, or aligned-pair continuity broken
    cont = np.ones(qi.size, dtype=bool)
    cont[1:] = (np.diff(qi) == 1) & (np.diff(ti) == 1)
    start_flag = eq & (~np.roll(eq, 1) | ~cont)
    start_flag[0] = eq[0]
    run_id = np.cumsum(start_flag) - 1
    runs = []
    if eq.any():
        idx = np.where(eq)[0]
        rid = run_id[idx]
        # first/last index of each run
        first = np.searchsorted(rid, np.arange(rid[-1] + 1), side="left")
        last = np.searchsorted(rid, np.arange(rid[-1] + 1), side="right") - 1
        for f, l in zip(first, last):
            if f > l:
                continue
            i0, i1 = idx[f], idx[l]
            length = int(i1 - i0 + 1)
            if length >= max(min_match_length, 1):
                runs.append((int(qi[i0]), int(ti[i0]), length))
    if validate:
        for qs, ts, n in runs:
            if query_is_rc:
                qb = complement_bytes(query)[qlen - 1 - (qs + np.arange(n))]
            else:
                qb = np.asarray(query)[qs : qs + n]
            if not (qb == np.asarray(target)[ts : ts + n]).all():
                raise AssertionError(
                    "VALIDATION ERROR: attempting to unite non-matching bases "
                    f"(q[{qs}:{qs+n}] vs t[{ts}:{ts+n}], rc={query_is_rc})"
                )
    return runs


def runs_to_pos_pairs(
    runs: list[tuple[int, int, int]],
    query_offset: int,
    target_offset: int,
    query_is_rc: bool,
    query_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand match runs into per-base Pos pairs for bulk unite.

    Forward:  (q_off+qs+i, F) <-> (t_off+ts+i, F)
    Query-RC: (q_off + qlen-1-(qs+i), R) <-> (t_off+ts+i, F)
    (bidirected_union_find.rs:60-98)
    """
    total = sum(n for _, _, n in runs)
    u = np.empty(total, dtype=np.int64)
    v = np.empty(total, dtype=np.int64)
    pos = 0
    for qs, ts, n in runs:
        i = np.arange(n, dtype=np.int64)
        v[pos : pos + n] = (np.int64(target_offset + ts) + i) << 1
        if query_is_rc:
            fwd_local = np.int64(query_len - 1) - (np.int64(qs) + i)
            u[pos : pos + n] = ((np.int64(query_offset) + fwd_local) << 1) | 1
        else:
            u[pos : pos + n] = (np.int64(query_offset + qs) + i) << 1
        pos += n
    return u, v
