"""Orientation-encoded positions and handles; base codes.

A ``Pos`` packs (offset, orientation) into a single integer with the
orientation in the LSB (0 = forward, 1 = reverse); a ``Handle`` does the same
for (node_id, orientation).  These bit encodings mirror the reference design
(reference src/pos.rs:6-64, reference src/bidirected_graph.rs:9-63) and
are array-friendly: every Pos and Handle helper here works on a scalar or
elementwise on a numpy integer array.  A copy of seqrush_tpu/pos.py.
"""

from __future__ import annotations

import numpy as np

FORWARD = 0
REVERSE = 1

# -- Pos ---------------------------------------------------------------------


def make_pos(offset, is_reverse):
    """Encode (offset, orientation) -> Pos. Works on scalars or arrays."""
    return (np.asarray(offset) << 1) | np.asarray(is_reverse).astype(np.int64).astype(
        np.asarray(offset).dtype if hasattr(offset, "dtype") else np.int64
    )


def is_rev(pos):
    return (np.asarray(pos) & 1) == 1


def pos_offset(pos):
    return np.asarray(pos) >> 1


def flip_orientation(pos):
    return np.asarray(pos) ^ 1


def incr_pos(pos):
    """Advance along the strand (reverse strand walks backward).

    Mirrors reference src/pos.rs:28-41 including the clamp at offset 0.
    """
    pos = np.asarray(pos)
    rev = (pos & 1) == 1
    off = pos >> 1
    fwd_next = ((off + 1) << 1)
    rev_next = (np.maximum(off - 1, 0) << 1) | 1
    # reverse strand at offset 0 stays put (clamp), matching the reference
    rev_next = np.where(off > 0, rev_next, pos)
    return np.where(rev, rev_next, fwd_next)


def decr_pos(pos):
    pos = np.asarray(pos)
    rev = (pos & 1) == 1
    off = pos >> 1
    rev_prev = ((off + 1) << 1) | 1
    fwd_prev = np.maximum(off - 1, 0) << 1
    fwd_prev = np.where(off > 0, fwd_prev, pos)
    return np.where(rev, rev_prev, fwd_prev)


# -- Handle ------------------------------------------------------------------


def make_handle(node_id, is_reverse):
    return (np.asarray(node_id) << 1) | np.asarray(is_reverse).astype(np.int64).astype(
        np.asarray(node_id).dtype if hasattr(node_id, "dtype") else np.int64
    )


def handle_node(handle):
    return np.asarray(handle) >> 1


def handle_is_rev(handle):
    return (np.asarray(handle) & 1) == 1


def handle_flip(handle):
    return np.asarray(handle) ^ 1


def handle_str(handle) -> str:
    h = int(handle)
    return f"{h >> 1}{'-' if h & 1 else '+'}"


# -- Bases -------------------------------------------------------------------

# Encoded bases: A=0 C=1 G=2 T=3, N=4.  Characters outside uppercase ACGTN keep their raw byte value (>= 8, so
# they never collide with the codes or the kernel pad values 6/7): two bases
# compare equal iff the original bytes are equal.  This matches the
# reference, whose WFA2 kernel and unite validation compare raw bytes
# (case-sensitive; 'a' does not match 'A').
_ENCODE_LUT = np.arange(256, dtype=np.uint8)
for i, ch in enumerate(b"ACGT"):
    _ENCODE_LUT[ch] = i
_ENCODE_LUT[ord("N")] = 4

_DECODE_LUT = np.frombuffer(b"ACGTNX", dtype=np.uint8).copy()

_COMPLEMENT_BYTE_LUT = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ATCGNatcgn", b"TAGCNtagcn"):
    _COMPLEMENT_BYTE_LUT[a] = b


def encode_bases(data: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> base codes (uint8: 0..3 ACGT, 4 N, raw byte otherwise)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return _ENCODE_LUT[arr]


def decode_bases(codes: np.ndarray) -> bytes:
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes()


def complement_bytes(data: np.ndarray) -> np.ndarray:
    """Elementwise complement of ASCII bases (A<->T, C<->G, N->N, else kept)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return _COMPLEMENT_BYTE_LUT[arr]


def reverse_complement(data) -> np.ndarray:
    """Reverse complement over ASCII byte arrays (reference bidirected_graph.rs:73-85)."""
    return complement_bytes(data)[::-1]


def rc_byte(base: int) -> int:
    return int(_COMPLEMENT_BYTE_LUT[base])


# complement in code space: ACGT codes complement as 3-b; N stays; raw-byte
# codes (>= 8) complement through the byte LUT so e.g. 'a' (97) <-> 't' (116)
_CODE_COMPLEMENT_LUT = _COMPLEMENT_BYTE_LUT.copy()
for _i in range(4):
    _CODE_COMPLEMENT_LUT[_i] = 3 - _i
_CODE_COMPLEMENT_LUT[4] = 4
_CODE_COMPLEMENT_LUT[5] = 5
_CODE_COMPLEMENT_LUT[6] = 6
_CODE_COMPLEMENT_LUT[7] = 7


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in base-code space (matches byte-level RC)."""
    return _CODE_COMPLEMENT_LUT[np.asarray(codes, dtype=np.uint8)][::-1]
