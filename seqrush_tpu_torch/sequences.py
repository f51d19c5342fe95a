"""Sequence loading and the concatenated-offset address space.

Equivalent surface to the reference loader (reference src/seqrush.rs:
272-296, 1801-1837): multi-line FASTA, IDs truncated at first whitespace,
each sequence assigned a global ``offset`` into the concatenated base space.

Array-first difference: besides the per-sequence byte views we keep a single
contiguous ``concat`` uint8 array, so graph induction and the union-find
address all bases through one dense address space.

``load_fasta`` reads a file with the host library's C++ parser, as the JAX
package does wherever its library builds; the Python loop below it is the
plain version, taken only when the C++ call itself raises (an unreadable
path, a name that is not UTF-8).  A library that does not build raises.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

import numpy as np

from .native import get_lib, parse_fasta_native


@dataclass
class Sequence:
    id: str
    data: np.ndarray  # uint8 ASCII bases
    offset: int  # offset in the concatenated space

    def __len__(self) -> int:
        return len(self.data)


@dataclass
class SequenceSet:
    """All input sequences plus the dense concatenated views used on device."""

    sequences: list[Sequence]
    concat: np.ndarray = field(init=False)  # uint8 ASCII, shape [total_len]
    offsets: np.ndarray = field(init=False)  # int64 [n+1] prefix offsets

    def __post_init__(self):
        for s in self.sequences:
            if len(s.data) == 0:
                raise ValueError(
                    f"Empty sequences are not allowed: sequence '{s.id}' has length 0"
                )
        if self.sequences:
            self.concat = np.concatenate([s.data for s in self.sequences])
        else:
            self.concat = np.zeros(0, dtype=np.uint8)
        lens = np.array([len(s.data) for s in self.sequences], dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lens)])
        for s, off in zip(self.sequences, self.offsets[:-1]):
            assert s.offset == int(off), "sequence offsets must be prefix sums"

    @property
    def total_length(self) -> int:
        return int(self.offsets[-1])

    def __len__(self) -> int:
        return len(self.sequences)

    def __getitem__(self, i: int) -> Sequence:
        return self.sequences[i]

    def name_to_index(self) -> dict[str, int]:
        return {s.id: i for i, s in enumerate(self.sequences)}


def make_sequence_set(named_seqs: list[tuple[str, bytes]]) -> SequenceSet:
    seqs = []
    offset = 0
    for name, data in named_seqs:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        seqs.append(Sequence(id=name, data=arr, offset=offset))
        offset += len(arr)
    return SequenceSet(seqs)


def load_fasta(path: str | os.PathLike) -> SequenceSet:
    """Parse FASTA into a SequenceSet (reference seqrush.rs:1801-1837)."""
    get_lib()  # a failed build raises here, not in the fallback below
    try:
        return make_sequence_set(parse_fasta_native(os.fspath(path)))
    except (OSError, UnicodeDecodeError):
        pass  # an unreadable path or a name that is not UTF-8: the loop decides, as in the JAX package
    return load_fasta_python(path)


def load_fasta_python(path: str | os.PathLike) -> SequenceSet:
    """The plain version of load_fasta: a Python loop that strips every
    whitespace byte and keeps the first whitespace-separated word of a
    header."""
    named: list[tuple[str, bytes]] = []
    current_id: str | None = None
    chunks: list[bytes] = []
    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.strip()
            if line.startswith(b">"):
                if current_id is not None:
                    named.append((current_id, b"".join(chunks)))
                    chunks = []
                # first whitespace-separated word is the ID
                current_id = line[1:].split(None, 1)[0].decode() if len(line) > 1 else ""
            elif current_id is not None:
                chunks.append(line)
    if current_id is not None:
        named.append((current_id, b"".join(chunks)))
    return make_sequence_set(named)


def load_fasta_str(text: str) -> SequenceSet:
    """Parse FASTA text (the JAX package's ``load_fasta_str``)."""
    named: list[tuple[str, bytes]] = []
    current_id: str | None = None
    chunks: list[str] = []
    for raw in io.StringIO(text):
        line = raw.strip()
        if line.startswith(">"):
            if current_id is not None:
                named.append((current_id, "".join(chunks).encode()))
                chunks = []
            current_id = line[1:].split()[0] if len(line) > 1 else ""
        elif current_id is not None:
            chunks.append(line)
    if current_id is not None:
        named.append((current_id, "".join(chunks).encode()))
    return make_sequence_set(named)
