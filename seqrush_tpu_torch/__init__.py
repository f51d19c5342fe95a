"""seqrush_tpu_torch — pangenome graph construction in PyTorch, with
hand-written CUDA kernels for Hopper.

The PyTorch/CUDA port of ``seqrush_tpu``: FASTA in, all-pairs banded Gotoh
alignment (a sweep kernel and a traceback-walk kernel; or the seed-and-extend
sweepga backend, and the inversion-aware mode), bidirected union-find, graph
induction, compaction, layout and GFA 1.0 out.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions of the kernels.
"""

__version__ = "0.1.0"

from .config import Args  # noqa: F401
from .scores import AlignmentScores  # noqa: F401
from .sequences import Sequence, SequenceSet, load_fasta, load_fasta_str, make_sequence_set  # noqa: F401


def run_seqrush(args):
    """Top-level pipeline entry (lazy import keeps `import seqrush_tpu_torch` light)."""
    from .pipeline import run_seqrush as _run

    return _run(args)
