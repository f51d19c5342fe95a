"""seqrush_tpu_torch and chip_smoke.py import nothing of JAX and nothing of
seqrush_tpu; entry points default to cuda and raise without a GPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seqrush_tpu_torch.align.runner import WfaAligner
from seqrush_tpu_torch.config import Args
from seqrush_tpu_torch.ops import nw_cuda
from seqrush_tpu_torch.ops import unionfind as uf
from seqrush_tpu_torch.pipeline import SeqRushTorch
from seqrush_tpu_torch.sequences import make_sequence_set
from seqrush_tpu_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "seqrush_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path.name} imports {name}"
        assert top != "seqrush_tpu", f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, json\n"
        "before = set(sys.modules)\n"
        "import seqrush_tpu_torch, seqrush_tpu_torch.cli, seqrush_tpu_torch.pipeline\n"
        "import seqrush_tpu_torch.ops.nw_cuda\n"
        "added = sorted(set(sys.modules) - before)\n"
        "print(json.dumps(added))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "seqrush_tpu_torch.cli" in added
    bad = [m for m in added if m.split(".")[0] in ("jax", "jaxlib", "seqrush_tpu")]
    assert bad == []


def test_entry_points_default_to_cuda_and_do_not_fall_back():
    assert Args().device == "cuda"
    seqs = make_sequence_set([("a", b"ACGTACGT"), ("b", b"ACGTTCGT")])
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WfaAligner(seqs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqRushTorch(seqs, Args(no_sort=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uf.create(4)
    assert resolve_device("cpu").type == "cpu"
    assert WfaAligner(seqs, device="cpu").align_pairs(np.array([[0, 1]]))[0].score == 5
    with pytest.raises(ValueError, match="cuda or cpu"):
        nw_cuda.nw_walk(
            torch.zeros((1, 128, 4), dtype=torch.uint8, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            band=3, tmax=8,
        )
