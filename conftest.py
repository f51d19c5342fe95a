"""Build the native runtime library once per test run.

``seqrush_tpu/native.py`` compiles ``csrc/seqrush_native.cpp`` with g++ on
first use into ``build/libseqrush_native_<hash>.so``.  Under pytest-xdist
every worker would otherwise compile at the same time into the same
temporary file; a worker whose compile, rename or load loses that race
remembers the failure and skips all its native tests.  Here the first
process to take the lock builds the library before any test module is
collected, and every later process finds it built.

``native.py`` is loaded by its path, not through ``import seqrush_tpu``: it
needs only the standard library and numpy, and importing the package could
import jax before ``tests/conftest.py`` sets up its CPU devices.

Each pytest-xdist worker also gets one torch intra-op thread.  The port's
CPU paths issue many small torch ops; six workers each spinning torch's
default pool of one thread a core on the same cores run them hundreds of
times slower than one thread each.  No result depends on the thread count.
"""

import fcntl
import importlib.util
import os
from pathlib import Path

_ROOT = Path(__file__).resolve().parent


def pytest_configure(config):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        try:
            import torch
        except ImportError:
            pass
        else:
            torch.set_num_threads(1)
    native_py = _ROOT / "seqrush_tpu" / "native.py"
    if not native_py.exists():
        return
    build = _ROOT / "build"
    build.mkdir(exist_ok=True)
    with open(build / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            spec = importlib.util.spec_from_file_location("_seqrush_native_build", native_py)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            module.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
