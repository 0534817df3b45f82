"""Build directory and file lock shared by the port's native builds.

The rANS host coder (g++) and the CUDA kernels (nvcc) are compiled at first
use into ``tpucdc_torch/_build/``, which git ignores. Concurrent builders
(test workers, several processes on one card) serialize on a lock file there,
and a library is rebuilt when any of its sources is newer than it.
"""

from __future__ import annotations

import contextlib
import fcntl
import pathlib

BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"


def is_stale(target: pathlib.Path, sources) -> bool:
    """True when ``target`` is missing or older than any of ``sources``."""
    if not target.exists():
        return True
    built = target.stat().st_mtime
    return any(pathlib.Path(s).stat().st_mtime > built for s in sources)


@contextlib.contextmanager
def build_lock(name: str):
    """Hold an exclusive lock on ``_build/.<name>.lock`` for the block."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
