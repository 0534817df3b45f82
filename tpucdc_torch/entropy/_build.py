"""Build-on-first-use of the C++ rANS shared library.

Compiles tpucdc_torch/entropy/cpp/rans.cc with g++ into the port's build
directory (``tpucdc_torch/_build/``); concurrent builders serialize on a lock
file there. If no compiler is available the caller falls back to the
pure-Python coder (rans_py.py).
"""

from __future__ import annotations

import os
import pathlib
import subprocess

from tpucdc_torch.utils.build import BUILD_DIR, build_lock, is_stale

_SRC = pathlib.Path(__file__).parent / "cpp" / "rans.cc"
_SO = BUILD_DIR / "librans_tpucdc_torch.so"


def build_library(force: bool = False) -> pathlib.Path | None:
    """Return the path to the built .so, or None if building is impossible."""
    if not force and not is_stale(_SO, [_SRC]):
        return _SO
    with build_lock("rans"):
        if not force and not is_stale(_SO, [_SRC]):
            return _SO
        tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
               "-march=native", "-o", str(tmp), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            msg = getattr(e, "stderr", b"")
            print(f"[tpucdc_torch.entropy] C++ coder build failed "
                  f"({type(e).__name__}: {msg!r}); using Python fallback.")
            return None
        os.replace(tmp, _SO)
        return _SO
