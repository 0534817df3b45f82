"""nvcc build, ctypes bindings and launch counts of the port's CUDA kernels.

The sources in ``tpucdc_torch/csrc/*.cu`` have a plain C interface. At first
use each one is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a``, and the objects are linked into
``_build/libtpucdc_torch_kernels.so``, which ctypes loads. Every pointer and
the stream are passed as ``c_void_p``; each entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

``LAUNCHES`` counts, per kernel, the device launches made through the
wrappers in ``ops/groupnorm.py``, ``ops/attention.py`` and ``ops/adaln.py``:
one per call for each (GN+SiLU is one cooperative launch). A run reads it to
show that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

from tpucdc_torch.utils.build import BUILD_DIR, build_lock, is_stale

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "gn_silu.cu", CSRC / "attention.cu",
           CSRC / "attention_sm90.cu", CSRC / "dit_adaln.cu")
LIBRARY = BUILD_DIR / "libtpucdc_torch_kernels.so"
PTXAS_LOG = BUILD_DIR / "ptxas.log"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# Device launches per kernel; each wrapper adds 1 where it launches.
LAUNCHES = {"gn_silu": 0, "attention": 0, "adaln": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def build(force: bool = False) -> pathlib.Path:
    """Compile and link the kernel library if it is missing or stale."""
    if not force and not is_stale(LIBRARY, SOURCES):
        return LIBRARY
    with build_lock("kernels"):
        if not force and not is_stale(LIBRARY, SOURCES):
            return LIBRARY
        nvcc = _nvcc()
        objects, procs = [], []
        for src in SOURCES:
            obj = BUILD_DIR / f"{src.stem}.o"
            objects.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        logs = []
        for src, proc in zip(SOURCES, procs):
            out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}{err}")
            logs.append(f"== {src.name}\n{out}{err}")
        tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, LIBRARY)
        PTXAS_LOG.write_text("".join(logs))
        return LIBRARY


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.tpucdc_gn_silu.restype = i
        lib.tpucdc_gn_silu.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, p]
        lib.tpucdc_attention.restype = i
        lib.tpucdc_attention.argtypes = [p, p, p, p, i, i, i, i, i,
                                         ctypes.POINTER(ctypes.c_longlong),
                                         f, i, p]
        lib.tpucdc_dit_adaln.restype = i
        lib.tpucdc_dit_adaln.argtypes = [p, p, p, p, p, ll, ll, ll, p, p, i,
                                         i, i, f, i, i, p]
        _lib = lib
    return _lib


def dtype_code(dtype) -> int:
    """The kernels' dtype argument: 0 = float32, 1 = bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
