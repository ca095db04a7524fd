"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles, on its
own, into ``build/lib<name>-<hash>.so``; the hash covers the source and
the flags, so an edited source rebuilds and an unchanged one loads
straight from the build directory. Nothing is compiled when a module is
imported: a kernel's wrapper calls :func:`load` when it launches (only
the first call builds and binds), and
:func:`build` compiles several sources at once (one nvcc process each,
all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_loaded: Dict[str, Callable] = {}
# name -> (seconds, nvcc output incl. ptxas register/smem report), for the
# sources this process compiled.
build_log: Dict[str, tuple] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH;"
        " the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every source in ``names`` that has no current library, all
    nvcc processes in parallel. Returns seconds per compiled source;
    raises with nvcc's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds = {}
    failed = []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = (seconds[name], log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, argtypes: Sequence) -> Callable:
    """The C entry point ``name`` of ``csrc/<name>.cu``, bound with
    ``argtypes`` and returning its ``cudaError_t`` as an int; builds the
    library first if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
