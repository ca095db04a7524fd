"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (one or more entry
points) and compiles, on its own, into ``build/lib<name>-<hash>.so``; the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source or header rebuilds and an unchanged one loads
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
from typing import Callable, Dict, Iterable, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
# --split-compile=0 lets nvcc optimize a source's kernels in parallel,
# one thread per CPU.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--split-compile=0",
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
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


#: The host C++ compiler's flags for the port's native libraries
#: (``native/*.cc``: the placement kernel, the node agent's scan).
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]


def find_cxx() -> str:
    """The host C++ compiler: c++, else g++, on PATH."""
    found = shutil.which("c++") or shutil.which("g++")
    if not found:
        raise RuntimeError(
            "no C++ compiler (c++ or g++) on PATH; the port's native"
            " libraries (the placement kernel, the node agent's scan)"
            " cannot be built"
        )
    return found


def cxx_library_path(source: Path, build_dir: Path, stem: str) -> Path:
    """``build_dir/lib<stem>-<hash>.so``, the hash over the source and
    the flags."""
    digest = hashlib.sha256(
        Path(source).read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return Path(build_dir) / f"lib{stem}-{digest}.so"


def build_cxx(source: Path, build_dir: Path, stem: str,
              log: Dict[str, tuple]) -> Path:
    """Compile ``source`` with the host C++ compiler into ``build_dir``
    unless its library is current; returns the library's path and puts
    (seconds, compiler output) under ``log[stem]`` when it compiled.
    Raises RuntimeError with the compiler's output when the compile
    fails."""
    out = cxx_library_path(source, build_dir, stem)
    if out.exists():
        return out
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    log[stem] = (time.perf_counter() - t0, proc.stdout)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(
            f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see half
    return out


def load(name: str, argtypes: Sequence, symbol: Optional[str] = None
         ) -> Callable:
    """The C entry point ``symbol`` (default ``name``) of
    ``csrc/<name>.cu``, bound with ``argtypes`` and returning its
    ``cudaError_t`` as an int; builds the library first if needed."""
    symbol = symbol or name
    with _lock:
        fn = _loaded.get(symbol)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[symbol] = fn
        return fn
