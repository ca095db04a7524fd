"""ctypes binding to the native node-agent core (port of
``tpu_composer/agent/native.py``).

The port builds its own copy of the library, ``native/gpunode.cc`` in this
package, at first use with the host C++ compiler into ``build/``, as
``scheduler/native.py`` builds the placement kernel: the library's name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads straight from the build directory. A failed
build raises with the compiler's output; the agent never falls back to
Python quietly. The JAX package's ``native/build`` is never loaded.

The library's enumeration matches ``/dev/accel*`` and the per-GPU
``/dev/nvidia<minor>`` nodes (never NVIDIA's control nodes), by the same
rule as ``nodeagent._NVIDIA_GPU_NODE``. ``LocalNodeAgent``'s pure-Python
paths have the same semantics; the tests hold the two against each other.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Dict, List, Optional

from tpu_composer_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gpunode.cc"

_lib: Optional["_NativeLib"] = None
#: Seconds and compiler output of the build this process ran, if any.
build_log: Dict[str, tuple] = {}


class _NativeLib:
    def __init__(self, cdll: ctypes.CDLL, path: str = "") -> None:
        self._c = cdll
        #: The shared object this handle was loaded from.
        self.path = path
        self._c.tpun_version.restype = ctypes.c_char_p
        self._c.tpun_enum_accel.restype = ctypes.c_int
        self._c.tpun_enum_accel.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        self._c.tpun_fd_holders.restype = ctypes.c_int
        self._c.tpun_fd_holders.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        self._c.tpun_read_file.restype = ctypes.c_int
        self._c.tpun_read_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        self._c.tpun_fd_holders_multi.restype = ctypes.c_int
        self._c.tpun_fd_holders_multi.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        self._c.tpun_proc_name.restype = ctypes.c_int
        self._c.tpun_proc_name.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        self._c.tpun_watch_dev.restype = ctypes.c_int
        self._c.tpun_watch_dev.argtypes = [ctypes.c_char_p, ctypes.c_int]

    def version(self) -> str:
        return self._c.tpun_version().decode()

    def enum_accel(self, dev_dir: str) -> List[str]:
        """Per-chip device nodes under ``dev_dir``, sorted: ``accel*`` and
        the per-GPU ``nvidia<minor>``."""
        buf = ctypes.create_string_buffer(64 * 1024)
        n = self._c.tpun_enum_accel(dev_dir.encode(), buf, len(buf))
        if n <= 0:
            return []
        return buf.value.decode().split("\n")

    def fd_holders(self, dev_path: str, proc_dir: str) -> List[int]:
        arr = (ctypes.c_int * 1024)()
        n = self._c.tpun_fd_holders(dev_path.encode(), proc_dir.encode(), arr, 1024)
        if n <= 0:
            return []
        return list(arr[: min(n, 1024)])

    def read_file(self, path: str) -> Optional[str]:
        buf = ctypes.create_string_buffer(64 * 1024)
        n = self._c.tpun_read_file(path.encode(), buf, len(buf))
        if n < 0:
            return None
        return buf.value.decode(errors="replace")

    def fd_holders_multi(self, dev_paths: List[str], proc_dir: str) -> "dict[str, List[int]]":
        """Holder pids per device path, attributed in a single /proc sweep:
        the C side emits (pid, path_index) pairs directly. Raises OSError on
        a failed sweep — callers guard drains, so an error must surface as
        UNKNOWN, never read as idle (matching the Python path, which
        propagates anything but a missing proc dir)."""
        if not dev_paths:
            return {}
        max_pairs = 4096
        pairs = (ctypes.c_int * (2 * max_pairs))()
        total = self._c.tpun_fd_holders_multi(
            "\n".join(dev_paths).encode(), proc_dir.encode(), pairs, max_pairs
        )
        out: dict[str, List[int]] = {p: [] for p in dev_paths}
        if total < 0:
            if not os.path.isdir(proc_dir):
                return out  # absent proc tree = no holders (Python parity)
            raise OSError(f"native fd sweep of {proc_dir} failed")
        for i in range(min(total, max_pairs)):
            pid, idx = pairs[2 * i], pairs[2 * i + 1]
            if 0 <= idx < len(dev_paths):
                out[dev_paths[idx]].append(pid)
        return out

    def proc_name(self, proc_dir: str, pid: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._c.tpun_proc_name(proc_dir.encode(), pid, buf, len(buf))
        if n <= 0:
            return ""
        return buf.value.decode(errors="replace")

    def watch_dev(self, dev_dir: str, timeout_ms: int) -> int:
        """1 = a device node changed under dev_dir, 0 = timeout, -1 = error
        (caller falls back to polling)."""
        return self._c.tpun_watch_dev(dev_dir.encode(), timeout_ms)


def library_path(source: Path = SOURCE, build_dir: Path = _build.BUILD) -> Path:
    return _build.cxx_library_path(source, build_dir, "gpunode")


def build_native(source: Path = SOURCE, build_dir: Path = _build.BUILD) -> Path:
    """Compile ``source`` into ``build_dir`` unless its library is current;
    returns the library's path. Raises RuntimeError with the compiler's
    output when the compile fails."""
    return _build.build_cxx(source, build_dir, "gpunode", build_log)


def native_lib() -> "_NativeLib":
    """Build (once), load and return the native library; raises when it
    cannot be built or loaded."""
    global _lib
    with _build._lock:
        if _lib is None:
            path = build_native()
            _lib = _NativeLib(ctypes.CDLL(str(path)), str(path))
        return _lib
