"""ctypes binding to the native placement kernel (port of
``tpu_composer/scheduler/native.py``).

The port builds its own copy of the kernel, ``native/tpusched.cc`` in this
package, at first use with the host C++ compiler into ``build/`` beside
the CUDA kernels (``ops/_build.py``'s directory and lock). The library's
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads straight from the build directory. A
failed build raises with the compiler's output: it never turns into the
Python kernel quietly. The JAX package's ``native/build`` is never loaded.

``TPUC_NATIVE_SCHED=0`` is the one way to ask for the Python path: it
disables the whole native-scheduler layer (snapshot AND kernel), and the
scheduler then runs the legacy store-walk engine
(``PlacementEngine.last_scan_kind == "legacy"``). The kernel is bit-identical
to the pure-Python ``snapshot.py_scan`` and ``preemption.py``'s search
(differential-fuzzed in tests/test_torch_native_sched.py).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from tpu_composer_torch.ops import _build

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tpusched.cc"

_lib: Optional["_NativeLib"] = None
#: Seconds and compiler output of the build this process ran, if any.
build_log: Dict[str, tuple] = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def native_sched_enabled() -> bool:
    """The master switch for the snapshot + native-kernel layer."""
    return os.environ.get("TPUC_NATIVE_SCHED", "1") != "0"


class _NativeLib:
    def __init__(self, cdll: ctypes.CDLL) -> None:
        self._c = cdll
        self._c.tpus_version.restype = ctypes.c_int
        self._c.tpus_scan.restype = ctypes.c_int32
        self._c.tpus_scan.argtypes = [
            ctypes.c_int32,
            _I32P, _I32P, _I32P, _U8P,
            _I64P, _I64P, _I64P, _I64P,
            ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P, _I32P, _I32P,
        ]
        self._c.tpus_victims.restype = ctypes.c_int32
        self._c.tpus_victims.argtypes = [
            ctypes.c_int32,
            _I32P, _I32P, _U8P,
            _I64P, _I64P, _I64P, _I64P,
            ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            _I64P, _I64P, _I32P,
            _I32P, _I32P, _I32P,
            ctypes.c_int32, ctypes.c_int32,
            _I32P, _I64P,
        ]

    def version(self) -> int:
        return int(self._c.tpus_version())

    def scan(
        self, n, slots, used, hidx, flags, cpu, mem, eph, pods,
        other, chips: int, count: int,
    ):
        """Mirror of snapshot.py's py_scan over the same packed arrays:
        returns (num_ok, out_free, out_verdict, out_order, sel) with
        sel=None when no selection was requested or fewer than ``count``
        nodes fit. Raises OSError on a kernel-reported argument error so
        the caller can fall back to the Python path."""
        out_free = (ctypes.c_int32 * n)()
        out_verdict = (ctypes.c_int32 * n)()
        out_order = (ctypes.c_int32 * n)()
        out_sel = (ctypes.c_int32 * max(1, count))()
        num_ok = self._c.tpus_scan(
            n, slots, used, hidx, flags, cpu, mem, eph, pods,
            1 if other is not None else 0,
            other.milli_cpu if other is not None else 0,
            other.memory if other is not None else 0,
            other.ephemeral_storage if other is not None else 0,
            other.allowed_pod_number if other is not None else 0,
            chips, count,
            out_free, out_verdict, out_order, out_sel,
        )
        if num_ok < 0:
            raise OSError("tpus_scan rejected its arguments")
        sel = None
        if count >= 1 and num_ok >= count:
            sel = [out_sel[i] for i in range(count)]
        return num_ok, out_free, out_verdict, out_order, sel

    def victims(
        self, n, slots, used, usable, cpu, mem, eph, pods,
        other, chips: int, num_hosts: int,
        target_mode: int, target_idx: int,
        cand_prio, cand_chips, cand_rank,
        freed_off, freed_idx, freed_amt,
        max_exh_cands: int, max_exh_size: int,
    ) -> Tuple[List[int], dict]:
        """Returns (victim candidate indices, last_search-shaped info).
        Raises OSError on a kernel-reported argument error."""
        ncand = len(cand_rank)
        out_sel = (ctypes.c_int32 * max(1, ncand))()
        out_info = (ctypes.c_int64 * 4)()
        nv = self._c.tpus_victims(
            n, slots, used, usable, cpu, mem, eph, pods,
            1 if other is not None else 0,
            other.milli_cpu if other is not None else 0,
            other.memory if other is not None else 0,
            other.ephemeral_storage if other is not None else 0,
            other.allowed_pod_number if other is not None else 0,
            chips, num_hosts, target_mode, target_idx,
            ncand, cand_prio, cand_chips, cand_rank,
            freed_off, freed_idx, freed_amt,
            max_exh_cands, max_exh_size,
            out_sel, out_info,
        )
        if nv < 0:
            raise OSError("tpus_victims rejected its arguments")
        mode = int(out_info[0])
        if mode == 1:
            info = {
                "mode": "exhaustive",
                "candidates": ncand,
                "set_size": int(out_info[1]),
                "victim_priority_sum": int(out_info[2]),
                "victim_chips": int(out_info[3]),
            }
        elif mode == 2:
            info = {
                "mode": "greedy+prune",
                "candidates": ncand,
                "set_size": int(out_info[1]),
            }
        else:
            info = {"mode": "infeasible", "candidates": ncand}
        return [out_sel[i] for i in range(nv)], info


def library_path(source: Path = SOURCE, build_dir: Path = _build.BUILD) -> Path:
    return _build.cxx_library_path(source, build_dir, "tpusched")


def build_native(source: Path = SOURCE, build_dir: Path = _build.BUILD) -> Path:
    """Compile ``source`` into ``build_dir`` unless its library is current;
    returns the library's path. Raises RuntimeError with the compiler's
    output when the compile fails."""
    return _build.build_cxx(source, build_dir, "tpusched", build_log)


def native_lib() -> "_NativeLib":
    """Build (once), load and return the native library; raises when it
    cannot be built or loaded. The TPUC_NATIVE_SCHED=0 kill switch is
    enforced by the caller (ClusterScheduler) — the load is cached
    process-wide, in this package's own handle, and must not capture a
    transient env state."""
    global _lib
    with _build._lock:
        if _lib is None:
            _lib = _NativeLib(ctypes.CDLL(str(build_native())))
        return _lib
