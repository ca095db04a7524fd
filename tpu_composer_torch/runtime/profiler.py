"""Always-on sampling profiler for the control plane (port of
``tpu_composer/runtime/profiler.py``).

Before offloading a hot loop to native code one needs evidence of which
loop is hot (placement fit search, store serialization, dispatcher
lanes). This is the evidence layer: a low-overhead thread-stack sampler over
``sys._current_frames()`` that runs for the process's whole life as a
Manager runnable, attributing samples to the NAMED subsystem threads
(reconcile workers, dispatcher lanes, syncer, elector, event session) and
keeping a continuous ring of profile windows so the last few minutes are
always inspectable — including from a soak failure artifact.

Outputs:

- **Collapsed stacks** (flamegraph-folded: ``subsystem;root;..;leaf N``)
  and **top-N frames** (self + cumulative sample counts) via the
  manager's ``/debug/profile?seconds=&format=`` burst endpoint and the
  ``/debug/profile/continuous`` ring endpoint.
- **Wall-vs-CPU split per subsystem**: each sample classifies the thread
  as blocked (parked in a known wait frame — threading/queue/socket
  waits) or runnable; runnable wall time minus the thread's measured CPU
  time (``/proc/self/task/<tid>/stat``) estimates time spent RUNNABLE BUT
  NOT EXECUTING — overwhelmingly GIL wait in this process. That estimate
  (``tpuc_gil_wait_ratio{subsystem}``) is the number a native offload
  needs first. It is an upper bound: a thread
  parked in a C-level sleep the sampler cannot see (e.g. ``time.sleep``)
  reads as runnable with no CPU.
- ``TPUC_PROFILE=0`` (or ``set_enabled(False)``) disables the always-on
  sampler (and, via runtime/contention.py sharing the knob, the lock
  telemetry). The on-demand
  ``/debug/profile`` burst still works when disabled — it is explicitly
  requested, not ambient.

The workload side keeps ``torch.profiler`` for device execution; this
covers the operator half, like runtime/tracing.py does for causality.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_composer_torch.runtime.metrics import gil_wait_ratio, profiler_samples_total

_enabled = os.environ.get("TPUC_PROFILE", "1") != "0"

#: The most recently started always-on profiler — what the crash hooks
#: dump ($TPUC_PROFILE_FILE) and benchmark helpers read. Process-global like
#: the trace ring and the metrics registry.
_active: Optional["SamplingProfiler"] = None


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


# ----------------------------------------------------------------------
# thread attribution
# ----------------------------------------------------------------------
def subsystem_for(thread_name: str) -> str:
    """Canonical subsystem for a thread name — the attribution key the
    profile windows aggregate on. Every named control-plane thread maps to
    a stable bucket; anything unrecognized lands in 'other' (a growing
    'other' share means a new thread needs a name)."""
    n = thread_name or ""
    if n.startswith("fabric-dispatch-"):
        return "dispatcher-lane"
    if n.startswith("fabric-events-") or n == "FabricSession":
        return "session"
    if "-worker-" in n:
        return "reconcile-worker"
    if "-dispatch-" in n:
        return "watch-dispatch"
    if n == "UpstreamSyncer":
        return "syncer"
    if n in ("lease-renew", "shard-lease-renew", "leader-watchdog"):
        return "elector"
    if n.startswith("informer-") or n.startswith("kubecache-"):
        return "informer"
    if n == "lifecycle-watch":
        return "lifecycle"
    if n in ("health", "metrics", "admission-webhook", "node-agent") or (
        # ThreadingMixIn names request threads "Thread-N (process_request_thread)".
        "process_request_thread" in n
    ):
        return "http"
    if n.startswith("profiler") or n == "slo-engine":
        return "observatory"
    if n == "MainThread":
        return "main"
    if n == "FabricDispatcher":
        return "dispatcher-run"
    if n in ("DefragLoop", "DeviceEventWatcher", "MultiNodeWatcher"):
        return n
    return "other"


#: Leaf frames that mean "parked, not runnable": the stdlib's wait
#: primitives. Conservative on purpose — misreading blocked as runnable
#: only inflates the GIL estimate (documented as an upper bound).
_WAIT_FUNCS = frozenset({
    "wait", "wait_for", "acquire", "select", "poll", "accept", "recv",
    "recv_into", "read", "readinto", "get", "join", "epoll",
})
_WAIT_FILES = frozenset({
    "threading.py", "queue.py", "selectors.py", "socket.py", "ssl.py",
    "socketserver.py", "subprocess.py", "connection.py",
})

_CLK_TCK = 100.0
try:  # pragma: no branch
    _CLK_TCK = float(os.sysconf("SC_CLK_TCK"))
except (AttributeError, ValueError, OSError):  # pragma: no cover - non-posix
    pass


def _thread_cpu_s(native_id: Optional[int]) -> Optional[float]:
    """Per-thread CPU seconds (utime+stime) from /proc; None when the
    platform (or a raced thread exit) makes it unreadable."""
    if not native_id:
        return None
    try:
        with open(f"/proc/self/task/{native_id}/stat", "rb") as f:
            data = f.read()
        rest = data.rsplit(b")", 1)[1].split()
        return (int(rest[11]) + int(rest[12])) / _CLK_TCK
    except (OSError, IndexError, ValueError):
        return None


def _frame_label(code) -> str:
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}.{code.co_name}"


def _gil_split(
    samples: float, blocked: float, cpu_s: float, interval: float
) -> Tuple[float, float, float]:
    """(runnable_wall, gil_wait, gil_ratio) — THE estimate, defined once:
    runnable wall time is the non-blocked samples' worth of wall clock,
    and whatever part of it the thread did not spend executing (measured
    CPU) was spent waiting for the GIL (upper bound; see module doc)."""
    runnable_wall = (samples - blocked) * interval
    gil_wait = max(0.0, runnable_wall - cpu_s)
    ratio = gil_wait / runnable_wall if runnable_wall > 1e-9 else 0.0
    return runnable_wall, gil_wait, ratio


class _Window:
    """One aggregation window of the continuous ring."""

    __slots__ = (
        "started_at", "started_mono", "ended_mono", "samples",
        "stacks", "threads",
    )

    def __init__(self, now_mono: float) -> None:
        self.started_at = time.time()
        self.started_mono = now_mono
        self.ended_mono: Optional[float] = None
        self.samples = 0
        # (subsystem, stack_tuple) -> sample count (stack root-first)
        self.stacks: collections.Counter = collections.Counter()
        # subsystem -> {samples, blocked, cpu_s}
        self.threads: Dict[str, Dict[str, float]] = {}

    def freeze(self) -> "_Window":
        """Immutable copy for readers. Caller holds the profiler lock:
        the OPEN window keeps mutating under the sampler, and handing its
        live dicts to an endpoint iterating outside the lock is a
        'dictionary changed size during iteration' 500 waiting to happen.
        Rolled (ring) windows are never mutated again and are shared."""
        w = _Window.__new__(_Window)
        w.started_at = self.started_at
        w.started_mono = self.started_mono
        w.ended_mono = self.ended_mono
        w.samples = self.samples
        w.stacks = collections.Counter(self.stacks)
        w.threads = {sub: dict(st) for sub, st in self.threads.items()}
        return w

    def to_dict(self, interval: float) -> Dict[str, Any]:
        out_threads = {}
        for sub, st in sorted(self.threads.items()):
            runnable_wall, gil_wait, ratio = _gil_split(
                st["samples"], st["blocked"], st["cpu_s"], interval
            )
            out_threads[sub] = {
                "samples": int(st["samples"]),
                "blocked_samples": int(st["blocked"]),
                "wall_s": round(st["samples"] * interval, 4),
                "runnable_wall_s": round(runnable_wall, 4),
                "cpu_s": round(st["cpu_s"], 4),
                "gil_wait_s": round(gil_wait, 4),
                "gil_wait_ratio": round(ratio, 4),
            }
        return {
            "started_at": self.started_at,
            "duration_s": round(
                (self.ended_mono or time.monotonic()) - self.started_mono, 3
            ),
            "samples": self.samples,
            "threads": out_threads,
            "top": _top_from_stacks(self.stacks, 10),
        }


def _top_from_stacks(stacks: collections.Counter, n: int) -> List[Dict[str, Any]]:
    self_c: collections.Counter = collections.Counter()
    cum_c: collections.Counter = collections.Counter()
    total = 0
    for (_sub, stack), count in stacks.items():
        total += count
        if stack:
            self_c[stack[-1]] += count
            for frame in set(stack):
                cum_c[frame] += count
    out = []
    for frame, count in self_c.most_common(n):
        out.append({
            "frame": frame,
            "self": count,
            "cumulative": cum_c[frame],
            "self_pct": round(100.0 * count / max(1, total), 1),
        })
    return out


class SamplingProfiler:
    """The sampler: one tick walks every thread's current stack."""

    def __init__(
        self,
        interval: float = 0.05,
        window_s: float = 10.0,
        ring: int = 30,
        max_depth: int = 48,
        cpu_every: int = 4,
    ) -> None:
        self.interval = max(0.001, interval)
        self.window_s = max(self.interval, window_s)
        self.max_depth = max_depth
        # CPU times are read from /proc every ``cpu_every`` ticks — the
        # GIL estimate needs window-scale granularity, not tick-scale.
        self.cpu_every = max(1, cpu_every)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=max(1, ring))
        self._current: Optional[_Window] = None
        self._cpu_prev: Dict[int, float] = {}  # thread ident -> cpu seconds
        self._tick = 0
        self._own_ident: Optional[int] = None

    # ------------------------------------------------------------------
    def run(self, stop_event: threading.Event, register: bool = True) -> None:
        """Manager runnable: sample until stopped. ``register`` makes this
        the process's active profiler (crash dumps read it); auxiliary
        samplers (bench's profile_during) pass False so a stopped
        short-lived sampler never shadows the always-on one in the
        crash-hook dump."""
        global _active
        if register:
            _active = self
        self._own_ident = threading.get_ident()
        while not stop_event.wait(self.interval):
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - must never kill the loop
                pass
        with self._lock:
            self._roll_window(time.monotonic())

    def sample_once(self) -> None:
        now = time.monotonic()
        frames = sys._current_frames()
        threads = {t.ident: t for t in threading.enumerate()}
        read_cpu = (self._tick % self.cpu_every) == 0
        self._tick += 1
        with self._lock:
            win = self._current
            if win is None:
                win = self._current = _Window(now)
            elif now - win.started_mono >= self.window_s:
                self._roll_window(now)
                win = self._current = _Window(now)
            for ident, frame in frames.items():
                if ident == self._own_ident:
                    continue  # the sampler observing itself is noise
                t = threads.get(ident)
                name = t.name if t is not None else f"tid-{ident}"
                sub = subsystem_for(name)
                stack: List[str] = []
                blocked = False
                f = frame
                depth = 0
                while f is not None and depth < self.max_depth:
                    code = f.f_code
                    if depth == 0:
                        blocked = (
                            code.co_name in _WAIT_FUNCS
                            and os.path.basename(code.co_filename) in _WAIT_FILES
                        )
                    stack.append(_frame_label(code))
                    f = f.f_back
                    depth += 1
                stack.reverse()
                win.stacks[(sub, tuple(stack))] += 1
                st = win.threads.setdefault(
                    sub, {"samples": 0.0, "blocked": 0.0, "cpu_s": 0.0}
                )
                st["samples"] += 1
                if blocked:
                    st["blocked"] += 1
                if read_cpu and t is not None:
                    cpu = _thread_cpu_s(getattr(t, "native_id", None))
                    if cpu is not None:
                        prev = self._cpu_prev.get(ident)
                        if prev is not None and cpu >= prev:
                            st["cpu_s"] += cpu - prev
                        self._cpu_prev[ident] = cpu
            win.samples += 1
        profiler_samples_total.inc()

    def _roll_window(self, now: float) -> None:
        # caller holds the lock
        win = self._current
        if win is None or win.samples == 0:
            self._current = None
            return
        win.ended_mono = now
        self._ring.append(win)
        self._current = None
        # Level-set the per-subsystem GIL estimate from the closed window.
        for sub, st in win.threads.items():
            _, _, ratio = _gil_split(
                st["samples"], st["blocked"], st["cpu_s"], self.interval
            )
            gil_wait_ratio.set(round(ratio, 4), subsystem=sub)

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def _windows_in(self, seconds: Optional[float]) -> List[_Window]:
        with self._lock:
            wins = list(self._ring)
            if self._current is not None and self._current.samples:
                wins.append(self._current.freeze())
        if seconds is None:
            return wins
        cutoff = time.monotonic() - seconds
        return [
            w for w in wins
            if (w.ended_mono or time.monotonic()) >= cutoff
        ]

    def merged_stacks(self, seconds: Optional[float] = None) -> collections.Counter:
        merged: collections.Counter = collections.Counter()
        for w in self._windows_in(seconds):
            merged.update(w.stacks)
        return merged

    def collapsed(self, seconds: Optional[float] = None) -> str:
        """Flamegraph-folded text: ``subsystem;root;..;leaf count`` lines
        (feed to flamegraph.pl / speedscope / inferno)."""
        lines = []
        for (sub, stack), count in sorted(
            self.merged_stacks(seconds).items(),
            key=lambda kv: -kv[1],
        ):
            lines.append(f"{sub};{';'.join(stack)} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def top(self, n: int = 10, seconds: Optional[float] = None) -> List[Dict[str, Any]]:
        return _top_from_stacks(self.merged_stacks(seconds), n)

    def thread_summary(self, seconds: Optional[float] = None) -> Dict[str, Any]:
        """Per-subsystem wall/cpu/blocked/GIL-estimate aggregate."""
        agg: Dict[str, Dict[str, float]] = {}
        for w in self._windows_in(seconds):
            for sub, st in w.threads.items():
                a = agg.setdefault(
                    sub, {"samples": 0.0, "blocked": 0.0, "cpu_s": 0.0}
                )
                for k in a:
                    a[k] += st[k]
        out = {}
        for sub, a in sorted(agg.items()):
            _, gil, ratio = _gil_split(
                a["samples"], a["blocked"], a["cpu_s"], self.interval
            )
            out[sub] = {
                "samples": int(a["samples"]),
                "blocked_samples": int(a["blocked"]),
                "wall_s": round(a["samples"] * self.interval, 4),
                "cpu_s": round(a["cpu_s"], 4),
                "gil_wait_s": round(gil, 4),
                "gil_wait_ratio": round(ratio, 4),
            }
        return out

    def windows(self) -> List[Dict[str, Any]]:
        """The continuous ring, JSON-able (what /debug/profile/continuous
        serves and the soak failure artifacts carry)."""
        return [w.to_dict(self.interval) for w in self._windows_in(None)]

    def snapshot(self, seconds: Optional[float] = None) -> Dict[str, Any]:
        return {
            "interval_s": self.interval,
            "window_s": self.window_s,
            "threads": self.thread_summary(seconds),
            "top": self.top(15, seconds),
        }


def profile_burst(seconds: float = 2.0, interval: float = 0.01) -> SamplingProfiler:
    """Blocking one-shot profile on the calling thread (the
    /debug/profile?seconds= endpoint): a private sampler at burst
    frequency, independent of — and safe alongside — the always-on one
    (``sys._current_frames`` is a read)."""
    prof = SamplingProfiler(interval=interval, window_s=seconds + 1.0)
    prof._own_ident = threading.get_ident()
    deadline = time.monotonic() + max(0.05, seconds)
    while time.monotonic() < deadline:
        prof.sample_once()
        time.sleep(interval)
    return prof


def active() -> Optional[SamplingProfiler]:
    return _active


def dump_file(path: Optional[str] = None) -> Optional[str]:
    """Write the active profiler's continuous ring to ``path`` (default
    $TPUC_PROFILE_FILE). Called by the lifecycle crash hooks so a failed
    soak leaves its profile history next to the flight/trace black boxes.
    Never raises."""
    path = path or os.environ.get("TPUC_PROFILE_FILE")
    prof = _active
    if not path or prof is None:
        return None
    try:
        with open(path, "w") as f:
            json.dump(
                {"interval_s": prof.interval, "windows": prof.windows(),
                 "summary": prof.thread_summary()},
                f, indent=1,
            )
    except (OSError, ValueError):
        return None
    return path
