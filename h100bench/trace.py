"""Spans and the device trace of a traced run.

The benchmark marks its own calls into the program with
``torch.profiler.record_function`` spans (``bench.window`` around the
traced part of the window, one span per engine step inside it).
:class:`Tracer` runs ``torch.profiler`` over that part and reduces the
trace in memory to a :class:`TraceSummary`:

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, inside ``bench.window``; ``window_s`` that
  span's length;
- ``kernels``: device seconds by kernel name (the name up to its argument
  list), for the readers of kernel rooflines;
- ``gaps``: the device's idle time inside the window by what the host was
  doing at the middle of each gap: the step span and the outermost
  PyTorch operator running on the main thread then (``span>op``), or the
  span alone between operators.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "bench.window"


def kernel_name(name: str) -> str:
    """A kernel's name without its argument list and return type:
    ``void (anonymous namespace)::k<float>(float*, int)`` is
    ``(anonymous namespace)::k<float>``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[5:] if name.startswith("void ") else name


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: Dict[str, float] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, parts: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds any of ``parts``."""
        parts = tuple(parts)
        return sum(s for k, s in self.kernels.items()
                   if any(p in k for p in parts))

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _outermost(intervals: List[Tuple[int, int, str]]
               ) -> List[Tuple[int, int, str]]:
    """The intervals no other one contains, in order (nested calls of one
    thread never overlap partly)."""
    out: List[Tuple[int, int, str]] = []
    for a, b, n in sorted(intervals, key=lambda t: (t[0], -t[1])):
        if out and b <= out[-1][1]:
            continue
        out.append((a, b, n))
    return out


def _at(intervals: List[Tuple[int, int, str]], starts: List[int],
        t: int) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals[i][0] <= t < intervals[i][1]:
        return intervals[i][2]
    return None


def summarize(window: Tuple[int, int], device: List[Tuple[int, int, str]],
              spans: List[Tuple[int, int, str]],
              ops: List[Tuple[int, int, str]]) -> TraceSummary:
    """The reduction itself, on plain (start_ns, end_ns, name) triples:
    ``device`` activity, the benchmark's step ``spans`` and the main
    thread's operators ``ops``."""
    w0, w1 = window
    kernels: Dict[str, float] = defaultdict(float)
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            kernels[kernel_name(name)] += (b - a) / 1e9
    busy = _merge(clipped)
    spans = _outermost(spans)
    ops = _outermost(ops)
    span_starts = [s[0] for s in spans]
    op_starts = [o[0] for o in ops]
    gaps: Dict[str, float] = defaultdict(float)
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            mid = (t + a) // 2
            span = _at(spans, span_starts, mid) or WINDOW
            op = _at(ops, op_starts, mid)
            gaps[f"{span}>{op}" if op else span] += (a - t) / 1e9
        t = max(t, b)
    return TraceSummary(busy_s=sum(b - a for a, b in busy) / 1e9,
                        window_s=(w1 - w0) / 1e9, kernels=dict(kernels),
                        gaps=dict(gaps))


class Tracer:
    """``start()`` opens the profiler and the ``bench.window`` span;
    ``stop()`` closes both after a device sync and keeps the summary.
    ``span(name)`` marks one step inside the window."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        if enabled:
            # One empty session in set-up loads torch.profiler and pays
            # the profiler's one-time start (CUPTI's, seconds on the card),
            # which would otherwise fall inside the window.
            with self._profile():
                if cuda:
                    torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
        self.active = False
        self._stack: Optional[ExitStack] = None
        self.summary: Optional[TraceSummary] = None
        self.span_names: set = set()

    def span(self, name: str):
        if self.active:
            self.span_names.add(name)
            return torch.profiler.record_function(name)
        return _NULL

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self) -> None:
        if not self.enabled:
            return
        self._stack = ExitStack()
        self._prof = self._stack.enter_context(self._profile())
        self._stack.enter_context(torch.profiler.record_function(WINDOW))
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._stack.close()
        self.active = False
        self.summary = self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None

    def _reduce(self, events) -> TraceSummary:
        cuda = torch.autograd.DeviceType.CUDA
        marks = self.span_names | {WINDOW}
        window, tid = None, None
        for e in events:
            if e.name() == WINDOW and e.device_type() != cuda:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
                tid = e.start_thread_id()
        if window is None:
            raise RuntimeError("the trace holds no bench.window span")
        device, spans, ops = [], [], []
        for e in events:
            name = e.name()
            iv = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
            if e.device_type() == cuda:
                # Device activity: kernels, copies, memsets; the spans'
                # own device annotations cover kernels and gaps alike.
                if name not in marks:
                    device.append(iv)
            elif e.start_thread_id() == tid and name != WINDOW:
                (spans if name in marks else ops).append(iv)
        return summarize(window, device, spans, ops)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
