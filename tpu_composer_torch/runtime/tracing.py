"""Causal tracing for the control plane — spans over reconciles, fabric
calls and agent actuation, connected across threads by explicit
``TraceContext`` propagation, exported as Chrome trace-event JSON.

The reference has NO tracing at all (SURVEY.md §5: no pprof, no otel — its
only observability is logs plus default metrics), which makes attach-path
latency regressions archaeology. The original subsystem here recorded
thread-local spans only; the moment an attach crossed a thread boundary
(queue -> reconcile worker -> dispatcher lane -> completion latch ->
requeue, or a restart + adoption pass) causality was lost. This version
makes the causality explicit:

- ``span(name, **attrs)``: context manager recording wall-time begin/end
  with attributes; spans nest via a thread-local stack, so a reconcile's
  fabric call shows up as a child of the reconcile span.
- ``TraceContext``: a (trace_id, flow) pair handed across thread
  boundaries. ``ctx.handoff()`` emits a Chrome *flow-start* event bound to
  the current span; opening a span with ``ctx=...`` (or calling
  ``link(ctx)`` inside one) emits the matching *flow-finish* — Perfetto
  draws an arrow from the producing span to the consuming one, across
  threads. The trace_id for a fabric op IS the durable
  ``status.pending_op`` nonce, so one attach renders as one connected
  trace even across a process crash + adoption (the kill–restart soak
  asserts this).
- A bounded in-memory ring (default 10k entries, an entry one event or
  one pre-timed :func:`record` call — old traffic falls off rather than
  growing the heap) shared process-wide.
- ``export_chrome()``: the whole ring as Chrome trace-event JSON ("cat"
  = component, thread = worker) — load it in chrome://tracing or Perfetto.
- The manager's health server exposes ``/debug/traces`` (same port as
  healthz; read-only, no secrets — attribute values are names/counts),
  with ``?cat=`` / ``?limit=`` filtering and a response-size cap.
- ``TPUC_TRACE_FILE``: write the ring to a file at manager stop — and,
  via the crash hooks runtime/lifecycle.py installs, at interpreter exit
  and on unhandled thread exceptions, so a wedged or killed-by-exception
  process still leaves a trace behind.
- ``TPUC_TRACE=0`` (or ``set_enabled(False)``): hard-disable recording —
  ``span`` degrades to a no-op yield; the perf-smoke gate asserts the
  enabled path stays within 5% of this on the 32-chip wave.

The serving engine (``models/serving.py``) records one span tree per
step through the same ring, category ``serving``:

- ``Tree`` / ``open_tree``: spans the owner times itself with
  ``perf_counter_ns`` and hands over in ONE :func:`record` call when the
  tree closes (one lock and one ring entry per tree, no generator or
  event dict per span: :func:`snapshot` builds the events), so a hot
  loop pays a clock read per phase boundary. Disabled, ``open_tree``
  returns None and the caller's only cost is the branch on it.
- ``host_sync(what, fn, *args)``: runs an operation that blocks the host
  on the device stream (a device-to-host read, an upload of host memory)
  and, inside an open tree, records it as a ``<cat>.sync`` leaf with
  ``what`` and counts it in the root's ``syncs``.
- ``current_tree()``: the thread's open tree, for code below the owner
  that adds spans of its own (``models/moe.py``'s ``moe.*``);
  ``suspended()`` hides it for a block (a CUDA graph's capture).

The clock: ring timestamps are µs since this module was imported, on
``perf_counter``. One offset, read at import, maps them to Unix-epoch ns
(:func:`unix_ns`), the clock ``torch.profiler``'s device and host events
carry, so a ring export and a profiler export line up in Perfetto;
:func:`perf_ns` maps them back to ``perf_counter_ns``. ``chrome_doc``
carries the Unix ns of ts 0 as ``metadata.ts0_unix_ns``. The spans never
enter the profiler as ranges: a range would show on the device as an
annotation covering kernels and gaps alike.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
import zlib
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple,
)

_lock = threading.Lock()
# Events as dicts, and each record() call as the one tuple it keeps.
_events: Deque[Any] = deque(maxlen=10_000)
_tls = threading.local()
_clock = time.perf_counter_ns
_T0_NS = _clock()
_t0 = _T0_NS / 1e9
#: Unix-epoch ns minus perf_counter ns, read once: what :func:`unix_ns`
#: adds to put a ring timestamp on torch.profiler's clock.
_UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
# Monotonically-increasing ids shared by spans and flows so Perfetto can
# pair nested spans and flow arrows cheaply.
_next_id = 0
_enabled = os.environ.get("TPUC_TRACE", "1") != "0"
# Span-end sinks (the flight recorder subscribes): called OUTSIDE the ring
# lock with the finished event dict; exceptions are swallowed — a broken
# sink must never take down a reconcile.
_sinks: List[Callable[[Dict[str, Any]], None]] = []

#: Flow events all share one (name, cat) pair — Chrome/Perfetto match
#: flow-start to flow-finish on (name, cat, id), and the ids are unique.
_FLOW_NAME = "causal"
_FLOW_CAT = "flow"

#: Fleet identity for the Chrome trace "pid" column. Real OS replicas get
#: distinct os.getpid() values for free; the REPLICA tagging exists so (a)
#: merged multi-replica traces carry human process names, and (b) in-proc
#: replicas (bench harnesses, the shard-failover soak) render as distinct
#: Perfetto processes even though they share one interpreter. The module
#: default covers a whole process (cmd/main sets it once); bind_thread
#: overrides per thread for in-proc multi-replica harnesses.
_replica_default: Optional[Tuple[str, int]] = None
_pid_names: Dict[int, str] = {}


def replica_pid(identity: str) -> int:
    """Stable pseudo-pid for a replica identity (crc32, PYTHONHASHSEED-
    independent like shard_for): the same replica gets the same trace pid
    across restarts, so multi-incarnation merges line up."""
    return 100_000 + zlib.crc32(identity.encode("utf-8")) % 800_000


def set_replica(identity: Optional[str]) -> None:
    """Tag every event this PROCESS records with ``identity`` as its trace
    pid (None restores plain os.getpid()). cmd/main calls this when the
    fleet plane is on."""
    global _replica_default
    if identity is None:
        _replica_default = None
        return
    pid = replica_pid(identity)
    _pid_names[pid] = identity
    _replica_default = (identity, pid)


def bind_thread(identity: str) -> None:
    """Tag events recorded by THIS thread with ``identity``'s trace pid —
    the in-proc multi-replica hook: each replica's manager binds its
    controller workers, dispatcher lanes and runnables, so one shared ring
    still renders as N Perfetto processes."""
    pid = replica_pid(identity)
    _pid_names[pid] = identity
    _tls.replica = (identity, pid)


def current_replica() -> Optional[str]:
    """The identity whose pid this thread's events carry (thread binding
    first, then the process default), or None when untagged."""
    bound = getattr(_tls, "replica", None) or _replica_default
    return bound[0] if bound else None


def _pid() -> int:
    bound = _tls.__dict__.get("replica") or _replica_default
    return bound[1] if bound else _os_pid


def _new_os_pid() -> None:
    global _os_pid
    _os_pid = os.getpid()


# The process's pid, read once (and again in a forked child) rather than
# by a system call per span.
_new_os_pid()
os.register_at_fork(after_in_child=_new_os_pid)


def _now_us() -> float:
    return (time.perf_counter() - _t0) * 1e6


def perf_ns(ts: float) -> int:
    """A ring timestamp (``ts``, µs) on the ``perf_counter_ns`` clock."""
    return _T0_NS + round(ts * 1e3)


def unix_ns(ts: float) -> int:
    """A ring timestamp (``ts``, µs) in Unix-epoch ns, the clock of
    ``torch.profiler``'s events (kineto's ``start_ns``)."""
    return perf_ns(ts) + _UNIX_OFFSET_NS


def _new_id() -> int:
    global _next_id
    with _lock:
        _next_id += 1
        return _next_id


def _tid() -> int:
    return threading.get_ident() % 1_000_000


@dataclass
class TraceContext:
    """A causal handle crossing a thread (or process-restart) boundary.

    ``trace_id`` groups every span of one logical operation — for fabric
    ops it is the durable ``status.pending_op`` nonce, which is what makes
    the trace survive a crash + adoption. ``flow_id`` is a one-shot Chrome
    flow-arrow id emitted by :meth:`handoff` on the producing thread and
    consumed by the first ``span(ctx=...)`` / ``link`` on the consumer.
    """

    trace_id: str
    flow_id: Optional[int] = None
    _flow_consumed: bool = field(default=False, repr=False)

    def handoff(self) -> "TraceContext":
        """Mint a context to hand to another thread: emits a flow-start
        bound to the CURRENT thread's enclosing span and returns a fresh
        context (same trace_id, new one-shot flow id)."""
        if not _enabled:
            return TraceContext(self.trace_id)
        fid = _new_id()
        evt = {
            "name": _FLOW_NAME, "cat": _FLOW_CAT, "ph": "s", "id": fid,
            "ts": _now_us(), "pid": _pid(), "tid": _tid(),
            "args": {"trace_id": self.trace_id},
        }
        with _lock:
            _events.append(evt)
        return TraceContext(self.trace_id, flow_id=fid)


def new_trace(trace_id: Optional[str] = None) -> TraceContext:
    return TraceContext(trace_id or uuid.uuid4().hex[:12])


def context() -> Optional[TraceContext]:
    """The thread's active TraceContext (None outside any trace)."""
    return getattr(_tls, "ctx", None)


def _consume_flow(ctx: TraceContext, ts: Optional[float] = None) -> None:
    if ctx.flow_id is None or ctx._flow_consumed:
        return
    ctx._flow_consumed = True
    evt = {
        "name": _FLOW_NAME, "cat": _FLOW_CAT, "ph": "f", "bp": "e",
        "id": ctx.flow_id, "ts": ts if ts is not None else _now_us(),
        "pid": _pid(), "tid": _tid(),
        "args": {"trace_id": ctx.trace_id},
    }
    with _lock:
        _events.append(evt)


def link(ctx: Optional[TraceContext]) -> None:
    """Consume ``ctx``'s pending flow inside the current span — draws the
    arrow from the producing span into this one WITHOUT making ctx the
    thread's active context (how a batched group call links each member's
    submission into the one parent dispatch span)."""
    if ctx is None or not _enabled:
        return
    _consume_flow(ctx)


def adopt_trace(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Make ``ctx`` the thread's active context and back-fill its trace_id
    into every currently-open span (the reconcile span is already open when
    the resource controller discovers the CR's pending_op nonce). Returns
    the previous context; the enclosing ``span()`` restores it on exit.

    Outside any open span the context is NOT made active — there would be
    no restore point, so it would leak onto the thread and stamp every
    later unrelated span (bit tests calling reconcile() directly, without
    the controller loop's wrapping span)."""
    prev = getattr(_tls, "ctx", None)
    stack = getattr(_tls, "stack", None)
    if stack:
        _tls.ctx = ctx
    if ctx is not None and _enabled:
        for _, args in stack or ():
            args["trace_id"] = ctx.trace_id
        _consume_flow(ctx)
    return prev


def set_enabled(on: bool) -> None:
    """Hard on/off switch (TPUC_TRACE=0). Disabled: spans yield without
    recording, handoffs carry trace ids but emit nothing."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def configure(capacity: int) -> None:
    """Resize the ring (drops current contents). Safe during active spans:
    in-flight spans append into whichever ring is current at their end."""
    global _events
    with _lock:
        _events = deque(maxlen=capacity)


def reset() -> None:
    with _lock:
        _events.clear()


def add_span_sink(fn: Callable[[Dict[str, Any]], None]) -> None:
    if fn not in _sinks:
        _sinks.append(fn)


def remove_span_sink(fn: Callable[[Dict[str, Any]], None]) -> None:
    if fn in _sinks:
        _sinks.remove(fn)


@contextmanager
def span(
    name: str, cat: str = "operator", ctx: Optional[TraceContext] = None,
    **attrs: Any,
) -> Iterator[Dict[str, Any]]:
    """Record one complete span. Yields the attribute dict so callers can
    attach results discovered mid-span (e.g. outcome="requeued").

    ``ctx`` joins the span to a propagated trace: its trace_id lands in the
    span's args, its pending flow (if any) is consumed here — drawing the
    cross-thread arrow into this span — and it becomes the thread's active
    context for the span's duration, so child spans (and handoffs made
    inside) inherit the trace."""
    if not _enabled:
        yield dict(attrs)
        return
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    sid = _new_id()
    parent = _tls.stack[-1][0] if _tls.stack else None
    prev_ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        _tls.ctx = ctx
    active = getattr(_tls, "ctx", None)
    args: Dict[str, Any] = dict(attrs)
    if parent is not None:
        args["parent_span"] = parent
    if active is not None and active.trace_id:
        args["trace_id"] = active.trace_id
    _tls.stack.append((sid, args))
    begin = _now_us()
    if ctx is not None:
        _consume_flow(ctx, begin)
    try:
        yield args
    except BaseException as e:
        args["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _tls.stack.pop()
        _tls.ctx = prev_ctx
        end = _now_us()
        evt = {
            "name": name,
            "cat": cat,
            "ph": "X",  # complete event
            "ts": begin,
            "dur": end - begin,
            "pid": _pid(),
            "tid": _tid(),
            "id": sid,
            "args": {k: _safe(v) for k, v in args.items()},
        }
        with _lock:
            _events.append(evt)
        for sink in list(_sinks):
            try:
                sink(evt)
            except Exception:
                pass  # a sink bug must never surface into the traced code


#: One pre-timed span: (name, cat, start_ns, end_ns, parent, args), the
#: times on ``perf_counter_ns``, ``parent`` the index of an earlier span
#: of the same call or None, ``args`` JSON scalars by name.
Timed = Tuple[str, str, int, int, Optional[int], Dict[str, Any]]


def record(spans: Sequence[Timed]) -> Sequence[int]:
    """Append spans their caller has already timed and return their ids.
    One call is ONE entry of the ring, appended under one lock, which
    :func:`snapshot` expands into complete events, a span's ``parent``
    (an index into ``spans``) becoming ``args.parent_span``, the parent's
    id, as :func:`span` nests. So the caller pays neither a dict nor a
    lock per span, and the ring's bound counts calls, not their spans."""
    if not _enabled or not spans:
        return range(0)
    global _next_id
    pid, tid, spans = _pid(), _tid(), tuple(spans)
    with _lock:
        base = _next_id + 1
        _next_id += len(spans)
        entry = (base, pid, tid, spans)
        _events.append(entry)
    if _sinks:
        for sink in list(_sinks):
            for evt in _expand(entry):
                try:
                    sink(evt)
                except Exception:
                    pass  # a sink bug must never surface into the traced code
    return range(base, base + len(spans))


def _expand(entry: tuple) -> List[Dict[str, Any]]:
    """The complete ("X") events of one :func:`record` call."""
    base, pid, tid, spans = entry
    out = []
    for i, (name, cat, start, end, parent, args) in enumerate(spans):
        args = dict(args)
        if parent is not None:
            args["parent_span"] = base + parent
        out.append({"name": name, "cat": cat, "ph": "X",
                    "ts": (start - _T0_NS) / 1e3, "dur": (end - start) / 1e3,
                    "pid": pid, "tid": tid, "id": base + i, "args": args})
    return out


class Tree:
    """One span tree its owner times with ``perf_counter_ns``: a root
    opened with the tree, children opened and closed with
    :meth:`begin`/:meth:`end` (each nested in the innermost open one),
    and ``<cat>.sync`` leaves added by :func:`host_sync` while the tree
    is the thread's. :meth:`close` ends whatever is still open, stores
    the count of syncs in the root's ``syncs`` and hands the whole tree
    to :func:`record` at once."""

    __slots__ = ("cat", "sync_name", "spans", "open", "syncs", "_prev")

    def __init__(self, name: str, cat: str, **args: Any):
        self.cat = cat
        self.sync_name = cat + ".sync"
        self.spans: List[list] = [[name, cat, _clock(), 0, None, args]]
        self.open = [0]
        self.syncs = 0
        self._prev: Optional["Tree"] = None

    def begin(self, name: str, **args: Any) -> None:
        spans = self.spans
        self.open.append(len(spans))
        spans.append([name, self.cat, _clock(), 0, self.open[-2], args])

    def note(self, **args: Any) -> None:
        """Add ``args`` to the innermost open span's, for what is known
        only once its work has been issued."""
        self.spans[self.open[-1]][5].update(args)

    def end(self) -> None:
        self.spans[self.open.pop()][3] = _clock()

    def close(self, **args: Any) -> Sequence[int]:
        now = _clock()
        while self.open:
            self.spans[self.open.pop()][3] = now
        self.spans[0][5].update(args, syncs=self.syncs)
        if _trees.tree is self:
            _trees.tree = self._prev
        return record(self.spans)


class _Trees(threading.local):
    tree: Optional[Tree] = None


_trees = _Trees()


def open_tree(name: str, cat: str, **args: Any) -> Optional[Tree]:
    """A :class:`Tree` rooted at ``name`` and made the thread's, so
    :func:`host_sync` calls under it land in it; None while recording is
    off."""
    if not _enabled:
        return None
    tree = Tree(name, cat, **args)
    tree._prev = _trees.tree
    _trees.tree = tree
    return tree


def current_tree() -> Optional[Tree]:
    """The thread's open :class:`Tree`, None where there is none."""
    return _trees.tree


@contextmanager
def suspended() -> Iterator[None]:
    """No tree is the thread's inside the block."""
    prev, _trees.tree = _trees.tree, None
    try:
        yield
    finally:
        _trees.tree = prev


def host_sync(what: str, fn: Callable[..., Any], *args: Any,
              count: int = 1) -> Any:
    """``fn(*args)``, an operation that blocks the host until the device
    stream drains (``count`` of them back to back), timed and counted
    under ``what`` in the thread's open :class:`Tree`, if any."""
    tree = _trees.tree
    if tree is None:
        return fn(*args)
    start = _clock()
    out = fn(*args)
    tree.spans.append((tree.sync_name, tree.cat, start, _clock(),
                       tree.open[-1], {"what": what} if count == 1
                       else {"what": what, "count": count}))
    tree.syncs += count
    return out


def _safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def snapshot(
    cat: Optional[str] = None, limit: Optional[int] = None
) -> List[Dict[str, Any]]:
    """The ring's events, oldest first; ``cat`` filters by category and
    ``limit`` keeps only the NEWEST n (what /debug/traces paginates on)."""
    with _lock:
        events = list(_events)
    events = [x for e in events
              for x in ((e,) if type(e) is dict else _expand(e))]
    if cat:
        events = [e for e in events if e.get("cat") == cat]
    if limit is not None and limit >= 0:
        # NB: events[-0:] would be the FULL list — limit=0 means none.
        events = events[-limit:] if limit else []
    return events


def _process_name_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Chrome metadata events naming each known replica pid present in
    ``events`` — Perfetto's process rail shows the identity, not a number."""
    pids = {e.get("pid") for e in events}
    return [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": name}}
        for pid, name in sorted(_pid_names.items())
        if pid in pids
    ]


def chrome_doc(events: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The Chrome JSON-Object trace document for ``events`` (default: the
    ring), carrying the two merge anchors the ring events themselves lack:
    ``process_name`` metadata events for every replica-tagged pid, and a
    top-level ``metadata.epoch_us`` (the wall-clock instant of ts=0) so
    :func:`merge_chrome` can align files from processes whose monotonic
    trace clocks started at different moments. Every trace exit path —
    file dumps, /debug/traces scrapes, pre-kill snapshots — must ship this
    shape or its events merge unlabeled and unaligned. ``metadata.
    ts0_unix_ns`` is ts=0 in Unix-epoch ns from the offset read at import
    (:func:`unix_ns`): shift the events by it to lay them over a
    ``torch.profiler`` trace of the same process."""
    if events is None:
        events = snapshot()
    epoch_us = time.time() * 1e6 - _now_us()
    return {
        "traceEvents": _process_name_events(events) + events,
        "displayTimeUnit": "ms",
        "metadata": {"epoch_us": epoch_us,
                     "ts0_unix_ns": _T0_NS + _UNIX_OFFSET_NS},
    }


def export_chrome(events: Optional[List[Dict[str, Any]]] = None) -> str:
    """Chrome trace-event format (the JSON Object flavor) — open in
    chrome://tracing or https://ui.perfetto.dev. Flow events ("ph": s/f)
    render as arrows connecting spans across threads."""
    return json.dumps(chrome_doc(events))


def write_file(path: Optional[str] = None) -> Optional[str]:
    """Dump the ring to ``path`` (default $TPUC_TRACE_FILE); returns the
    path written or None when tracing-to-file is not configured. Called at
    clean manager stop, on drain-timeout, and by the lifecycle crash hooks
    (atexit / unhandled thread exception)."""
    path = path or os.environ.get("TPUC_TRACE_FILE")
    if not path:
        return None
    with open(path, "w") as f:
        f.write(export_chrome())
    return path


def summarize(cat: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """Per-span-name count/total/max durations (ms) — the quick look that
    answers 'where did the attach time go' without leaving the terminal."""
    out: Dict[str, Dict[str, float]] = {}
    for e in snapshot():
        if e.get("ph") != "X":
            continue  # flow events carry no duration
        if cat and e["cat"] != cat:
            continue
        s = out.setdefault(e["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = e["dur"] / 1e3
        s["count"] += 1
        s["total_ms"] += dur_ms
        s["max_ms"] = max(s["max_ms"], dur_ms)
    return out


def trace_events(trace_id: str) -> List[Dict[str, Any]]:
    """Every ring event belonging to one trace (spans + flow arrows)."""
    return [
        e for e in snapshot()
        if e.get("args", {}).get("trace_id") == trace_id
    ]


# ----------------------------------------------------------------------
# cross-process trace merging (the fleet observatory's stitch pass)
# ----------------------------------------------------------------------
def merge_chrome(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-replica Chrome trace documents into ONE stitched trace.

    Three passes make a kill -9 failover render as a single connected
    Perfetto story instead of N unrelated fragments:

    1. **Clock alignment.** Each document's ``metadata.epoch_us`` (the
       wall instant of its ts=0) shifts its events onto one shared
       timeline — two processes' monotonic trace clocks start at
       different moments, and unshifted spans would interleave nonsense.
       Documents without the anchor (pre-fleet exports) merge unshifted.
    2. **Pid disambiguation.** Documents whose events collide on a pid
       (two unrelated hosts can reuse an OS pid) get the later file's
       colliding pids remapped to a free range; replica-tagged pseudo-pids
       (:func:`replica_pid`) are already collision-managed and keep their
       values, so process_name metadata stays attached.
    3. **Flow stitching.** Span events sharing one ``args.trace_id`` (the
       durable intent nonce) across DIFFERENT pids get synthetic flow
       start/finish pairs connecting each cross-pid neighbor in time order
       — the arrow from replica A's pre-crash attach span to replica B's
       post-crash adopt span that no single process could have emitted.
       Stitched flows carry ``args.stitched = true`` so a reader can tell
       reconstructed causality from recorded causality.
    """
    for doc in docs:
        if not isinstance(doc, dict):
            raise ValueError(
                "trace document is not a JSON object — only the Chrome"
                " JSON-Object flavor ({'traceEvents': [...]}) merges"
            )
    merged: List[Dict[str, Any]] = []
    epochs = [
        float((d.get("metadata") or {}).get("epoch_us") or 0.0) for d in docs
    ]
    known = [e for e in epochs if e > 0]
    base = min(known) if known else 0.0
    used_pids: set = set()
    # pid -> process_name already merged under that pid. A colliding pid
    # is kept only when both files NAME it identically (two incarnations
    # of one replica — replica_pid is stable across restarts exactly so
    # their files line up); unnamed or differently-named collisions are
    # remapped. Read from the DOCUMENTS' own metadata, never from this
    # process's registry — the trace-merge CLI runs in a process that
    # recorded nothing.
    pid_owner: Dict[int, str] = {}
    used_ids: set = set()
    max_id = 0
    for doc, epoch in zip(docs, epochs):
        events = [dict(e) for e in doc.get("traceEvents", [])]
        shift = (epoch - base) if epoch > 0 else 0.0
        doc_pids = {e.get("pid") for e in events if "pid" in e}
        doc_names = {
            e["pid"]: e["args"]["name"]
            for e in events
            if e.get("name") == "process_name"
            and isinstance(e.get("args"), dict) and "name" in e["args"]
        }
        remap: Dict[int, int] = {}
        for pid in sorted(p for p in doc_pids if isinstance(p, int)):
            if pid not in used_pids:
                continue
            name = doc_names.get(pid, "")
            if name and pid_owner.get(pid) == name:
                continue  # same replica identity — same Perfetto process
            new = pid
            while new in used_pids:
                new += 1_000_000
            remap[pid] = new
        # Event ids restart at 0 in every process, so every file reuses
        # flow ids 1..N under the one (cat, name) flow key — colliding
        # ids from a later file must be remapped or Perfetto binds
        # causally unrelated flows across replicas. One mapping per file
        # keeps its own s/f pairs intact; replacement ids dodge both the
        # already-merged ids and this file's own (a replacement equal to
        # a later id in the same file would be a fresh collision).
        doc_ids = {
            e["id"] for e in events if isinstance(e.get("id"), int)
        }
        id_remap: Dict[int, int] = {}
        for e in events:
            if shift and "ts" in e:
                e["ts"] = e["ts"] + shift
            if e.get("pid") in remap:
                e["pid"] = remap[e["pid"]]
            eid = e.get("id")
            if isinstance(eid, int):
                if eid in id_remap:
                    e["id"] = id_remap[eid]
                elif eid in used_ids:
                    max_id += 1
                    while max_id in used_ids or max_id in doc_ids:
                        max_id += 1
                    id_remap[eid] = max_id
                    e["id"] = max_id
                max_id = max(max_id, e["id"])
        used_ids.update(
            e["id"] for e in events if isinstance(e.get("id"), int)
        )
        used_pids.update(e.get("pid") for e in events if "pid" in e)
        for pid, name in doc_names.items():
            pid_owner.setdefault(remap.get(pid, pid), name)
        merged.extend(events)

    # Stitch: one synthetic flow per cross-pid neighbor pair per trace id.
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for e in merged:
        if e.get("ph") != "X":
            continue
        tid = (e.get("args") or {}).get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(e)
    stitches: List[Dict[str, Any]] = []
    next_id = max_id + 1
    for trace_id, spans in by_trace.items():
        if len({s["pid"] for s in spans}) < 2:
            continue
        spans.sort(key=lambda s: s.get("ts", 0.0))
        for a, b in zip(spans, spans[1:]):
            if a["pid"] == b["pid"]:
                continue
            args = {"trace_id": trace_id, "stitched": True}
            stitches.append({
                "name": _FLOW_NAME, "cat": _FLOW_CAT, "ph": "s",
                "id": next_id, "ts": a["ts"] + a.get("dur", 0.0),
                "pid": a["pid"], "tid": a.get("tid", 0), "args": dict(args),
            })
            stitches.append({
                "name": _FLOW_NAME, "cat": _FLOW_CAT, "ph": "f", "bp": "e",
                "id": next_id, "ts": b["ts"],
                "pid": b["pid"], "tid": b.get("tid", 0), "args": dict(args),
            })
            next_id += 1
    merged.extend(stitches)
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "epoch_us": base,
            "merged_files": len(docs),
            "stitched_flows": len(stitches) // 2,
        },
    }


def merge_files(paths: List[str]) -> Dict[str, Any]:
    """Load per-replica trace files (``write_file`` / crash-hook output)
    and return the stitched merge — the ``tpu-composer trace-merge``
    subcommand's engine."""
    docs = []
    for path in paths:
        with open(path) as f:
            docs.append(json.load(f))
    return merge_chrome(docs)
