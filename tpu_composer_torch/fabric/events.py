"""Fabric event plane — server-push completions over a persistent session
(port of ``tpu_composer/fabric/events.py``).

Why this subsystem exists: the dispatcher turned the fabric *write* path into submit-and-
return, but completion of a fabric-async op was still observed by re-polling
on a fixed ``poll_interval`` timer — a latency floor under every
attach-to-ready, and one wire call per pending op per quantum at fleet
scale. Dagger (arXiv:2106.01482) and RPCAcc (arXiv:2411.07632) both measure
RPC round-trip overhead dominating exactly this kind of control traffic.
The fix is the same one the store side got (a watch-fed informer): stop
asking, start listening.

A :class:`FabricSession` holds one persistent streaming subscription per
fabric endpoint — NDJSON-shaped long-poll batches over the existing
``JsonHttpClient`` for remote backends (``GET /v1/events?cursor=``), a
condition-variable tail for the in-proc pool — carrying sequence-numbered
:class:`FabricEvent` records:

- ``op_completed`` — an attach/detach the fabric finished server-side,
  keyed by the durable intent nonce (the ``status.pending_op`` record,
  which already rides every fabric mutation);
- ``health`` — a device health transition;
- ``inventory`` — devices entering/leaving the fabric listing.

Delivery discipline:

- events apply in sequence order; an event at or below the resume cursor is
  a duplicate and is dropped (counted ``stale``) — chaos-duplicated or
  reordered streams cannot double-apply;
- a sequence GAP (next seq > cursor+1: lossy stream, server buffer rotated
  past our resume cursor after a long disconnect) is never silently
  absorbed: the gap handlers run once per gap — the dispatcher's handler
  performs ONE ``get_resources()`` resync and wakes every fabric-pending op
  for an immediate re-poll, so a lost completion costs one listing, not a
  silent wait;
- on any transport error the session reconnects under decorrelated backoff,
  resuming from the cursor; a provider without an event stream answers the
  first poll with :class:`~tpu_composer_torch.fabric.provider.UnsupportedEvents`
  and the session goes dormant for the process lifetime (the capability
  probe — polling remains the primary path, bit-identical to the
  pre-event-plane behavior).

The event is a DOORBELL, not a data carrier: consumers that act on it (the
dispatcher) re-read authoritative state through the idempotent provider
verbs rather than trusting the payload, so a chaos-mutated event can at
worst cause one redundant wire call. The poll timers stay wired as safety
nets — stretched to ``poll_interval * fallback_multiplier`` while the
session is streaming, snapped back on session loss — and anything they
catch that the stream should have delivered counts
``tpuc_fabric_poll_fallbacks_total`` (the "degraded to polling" signal).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from tpu_composer_torch.fabric.provider import FabricError, UnsupportedEvents
from tpu_composer_torch.runtime.metrics import (
    fabric_events_total,
    fabric_session_state,
)

# Event types.
EVENT_OP_COMPLETED = "op_completed"
EVENT_HEALTH = "health"
EVENT_INVENTORY = "inventory"

# Session states, exported via the tpuc_fabric_session_state gauge.
SESSION_DOWN = 0.0
SESSION_STREAMING = 1.0
SESSION_UNSUPPORTED = -1.0

#: ``poll_events`` cursor meaning "tail from now": the server returns no
#: backlog, only its current head sequence number — a fresh session must
#: not replay completions that predate it (their ops settled via polling).
CURSOR_TAIL = -1


@dataclass
class FabricEvent:
    """One sequence-numbered server-push record from the fabric.

    ``seq`` is per-endpoint monotonic; ``nonce`` (op_completed only) is the
    durable intent nonce the submitting controller wrote into
    ``status.pending_op`` — the key that ties one fabric completion to one
    logical op across crash/retry cycles."""

    seq: int = 0
    type: str = ""  # op_completed | health | inventory
    resource: str = ""  # ComposableResource name (op_completed)
    verb: str = ""  # add | remove (op_completed)
    nonce: str = ""  # durable intent nonce (op_completed)
    node: str = ""
    device_ids: List[str] = field(default_factory=list)
    outcome: str = ""  # ok | error (op_completed)
    error: str = ""
    state: str = ""  # DeviceHealth state (health)
    detail: str = ""

    def to_wire(self) -> dict:
        """Compact JSON form (empty fields omitted) for the /v1/events
        route — one dict per event in a long-poll batch."""
        out: dict = {"seq": self.seq, "type": self.type}
        for k in ("resource", "verb", "nonce", "node", "outcome", "error",
                  "state", "detail"):
            v = getattr(self, k)
            if v:
                out[k] = v
        if self.device_ids:
            out["device_ids"] = list(self.device_ids)
        return out

    @classmethod
    def from_wire(cls, d: dict) -> "FabricEvent":
        return cls(
            seq=int(d.get("seq", 0)),
            type=str(d.get("type", "")),
            resource=str(d.get("resource", "")),
            verb=str(d.get("verb", "")),
            nonce=str(d.get("nonce", "")),
            node=str(d.get("node", "")),
            device_ids=[str(x) for x in d.get("device_ids", [])],
            outcome=str(d.get("outcome", "")),
            error=str(d.get("error", "")),
            state=str(d.get("state", "")),
            detail=str(d.get("detail", "")),
        )


def doorbell_wait(stop_event: threading.Event, wake: threading.Event,
                  deadline: float, floor: float) -> None:
    """Park an event-paced reconcile loop until its next pass is due.

    Returns when ``stop_event`` is set, the unprompted ``deadline``
    passes, or ``wake`` is rung AND ``time.monotonic() >= floor``. The
    floor is the burst coalescer: a churny fabric fires one inventory
    event per attach/detach, and without it every doorbell-driven
    consumer (syncer relist, slice-repair pass) degenerates into a full
    listing PER EVENT — more wire ops than the timed poll it replaced.
    Callers set ``floor = last_pass + period`` so event-driven passes
    never run hotter than the base poll cadence, while a doorbell after
    a quiet stretch still fires immediately.
    """
    while not stop_event.is_set():
        now = time.monotonic()
        if now >= deadline:
            return
        if wake.is_set():
            if now >= floor:
                return
            # Wake already rung: waiting on the (set) event would spin,
            # so sleep out the remaining floor in stop-responsive chunks.
            time.sleep(min(floor - now, 0.25))
        else:
            wake.wait(min(deadline - now, 0.25))


class FabricSession:
    """One persistent event subscription against one fabric provider.

    Runs as a Manager runnable (``run(stop_event)``) or standalone via
    ``start()``/``stop()`` in tests and benches. Handlers registered with
    :meth:`on_event` / :meth:`on_gap` / :meth:`on_state` run on the session
    thread; they must be fast and never raise (raises are logged and
    swallowed so one bad consumer cannot kill the stream)."""

    def __init__(
        self,
        provider,
        poll_timeout: float = 5.0,
        retry_base: float = 0.05,
        retry_cap: float = 2.0,
        name: str = "fabric",
    ) -> None:
        self.provider = provider
        self.poll_timeout = poll_timeout
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.name = name
        self.log = logging.getLogger(f"FabricSession[{name}]")
        self._handlers: List[Callable[[FabricEvent], None]] = []
        self._gap_handlers: List[Callable[[], None]] = []
        self._state_handlers: List[Callable[[bool], None]] = []
        self._lock = threading.Lock()
        self._cursor = CURSOR_TAIL
        self._healthy = False
        self._supported = True  # until the capability probe says otherwise
        self._thread: Optional[threading.Thread] = None
        self._own_stop: Optional[threading.Event] = None
        # Introspection (tests / debug endpoints).
        self.events_seen = 0
        self.gaps = 0
        self.reconnects = 0
        fabric_session_state.set(SESSION_DOWN, endpoint=self.name)

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def on_event(self, handler: Callable[[FabricEvent], None]) -> None:
        self._handlers.append(handler)

    def on_gap(self, handler: Callable[[], None]) -> None:
        self._gap_handlers.append(handler)

    def on_state(self, handler: Callable[[bool], None]) -> None:
        """``handler(healthy)`` fires on every streaming<->down transition
        (never for the dormant unsupported state)."""
        self._state_handlers.append(handler)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def healthy(self) -> bool:
        """True while the stream is connected and delivering."""
        with self._lock:
            return self._healthy

    def supported(self) -> bool:
        """False once the provider answered the capability probe with
        UnsupportedEvents — the session is dormant and polling is the
        primary (not fallback) completion path."""
        with self._lock:
            return self._supported

    def cursor(self) -> int:
        with self._lock:
            return self._cursor

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Standalone start (tests/bench); Manager wiring uses run()."""
        if self._thread is not None:
            return
        self._own_stop = threading.Event()
        self._thread = threading.Thread(
            target=self.run, args=(self._own_stop,),
            name=f"fabric-events-{self.name}", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._own_stop is not None:
            self._own_stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        self._own_stop = None

    def run(self, stop_event: threading.Event) -> None:
        """Long-poll loop: resume cursor, reconnect backoff, capability
        probe. Exits when ``stop_event`` sets or the provider proves it has
        no event stream."""
        delay = self.retry_base
        while not stop_event.is_set():
            try:
                events, cursor = self.provider.poll_events(
                    self._cursor, timeout=self.poll_timeout
                )
            except UnsupportedEvents as e:
                self._go_dormant(str(e))
                return
            except FabricError as e:
                if self._set_healthy(False):
                    self.log.warning(
                        "event stream down (%s); reconnecting with resume"
                        " cursor %d", e, self._cursor,
                    )
                stop_event.wait(delay)
                delay = min(self.retry_cap, delay * 2)
                continue
            except Exception:
                self.log.exception("event poll failed unexpectedly")
                stop_event.wait(delay)
                delay = min(self.retry_cap, delay * 2)
                continue
            delay = self.retry_base
            if self._set_healthy(True):
                self.log.info(
                    "event stream connected (cursor %d)", self._cursor
                )
            self._apply(events, cursor)
        self._set_healthy(False)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _apply(self, events: List[FabricEvent], server_cursor: int) -> None:
        if self._cursor == CURSOR_TAIL:
            # Bootstrap: adopt the server head — no backlog replay. Ops
            # already in flight settle via the safety-net polls; events
            # from here on are gap-checked against this cursor.
            self._cursor = max(0, server_cursor)
            if not events:
                return
        # In-order application: a batch may arrive shuffled (chaos, or a
        # fan-in server); sorting makes within-batch reordering free and
        # leaves only cross-batch reorder to the stale/gap machinery.
        gapped = 0
        for ev in sorted(events, key=lambda e: e.seq):
            if ev.seq <= self._cursor:
                fabric_events_total.inc(type="stale")
                continue
            if ev.seq > self._cursor + 1:
                # Lossy stream / rotated buffer: never silently skip.
                self.gaps += 1
                gapped += 1
                fabric_events_total.inc(type="gap")
                self.log.warning(
                    "event gap: cursor %d -> seq %d; resync after batch",
                    self._cursor, ev.seq,
                )
            self._cursor = ev.seq
            self.events_seen += 1
            fabric_events_total.inc(type=ev.type or "unknown")
            for h in self._handlers:
                try:
                    h(ev)
                except Exception:
                    self.log.exception("event handler failed")
        if gapped:
            # ONE resync per delivery, however many interior gaps the
            # batch carried: the gap handlers do a full listing + wake-all,
            # so firing per-gap would run N slow synchronous listings on
            # the session thread (stalling the long-poll loop) for the
            # same correctness one buys.
            self._fire_gap()

    def _fire_gap(self) -> None:
        for h in self._gap_handlers:
            try:
                h()
            except Exception:
                self.log.exception("gap handler failed")

    def _set_healthy(self, healthy: bool) -> bool:
        """Returns True when this call transitioned the state."""
        with self._lock:
            if self._healthy == healthy:
                return False
            self._healthy = healthy
            if healthy:
                self.reconnects += 1
        fabric_session_state.set(
            SESSION_STREAMING if healthy else SESSION_DOWN,
            endpoint=self.name,
        )
        for h in self._state_handlers:
            try:
                h(healthy)
            except Exception:
                self.log.exception("state handler failed")
        return True

    def _go_dormant(self, reason: str) -> None:
        with self._lock:
            was_healthy = self._healthy
            self._supported = False
            self._healthy = False
        fabric_session_state.set(SESSION_UNSUPPORTED, endpoint=self.name)
        if was_healthy:
            # A provider that turns unsupported MID-LIFE (rollback,
            # misrouted LB) is a loss of the streaming channel like any
            # other: the state handlers must run so consumers snap their
            # stretched safety-net polls back to the tight quantum —
            # nobody will ring the doorbell again.
            for h in self._state_handlers:
                try:
                    h(False)
                except Exception:
                    self.log.exception("state handler failed")
        self.log.info(
            "provider has no event stream (%s); session dormant, polling"
            " stays primary", reason,
        )
