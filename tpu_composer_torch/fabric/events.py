"""Fabric event plane: the sequence-numbered events a fabric provider
emits (port of ``tpu_composer/fabric/events.py``, without
``FabricSession``).

A provider's event stream carries :class:`FabricEvent` records:

- ``op_completed`` — an attach/detach the fabric finished server-side,
  keyed by the durable intent nonce (``status.pending_op``, which rides
  every fabric mutation);
- ``health`` — a device health transition;
- ``inventory`` — devices entering/leaving the fabric listing.

The in-memory pool (``fabric/inmem.py``) emits them into a bounded ring
that ``poll_events`` long-polls, and the device publisher's doorbell loop
wakes on them. The event is a DOORBELL, not a data carrier: consumers
re-read authoritative state through the idempotent provider verbs rather
than trusting the payload. The persistent subscription that resumes from
a cursor across reconnects (``FabricSession``) arrives with the remote
fabric backends.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List

# Event types.
EVENT_OP_COMPLETED = "op_completed"
EVENT_HEALTH = "health"
EVENT_INVENTORY = "inventory"

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
