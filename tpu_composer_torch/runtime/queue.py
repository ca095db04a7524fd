"""Rate-limited, deduplicating work queue.

Reference analog: k8s.io/client-go/util/workqueue as used implicitly by every
controller-runtime reconciler in the reference's internal/controller. Contract:

- ``add(key)`` enqueues; a key already queued or being processed is not
  double-queued (dedup) but a key re-added while in-flight is re-queued when
  ``done`` is called (the "dirty" set);
- ``add_after(key, delay)`` schedules a delayed requeue (the reference's
  ``RequeueAfter: 30s`` results);
- ``add_rate_limited(key)`` applies per-key exponential backoff with
  decorrelated jitter (failures) — deterministic 2^n backoff made every key
  that failed during a fabric blackout requeue in the same instant when it
  healed (thundering herd into the just-recovered endpoint); jitter spreads
  the recovery wave while keeping the same expected growth. Jitter alone is
  not enough when an OUTAGE aligns the expiries: backoff entries that all
  came due during a blackout used to mass-promote in one ``_promote_ready``
  pass on heal, so promotion now re-spreads any such stale herd past
  ``herd_threshold`` over one ``herd_spread`` quantum;
- ``forget(key)`` resets the backoff (successful reconcile) AND lazily
  invalidates the key's pending backoff entries: a key that succeeded must
  not be woken again by a stale pre-success failure requeue. Plain
  ``add_after`` entries (periodic polls) are never invalidated — they are
  liveness, not backoff.

Causal tracing rides the queue: ``add`` called from inside a traced span
(a dispatcher completion latch, a reconcile that just submitted a fabric
op) captures a ``TraceContext`` handoff for the key — emitting the Chrome
flow-start on the producing thread — and the worker that dequeues the key
consumes it via ``pop_context``, so the next reconcile span joins the same
trace with a cross-thread flow arrow. Deduped re-adds keep the NEWEST
context (latest causality wins).

The ready queue is a ``collections.deque``: under deep queues (an attach
wave fanning hundreds of keys out) the old ``list.pop(0)`` made every get
O(n) — O(n^2) to drain the wave.
"""

from __future__ import annotations

import collections
import heapq
import random
import threading
import time
from typing import Deque, Dict, Hashable, List, Optional, Tuple

from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import queue_wait_seconds


class RateLimitingQueue:
    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 16.0,
        jitter: Optional[random.Random] = None,
        name: str = "queue",
        herd_threshold: int = 8,
        herd_spread: float = 1.0,
        herd_stale: float = 0.25,
    ) -> None:
        self._base_delay = base_delay
        self._max_delay = max_delay
        self._rng = jitter or random.Random()
        # Post-outage herd pacing (see _promote_ready): one promotion pass
        # finding more than herd_threshold backoff entries that ALL went
        # stale (ready more than herd_stale ago — the signature of backoffs
        # expiring during a blackout while the workers were wedged on the
        # dead store) promotes the first herd_threshold and re-spreads the
        # rest over U(0, herd_spread) so heal does not release the whole
        # herd in one instant. herd_spread <= 0 disables the pacing.
        self._herd_threshold = max(1, herd_threshold)
        self._herd_spread = herd_spread
        self._herd_stale = herd_stale
        #: Label for tpuc_queue_wait_seconds{queue}: controllers pass
        #: their name so saturation is attributable per queue.
        self.name = name
        # key -> last jittered delay (decorrelated jitter state)
        self._last_delay: Dict[Hashable, float] = {}
        self._cond = threading.Condition()
        self._queue: Deque[Hashable] = collections.deque()
        self._queued: set = set()
        self._processing: set = set()
        self._dirty: set = set()
        self._failures: Dict[Hashable, int] = {}
        # min-heap of (ready_time, seq, key, backoff_gen); backoff_gen is
        # None for plain add_after entries and the key's backoff generation
        # at push time for add_rate_limited entries — forget() bumps the
        # generation so stale backoff entries evaporate at promotion
        # instead of spuriously re-waking a key that already succeeded.
        self._delayed: List[Tuple[float, int, Hashable, Optional[int]]] = []
        self._backoff_gen: Dict[Hashable, int] = {}
        self._backoff_pending: Dict[Hashable, int] = {}  # outstanding entries
        # key -> TraceContext handed off by the most recent add() made from
        # inside a traced span; claimed at dequeue (get() moves it to
        # _claimed_ctx under the same lock hold) and consumed by the
        # worker's pop_context. Bounded by queued+dirty+processing counts.
        self._trace_ctx: Dict[Hashable, tracing.TraceContext] = {}
        self._claimed_ctx: Dict[Hashable, tracing.TraceContext] = {}
        # key -> monotonic time it became READY (enqueued, or promoted
        # from the delayed heap): the tpuc_queue_wait_seconds source.
        # Delayed entries are deliberately not timed from add_after — the
        # wait that signals saturation is ready-to-run sitting unclaimed,
        # not an intentional backoff/poll delay.
        self._enqueued_at: Dict[Hashable, float] = {}
        self._seq = 0
        self._shutdown = False

    # ------------------------------------------------------------------
    def add(
        self, key: Hashable, ctx: Optional[tracing.TraceContext] = None
    ) -> None:
        with self._cond:
            if self._shutdown:
                # No handoff either: a flow-start with no consumer would
                # leave a dangling arrow in the exported trace.
                return
            if ctx is None:
                active = tracing.context()
                if active is not None:
                    # Capture the causal edge NOW, on the producing thread
                    # — the flow-start must bind to the span doing the add.
                    # (tracing's ring lock nests inside this queue's lock;
                    # tracing never calls back into the queue.)
                    ctx = active.handoff()
            if ctx is not None:
                old = self._trace_ctx.get(key)
                if old is not None:
                    # Newest causality wins; close the superseded
                    # handoff's arrow into this producing span so no
                    # flow-start dangles unmatched in the export.
                    tracing.link(old)
                self._trace_ctx[key] = ctx
            if key in self._processing:
                self._dirty.add(key)
                return
            if key not in self._queued:
                self._queued.add(key)
                self._queue.append(key)
                self._enqueued_at.setdefault(key, time.monotonic())
                self._cond.notify()

    def pop_context(self, key: Hashable) -> Optional[tracing.TraceContext]:
        """Consume the propagated trace context for a just-dequeued key.
        Returns only the context CLAIMED by this key's dequeue (get() moves
        it out of the parked map under the same lock hold), so a context
        parked by a concurrent add() after the dequeue is preserved for
        the requeued reconcile it belongs to."""
        with self._cond:
            return self._claimed_ctx.pop(key, None)

    def add_after(self, key: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(key)
            return
        with self._cond:
            if self._shutdown:
                return
            self._push_delayed(key, delay, None)

    def add_rate_limited(self, key: Hashable) -> None:
        with self._cond:
            if self._shutdown:
                return
            self._failures[key] = self._failures.get(key, 0) + 1
            # Decorrelated jitter (the AWS formula): next ∈ U(base, 3·prev),
            # capped. Expected growth ≈ 1.5x/attempt — same shape as the old
            # 2^n curve, but two keys failing in lockstep drift apart
            # instead of hammering the store/fabric on synchronized beats.
            prev = self._last_delay.get(key, self._base_delay)
            delay = min(
                self._max_delay, self._rng.uniform(self._base_delay, prev * 3)
            )
            self._last_delay[key] = delay
            self._backoff_pending[key] = self._backoff_pending.get(key, 0) + 1
            self._push_delayed(key, delay, self._backoff_gen.get(key, 0))

    def _push_delayed(
        self, key: Hashable, delay: float, gen: Optional[int]
    ) -> None:
        # caller holds the lock
        self._seq += 1
        heapq.heappush(
            self._delayed, (time.monotonic() + delay, self._seq, key, gen)
        )
        self._cond.notify()

    def forget(self, key: Hashable) -> None:
        # NOTE: deliberately leaves _trace_ctx alone. forget() runs on the
        # success path while the key is still marked processing — its own
        # context was already consumed by pop_context at dequeue, so any
        # context present NOW was parked by a concurrent add() (a dispatcher
        # completion latch firing mid-reconcile, which also set the dirty
        # bit) and belongs to the upcoming requeued reconcile. Popping it
        # here would sever the completion -> requeue flow arrow.
        with self._cond:
            self._failures.pop(key, None)
            self._last_delay.pop(key, None)
            if self._backoff_pending.get(key):
                # Outstanding backoff entries become stale: bump the
                # generation so _promote_ready drops them on arrival. The
                # per-key state is pruned when the last stale entry drains
                # (bounded by the backoff cap), so churning keys don't
                # accrete bookkeeping.
                self._backoff_gen[key] = self._backoff_gen.get(key, 0) + 1

    def retries(self, key: Hashable) -> int:
        with self._cond:
            return self._failures.get(key, 0)

    # ------------------------------------------------------------------
    def _promote_ready(self, now: float) -> None:
        # caller holds the lock
        stale_promoted = 0
        while self._delayed and self._delayed[0][0] <= now:
            ready_t, _, key, gen = heapq.heappop(self._delayed)
            if (
                gen is not None
                and self._herd_spread > 0
                and now - ready_t > self._herd_stale
            ):
                # Backoff entry that expired a while ago — the workers
                # were not draining when it came due (store blackout, a
                # long stall). If a whole herd of them arrives in THIS
                # pass, promote only the first herd_threshold and
                # re-spread the rest with fresh jittered ready times:
                # per-key decorrelated jitter spreads failures in time,
                # but a blackout ALIGNS the expiries and heal would
                # otherwise release them all in the same instant.
                stale_promoted += 1
                if stale_promoted > self._herd_threshold:
                    self._seq += 1
                    heapq.heappush(self._delayed, (
                        now + self._rng.uniform(0.0, self._herd_spread),
                        self._seq, key, gen,
                    ))
                    continue
            if gen is not None:
                current = self._backoff_gen.get(key, 0)
                left = self._backoff_pending.get(key, 1) - 1
                if left > 0:
                    self._backoff_pending[key] = left
                else:
                    # Last outstanding entry drained — prune the per-key
                    # bookkeeping (next backoff starts back at gen 0).
                    self._backoff_pending.pop(key, None)
                    self._backoff_gen.pop(key, None)
                if gen != current:
                    continue  # forgotten since scheduling — stale backoff
            if key in self._processing:
                self._dirty.add(key)
            elif key not in self._queued:
                self._queued.add(key)
                self._queue.append(key)
                self._enqueued_at.setdefault(key, now)

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Block until a key is ready (or timeout/shutdown → None)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                self._promote_ready(now)
                if self._queue:
                    key = self._queue.popleft()
                    self._queued.discard(key)
                    self._processing.add(key)
                    enq = self._enqueued_at.pop(key, None)
                    if enq is not None:
                        queue_wait_seconds.observe(
                            max(0.0, now - enq), queue=self.name
                        )
                    # Claim the key's parked context ATOMICALLY with the
                    # dequeue: an add() landing after this point (e.g. a
                    # completion latch) parks a context for the NEXT
                    # reconcile — pop_context must never hand it to the
                    # one that just started.
                    if key in self._trace_ctx:
                        self._claimed_ctx[key] = self._trace_ctx.pop(key)
                    return key
                if self._shutdown:
                    return None
                waits = []
                if self._delayed:
                    waits.append(self._delayed[0][0] - now)
                if deadline is not None:
                    if deadline <= now:
                        return None
                    waits.append(deadline - now)
                self._cond.wait(timeout=min(waits) if waits else None)

    def done(self, key: Hashable) -> None:
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                self._dirty.discard(key)
                if key not in self._queued:
                    self._queued.add(key)
                    self._queue.append(key)
                    self._enqueued_at.setdefault(key, time.monotonic())
                    self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._trace_ctx.clear()
            self._claimed_ctx.clear()
            self._enqueued_at.clear()
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)
