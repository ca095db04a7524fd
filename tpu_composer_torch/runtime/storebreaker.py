"""Store circuit breaker + post-outage resync pacing (port of
``tpu_composer/runtime/storebreaker.py``).

The apiserver twin of ``fabric/breaker.py``: where the fabric breaker
protects the pool manager from a retry storm, this wraps the OBJECT STORE
(the in-proc ``Store``, or the ChaosStore around it) and classifies its
errors the same way:

- ``StoreError`` (transient 5xx / timeouts / the ChaosStore's blackout,
  and every transport death a wire client maps to it: a connection
  failing ALL its pending verbs at once lands the whole batch on the trip
  streak in one tick) is a breaker failure; ``failure_threshold``
  consecutive ones trip OPEN;
- ``ConflictError`` / ``NotFoundError`` are the store WORKING — a 409 or
  404 is a healthy apiserver saying no, so they reset the failure streak
  and never trip the breaker.

While OPEN every wire verb fails fast with ``StoreError("store breaker
open ...")`` instead of paying a wire timeout — the controllers' existing
conflict/error requeue parks each key under decorrelated backoff, and
because this wrapper sits UNDER the CachedClient, reads keep serving from
the watch-fed informer at zero RTT for the whole outage. After
``reset_timeout`` (±20% jitter so N replicas don't probe in lockstep) one
HALF_OPEN probe is admitted; success closes, failure re-opens.

**Recovery pacing.** The close edge is where outages do their second
round of damage: every controller's backed-off keys wake within one
backoff quantum of heal and N controllers × K keys stampede the
just-recovered apiserver. On close, a global token bucket
(``resync_rate`` tokens/s, starting EMPTY) gates every wire verb for
``resync_window`` seconds — callers briefly sleep for a token
(``tpuc_resync_paced_total`` counts them), spreading the herd at a rate
the recovering store can absorb. Outside the window the bucket is
bypassed entirely: steady-state calls pay one lock acquire and nothing
else.

Metrics: ``tpuc_store_breaker_open`` (1 while open/half-open),
``tpuc_store_outage_seconds_total`` (settled at each close edge),
``tpuc_resync_paced_total``. ``/debug/storebreaker`` serves
:meth:`BreakingStore.snapshot`. A caller wires it between the store and
``maybe_cached`` (the order the operator's entry point uses).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, List, Optional, Type, TypeVar

from tpu_composer_torch.api.meta import ApiObject
from tpu_composer_torch.runtime.metrics import (
    resync_paced_total,
    store_breaker_open,
    store_outage_seconds_total,
)
from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    StoreError,
)

log = logging.getLogger("tpuc.storebreaker")

T = TypeVar("T", bound=ApiObject)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class BreakingStore:
    """Store wrapper: circuit breaker + post-outage resync pacing.

    Duck-types the full Store surface (CRUD + watch + plumbing) like the
    ChaosStore it may wrap; only the CRUD verbs traverse the breaker —
    watches are the informer's lifeline and must keep (re)connecting
    through an outage, and plumbing (scheme, keys) never leaves the
    process.
    """

    def __init__(
        self,
        inner,
        failure_threshold: int = 5,
        reset_timeout: float = 5.0,
        resync_rate: float = 50.0,
        resync_window: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._inner = inner
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.resync_rate = max(1.0, resync_rate)
        self.resync_window = max(0.0, resync_window)
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._retry_at = 0.0
        self._probing = False  # one half-open probe in flight at a time
        #: token bucket, armed at each close edge: tokens accrue at
        #: resync_rate from EMPTY until pacing_until passes.
        self._tokens = 0.0
        self._tokens_at = 0.0
        self._pacing_until = 0.0
        self.trips = 0
        store_breaker_open.set(0)

    # ------------------------------------------------------------------
    # breaker state machine (caller holds no lock; methods take it)
    # ------------------------------------------------------------------
    def is_open(self) -> bool:
        with self._lock:
            return self._state != CLOSED

    def state(self) -> str:
        with self._lock:
            return self._state

    def probe(self) -> bool:
        """Active recovery probe for an IDLE control plane. The breaker
        normally heals on the next admitted call — but the overload
        governor's shed gate defers all work below the priority cutoff,
        and a plane whose only pending work is low-priority would starve
        the breaker of the very call that closes it: store healed,
        breaker open, everything shed, forever. The governor calls this
        each tick while the breaker is open; it is a fail-fast no-op
        until the jittered retry window passes (no wire attempt), then
        one cheap list of the scheme's first kind serves as the
        half-open probe. Returns True iff the breaker is closed after."""
        if not self.is_open():
            return True
        try:
            kinds = self.scheme.kinds()
        except Exception:
            return False
        if not kinds:
            return False
        try:
            self.list(self.scheme.lookup(kinds[0]))
        except StoreError:
            return False
        except Exception:
            # A non-store error still proves the wire answered.
            pass
        return not self.is_open()

    def _admit(self, verb: str) -> bool:
        """True if the call may hit the wire; False = fail fast."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN and now >= self._retry_at:
                self._state = HALF_OPEN
                self._probing = False
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True  # this caller is the probe
                return True
            return False

    def _on_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == CLOSED:
                return
            # HALF_OPEN probe succeeded (or a straggler landed): close,
            # settle the outage clock, arm the resync bucket.
            now = self._clock()
            if self._opened_at is not None:
                store_outage_seconds_total.inc(max(0.0, now - self._opened_at))
            self._state = CLOSED
            self._probing = False
            self._opened_at = None
            self._tokens = 0.0
            self._tokens_at = now
            self._pacing_until = now + self.resync_window
            store_breaker_open.set(0)
            log.info("store breaker closed; pacing resyncs for %.1fs",
                     self.resync_window)

    def _on_failure(self) -> None:
        with self._lock:
            now = self._clock()
            if self._state == HALF_OPEN:
                self._trip(now)  # probe failed — straight back to open
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._trip(now)

    def _trip(self, now: float) -> None:
        # caller holds the lock
        if self._opened_at is None:
            self._opened_at = now
            self.trips += 1
        self._state = OPEN
        self._probing = False
        self._failures = 0
        # ±20% jitter so replicas sharing a dead apiserver spread probes.
        self._retry_at = now + self.reset_timeout * self._rng.uniform(0.8, 1.2)
        store_breaker_open.set(1)
        log.warning("store breaker OPEN (retry in ~%.1fs)", self.reset_timeout)

    # ------------------------------------------------------------------
    # resync pacing
    # ------------------------------------------------------------------
    def _pace(self) -> None:
        """Take a token from the post-heal bucket; sleeps (briefly) when
        the drain is running hot. No-op outside the resync window."""
        while True:
            with self._lock:
                now = self._clock()
                if now >= self._pacing_until:
                    return
                # Burst cap of 2: an idle stretch inside the window buys
                # at most two back-to-back calls, never a re-herd.
                self._tokens = min(
                    2.0,
                    self._tokens + (now - self._tokens_at) * self.resync_rate,
                )
                self._tokens_at = now
                # Epsilon: accrual is (elapsed * rate) float arithmetic, and
                # 0.1s * 10/s lands at 0.9999999999999964 — without the
                # tolerance the residual wait collapses toward zero and the
                # loop busy-spins on sub-nanosecond sleeps.
                if self._tokens >= 1.0 - 1e-9:
                    self._tokens = max(0.0, self._tokens - 1.0)
                    return
                wait = (1.0 - self._tokens) / self.resync_rate
            resync_paced_total.inc()
            self._sleep(min(max(wait, 1e-4), 0.25))

    # ------------------------------------------------------------------
    def _call(self, verb: str, fn: Callable, *args, **kwargs):
        self._pace()
        if not self._admit(verb):
            raise StoreError(
                f"store breaker open: {verb} rejected without a wire attempt"
            )
        try:
            result = fn(*args, **kwargs)
        except (ConflictError, NotFoundError):
            # The apiserver ANSWERED — 409/404 is a healthy store saying
            # no, so the streak resets (and a half-open probe closes).
            self._on_success()
            raise
        except StoreError:
            self._on_failure()
            raise
        self._on_success()
        return result

    # ------------------------------------------------------------------
    # Store interface (CRUD traverses the breaker; plumbing delegates)
    # ------------------------------------------------------------------
    @property
    def scheme(self):
        return self._inner.scheme

    def register_admission(self, kind, hook) -> None:
        self._inner.register_admission(kind, hook)

    def create(self, obj: T) -> T:
        return self._call("create", self._inner.create, obj)

    def get(self, cls: Type[T], name: str) -> T:
        return self._call("get", self._inner.get, cls, name)

    def try_get(self, cls: Type[T], name: str) -> Optional[T]:
        try:
            return self.get(cls, name)
        except NotFoundError:
            return None

    def list(self, cls: Type[T], label_selector=None) -> List[T]:
        return self._call("list", self._inner.list, cls, label_selector)

    def update(self, obj: T) -> T:
        return self._call("update", self._inner.update, obj)

    def update_status(self, obj: T) -> T:
        return self._call("update_status", self._inner.update_status, obj)

    def delete(self, cls: Type[T], name: str) -> None:
        return self._call("delete", self._inner.delete, cls, name)

    # ------------------------------------------------------------------
    # watches + plumbing: NEVER gated — the informer's watch reconnect is
    # how reads stay warm through the outage.
    # ------------------------------------------------------------------
    def watch(self, kind=None):
        return self._inner.watch(kind)

    def stop_watch(self, q) -> None:
        return self._inner.stop_watch(q)

    def keys(self):
        return self._inner.keys()

    def __len__(self) -> int:
        return len(self._inner)

    def __getattr__(self, name: str):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The /debug/storebreaker payload."""
        with self._lock:
            now = self._clock()
            return {
                "state": self._state,
                "trips": self.trips,
                "failure_streak": self._failures,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout,
                "open_for_s": (
                    round(now - self._opened_at, 3)
                    if self._opened_at is not None else None
                ),
                "outage_seconds_total": round(
                    store_outage_seconds_total.total(), 3
                ),
                "resync_rate_per_s": self.resync_rate,
                "resync_window_s": self.resync_window,
                "pacing_active": now < self._pacing_until,
                "resyncs_paced_total": round(resync_paced_total.total()),
            }
