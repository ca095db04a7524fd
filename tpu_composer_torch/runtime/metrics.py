"""Metrics registry with Prometheus text exposition.

Reference analog: controller-runtime's metrics server (cmd/main.go:109-127 +
config/prometheus/monitor.yaml). The reference exposes only default
controller metrics and notably has NO attach-latency instrumentation
(SURVEY.md §6) — our north-star metric requires one, so a Histogram is
first-class here and the controllers record ``attach_to_ready_seconds``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _escape_label_value(v: str) -> str:
    """Prometheus text exposition requires backslash, double-quote and
    newline escaped inside label values — an error string landing in a
    label (chaos injections carry exception text) must not corrupt the
    scrape for every metric after it."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = "") -> None:
        self.name, self.help = name, help_
        self._lock = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label set (bench convenience: the RTT counter's
        delta across a run divided by cycles = store_rtts_per_attach)."""
        with self._lock:
            return sum(self._values.values())

    def remove(self, **labels: str) -> None:
        """Drop one label-set's series (e.g. a deleted node's breaker
        gauges) so churning fleets don't grow /metrics unboundedly."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values.pop(key, None)

    def state(self) -> List[List[object]]:
        """JSON-serializable snapshot: ``[[{label: value}, value], ...]``
        — what a replica publishes into its fleet telemetry snapshot."""
        with self._lock:
            return [[dict(key), v] for key, v in sorted(self._values.items())]

    def merge(self, other) -> None:
        """Sum another counter's series into this one, label set by label
        set. ``other`` is a Counter/Gauge or a :meth:`state` list (the
        deserialized form a fleet snapshot carries)."""
        series = other.state() if hasattr(other, "state") else other
        for labels, value in series:
            key = tuple(sorted(dict(labels).items()))
            with self._lock:
                self._values[key] = self._values.get(key, 0.0) + float(value)

    def label_sets(self) -> List[Dict[str, str]]:
        """Every label combination this metric has observed (bench/debug
        introspection — e.g. enumerating which phases have durations)."""
        with self._lock:
            return [dict(key) for key in self._values]

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge(Counter):
    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    def __init__(
        self,
        name: str,
        help_: str = "",
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ) -> None:
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        self._sums: Dict[Tuple[Tuple[str, str], ...], float] = {}
        # Bounded raw-sample retention for exact percentiles (bench use);
        # bucket counts + sums alone serve /metrics exposition.
        self._samples: Dict[Tuple[Tuple[str, str], ...], "collections.deque[float]"] = {}
        self._max_samples = 10000

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._samples.setdefault(
                key, collections.deque(maxlen=self._max_samples)
            ).append(value)

    def count(self, **labels: str) -> int:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return sum(self._counts.get(key, []))

    def sum(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._sums.get(key, 0.0)

    def total_count(self) -> int:
        """Observation count summed across every label set (the SLO
        engine's traffic denominator — an objective spans all labels)."""
        with self._lock:
            return sum(sum(c) for c in self._counts.values())

    def total_count_le(self, value: float) -> float:
        """Observations <= ``value`` summed across every label set, with
        linear interpolation inside the bucket containing ``value``.
        Observations in the +Inf overflow bucket never count as <= a
        finite value — for an SLO that conservatively counts them as bad."""
        with self._lock:
            counts = [list(c) for c in self._counts.values()]
        total = 0.0
        for c in counts:
            total += self._interp_count_le(c, value)
        return total

    def _interp_count_le(self, counts: List[int], value: float) -> float:
        # Operates on a COPY of one label set's bucket counts (no lock
        # needed or held); the inverse walk of percentile's rank lookup.
        cum = 0.0
        prev_b = 0.0
        for i, b in enumerate(self.buckets):
            c = counts[i]
            if value >= b:
                cum += c
                prev_b = b
                continue
            if value > prev_b and b > prev_b:
                cum += c * (value - prev_b) / (b - prev_b)
            return cum
        return cum

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        """Quantile for one label set; ``None`` for an empty series (never
        a bucket boundary standing in for no data — the SLO engine treats
        None as "no traffic", not "objective met at 0s").

        Exact from the retained raw samples while they cover every
        observation; once the bounded sample ring has evicted (count >
        retained), falls back to the bucket counts with linear
        interpolation inside the target bucket (histogram_quantile
        semantics) instead of returning a raw bucket upper bound."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            samples = sorted(self._samples.get(key, []))
            counts = list(self._counts.get(key, []))
        total = sum(counts)
        if total == 0:
            return None
        if samples and len(samples) == total:
            idx = min(len(samples) - 1, max(0, int(round(q * (len(samples) - 1)))))
            return samples[idx]
        # Bucket interpolation: rank q*total, linear within its bucket.
        rank = max(0.0, min(1.0, q)) * total
        cum = 0.0
        prev_b = 0.0
        for i, b in enumerate(self.buckets):
            c = counts[i]
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                return prev_b + frac * (b - prev_b)
            cum += c
            prev_b = b
        # Rank lands in the +Inf overflow bucket: the best honest answer
        # is the largest retained sample (if any), else the last finite
        # boundary — flagged nowhere, so keep overflow buckets rare by
        # choosing bucket layouts that cover the expected range.
        if samples:
            return samples[-1]
        return self.buckets[-1] if self.buckets else None

    def percentile_all(self, q: float) -> Optional[float]:
        """Quantile over ALL label sets combined, from bucket counts with
        linear interpolation (never raw samples — the label sets' sample
        rings are not one coherent population). The fleet aggregator's
        percentile: a merged histogram carries every replica's label sets
        and the fleet p99 spans them all; ``None`` for an empty series."""
        with self._lock:
            cols = list(self._counts.values())
        if not cols:
            return None
        agg = [sum(col[i] for col in cols) for i in range(len(self.buckets) + 1)]
        total = sum(agg)
        if total == 0:
            return None
        rank = max(0.0, min(1.0, q)) * total
        cum = 0.0
        prev_b = 0.0
        for i, b in enumerate(self.buckets):
            c = agg[i]
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                return prev_b + frac * (b - prev_b)
            cum += c
            prev_b = b
        return self.buckets[-1] if self.buckets else None

    def label_sets(self) -> List[Dict[str, str]]:
        """Every label combination observed (see Counter.label_sets)."""
        with self._lock:
            return [dict(key) for key in self._counts]

    def state(self) -> Dict[str, object]:
        """JSON-serializable snapshot of the FULL bucket state:
        ``{"buckets": [...], "series": [[{label: value}, counts, sum]]}``
        where ``counts`` is per-bucket (len(buckets)+1, last = +Inf
        overflow). This is what a replica publishes fleet-wide — cumulative
        counts, so merged series stay monotonic and burn-rate diffs work."""
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "series": [
                    [dict(key), list(counts), self._sums.get(key, 0.0)]
                    for key, counts in sorted(self._counts.items())
                ],
            }

    def merge(self, other) -> None:
        """Sum another histogram's bucket counts and sums into this one,
        label set by label set. ``other`` is a Histogram or a
        :meth:`state` dict (a deserialized fleet snapshot).

        Bucket-schema guard: identical-bucket merging is the ONLY sound
        operation on histograms — summing counts across different bucket
        layouts silently mis-attributes observations, so mismatched bounds
        (or a malformed per-bucket count vector) raise ``ValueError``
        instead of producing a plausible-looking wrong aggregate. Raw
        samples are deliberately NOT merged: a merged series answers
        percentiles via bucket interpolation, never via one contributor's
        sample ring masquerading as the fleet's."""
        state = other.state() if hasattr(other, "state") else other
        theirs = tuple(float(b) for b in state.get("buckets", ()))
        if theirs != self.buckets:
            raise ValueError(
                f"histogram bucket schema mismatch merging into"
                f" {self.name}: {theirs!r} != {self.buckets!r}"
            )
        want = len(self.buckets) + 1
        for labels, counts, sum_ in state.get("series", []):
            if len(counts) != want:
                raise ValueError(
                    f"histogram {self.name}: malformed bucket counts"
                    f" (got {len(counts)}, want {want})"
                )
            key = tuple(sorted(dict(labels).items()))
            with self._lock:
                mine = self._counts.setdefault(key, [0] * want)
                for i, c in enumerate(counts):
                    mine[i] += int(c)
                self._sums[key] = self._sums.get(key, 0.0) + float(sum_)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += counts[i]
                    lab = key + (("le", repr(b)),)
                    out.append(f"{self.name}_bucket{_fmt_labels(lab)} {cum}")
                cum += counts[-1]
                lab = key + (("le", "+Inf"),)
                out.append(f"{self.name}_bucket{_fmt_labels(lab)} {cum}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums.get(key, 0.0)}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
        return out


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help_)
                self._metrics[name] = m
            assert isinstance(m, Counter) and not isinstance(m, Gauge)
            return m

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name, help_)
                self._metrics[name] = m
            assert isinstance(m, Gauge)
            return m

    def histogram(
        self, name: str, help_: str = "", buckets: Sequence[float] = _DEFAULT_BUCKETS
    ) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, buckets)
                self._metrics[name] = m
            assert isinstance(m, Histogram)
            return m

    def expose_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


#: Process-global registry (controllers import this), like controller-runtime's
#: metrics.Registry singleton.
global_registry = Registry()

#: The instrumentation the reference lacks (BASELINE.md north star).
attach_to_ready_seconds = global_registry.histogram(
    "tpuc_attach_to_ready_seconds",
    "Latency from ComposabilityRequest creation to Running state",
)
reconcile_total = global_registry.counter(
    "tpuc_reconcile_total", "Reconcile invocations by controller and outcome"
)
fabric_requests_total = global_registry.counter(
    "tpuc_fabric_requests_total", "Fabric provider calls by op and outcome"
)
composed_chips = global_registry.gauge(
    "tpuc_composed_chips", "Currently attached chips by node"
)

#: Fabric resilience layer (error taxonomy + breaker + quarantine).
fabric_retries_total = global_registry.counter(
    "tpuc_fabric_retries_total",
    "Transport-level retries of idempotent fabric GETs after transient errors",
)
fabric_breaker_state = global_registry.gauge(
    "tpuc_fabric_breaker_state",
    "Circuit breaker state per endpoint/scope (0=closed, 1=open, 2=half-open)",
)
fabric_breaker_trips_total = global_registry.counter(
    "tpuc_fabric_breaker_trips_total",
    "Breaker transitions into open, by endpoint/scope",
)
fabric_breaker_rejections_total = global_registry.counter(
    "tpuc_fabric_breaker_rejections_total",
    "Fabric calls rejected immediately because a breaker was open",
)
resources_quarantined_total = global_registry.counter(
    "tpuc_resources_quarantined_total",
    "ComposableResources quarantined after exhausting their attach budget",
)

#: Informer read cache (runtime/cache.py + kubestore reflector): the
#: read-path instrumentation that makes store_rtts_per_attach measurable.
store_requests_total = global_registry.counter(
    "tpuc_store_requests_total",
    "Store/apiserver round trips by verb and kind (wire ops only — reads"
    " served from the informer cache are counted in tpuc_cached_reads_total)",
)
cached_reads_total = global_registry.counter(
    "tpuc_cached_reads_total",
    "get/list reads served from the watch-fed informer cache (zero RTT)",
)
status_writes_coalesced_total = global_registry.counter(
    "tpuc_status_writes_coalesced_total",
    "update_status calls skipped because the status dict was unchanged at"
    " the current resourceVersion",
)
store_watch_queue_depth = global_registry.gauge(
    "tpuc_store_watch_queue_depth",
    "Undrained events per store watcher queue (a growing depth means a"
    " slow consumer — the unbounded queue would otherwise hide it)",
)
wire_mux_active = global_registry.gauge(
    "tpuc_wire_mux_active",
    "1 while the store client is on the multiplexed framed transport"
    " (tpuc-mux/1); 0 after falling back to per-request keep-alive HTTP"
    " (server declined the upgrade, the K-streak flap damper tripped, or"
    " TPUC_WIRE_MUX=0)",
)
wire_mux_reconnects_total = global_registry.counter(
    "tpuc_wire_mux_reconnects_total",
    "Mux connections re-established after a connection loss (the first"
    " dial of a process does not count) — each increment is one framed-"
    "transport death ridden out by reconnect + watch resume-from-cursor",
)
wire_mux_degraded_total = global_registry.counter(
    "tpuc_wire_mux_degraded_total",
    "Permanent mux->HTTP demotions by reason (declined = server without a"
    " /mux endpoint; failures = K consecutive mux connection failures"
    " tripped the flap damper). At most one per process per store",
)
wire_ping_rtt_seconds = global_registry.histogram(
    "tpuc_wire_ping_rtt_seconds",
    "Mux liveness ping/pong round-trip time on the framed transport —"
    " the transport-level health signal behind dead-connection detection"
    " (a pong outstanding past the miss deadline fails the connection)",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)

#: Fabric I/O pipeline (fabric/dispatcher.py): per-node batched group
#: attach, async dispatch, completion-driven requeue.
fabric_calls_total = global_registry.counter(
    "tpuc_fabric_calls_total",
    "Provider calls issued by the fabric write path, by verb and whether"
    " the call was a batched group verb (batched=true) or a single-item"
    " call (batched=false; includes split retries of failed batches)",
)
fabric_batch_size = global_registry.histogram(
    "tpuc_fabric_batch_size",
    "Members per group fabric call attempted by the dispatcher",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
)
fabric_inflight = global_registry.gauge(
    "tpuc_fabric_inflight",
    "Fabric ops currently executing against the provider (all nodes)",
)
fabric_completion_latency = global_registry.histogram(
    "tpuc_fabric_completion_latency_seconds",
    "Latency from dispatcher submission to op completion (batch window +"
    " provider time + any fabric-async wait), by verb and outcome",
)
fabric_reads_coalesced_total = global_registry.counter(
    "tpuc_fabric_reads_coalesced_total",
    "get_resources listings served from the dispatcher's shared snapshot"
    " (no provider call; staleness bounded by the batch window)",
)

#: Fabric event plane (fabric/events.py): server-push op completions over
#: a persistent session, with the poll timers demoted to safety nets.
fabric_events_total = global_registry.counter(
    "tpuc_fabric_events_total",
    "Server-push fabric events processed by the session, by type"
    " (op_completed | health | inventory | stale = duplicate/out-of-order"
    " drop | gap = sequence gap detected)",
)
fabric_poll_fallbacks_total = global_registry.counter(
    "tpuc_fabric_poll_fallbacks_total",
    "Fabric-pending ops settled by the safety-net poll pass that the event"
    " stream should have completed, by verb (steady nonzero growth while"
    " the session reports streaming = events are being missed; climbing"
    " with the session down = degraded to polling — see OPERATIONS.md)",
)
fabric_session_state = global_registry.gauge(
    "tpuc_fabric_session_state",
    "Fabric event session state per endpoint (1 = streaming, 0 ="
    " down/reconnecting, -1 = provider has no event stream; series absent"
    " = event plane disabled)",
)
fabric_event_resyncs_total = global_registry.counter(
    "tpuc_fabric_event_resyncs_total",
    "get_resources resyncs triggered by event-stream sequence gaps (one"
    " per detected gap — the bounded-cost alternative to silent loss)",
)

#: Crash consistency (durable intent + cold-start adoption + drain).
adoption_ops_total = global_registry.counter(
    "tpuc_adoption_ops_total",
    "Pending fabric-op intents classified by the cold-start adoption pass,"
    " by verb and outcome (adopted | reissue | repoll | cleared | deferred"
    " | error)",
)
dispatcher_drains_total = global_registry.counter(
    "tpuc_dispatcher_drains_total",
    "Graceful dispatcher drains at shutdown/leader handoff, by outcome"
    " (clean = every op settled and every outcome consumed within"
    " --drain-timeout; timeout = durable intent + adoption recover the"
    " rest after restart)",
)
store_chaos_injected_total = global_registry.counter(
    "tpuc_store_chaos_injected_total",
    "Store-layer faults injected by the ChaosStore, by verb and mode"
    " (transient | conflict | watch_drop)",
)

#: Self-healing data plane (post-Ready failure detection + repair driver).
member_degradations_total = global_registry.counter(
    "tpuc_member_degradations_total",
    "Online->Degraded transitions by detection source (health-probe ="
    " damped consecutive failed probes; syncer = device vanished from the"
    " fabric listing)",
)
degraded_members = global_registry.gauge(
    "tpuc_degraded",
    "Attached members currently Degraded or Repairing, fleet-wide"
    " (level-set by the repair driver and the syncer's anti-drift pass)",
)
repairs_total = global_registry.counter(
    "tpuc_repairs_total",
    "Repair driver actions by outcome (started = replacement placed +"
    " attaching; replaced = failed member detached after its replacement"
    " came Online; detached = DetachOnly policy detach; fallback ="
    " provider has no in-place repair, detached + re-solved; retried ="
    " replacement died, repair re-attempted; failed = placement/fabric"
    " error, retried next pass; frozen = fleet breaker freeze edge)",
)
repair_breaker_open = global_registry.gauge(
    "tpuc_repair_breaker_open",
    "1 while the fleet-level repair breaker is open (degraded fraction"
    " above threshold — repairs and repair detaches frozen), else 0",
)

#: Live migration + node maintenance drains (the evacuation verb).
migrations_total = global_registry.counter(
    "tpuc_migrations_total",
    "Live-migration driver actions by trigger (maintenance | evacuation |"
    " defrag) and outcome (started = replacement placed + attaching;"
    " cutover = coordinates flipped to the target, drain grace running;"
    " completed = source detached after its replacement came Online;"
    " retried = replacement died, migration re-attempted; fallback ="
    " provider has no in-place member move, detached + re-solved"
    " break-before-make; failed = placement/fabric error, retried next"
    " pass; frozen = migration breaker freeze edge; aborted = evacuation"
    " mark withdrawn by a drain deadline)",
)
migration_duration_seconds = global_registry.histogram(
    "tpuc_migration_duration_seconds",
    "End-to-end live-migration latency: from the migration record's"
    " started_at (replacement created) to the source member's detach"
    " (make-before-break complete), by trigger",
)
migration_breaker_open = global_registry.gauge(
    "tpuc_migration_breaker_open",
    "1 while the fleet migration breaker is open (degraded fraction above"
    " the migration threshold — no NEW evacuations start and cutover"
    " detaches wait; a brownout must never trigger a mass evacuation),"
    " else 0",
)
node_maintenances_active = global_registry.gauge(
    "tpuc_node_maintenances",
    "NodeMaintenance drains currently active (Cordoned/Draining),"
    " level-set by the maintenance controller",
)

#: Sharded control plane (runtime/shards.py + runtime/leases.py): K shard
#: leases across N replicas, with live handoff and partition fencing.
lease_transitions_total = global_registry.counter(
    "tpuc_lease_transitions_total",
    "Single-leader lease churn by event (acquired = this replica won the"
    " lease; renewed_fail = one failed renewal attempt; deposed = the"
    " manager watchdog observed leadership lost — counted once per"
    " deposition; released = voluntary release at shutdown)",
)
shard_ownership_gauge = global_registry.gauge(
    "tpuc_shard_ownership",
    "1 for each shard lease this replica currently holds, 0 otherwise"
    " (per-process: sum over replicas == shard count when the fleet is"
    " healthy; a shard stuck at 0 fleet-wide is orphaned)",
)
shard_handoffs_total = global_registry.counter(
    "tpuc_shard_handoffs_total",
    "Shard ownership changes at this replica, by reason (acquisitions:"
    " bootstrap = lease created fresh | handoff = picked up a released"
    " lease | failover = stole an expired lease from a dead replica;"
    " losses: fenced = renewals failed past the monotonic deadline |"
    " deposed = another replica holds the lease | rebalance = shed to a"
    " returning replica | released = voluntary shutdown)",
)

#: Cluster scheduler (scheduler/: priority queue, preemption, defrag).
scheduler_queue_depth = global_registry.gauge(
    "tpuc_scheduler_queue_depth",
    "ComposabilityRequests waiting for placement (pending queue size)",
)
scheduler_preemptions_total = global_registry.counter(
    "tpuc_scheduler_preemptions_total",
    "Victim requests evicted so a higher-priority request could place",
)
scheduler_held_back_total = global_registry.counter(
    "tpuc_scheduler_held_back_total",
    "Placement attempts that could not be granted, by reason"
    " (backfill-gate = deferred to protect a pending higher-priority"
    " request | tpu-ports = not enough hosts with free TPU ports |"
    " node-resources = hosts had ports but failed cpu/memory/pod caps |"
    " target-node = the pinned host is missing/quarantined/full |"
    " capacity = no placement and the decision ledger is off). The"
    " unlabeled pre-ledger total is the sum over reasons",
)
scheduler_decisions_total = global_registry.counter(
    "tpuc_scheduler_decisions_total",
    "Scheduler decisions recorded in the decision ledger, by kind (place |"
    " place-scalar | place-extra | defrag-skip | defrag-migrate) and"
    " outcome (placed | held-back | preempting | skipped | evacuating)."
    " Collapsed reconcile-retry repeats count once per retry",
)
scheduler_fragmentation_score = global_registry.gauge(
    "tpuc_scheduler_fragmentation_score",
    "Share of free TPU capacity stranded on partially-used hosts"
    " (0 = all free capacity sits on whole hosts)",
)
scheduler_time_to_placement_seconds = global_registry.histogram(
    "tpuc_scheduler_time_to_placement_seconds",
    "Wait from first failed placement attempt to successful placement",
)
scheduler_defrag_migrations_total = global_registry.counter(
    "tpuc_scheduler_defrag_migrations_total",
    "Worker migrations started by the defragmentation planner",
)

#: Causal tracing + lifecycle timelines (runtime/tracing.py +
#: runtime/lifecycle.py): per-CR phase transitions with durations — the
#: attach-latency curve decomposed by stage (Pending | Scheduled |
#: Attaching | Ready | Detaching | Terminating), by object kind.
phase_duration_seconds = global_registry.histogram(
    "tpuc_phase_duration_seconds",
    "Seconds an object spent in the lifecycle phase it just left, by kind"
    " (request | resource) and phase — fed by the manager's lifecycle"
    " tracker watching state transitions",
)
flight_dumps_total = global_registry.counter(
    "tpuc_flight_dumps_total",
    "Flight-recorder dumps written, by reason (drain-timeout |"
    " unhandled-exception | atexit | manual)",
)

#: Control-plane observatory (runtime/profiler.py + runtime/contention.py
#: + runtime/slo.py): sampling profiler, lock-contention telemetry, and
#: the SLO engine with multi-window burn-rate alerts.
_LOCK_BUCKETS = (
    1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0,
)
lock_wait_seconds = global_registry.histogram(
    "tpuc_lock_wait_seconds",
    "Time threads spent blocked acquiring an instrumented hot lock, by"
    " lock (store | inmem_pool | informer:<kind> | dispatcher |"
    " chip_index). Wait climbing while hold stays flat = contention;"
    " both climbing = the critical section itself got slower",
    buckets=_LOCK_BUCKETS,
)
lock_hold_seconds = global_registry.histogram(
    "tpuc_lock_hold_seconds",
    "Time an instrumented hot lock was held per outermost acquire"
    " (condition-variable parks inside the hold are excluded — the lock"
    " is released while parked)",
    buckets=_LOCK_BUCKETS,
)
queue_wait_seconds = global_registry.histogram(
    "tpuc_queue_wait_seconds",
    "Seconds a key sat ready in a work queue between enqueue (or delayed-"
    "entry promotion) and dequeue, by queue (controller name) — the"
    " saturation signal that climbs before reconcile latency does",
    buckets=_LOCK_BUCKETS,
)
worker_busy_ratio = global_registry.gauge(
    "tpuc_worker_busy_ratio",
    "Fraction of the last tracking window the named worker pool spent"
    " executing (reconciles / fabric calls) rather than parked, by pool"
    " (controller name | fabric-dispatch). Sustained ~1.0 = the pool is"
    " saturated and queue wait is about to climb",
)
gil_wait_ratio = global_registry.gauge(
    "tpuc_gil_wait_ratio",
    "Profiler estimate of the share of a subsystem's runnable wall time"
    " spent waiting for the GIL rather than executing (runnable samples *"
    " interval minus measured thread CPU time), by subsystem — the number"
    " that says whether scale-out is re-serializing on the interpreter",
)
profiler_samples_total = global_registry.counter(
    "tpuc_profiler_samples_total",
    "Thread-stack samples taken by the always-on sampling profiler",
)
slo_burn_rate = global_registry.gauge(
    "tpuc_slo_burn_rate",
    "Error-budget burn rate per objective and window (fast | slow):"
    " bad-fraction / budget over the rolling window. 1.0 = consuming"
    " exactly the budget; the alert threshold is --slo-burn-threshold",
)
slo_breached = global_registry.gauge(
    "tpuc_slo_breached",
    "1 while the objective's burn-rate alert is firing (fast AND slow"
    " windows above the burn threshold; clears when the fast window"
    " recovers), else 0",
)
repair_time_to_replace_seconds = global_registry.histogram(
    "tpuc_repair_time_to_replace_seconds",
    "Self-healing repair latency: from the member's failure record"
    " (Degraded observed_at) to the failed member's detach after its"
    " replacement came Online (the make-before-break 'replaced' edge)",
)

#: Fleet observatory (runtime/fleet.py): every replica publishes a
#: telemetry snapshot into the shared store; the aggregator on EVERY
#: replica merges them, so these fleet-level series read the same from
#: whichever replica's /metrics you scrape.
fleet_replicas = global_registry.gauge(
    "tpuc_fleet_replicas",
    "Live operator replicas in the fleet view (publishing telemetry"
    " snapshots whose sequence number still advances on this replica's"
    " observation clock). Level-set each aggregation tick: a kill -9'd"
    " replica drops out after --fleet-stale-after",
)
fleet_stale_replicas = global_registry.gauge(
    "tpuc_fleet_stale_replicas",
    "Replicas with a published snapshot whose sequence number has sat"
    " unchanged past the staleness window — dead or partitioned; their"
    " series are excluded from every fleet aggregate",
)
fleet_replica_shards = global_registry.gauge(
    "tpuc_fleet_replica_shards",
    "Shard leases each live replica reports owning, by replica identity"
    " (label sets for stale replicas are removed each tick — a dead"
    " replica must not linger in the fleet view)",
)
fleet_attach_p99_seconds = global_registry.gauge(
    "tpuc_fleet_attach_p99_seconds",
    "Fleet-merged attach-to-ready p99 (identical-bucket histogram"
    " summation across live replica processes, bucket-interpolated)",
)
fleet_queue_wait_p99_seconds = global_registry.gauge(
    "tpuc_fleet_queue_wait_p99_seconds",
    "Fleet-merged work-queue wait p99 across live replica processes",
)
fleet_goodput_ratio = global_registry.gauge(
    "tpuc_fleet_goodput_ratio",
    "Fleet-merged goodput: Ready-serving seconds over total accounted"
    " wall seconds across live replica processes (1.0 = every request"
    " spent its whole life serving)",
)
fleet_publishes_total = global_registry.counter(
    "tpuc_fleet_publishes_total",
    "Telemetry snapshots this replica published into the shared store,"
    " by outcome (ok | error; a dormant publisher — store without the"
    " FleetTelemetry kind — counts nothing after its first probe)",
)


#: Goodput & capacity observatory (runtime/goodput.py +
#: runtime/capacity.py): per-request serving-time accounting on the
#: lifecycle tracker, and the capacity timeline the scheduler's decisions
#: are judged against (largest-placeable-slice / free-chip distribution —
#: utilization CURVES, not points; arXiv:2404.06467).
goodput_ratio = global_registry.gauge(
    "tpuc_goodput_ratio",
    "Ready-serving wall seconds over total accounted wall seconds across"
    " every tracked request (queued + provisioning + degraded + repairing"
    " + migrating time is the lost share; terminating time is excluded)."
    " 1.0 = perfect goodput",
)
goodput_seconds_total = global_registry.counter(
    "tpuc_goodput_seconds_total",
    "Cumulative request wall seconds by category (ready | queued |"
    " provisioning | degraded | repairing | migrating), settled at each"
    " phase transition — the goodput ratio's numerator (ready) and"
    " denominator (sum) as first-class series",
)
capacity_largest_slice_chips = global_registry.gauge(
    "tpuc_capacity_largest_slice_chips",
    "Largest TPU slice (hosts x chips-per-host) composable RIGHT NOW from"
    " free schedulable capacity — the headroom number a pending gang"
    " compares its demand against",
)
capacity_free_chips = global_registry.gauge(
    "tpuc_capacity_free_chips",
    "Free TPU ports across schedulable (ready, uncordoned, unquarantined)"
    " hosts — the capacity timeline's raw supply curve",
)
capacity_hosts_by_free = global_registry.gauge(
    "tpuc_capacity_hosts_by_free",
    "Schedulable hosts by exact free-TPU-port count (label free=N),"
    " level-set each sample — the free-chip distribution whose shape"
    " distinguishes fragmentation from exhaustion",
)


#: Control-plane survival layer (runtime/overload.py + runtime/storebreaker.py
#: + runtime/watchdog.py): the operator protecting itself from its own
#: brownouts — overload shedding, store-outage ride-through, stall detection.
overload_state = global_registry.gauge(
    "tpuc_overload_state",
    "Overload governor state (0 = ok, 1 = warn: non-critical cadences"
    " stretched, 2 = shed: low-priority request reconciles deferred to the"
    " stretched backoff quantum while the tight path keeps running)",
)
overload_sheds_total = global_registry.counter(
    "tpuc_overload_sheds_total",
    "Reconcile passes deferred by the overload governor while in shed"
    " state, by class (request = low-priority ComposabilityRequest"
    " reconciles). Every shed also lands in the decision ledger as a"
    " hold-back with reason=overload",
)
store_breaker_open = global_registry.gauge(
    "tpuc_store_breaker_open",
    "1 while the store circuit breaker is open (apiserver outage: writes"
    " fail fast, reads keep serving from the informer cache) or half-open"
    " (probing), else 0",
)
store_outage_seconds_total = global_registry.counter(
    "tpuc_store_outage_seconds_total",
    "Cumulative wall seconds the store breaker spent open, settled at each"
    " close edge — the ride-through clock an outage postmortem reads",
)
resync_paced_total = global_registry.counter(
    "tpuc_resync_paced_total",
    "Store calls delayed by the post-outage token-bucket resync limiter"
    " (the recovery drain's pacing: N controllers x K backed-off keys must"
    " not stampede the just-healed apiserver)",
)
watchdog_stalls_total = global_registry.counter(
    "tpuc_watchdog_stalls_total",
    "Heartbeat stalls detected by the subsystem watchdog, by subsystem"
    " (counted once per stall edge, not per scan — a healthy suite runs at"
    " zero; any growth names the wedged thread)",
)
watchdog_restarts_total = global_registry.counter(
    "tpuc_watchdog_restarts_total",
    "Stalled restartable runnables restarted by the watchdog, by subsystem"
    " (bounded by --watchdog-restart-budget per subsystem)",
)


def timed() -> float:
    return time.monotonic()
