"""Operator process entry point (port of ``tpu_composer/cmd/main.py``).

Every flag and ``TPUC_*`` variable of the JAX package's command line, with
the same meaning; the operator composes TPU slices and NVIDIA H100 hosts
alike (the model names them). Nothing on this path imports torch: a
replica and its node agent start without loading torch or CUDA.

Reference analog: cmd/main.go — flag parsing (:62-82), logger setup (:84),
manager construction with metrics/health endpoints and leader election
(:137-155), controller + webhook wiring (:167-201), healthz/readyz (:205-212),
and the blocking Start with signal handling (:214-218).

Env contract (reference analog: composableresource_adapter.go:43-70):

  CDI_PROVIDER_TYPE   MOCK | REST_CM | REST_FM | LAYOUT | REDFISH
  FABRIC_ENDPOINT     base URL for remote providers
  FABRIC_TENANT_ID / FABRIC_CLUSTER_ID     multi-tenant path scoping
  FABRIC_AUTH_URL / FABRIC_USERNAME / FABRIC_PASSWORD /
  FABRIC_CREDENTIALS_FILE                  OAuth2 password-grant auth
  NODE_AGENT          FAKE | LOCAL | REMOTE (default FAKE under MOCK, LOCAL
                      otherwise); REMOTE reaches each node's agent daemon
                      (agent/serve.py) at Node.spec.agent_endpoint, else
                      at NODE_AGENT_ENDPOINT_TEMPLATE (default {node}:9444)
  ENABLE_WEBHOOKS     "false" disables in-process admission (cmd/main.go:196)
  TPUC_STATE_DIR      object-store persistence directory
  TPUC_CACHED_READS   "0" disables the watch-fed informer read cache
                      (--no-cached-reads equivalent; default on)
  TPUC_FABRIC_BATCH   "0" disables the FabricDispatcher (--no-fabric-batch
                      equivalent): attach/detach run as today's direct
                      blocking calls inside reconcile workers
  TPUC_FABRIC_EVENTS  "0" disables the fabric event plane
                      (--no-fabric-events equivalent): no FabricSession is
                      constructed and op completion is observed purely by
                      the dispatcher's poll timers, bit-identical to the
                      pre-event-plane behavior
  TPUC_FABRIC_POLL_FALLBACK_MULT
                      poll_interval stretch factor while the event session
                      is streaming (--fabric-poll-fallback-mult)
  TPUC_DRAIN_TIMEOUT  seconds a graceful shutdown drains in-flight fabric
                      ops before releasing the lease (--drain-timeout)
  TPUC_CHAOS_STORE_*  store-layer fault injection (FAILURE_RATE,
                      CONFLICT_RATE, LATENCY, WATCH_DROP_RATE, SEED) —
                      the apiserver twin of the fabric chaos knobs
  TPUC_PROFILE        "0" disables the control-plane observatory
                      (--no-profile): the always-on sampling profiler,
                      lock-contention histograms AND SLO evaluation
  TPUC_PROFILE_INTERVAL / TPUC_PROFILE_WINDOW
                      sampler tick / continuous-window size, seconds
  TPUC_PROFILE_FILE / TPUC_SLO_FILE
                      crash-hook dump destinations for the continuous-
                      profile ring and the /debug/slo snapshot
  TPUC_SLO_*          objective thresholds and burn-rate windows
                      (ATTACH_P99, COMPLETION_P50, QUEUE_P99, REPAIR_P99,
                      FAST_WINDOW, SLOW_WINDOW, BURN_THRESHOLD)
  TPUC_FLEET          "0" disables the fleet observatory (--no-fleet):
                      no telemetry publishing, no cross-replica
                      aggregation, no /debug/fleet, no replica-tagged
                      trace pids — per-process observability only
  TPUC_FLEET_PUBLISH_PERIOD / TPUC_FLEET_STALE_AFTER
                      fleet snapshot cadence / dead-replica ageing window
  TPUC_FLEET_FILE     write the /debug/fleet view here from the crash
                      hooks (--fleet-file)
  TPUC_TRACE          "0" disables causal tracing entirely (--no-trace)
  TPUC_TRACE_EVENTS   trace ring capacity in events (--trace-events)
  TPUC_TRACE_FILE     write the Chrome trace ring here at stop AND on
                      crash/drain-timeout (--trace-file)
  TPUC_FLIGHT_FILE    write the flight-recorder black box here on
                      crash/drain-timeout (--flight-file)
  TPUC_SHARDS         number of control-plane shard leases (--shards);
                      1 (default) = today's single-leader behavior,
                      K>1 = N replicas each own a hash partition of keys
  TPUC_SHARD_REPLICAS expected replica count (--shard-replicas): damps the
                      first replica's startup grab during a rolling deploy
  TPUC_REPLICA_ID     stable replica identity (--replica-id) for member
                      leases, fleet telemetry and trace process names;
                      default is a fresh hostname_uuid per boot. The
                      proc-mode supervisor (fleet/proc.py) pins one per
                      spawned replica
  TPUC_PORT_FILE      write {"pid","health_port","replica_id"} JSON here
                      after startup (--port-file) — the supervisor's
                      race-free discovery of a :0 health bind
  TPUC_LEASE_DURATION / TPUC_LEASE_RENEW_PERIOD
                      lease timing for both the single-leader and shard
                      electors (--lease-duration / --lease-renew-period)
  TPUC_POLL_SCALE     multiplier over the reconcilers' lifecycle requeue
                      cadences (attach/visibility/detach/busy/cleanup
                      re-polls); 1.0 (default) = production cadences.
                      Bench/smoke harnesses shrink it so throughput, not
                      the polling latency floor, is what gets measured

  TPUC_MIGRATE        "0" disables the live-migration verb (--no-migrate):
                      no NodeMaintenance controller, no migration driver,
                      no node-escalation evacuation, and the defrag
                      executor reverts to delete/re-solve
  TPUC_MIGRATE_MAX_CONCURRENT / TPUC_MIGRATE_BREAKER_FRACTION /
  TPUC_MIGRATE_DRAIN_DEADLINE
                      fleet migration surge cap, migration-breaker
                      threshold, and the default NodeMaintenance drain
                      deadline (--migrate-*)
  TPUC_HEALTH_FAILURE_THRESHOLD   consecutive failed health probes before
                      an Online member goes Degraded (--health-failure-threshold)
  TPUC_DECISIONS      "0" disables the scheduler decision observatory
                      (--no-decisions): no decision ledger (every
                      placement/hold-back/preemption record), no goodput
                      accounting, no capacity timeline, no
                      /debug/scheduler/* or /debug/goodput endpoints
  TPUC_DECISIONS_FILE write the decision ring here from the crash hooks
                      (--decisions-file; the soak failure artifact beside
                      the flight/profile/SLO/fleet black boxes)
  TPUC_CAPACITY_SAMPLE_PERIOD
                      seconds between capacity-timeline samples
                      (--capacity-sample-period)
  TPUC_SLO_GOODPUT_TARGET
                      goodput SLO target fraction (--slo-goodput-target;
                      0.95 = at most 5% of accounted request wall time
                      may be non-serving; <= 0 drops the objective)
  TPUC_NODE_DEGRADE_THRESHOLD     per-node Degraded transitions that
                      escalate to node quarantine (--node-degrade-threshold)
  TPUC_REPAIR_BREAKER_FRACTION / TPUC_REPAIR_BREAKER_MIN_MEMBERS
                      fleet-level repair-storm breaker (--repair-breaker-*)

Run: ``python -m tpu_composer_torch [flags]`` or ``python -m tpu_composer_torch.cmd.main``.

Subcommands (dispatched before operator flag parsing):

  trace-merge [--out merged.json] a.json b.json ...
      Stitch per-replica Chrome trace files (TPUC_TRACE_FILE output, one
      per replica process) into ONE connected Perfetto trace: clocks are
      aligned via each file's epoch anchor, colliding pids remapped, and
      spans sharing an intent-nonce trace id across processes joined with
      synthetic flow arrows — a kill -9 failover mid-attach renders as
      intent-by-A → adopted-by-B across two process rails.

  explain <cr> [--addr host:port] [--file decisions.json] [--json]
      Print the scheduler's decision ring for one ComposabilityRequest —
      where it landed and why, what held it back and which resource was
      binding, whom it preempted and why that set was minimal. Reads a
      running operator's /debug/scheduler/explain/<cr> (default
      127.0.0.1:8081), or a $TPUC_DECISIONS_FILE crash dump with --file.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
from typing import List, Optional

from tpu_composer_torch.admission.validating import register_validating_webhooks
from tpu_composer_torch.agent.fake import FakeNodeAgent
from tpu_composer_torch.agent.nodeagent import LocalNodeAgent, NodeAgent
from tpu_composer_torch.controllers import (
    ComposabilityRequestReconciler,
    ComposableResourceReconciler,
    UpstreamSyncer,
)
from tpu_composer_torch.fabric.adapter import new_fabric_provider
from tpu_composer_torch.runtime.manager import Manager
from tpu_composer_torch.runtime.store import Store


def _env_float(name: str, default: float) -> float:
    """Env knob holding a number; a malformed value must die as a clean
    startup error, not an argparse-construction traceback."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise SystemExit(f"bad {name}={raw!r}: expected a plain number")


def _env_seconds(name: str, default: float) -> float:
    return _env_float(name, default)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise SystemExit(f"bad {name}={raw!r}: expected an integer")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-composer",
        description="composable-resource operator for TPU slices and"
                    " NVIDIA H100 hosts",
    )
    # Reference flags (cmd/main.go:68-81); one HTTP server carries health,
    # readiness and Prometheus metrics.
    p.add_argument(
        "--health-probe-bind-address",
        default=":8081",
        help="host:port for /healthz, /readyz and /metrics (empty to disable)",
    )
    p.add_argument(
        "--port-file",
        default=os.environ.get("TPUC_PORT_FILE", ""),
        help="after startup, write a JSON line {\"pid\", \"health_port\","
             " \"replica_id\"} here. With a :0 health bind this is how a"
             " supervisor (fleet/proc.py) discovers the real bound port"
             " race-free (env TPUC_PORT_FILE)",
    )
    # Secure metrics (reference cmd/main.go:109-127: HTTPS + authn/authz
    # filter; here TLS + bearer-token authorization from a mounted secret).
    p.add_argument(
        "--metrics-bind-address",
        default="",
        help="host:port for the dedicated secure /metrics endpoint"
             " (empty: metrics stay on the health port, plain HTTP)",
    )
    p.add_argument(
        "--metrics-cert", default="",
        help="TLS certificate for the metrics endpoint",
    )
    p.add_argument(
        "--metrics-key", default="",
        help="TLS key for the metrics endpoint",
    )
    p.add_argument(
        "--metrics-token-file", default="",
        help="file holding the bearer token scrapers must present"
             " (re-read per request; empty disables authorization)",
    )
    p.add_argument(
        "--leader-elect",
        action="store_true",
        help="enable leader election (file-lock based) before starting controllers",
    )
    p.add_argument(
        "--leader-lock-path",
        default=None,
        help="leader lock file (default under TPUC_RUN_DIR)",
    )
    # Sharded control plane (runtime/shards.py): K shard leases, N active
    # replicas each CAS-owning a balanced subset of object keys (crc32
    # consistent hash). --shards 1 is bit-identical to the single-leader
    # path: none of the shard machinery is constructed.
    p.add_argument(
        "--shards",
        type=int,
        default=_env_int("TPUC_SHARDS", 1),
        help="number of control-plane shard leases (K). 1 (default) keeps"
             " today's single-active-leader behavior unchanged; K>1 lets N"
             " replicas each own a hash partition of CR keys, with live"
             " handoff (scoped adoption) on failover/rebalance and"
             " monotonic-deadline fencing on lease loss"
             " (env TPUC_SHARDS)",
    )
    p.add_argument(
        "--shard-replicas",
        type=int,
        default=_env_int("TPUC_SHARD_REPLICAS", 0),
        help="expected operator replica count (N). Purely a startup damper:"
             " for the first lease duration a booting replica caps its grab"
             " at ceil(K/N) so a rolling deploy doesn't churn shards through"
             " replica-1; live membership (renewing replicas) governs the"
             " balance target afterwards. 0 disables"
             " (env TPUC_SHARD_REPLICAS)",
    )
    p.add_argument(
        "--replica-id",
        default=os.environ.get("TPUC_REPLICA_ID", ""),
        help="stable replica identity for shard/member leases, fleet"
             " telemetry and trace process names. Default: a fresh"
             " hostname_uuid per boot. Supervisors (fleet/proc.py) pin it"
             " so /debug/fleet and trace-merge attribute real pids without"
             " collision remapping across restarts"
             " (env TPUC_REPLICA_ID)",
    )
    p.add_argument(
        "--lease-duration",
        type=float,
        default=_env_seconds("TPUC_LEASE_DURATION", 15.0),
        help="seconds a leader/shard lease stays valid without renewal —"
             " the failover budget: a crashed replica's keys migrate to a"
             " survivor within one lease duration"
             " (env TPUC_LEASE_DURATION)",
    )
    p.add_argument(
        "--lease-renew-period",
        type=float,
        default=_env_seconds("TPUC_LEASE_RENEW_PERIOD", 5.0),
        help="seconds between lease renewals; the fencing deadline (stop"
             " acting when renewals keep failing) defaults to 2/3 of"
             " --lease-duration and is measured on the monotonic clock"
             " (env TPUC_LEASE_RENEW_PERIOD)",
    )
    p.add_argument(
        "--state-dir",
        default=os.environ.get("TPUC_STATE_DIR", ""),
        help="persist API objects under this directory (empty: in-memory only)",
    )
    # Cluster mode (reference: client-go kubeconfig/in-cluster loading,
    # cmd/main.go:161-165). Selecting a real apiserver replaces the
    # standalone store: CRs come from kubectl, nodes from kubelet.
    p.add_argument(
        "--kubeconfig",
        default="",
        help="kubeconfig path — run against a real kube-apiserver via "
             "KubeStore ($KUBECONFIG is honored unless --state-dir or "
             "--no-in-cluster selects the standalone store)",
    )
    p.add_argument(
        "--namespace",
        default=os.environ.get("TPUC_NAMESPACE", "tpu-composer-system"),
        help="namespace for the operator's namespaced objects (leader/"
             "shard Leases) in cluster mode (env TPUC_NAMESPACE)",
    )
    p.add_argument(
        "--in-cluster",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="use the pod service account to reach the apiserver. Default: "
             "auto — in-cluster when a service account token is mounted AND "
             "no --state-dir/TPUC_STATE_DIR configures standalone mode; "
             "--no-in-cluster forces the standalone store inside a pod",
    )
    p.add_argument(
        "--cached-reads",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_CACHED_READS", "1") != "0",
        help="serve controller get/list from a watch-fed informer cache;"
             " only writes pay an apiserver round trip (controller-runtime"
             " parity). --no-cached-reads or TPUC_CACHED_READS=0 reads the"
             " store directly on every call (escape hatch; semantics are"
             " identical, latency is not)",
    )
    p.add_argument(
        "--native-sched",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="run placement decisions on the watch-maintained chip-index"
             " snapshot, scanned by the native kernel"
             " (native/tpusched.cc, built at first use by the host C++"
             " compiler). --no-native-sched or TPUC_NATIVE_SCHED=0"
             " restores the legacy per-decision store walks. Default:"
             " enabled (env TPUC_NATIVE_SCHED)",
    )
    p.add_argument(
        "--wire-mux",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_WIRE_MUX", "1") != "0",
        help="carry every store verb AND watch of this replica on ONE"
             " persistent framed connection (tpuc-mux/1: length-prefixed"
             " JSON frames, correlation-id pipelining, watches as"
             " server-push streams) instead of per-request keep-alive HTTP"
             " plus one dedicated connection per watch. Falls back to HTTP"
             " automatically when the apiserver has no /mux endpoint."
             " --no-wire-mux or TPUC_WIRE_MUX=0 forces the HTTP path"
             " bit-identically (cluster mode only; the standalone store"
             " has no wire)",
    )
    p.add_argument(
        "--wire-ping-period",
        type=float,
        default=_env_seconds("TPUC_WIRE_PING_PERIOD", 5.0),
        help="seconds between mux liveness ping frames; a pong outstanding"
             " past --wire-ping-misses periods declares the framed"
             " connection dead and fails every pending verb and watch at"
             " once instead of waiting out per-request timeouts. 0 (or"
             " TPUC_WIRE_PING=0) disables pings entirely (env"
             " TPUC_WIRE_PING_PERIOD)",
    )
    p.add_argument(
        "--wire-ping-misses",
        type=int,
        default=_env_int("TPUC_WIRE_PING_MISSES", 2),
        help="mux liveness deadline in ping periods: with a ping"
             " outstanding, the connection is declared dead once NO frame"
             " of any kind has arrived for (misses + 0.5) ping periods —"
             " frame-age, so a busy wire never false-positives; worst-case"
             " detection from stall onset is (misses + 0.75) periods (env"
             " TPUC_WIRE_PING_MISSES)",
    )
    p.add_argument(
        "--wire-mux-max-fails",
        type=int,
        default=_env_int("TPUC_WIRE_MUX_MAX_FAILS", 5),
        help="flap damper for the mux->HTTP fallback: degrade to plain"
             " HTTP only after this many CONSECUTIVE mux connection"
             " failures (failed dials / connections dead before a single"
             " frame); per-request failures never count and any healthy"
             " frame resets the streak (env TPUC_WIRE_MUX_MAX_FAILS)",
    )
    p.add_argument(
        "--wire-connect-timeout",
        type=float,
        default=_env_seconds("TPUC_WIRE_CONNECT_TIMEOUT", 5.0),
        help="seconds a mux (re)dial may take before failing fast — bounds"
             " how long a store call can wedge on an unreachable apiserver"
             " during a partition (env TPUC_WIRE_CONNECT_TIMEOUT)",
    )
    p.add_argument(
        "--fabric-batch",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_FABRIC_BATCH", "1") != "0",
        help="route attach/detach through the FabricDispatcher: same-node"
             " submissions coalesce into one group provider call, fabric"
             " waits are polled off-worker with one shared per-node pass,"
             " and completions re-enqueue the CR immediately."
             " --no-fabric-batch or TPUC_FABRIC_BATCH=0 restores direct"
             " blocking fabric calls inside reconcile workers",
    )
    p.add_argument(
        "--fabric-batch-window",
        type=float,
        default=_env_seconds("TPUC_FABRIC_BATCH_WINDOW", 0.02),
        help="seconds a fabric submission waits for same-node companions"
             " before dispatch (the batching/latency trade; env"
             " TPUC_FABRIC_BATCH_WINDOW)",
    )
    p.add_argument(
        "--fabric-events",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_FABRIC_EVENTS", "1") != "0",
        help="hold one persistent event session per fabric endpoint"
             " (server-push op completions, health transitions, inventory"
             " deltas; GET /v1/events for REST backends): completions"
             " settle dispatcher ops the moment the fabric finishes, and"
             " the re-poll pass stretches to a safety net. Providers"
             " without an event stream keep polling unchanged."
             " --no-fabric-events or TPUC_FABRIC_EVENTS=0 restores the"
             " poll-driven completion path bit-identically",
    )
    p.add_argument(
        "--fabric-poll-fallback-mult",
        type=float,
        default=_env_float("TPUC_FABRIC_POLL_FALLBACK_MULT", 20.0),
        help="while the event session is streaming, fabric-pending ops"
             " park at poll_interval times this factor (the safety-net"
             " cadence; anything the net catches counts"
             " tpuc_fabric_poll_fallbacks_total). Session loss snaps"
             " parked polls back to the tight poll_interval"
             " (env TPUC_FABRIC_POLL_FALLBACK_MULT)",
    )
    p.add_argument(
        "--fabric-concurrency",
        type=int,
        default=int(os.environ.get("TPUC_FABRIC_CONCURRENCY", "8")),
        help="dispatcher worker threads — concurrent fabric calls across"
             " nodes (per-node calls are always serialized FIFO; env"
             " TPUC_FABRIC_CONCURRENCY)",
    )
    p.add_argument(
        "--drain-timeout",
        type=float,
        default=_env_seconds("TPUC_DRAIN_TIMEOUT", 8.0),
        help="seconds a graceful shutdown (SIGTERM / leader handoff) waits"
             " for in-flight fabric ops to settle and their outcomes to be"
             " consumed before releasing the leader lease; <= 0 disables —"
             " in-flight intent then recovers via the cold-start adoption"
             " pass on the next start (env TPUC_DRAIN_TIMEOUT)",
    )
    # Store-layer chaos (runtime/chaosstore.py): the apiserver twin of the
    # fabric chaos knobs; all default off. See docs/OPERATIONS.md for the
    # watch-drop/cached-reads pairing caveat.
    p.add_argument(
        "--chaos-store-failure-rate", type=float,
        default=_env_float("TPUC_CHAOS_STORE_FAILURE_RATE", 0.0),
        help="probability each store call fails with a transient error"
             " (fault-injection soaks only; env TPUC_CHAOS_STORE_FAILURE_RATE)",
    )
    p.add_argument(
        "--chaos-store-conflict-rate", type=float,
        default=_env_float("TPUC_CHAOS_STORE_CONFLICT_RATE", 0.0),
        help="probability each mutating store call fails with a resource-"
             "version conflict (env TPUC_CHAOS_STORE_CONFLICT_RATE)",
    )
    p.add_argument(
        "--chaos-store-latency", type=float,
        default=_env_seconds("TPUC_CHAOS_STORE_LATENCY", 0.0),
        help="seconds of injected latency per store call"
             " (env TPUC_CHAOS_STORE_LATENCY)",
    )
    p.add_argument(
        "--chaos-store-watch-drop-rate", type=float,
        default=_env_float("TPUC_CHAOS_STORE_WATCH_DROP_RATE", 0.0),
        help="probability each watch event is dropped; pair with"
             " --no-cached-reads (the informer has no periodic resync;"
             " env TPUC_CHAOS_STORE_WATCH_DROP_RATE)",
    )
    p.add_argument(
        "--chaos-store-seed", type=int,
        default=_env_int("TPUC_CHAOS_STORE_SEED", 0),
        help="RNG seed for the store chaos injector"
             " (env TPUC_CHAOS_STORE_SEED)",
    )
    # Observability (runtime/tracing.py + runtime/lifecycle.py): causal
    # spans with cross-thread flow arrows, per-CR lifecycle timelines, and
    # the crash flight recorder. All on by default; the files are opt-in.
    p.add_argument(
        "--trace",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_TRACE", "1") != "0",
        help="record causal control-plane traces (spans + cross-thread flow"
             " arrows; /debug/traces serves them as Chrome trace-event"
             " JSON). --no-trace or TPUC_TRACE=0 turns recording into a"
             " no-op",
    )
    p.add_argument(
        "--trace-events",
        type=int,
        default=_env_int("TPUC_TRACE_EVENTS", 10_000),
        help="trace ring capacity in events; oldest events fall off"
             " (env TPUC_TRACE_EVENTS)",
    )
    p.add_argument(
        "--trace-file",
        default=os.environ.get("TPUC_TRACE_FILE", ""),
        help="write the trace ring (Chrome trace-event JSON) here at clean"
             " stop, on drain-timeout, and from the crash hooks"
             " (env TPUC_TRACE_FILE; empty disables the file)",
    )
    p.add_argument(
        "--flight-file",
        default=os.environ.get("TPUC_FLIGHT_FILE", ""),
        help="write the flight-recorder black box (last-N state"
             " transitions, span summaries and events per CR) here on"
             " drain-timeout and from the crash hooks"
             " (env TPUC_FLIGHT_FILE; empty disables the dump)",
    )
    # Control-plane observatory (runtime/profiler.py + runtime/contention
    # + runtime/slo.py): always-on sampling profiler with per-subsystem
    # GIL-wait estimates, lock-contention histograms, and the SLO engine
    # with multi-window burn-rate alerts. One knob gates all three.
    p.add_argument(
        "--profile",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_PROFILE", "1") != "0",
        help="run the control-plane observatory: the always-on stack"
             " sampler (/debug/profile/continuous), lock wait/hold"
             " histograms on the hot locks, and SLO burn-rate evaluation"
             " (/debug/slo). --no-profile or TPUC_PROFILE=0 disables all"
             " three. The on-demand /debug/profile burst endpoint works"
             " either way",
    )
    p.add_argument(
        "--profile-interval",
        type=float,
        default=_env_seconds("TPUC_PROFILE_INTERVAL", 0.05),
        help="always-on sampler tick, seconds (env TPUC_PROFILE_INTERVAL)",
    )
    p.add_argument(
        "--profile-window",
        type=float,
        default=_env_seconds("TPUC_PROFILE_WINDOW", 10.0),
        help="seconds per continuous-profile window; the ring keeps the"
             " most recent 30 windows (env TPUC_PROFILE_WINDOW)",
    )
    # Lockdep witness (tpu_composer_torch/analysis/lockdep.py): ObservedLock
    # feeds per-thread held-lock stacks into a global acquisition-order
    # graph; a cycle is a potential ABBA deadlock. The test suite runs it
    # strict (raise at the offending acquire); in production it records
    # reports served on /debug/lockdep.
    p.add_argument(
        "--lockdep",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_LOCKDEP", "0") == "1",
        help="enable the lock-order witness on the observed hot locks:"
             " acquisition-order cycles (potential ABBA deadlocks) are"
             " recorded and served on /debug/lockdep (env TPUC_LOCKDEP;"
             " default off — the suite-wide strict mode lives in the test"
             " conftest)",
    )
    p.add_argument(
        "--lockdep-file",
        default=os.environ.get("TPUC_LOCKDEP_FILE", ""),
        help="dump the lockdep order graph + cycle reports here on"
             " shutdown (env TPUC_LOCKDEP_FILE; empty disables)",
    )
    p.add_argument(
        "--profile-file",
        default=os.environ.get("TPUC_PROFILE_FILE", ""),
        help="write the continuous-profile ring here from the crash hooks"
             " (the soak failure artifact; env TPUC_PROFILE_FILE)",
    )
    p.add_argument(
        "--slo-attach-p99",
        type=float,
        default=_env_seconds("TPUC_SLO_ATTACH_P99", 5.0),
        help="attach-to-ready p99 objective, seconds (<= 0 disables this"
             " objective; env TPUC_SLO_ATTACH_P99)",
    )
    p.add_argument(
        "--slo-completion-p50",
        type=float,
        default=_env_seconds("TPUC_SLO_COMPLETION_P50", 1.0),
        help="fabric completion-notification p50 objective, seconds"
             " (env TPUC_SLO_COMPLETION_P50)",
    )
    p.add_argument(
        "--slo-queue-p99",
        type=float,
        default=_env_seconds("TPUC_SLO_QUEUE_P99", 1.0),
        help="work-queue wait p99 objective, seconds"
             " (env TPUC_SLO_QUEUE_P99)",
    )
    p.add_argument(
        "--slo-repair-p99",
        type=float,
        default=_env_seconds("TPUC_SLO_REPAIR_P99", 120.0),
        help="self-healing time-to-replace p99 objective, seconds"
             " (env TPUC_SLO_REPAIR_P99)",
    )
    p.add_argument(
        "--slo-fast-window",
        type=float,
        default=_env_seconds("TPUC_SLO_FAST_WINDOW", 60.0),
        help="fast burn-rate window, seconds — reactivity and recovery"
             " (env TPUC_SLO_FAST_WINDOW)",
    )
    p.add_argument(
        "--slo-slow-window",
        type=float,
        default=_env_seconds("TPUC_SLO_SLOW_WINDOW", 600.0),
        help="slow burn-rate window, seconds — blip filtering: the alert"
             " fires only when BOTH windows burn above the threshold"
             " (env TPUC_SLO_SLOW_WINDOW)",
    )
    p.add_argument(
        "--slo-burn-threshold",
        type=float,
        default=_env_float("TPUC_SLO_BURN_THRESHOLD", 2.0),
        help="burn-rate multiple that fires the alert (1.0 = consuming"
             " exactly the error budget; env TPUC_SLO_BURN_THRESHOLD)",
    )
    p.add_argument(
        "--slo-file",
        default=os.environ.get("TPUC_SLO_FILE", ""),
        help="write the /debug/slo snapshot here from the crash hooks"
             " (env TPUC_SLO_FILE)",
    )
    # Scheduler decision observatory (scheduler/ledger.py +
    # runtime/goodput.py + runtime/capacity.py): every placement decision
    # explains itself, goodput accounting rides the lifecycle tracker,
    # and the capacity timeline samples the supply curve. One knob.
    p.add_argument(
        "--decisions",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_DECISIONS", "1") != "0",
        help="run the scheduler decision observatory: a per-CR decision"
             " ledger (inputs digest, candidate verdicts, tiebreak and"
             " binding-constraint rationale; /debug/scheduler/explain/"
             "<name> and `tpu-composer explain <cr>`), per-request goodput"
             " accounting (tpuc_goodput_ratio + the goodput SLO"
             " objective), and the capacity timeline sampler"
             " (/debug/scheduler/capacity). --no-decisions or"
             " TPUC_DECISIONS=0 constructs none of it",
    )
    p.add_argument(
        "--decisions-file",
        default=os.environ.get("TPUC_DECISIONS_FILE", ""),
        help="write the decision ring here from the crash hooks (the soak"
             " failure artifact beside the flight/profile/SLO/fleet black"
             " boxes; env TPUC_DECISIONS_FILE)",
    )
    p.add_argument(
        "--capacity-sample-period",
        type=float,
        default=_env_seconds("TPUC_CAPACITY_SAMPLE_PERIOD", 5.0),
        help="seconds between capacity-timeline samples (largest-"
             "placeable-slice, free-chip distribution, fragmentation,"
             " goodput; env TPUC_CAPACITY_SAMPLE_PERIOD)",
    )
    p.add_argument(
        "--slo-goodput-target",
        type=float,
        default=_env_float("TPUC_SLO_GOODPUT_TARGET", 0.95),
        help="goodput SLO target: the fraction of accounted request wall"
             " time that must be Ready-serving (0.95 = a 5%% lost-time"
             " budget; burn-rate alerting like every other objective;"
             " <= 0 or --no-decisions drops the objective"
             " (env TPUC_SLO_GOODPUT_TARGET)",
    )
    # Fleet observatory (runtime/fleet.py): every replica publishes a
    # telemetry snapshot into the shared store and aggregates everyone's,
    # so /debug/fleet and tpuc_fleet_* read the same from any replica.
    p.add_argument(
        "--fleet",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_FLEET", "1") != "0",
        help="run the fleet observatory: publish this replica's telemetry"
             " snapshot (histogram bucket state, SLO burn rates, GIL"
             " ratios, owned shards) into the shared store each period,"
             " aggregate every replica's into fleet-merged SLOs and"
             " tpuc_fleet_* gauges, serve /debug/fleet, and tag trace"
             " events with the replica identity as the Chrome trace pid"
             " (what the trace-merge subcommand stitches on)."
             " --no-fleet or TPUC_FLEET=0 constructs none of it",
    )
    p.add_argument(
        "--fleet-publish-period",
        type=float,
        default=_env_seconds("TPUC_FLEET_PUBLISH_PERIOD", 2.0),
        help="seconds between fleet telemetry publishes (and aggregation"
             " ticks; env TPUC_FLEET_PUBLISH_PERIOD)",
    )
    p.add_argument(
        "--fleet-stale-after",
        type=float,
        default=_env_seconds("TPUC_FLEET_STALE_AFTER", 0.0),
        help="seconds a replica's snapshot sequence number may sit"
             " unchanged on THIS replica's monotonic clock before the"
             " replica is considered dead and leaves every fleet"
             " aggregate (0 = 5x the publish period; the leases'"
             " observation-clock discipline — wall jumps can neither"
             " hasten nor mask the ageing; env TPUC_FLEET_STALE_AFTER)",
    )
    p.add_argument(
        "--fleet-file",
        default=os.environ.get("TPUC_FLEET_FILE", ""),
        help="write the /debug/fleet view here from the crash hooks"
             " (the soak failure artifact; env TPUC_FLEET_FILE)",
    )
    # Self-healing data plane (post-Ready failure detection + repair):
    # per-request policy lives on ComposabilityRequest.spec (repairPolicy /
    # maxConcurrentRepairs / repairGraceSeconds); these are the fleet-wide
    # detection and storm-containment knobs.
    p.add_argument(
        "--health-failure-threshold",
        type=int,
        default=_env_int("TPUC_HEALTH_FAILURE_THRESHOLD", 3),
        help="consecutive failed fabric health probes before an Online"
             " member goes Degraded (flap damping: below this nothing is"
             " written; env TPUC_HEALTH_FAILURE_THRESHOLD)",
    )
    p.add_argument(
        "--node-degrade-threshold",
        type=int,
        default=_env_int("TPUC_NODE_DEGRADE_THRESHOLD", 3),
        help="Degraded transitions on one node within 10 min that escalate"
             " to a durable node quarantine (reason post-ready-failures);"
             " <= 0 disables (env TPUC_NODE_DEGRADE_THRESHOLD)",
    )
    p.add_argument(
        "--repair-breaker-fraction",
        type=float,
        default=_env_float("TPUC_REPAIR_BREAKER_FRACTION", 0.5),
        help="freeze ALL repairs while more than this fraction of attached"
             " members is Degraded/Repairing at once — a brownout is a"
             " fabric problem; mass-detaching would amplify it"
             " (env TPUC_REPAIR_BREAKER_FRACTION)",
    )
    p.add_argument(
        "--repair-breaker-min-members",
        type=int,
        default=_env_int("TPUC_REPAIR_BREAKER_MIN_MEMBERS", 4),
        help="repair breaker only arms at this many attached members —"
             " a tiny fleet's single failure is not a brownout"
             " (env TPUC_REPAIR_BREAKER_MIN_MEMBERS)",
    )
    # Live migration + node maintenance drains: the make-before-break verb
    # that evacuates capacity (NodeMaintenance drains, node-escalation
    # evacuation, defrag) without killing the job.
    p.add_argument(
        "--migrate",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_MIGRATE", "1") != "0",
        help="enable the live-migration verb: the NodeMaintenance drain"
             " controller, the request controllers' migration driver"
             " (healthy members marked for evacuation move"
             " make-before-break), node-escalation evacuation, and the"
             " defrag executor's migrate mode. --no-migrate or"
             " TPUC_MIGRATE=0 constructs none of it — no maintenance"
             " controller, no evacuations, defrag back to delete/re-solve"
             " — bit-identical to the pre-migration operator",
    )
    p.add_argument(
        "--migrate-max-concurrent",
        type=int,
        default=_env_int("TPUC_MIGRATE_MAX_CONCURRENT", 2),
        help="fleet-wide cap on members migrating at once — an N-node"
             " maintenance wave trickles instead of stampeding"
             " (per-request surge stays spec.maxConcurrentRepairs;"
             " env TPUC_MIGRATE_MAX_CONCURRENT)",
    )
    p.add_argument(
        "--migrate-breaker-fraction",
        type=float,
        default=_env_float("TPUC_MIGRATE_BREAKER_FRACTION", 0.25),
        help="freeze NEW evacuations (and park cutover detaches) while"
             " more than this fraction of attached members is"
             " Degraded/Repairing — a brownout must never trigger a mass"
             " evacuation; deliberately tighter than the repair breaker"
             " (env TPUC_MIGRATE_BREAKER_FRACTION)",
    )
    p.add_argument(
        "--migrate-drain-deadline",
        type=float,
        default=_env_seconds("TPUC_MIGRATE_DRAIN_DEADLINE", 1800.0),
        help="default NodeMaintenance drain deadline, seconds (applies"
             " when spec.deadline_seconds is 0; a drain that cannot"
             " finish aborts — marks withdrawn, node uncordoned — instead"
             " of wedging half-drained; <= 0 disables the default;"
             " env TPUC_MIGRATE_DRAIN_DEADLINE)",
    )
    p.add_argument(
        "--repair-dwell",
        type=float,
        default=_env_seconds("TPUC_REPAIR_DWELL", 0.0),
        help="seconds a member must stay Degraded before a repair may act"
             " on it — gives a lifting brownout's tail members their"
             " chance to recover in place instead of being replaced"
             " (env TPUC_REPAIR_DWELL)",
    )
    # Control-plane survival layer (runtime/overload.py, storebreaker.py,
    # watchdog.py): the governor degrades by policy under overload, the
    # store breaker rides out apiserver outages, the watchdog catches
    # wedged subsystems. Three independent escape hatches.
    p.add_argument(
        "--overload",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_OVERLOAD", "1") != "0",
        help="run the overload governor: fold queue depth, worker"
             " saturation, queue-wait p99, SLO burn and breaker states"
             " into an Ok/Warn/Shed state with hysteresis"
             " (tpuc_overload_state, /debug/overload). Warn stretches"
             " non-critical cadences (defrag, capacity sampler, fleet"
             " publish, ledger rescans); Shed additionally defers"
             " low-priority request reconciles, each deferral ledgered as"
             " a hold-back with reason=overload. --no-overload or"
             " TPUC_OVERLOAD=0 constructs none of it",
    )
    p.add_argument(
        "--overload-period",
        type=float,
        default=_env_seconds("TPUC_OVERLOAD_PERIOD", 1.0),
        help="seconds between governor evaluation ticks"
             " (env TPUC_OVERLOAD_PERIOD)",
    )
    p.add_argument(
        "--overload-depth-warn",
        type=int,
        default=_env_int("TPUC_OVERLOAD_DEPTH_WARN", 256),
        help="summed controller queue depth entering Warn"
             " (env TPUC_OVERLOAD_DEPTH_WARN)",
    )
    p.add_argument(
        "--overload-depth-shed",
        type=int,
        default=_env_int("TPUC_OVERLOAD_DEPTH_SHED", 1024),
        help="summed controller queue depth entering Shed"
             " (env TPUC_OVERLOAD_DEPTH_SHED)",
    )
    p.add_argument(
        "--overload-priority-cutoff",
        type=int,
        default=_env_int("TPUC_OVERLOAD_PRIORITY_CUTOFF", 50),
        help="requests with spec.priority below this are shed-eligible;"
             " >= keeps the tight path even while shedding"
             " (env TPUC_OVERLOAD_PRIORITY_CUTOFF)",
    )
    p.add_argument(
        "--overload-shed-quantum",
        type=float,
        default=_env_seconds("TPUC_OVERLOAD_SHED_QUANTUM", 5.0),
        help="defer quantum for shed reconciles, seconds (jittered to"
             " U(0.5, 1.0)x so releases spread;"
             " env TPUC_OVERLOAD_SHED_QUANTUM)",
    )
    p.add_argument(
        "--overload-stretch",
        type=float,
        default=_env_float("TPUC_OVERLOAD_STRETCH", 4.0),
        help="multiplier applied to non-critical cadences while in"
             " Warn/Shed (env TPUC_OVERLOAD_STRETCH)",
    )
    p.add_argument(
        "--store-breaker",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_STORE_BREAKER", "1") != "0",
        help="wrap the object store in a circuit breaker UNDER the read"
             " cache: consecutive StoreErrors trip it open (writes fail"
             " fast into per-key backoff, informer reads keep serving),"
             " a half-open probe closes it, and the close edge paces the"
             " resync herd through a token bucket"
             " (tpuc_store_breaker_open, /debug/storebreaker)."
             " --no-store-breaker or TPUC_STORE_BREAKER=0 constructs"
             " none of it",
    )
    p.add_argument(
        "--store-breaker-threshold",
        type=int,
        default=_env_int("TPUC_STORE_BREAKER_THRESHOLD", 5),
        help="consecutive store failures (StoreError; 409/404 reset the"
             " streak) that trip the breaker open"
             " (env TPUC_STORE_BREAKER_THRESHOLD)",
    )
    p.add_argument(
        "--store-breaker-reset",
        type=float,
        default=_env_seconds("TPUC_STORE_BREAKER_RESET", 5.0),
        help="seconds (±20%% jitter) before an open store breaker admits"
             " its half-open probe (env TPUC_STORE_BREAKER_RESET)",
    )
    p.add_argument(
        "--store-breaker-resync-rate",
        type=float,
        default=_env_float("TPUC_STORE_BREAKER_RESYNC_RATE", 50.0),
        help="post-heal resync pacing, wire calls per second admitted"
             " through the recovery token bucket (tpuc_resync_paced_total"
             " counts paced callers; env TPUC_STORE_BREAKER_RESYNC_RATE)",
    )
    p.add_argument(
        "--store-breaker-resync-window",
        type=float,
        default=_env_seconds("TPUC_STORE_BREAKER_RESYNC_WINDOW", 2.0),
        help="seconds after a breaker close during which the pacing"
             " bucket gates wire calls; outside it the bucket is bypassed"
             " (env TPUC_STORE_BREAKER_RESYNC_WINDOW)",
    )
    p.add_argument(
        "--watchdog",
        action=argparse.BooleanOptionalAction,
        default=os.environ.get("TPUC_WATCHDOG", "1") != "0",
        help="run the subsystem watchdog: controller workers, dispatcher"
             " lanes and manager runnables heartbeat a registry; a stalled"
             " subsystem raises a WatchdogStall Event + flight-record +"
             " on-demand profiler burst of the wedged stack"
             " (tpuc_watchdog_stalls_total), restartable runnables are"
             " respawned inside a restart budget"
             " (tpuc_watchdog_restarts_total), and chronic stalls dump"
             " the black boxes. --no-watchdog or TPUC_WATCHDOG=0"
             " constructs none of it",
    )
    p.add_argument(
        "--watchdog-stall-after",
        type=float,
        default=_env_seconds("TPUC_WATCHDOG_STALL_AFTER", 30.0),
        help="seconds without a heartbeat before a subsystem is flagged"
             " stalled (healthy workers beat multiple times per second,"
             " so the default has wide false-positive margin;"
             " env TPUC_WATCHDOG_STALL_AFTER)",
    )
    p.add_argument(
        "--watchdog-restart-budget",
        type=int,
        default=_env_int("TPUC_WATCHDOG_RESTART_BUDGET", 3),
        help="restarts allowed per restartable subsystem; past it the"
             " watchdog stops restarting and dumps the black boxes"
             " (env TPUC_WATCHDOG_RESTART_BUDGET)",
    )
    p.add_argument(
        "--workers",
        type=int,
        default=8,
        help="reconcile worker threads per controller (reconciles are "
             "IO-bound — apiserver RTTs and fabric waits — and the queue "
             "serializes per object, so workers scale attach fan-out: an "
             "8-host slice's children attach as one wave instead of four)",
    )
    p.add_argument(
        "--sync-period",
        type=float,
        default=60.0,
        help="upstream fabric anti-drift sync period, seconds (reference: 60)",
    )
    p.add_argument(
        "--sync-grace",
        type=float,
        default=600.0,
        help="grace before orphaned fabric devices are force-detached (reference: 600)",
    )
    p.add_argument(
        "--defrag-interval",
        type=float,
        default=_env_seconds("TPUC_DEFRAG_INTERVAL", 0.0),
        help="seconds between defragmentation planner passes (0 disables;"
             " env TPUC_DEFRAG_INTERVAL)",
    )
    p.add_argument(
        "--defrag-execute",
        action="store_true",
        default=os.environ.get("TPUC_DEFRAG_EXECUTE", "") == "1",
        help="execute defrag plans (migrate workers via re-solve) instead"
             " of dry-run logging them (env TPUC_DEFRAG_EXECUTE=1)",
    )
    p.add_argument(
        "--webhook-bind-address",
        default=os.environ.get("WEBHOOK_BIND_ADDRESS", ""),
        help="host:port for the AdmissionReview webhook server "
             "(reference serves :9443; empty disables the HTTP server — "
             "in-process hooks still run)",
    )
    p.add_argument(
        "--webhook-cert",
        default=os.environ.get("WEBHOOK_TLS_CERT", ""),
        help="TLS certificate for the webhook server (cert-manager mount)",
    )
    p.add_argument(
        "--webhook-key",
        default=os.environ.get("WEBHOOK_TLS_KEY", ""),
        help="TLS key for the webhook server",
    )
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    return p


def pick_node_agent(store: Optional[Store] = None) -> NodeAgent:
    kind = os.environ.get("NODE_AGENT", "").upper()
    if not kind:
        provider = os.environ.get("CDI_PROVIDER_TYPE", "MOCK").upper()
        kind = "FAKE" if provider == "MOCK" else "LOCAL"
    if kind == "LOCAL":
        return LocalNodeAgent()
    if kind == "REMOTE":
        # Cluster mode: route to each node's agent DaemonSet pod via
        # Node.spec.agent_endpoint, with NODE_AGENT_ENDPOINT_TEMPLATE as
        # the fallback for nodes that never registered one
        # (deploy/node-agent.yaml hostPort).
        from tpu_composer_torch.agent.remote import RemoteNodeAgent

        if store is None:
            raise SystemExit("NODE_AGENT=REMOTE requires the store")
        return RemoteNodeAgent.from_store(
            store,
            endpoint_template=os.environ.get(
                "NODE_AGENT_ENDPOINT_TEMPLATE", "{node}:9444"
            ),
        )
    if kind == "FAKE":
        # Wired to the mock pool when that is the provider, so visibility
        # follows attachment in single-box/bench runs. With a remote
        # provider (proc-mode fleet: REST pool in another process) the
        # agent instead follows the fabric's own attachment listing — the
        # out-of-process analog of the same "chips enumerate once the
        # fabric programs the link" behavior.
        provider = new_fabric_provider()
        from tpu_composer_torch.fabric.inmem import InMemoryPool

        if isinstance(provider, InMemoryPool):
            return FakeNodeAgent(pool=provider)
        return FakeNodeAgent(fabric=provider)
    raise SystemExit(f"unknown NODE_AGENT {kind!r} (want FAKE or LOCAL)")


def build_store(args: argparse.Namespace):
    """Standalone in-proc store, or KubeStore when a cluster is configured.

    Precedence (most explicit wins):
      1. --kubeconfig <path>          → cluster
      2. --no-in-cluster              → standalone
      3. --in-cluster                 → cluster (service account)
      4. --state-dir / TPUC_STATE_DIR → standalone (an env-derived
         $KUBECONFIG or an auto-mounted pod token must not silently
         override an explicitly configured standalone deployment)
      5. $KUBECONFIG / mounted pod service-account token → cluster
      6. otherwise                    → standalone in-memory
    """
    log = logging.getLogger("setup")
    kubeconfig = getattr(args, "kubeconfig", "")
    in_cluster = getattr(args, "in_cluster", None)
    use_cluster = bool(kubeconfig)
    if not use_cluster:
        if in_cluster is False:
            use_cluster = False
        elif in_cluster is True:
            use_cluster = True
        elif args.state_dir:
            use_cluster = False
        else:
            use_cluster = bool(os.environ.get("KUBECONFIG")) or (
                os.environ.get("KUBERNETES_SERVICE_HOST", "") != ""
                and os.path.exists(
                    "/var/run/secrets/kubernetes.io/serviceaccount/token"
                )
            )
    if use_cluster:
        from tpu_composer_torch.runtime.kubestore import KubeConfig, KubeStore

        # KubeConfig.load owns the flag > $KUBECONFIG > in-cluster chain —
        # single source of truth for the resolution client-go encodes.
        cfg = (
            KubeConfig.in_cluster()
            if in_cluster is True and not kubeconfig
            else KubeConfig.load(kubeconfig or None)
        )
        log.info("store: kube-apiserver at %s", cfg.host)
        # KubeStore's reflector cache is the wire-path twin of the
        # standalone CachedClient — one flag governs both.
        store = KubeStore(
            config=cfg,
            cache_reads=getattr(args, "cached_reads", True),
            namespace=getattr(args, "namespace", None),
            wire_mux=getattr(args, "wire_mux", None),
            wire_ping_period=getattr(args, "wire_ping_period", None),
            wire_ping_misses=getattr(args, "wire_ping_misses", None),
            wire_mux_max_fails=getattr(args, "wire_mux_max_fails", None),
            wire_connect_timeout=getattr(args, "wire_connect_timeout", None),
        )
    else:
        log.info("store: standalone (state_dir=%s)",
                 args.state_dir or "<memory>")
        store = Store(persist_dir=args.state_dir or None)
    return _maybe_chaos_store(args, store, log)


def _maybe_chaos_store(args: argparse.Namespace, store, log):
    """Wrap the store in the chaos injector when any knob is on — same
    layer for the in-proc store and KubeStore (the faults land where wire
    faults would: between every client and the canonical state)."""
    rates = (
        getattr(args, "chaos_store_failure_rate", 0.0),
        getattr(args, "chaos_store_conflict_rate", 0.0),
        getattr(args, "chaos_store_latency", 0.0),
        getattr(args, "chaos_store_watch_drop_rate", 0.0),
    )
    if not any(r > 0 for r in rates):
        return store
    from tpu_composer_torch.runtime.chaosstore import ChaosStore

    log.warning(
        "store chaos ON (failure=%.3f conflict=%.3f latency=%.3fs"
        " watch_drop=%.3f seed=%d) — fault-injection mode",
        rates[0], rates[1], rates[2], rates[3],
        getattr(args, "chaos_store_seed", 0),
    )
    return ChaosStore(
        store,
        failure_rate=rates[0],
        conflict_rate=rates[1],
        latency=rates[2],
        watch_drop_rate=rates[3],
        seed=getattr(args, "chaos_store_seed", 0),
    )


def _configure_tracing(args: argparse.Namespace) -> None:
    """Apply the observability knobs before any traced code runs. The file
    destinations land in the env because the crash paths (atexit, thread
    excepthook, drain-timeout) read $TPUC_TRACE_FILE / $TPUC_FLIGHT_FILE —
    they must work even when no argparse namespace is reachable."""
    from tpu_composer_torch.runtime import tracing

    tracing.set_enabled(getattr(args, "trace", True))
    capacity = getattr(args, "trace_events", 0)
    if capacity > 0:
        # Unconditional: the ring is empty this early, so configure()'s
        # drop-contents side effect is moot.
        tracing.configure(capacity)
    if getattr(args, "trace_file", ""):
        os.environ["TPUC_TRACE_FILE"] = args.trace_file
    if getattr(args, "flight_file", ""):
        os.environ["TPUC_FLIGHT_FILE"] = args.flight_file
    # Observatory: one knob (--profile / TPUC_PROFILE) gates the sampler,
    # the lock-contention observations AND the SLO engine together.
    from tpu_composer_torch.runtime import contention, profiler

    on = getattr(args, "profile", True)
    profiler.set_enabled(on)
    contention.set_enabled(on)
    if getattr(args, "profile_file", ""):
        os.environ["TPUC_PROFILE_FILE"] = args.profile_file
    if getattr(args, "slo_file", ""):
        os.environ["TPUC_SLO_FILE"] = args.slo_file
    if getattr(args, "fleet_file", ""):
        os.environ["TPUC_FLEET_FILE"] = args.fleet_file
    if getattr(args, "decisions_file", ""):
        os.environ["TPUC_DECISIONS_FILE"] = args.decisions_file
    # Lockdep witness: production runs non-strict (record + serve on
    # /debug/lockdep — a detector must not crash a serving operator);
    # strict raising is the TEST suite's mode, enabled by conftest.
    if getattr(args, "lockdep", False):
        from tpu_composer_torch.analysis import lockdep

        lockdep.enable(strict=False)
    if getattr(args, "lockdep_file", ""):
        os.environ["TPUC_LOCKDEP_FILE"] = args.lockdep_file


def build_manager(args: argparse.Namespace) -> Manager:
    _configure_tracing(args)
    store = build_store(args)
    # Store circuit breaker (runtime/storebreaker.py), UNDER the read
    # cache so informer reads keep serving at zero RTT through an outage
    # while writes fail fast into per-key backoff. Deliberately NOT on
    # the `store` handle the electors/fleet use below: leases need their
    # own linearizable path, breaker-gated or not.
    storebreaker = None
    breaker_store = store
    if getattr(args, "store_breaker", True):
        from tpu_composer_torch.runtime.storebreaker import BreakingStore

        breaker_store = BreakingStore(
            store,
            failure_threshold=getattr(args, "store_breaker_threshold", 5),
            reset_timeout=getattr(args, "store_breaker_reset", 5.0),
            resync_rate=getattr(args, "store_breaker_resync_rate", 50.0),
            resync_window=getattr(args, "store_breaker_resync_window", 2.0),
        )
        storebreaker = breaker_store
    # Informer read cache (runtime/cache.py): controllers, scheduler,
    # syncer and admission all read through `client`; only writes reach
    # `store`. KubeStore passes through unchanged (it caches internally).
    from tpu_composer_torch.runtime.cache import maybe_cached

    client = maybe_cached(breaker_store, getattr(args, "cached_reads", True))
    from tpu_composer_torch.fabric.adapter import TracedFabricProvider

    # Every fabric verb becomes a trace span (runtime/tracing.py); the
    # wrapper delegates everything else, so pick_node_agent's
    # InMemoryPool-identity check keeps seeing the shared mock directly.
    fabric = TracedFabricProvider(new_fabric_provider())
    agent = pick_node_agent(client)

    addr = args.health_probe_bind_address or None
    if addr and addr.startswith(":"):
        addr = "0.0.0.0" + addr
    elector = None
    ownership = None
    shard_elector = None
    num_shards = max(1, getattr(args, "shards", 1))
    if num_shards > 1:
        # Sharded control plane: K shard leases replace the single global
        # leader — every replica is active on its owned key partition.
        # Requires a SHARED store (kube-apiserver, or a shared in-proc
        # store in tests/bench); --leader-elect is subsumed.
        from tpu_composer_torch.runtime.shards import ShardLeaseElector

        shard_elector = ShardLeaseElector(
            store,  # raw store, not the cache: leases need linearizable reads
            num_shards=num_shards,
            expected_replicas=max(0, getattr(args, "shard_replicas", 0)),
            lease_duration_s=getattr(args, "lease_duration", 15.0),
            renew_period_s=getattr(args, "lease_renew_period", 5.0),
            # Stable spawned-replica identity (proc-mode fleet): member
            # lease, fleet telemetry and trace pid all share this name.
            identity=getattr(args, "replica_id", "") or "",
        )
        ownership = shard_elector.ownership
        elector = shard_elector
        if args.leader_elect:
            logging.getLogger("setup").info(
                "--shards %d supersedes --leader-elect (every replica is"
                " active on its shard subset)", num_shards,
            )
    elif args.leader_elect:
        from tpu_composer_torch.runtime.chaosstore import ChaosStore
        from tpu_composer_torch.runtime.store import Store as _InProcStore

        raw_store = store._inner if isinstance(store, ChaosStore) else store
        if not isinstance(raw_store, _InProcStore):
            # Cluster mode: Lease-based election across replicas (reference
            # cmd/main.go:142-155); the file lock only fences one host.
            from tpu_composer_torch.runtime.leases import LeaseElector

            # The raw store, not the client: leader election needs
            # linearizable Lease reads (both cache layers exclude Leases,
            # but the intent belongs in the wiring too).
            elector = LeaseElector(
                store,
                lease_duration_s=getattr(args, "lease_duration", 15.0),
                renew_period_s=getattr(args, "lease_renew_period", 5.0),
            )
    maddr = args.metrics_bind_address or None
    if maddr and maddr.startswith(":"):
        maddr = "0.0.0.0" + maddr
    if maddr and args.metrics_token_file and not args.metrics_cert:
        # The whole point of the token is that it is a secret; serving it
        # over plaintext would broadcast it to the pod network on every
        # scrape. Refuse loudly instead of degrading silently.
        raise SystemExit(
            "--metrics-token-file requires --metrics-cert/--metrics-key:"
            " bearer tokens must not transit plain HTTP"
        )
    dispatcher = None
    if getattr(args, "fabric_batch", True):
        from tpu_composer_torch.fabric.dispatcher import FabricDispatcher

        # The dispatcher sits ABOVE the traced/breaker stack: every
        # provider call it issues (group or split) is traced and
        # breaker-guarded like a direct call would be.
        dispatcher = FabricDispatcher(
            fabric,
            batch_window=args.fabric_batch_window,
            concurrency=args.fabric_concurrency,
            # Shard fencing gate: lanes refuse ops for keys this replica
            # no longer owns (None = unsharded, no gate).
            owns=ownership.owns_key if ownership is not None else None,
            fallback_multiplier=getattr(args, "fabric_poll_fallback_mult", 20.0),
        )
    session = None
    if dispatcher is not None and getattr(args, "fabric_events", True):
        # Fabric event plane (fabric/events.py): one persistent session
        # per endpoint, server-push completions settling dispatcher ops.
        # Only meaningful WITH the dispatcher (the direct-call path blocks
        # inline and has nothing to push to); a provider without an event
        # stream answers the capability probe and the session goes
        # dormant, leaving polling primary.
        from tpu_composer_torch.fabric.events import FabricSession

        session = FabricSession(
            fabric, name=os.environ.get("FABRIC_ENDPOINT", "") or "fabric"
        )
        dispatcher.attach_session(session)
    # Scheduler decision observatory: the goodput tracker exists before
    # the SLO engine (its objective joins the engine's list at
    # construction) and before the fleet plane (which publishes its
    # counters). TPUC_DECISIONS=0 constructs none of this.
    decisions_on = getattr(args, "decisions", True)
    goodput_tracker = None
    if decisions_on:
        from tpu_composer_torch.runtime import lifecycle as lifecycle_mod
        from tpu_composer_torch.runtime.goodput import GoodputTracker

        goodput_tracker = GoodputTracker()
        # Fed by the manager's lifecycle watch; Manager.stop unregisters.
        lifecycle_mod.add_transition_sink(goodput_tracker.observe)
    profiler_inst = None
    slo_engine = None
    if getattr(args, "profile", True):
        from tpu_composer_torch.runtime.profiler import SamplingProfiler
        from tpu_composer_torch.runtime.slo import (
            GoodputObjective,
            SloEngine,
            default_objectives,
        )

        profiler_inst = SamplingProfiler(
            interval=getattr(args, "profile_interval", 0.05),
            window_s=getattr(args, "profile_window", 10.0),
        )
        objectives = default_objectives(
            attach_p99_s=getattr(args, "slo_attach_p99", 5.0),
            completion_p50_s=getattr(args, "slo_completion_p50", 1.0),
            queue_p99_s=getattr(args, "slo_queue_p99", 1.0),
            repair_p99_s=getattr(args, "slo_repair_p99", 120.0),
        )
        goodput_target = getattr(args, "slo_goodput_target", 0.95)
        if goodput_tracker is not None and goodput_target > 0:
            objectives.append(
                GoodputObjective(goodput_tracker, target=goodput_target)
            )
        slo_engine = SloEngine(
            objectives=objectives,
            fast_window=getattr(args, "slo_fast_window", 60.0),
            slow_window=getattr(args, "slo_slow_window", 600.0),
            burn_threshold=getattr(args, "slo_burn_threshold", 2.0),
        )
    fleet_plane = None
    replica_id = None
    if not getattr(args, "fleet", True):
        if shard_elector is not None:
            # --no-fleet means NO replica-tagged trace pids anywhere —
            # the elector's renew thread included (its default tagging
            # serves direct harness wiring, not the escape hatch).
            shard_elector.tag_traces = False
    else:
        # Fleet observatory: identity follows the shard/member lease
        # identity when sharded (the fleet view and the lease table must
        # name replicas identically), a fresh per-boot identity otherwise.
        from tpu_composer_torch.runtime import tracing as tracing_mod
        from tpu_composer_torch.runtime.fleet import FleetPlane
        from tpu_composer_torch.runtime.leases import default_identity

        replica_id = (
            shard_elector.identity if shard_elector is not None
            else getattr(args, "replica_id", "") or default_identity()
        )
        # Every trace event this process records carries the replica
        # identity as its Chrome trace pid — what `tpu-composer
        # trace-merge` stitches cross-process failovers on.
        tracing_mod.set_replica(replica_id)
        fleet_plane = FleetPlane(
            store,  # raw store, not the cache: snapshots ride beside leases
            identity=replica_id,
            num_shards=num_shards,
            ownership=ownership,
            publish_period=getattr(args, "fleet_publish_period", 2.0),
            stale_after_s=getattr(args, "fleet_stale_after", 0.0),
            attach_p99_s=getattr(args, "slo_attach_p99", 5.0),
            queue_p99_s=getattr(args, "slo_queue_p99", 1.0),
            fast_window=getattr(args, "slo_fast_window", 60.0),
            slow_window=getattr(args, "slo_slow_window", 600.0),
            burn_threshold=getattr(args, "slo_burn_threshold", 2.0),
            slo_engine=slo_engine,
            profiler=profiler_inst,
            goodput=goodput_tracker,
        )
    # Subsystem watchdog (runtime/watchdog.py): controller workers,
    # dispatcher lanes and the governor heartbeat it; Manager.start hands
    # it the runnable-respawn hook.
    watchdog = None
    if getattr(args, "watchdog", True):
        from tpu_composer_torch.runtime.watchdog import Watchdog

        watchdog = Watchdog(
            stall_after=getattr(args, "watchdog_stall_after", 30.0),
            restart_budget=getattr(args, "watchdog_restart_budget", 3),
        )
        if dispatcher is not None:
            dispatcher.watchdog = watchdog
    mgr = Manager(
        store=client,
        leader_elect=args.leader_elect,
        leader_lock_path=args.leader_lock_path,
        health_addr=addr,
        leader_elector=elector,
        metrics_addr=maddr,
        metrics_certfile=args.metrics_cert or None,
        metrics_keyfile=args.metrics_key or None,
        metrics_token_file=args.metrics_token_file or None,
        dispatcher=dispatcher,
        drain_timeout=getattr(args, "drain_timeout", 8.0),
        profiler=profiler_inst,
        slo_engine=slo_engine,
        replica_id=replica_id,
        fleet=fleet_plane,
        goodput=goodput_tracker,
        watchdog=watchdog,
        storebreaker=storebreaker,
    )
    if watchdog is not None:
        watchdog.recorder = mgr.recorder
        mgr.add_runnable(watchdog.run)
    if slo_engine is not None:
        # The engine's breach/recovery Events flow through the manager's
        # recorder (constructed just above).
        slo_engine.recorder = mgr.recorder
    if fleet_plane is not None:
        # Fleet SLO breach Events ride the same recorder as local ones.
        fleet_plane.slo.recorder = mgr.recorder
        mgr.add_runnable(fleet_plane.run)
    if dispatcher is not None:
        mgr.add_runnable(dispatcher.run)
    if session is not None:
        mgr.add_runnable(session.run)
    # Cold-start adoption (controllers/adoption.py): post-leader-acquire,
    # pre-controller-start, every durable pending_op intent is classified
    # against the live fabric — completed attaches are adopted into
    # status, never-issued ops cleared for re-submission, fabric-async
    # ops handed to the dispatcher's re-poll pass.
    from tpu_composer_torch.controllers.adoption import adopt_pending_ops

    if shard_elector is not None:
        # Shard acquisition IS the adoption trigger: every shard this
        # replica wins — at boot, on failover, on rebalance — runs the
        # cold-start adoption pass scoped to that shard's keys
        # BEFORE the shard is served (the live-handoff contract), then a
        # resync wave re-enqueues the moved keys into running controllers.
        # Losing a shard fences its dispatcher lanes.
        from tpu_composer_torch.runtime.shards import shard_for

        shard_elector.on_acquire.append(
            lambda wins: adopt_pending_ops(
                client, fabric, dispatcher,
                shards=set(wins), num_shards=num_shards,
            )
        )
        shard_elector.on_ready.append(
            lambda shards: mgr.resync(
                lambda key, _s=frozenset(shards):
                shard_for(key, num_shards) in _s
            )
        )
        if dispatcher is not None:
            shard_elector.on_lose.append(
                lambda shard, reason: dispatcher.abandon_unowned()
            )
    else:
        mgr.add_startup_hook(
            lambda: adopt_pending_ops(client, fabric, dispatcher)
        )
    from tpu_composer_torch.controllers.request_controller import (
        MigrateConfig,
        RepairConfig,
        RequestTiming,
    )
    from tpu_composer_torch.controllers.resource_controller import ResourceTiming
    from tpu_composer_torch.scheduler import ClusterScheduler, DefragLoop

    migrate_on = getattr(args, "migrate", True)
    # Defrag executor mode follows the migration switch: with the verb on,
    # executed plans become live make-before-break moves (safe against
    # running workloads); the escape hatch restores delete/re-solve.
    scheduler = ClusterScheduler(
        client, defrag_mode="migrate" if migrate_on else "delete",
        decisions=decisions_on, recorder=mgr.recorder,
        native_sched=getattr(args, "native_sched", None),
    )
    # Which kernel decisions will actually run on: "native" (packed
    # snapshot + libtpusched.so), "python" (snapshot, pure-Python port),
    # or "legacy" (per-decision store walks) — the fallback chain is
    # silent by design, so say where it landed.
    logging.getLogger("setup").info(
        "placement engine kernel: %s", scheduler.engine.kernel_kind
    )
    if scheduler.ledger is not None:
        # /debug/scheduler/explain/<name> + the crash-hook dump handle.
        mgr.decisions = scheduler.ledger
        if slo_engine is not None:
            # Queue-wait SLO breaches name their probable cause: the
            # dominant binding resource among recent hold-backs.
            slo_engine.annotators["queue_wait_p99"] = (
                scheduler.ledger.dominant_hold_back_reason
            )
        if fleet_plane is not None:
            fleet_plane.slo.annotators["fleet_queue_wait_p99"] = (
                scheduler.ledger.dominant_hold_back_reason
            )
    if decisions_on:
        from tpu_composer_torch.runtime.capacity import CapacityObservatory

        capacity_obs = CapacityObservatory(
            client, scheduler.engine, goodput=goodput_tracker,
            period=getattr(args, "capacity_sample_period", 5.0),
        )
        mgr.capacity = capacity_obs
        mgr.add_runnable(capacity_obs.run)
    repair_cfg = RepairConfig(
        breaker_fraction=getattr(args, "repair_breaker_fraction", 0.5),
        breaker_min_members=getattr(args, "repair_breaker_min_members", 4),
        min_degraded_seconds=getattr(args, "repair_dwell", 0.0),
    )
    migrate_cfg = MigrateConfig(
        enabled=migrate_on,
        max_concurrent=max(1, getattr(args, "migrate_max_concurrent", 2)),
        breaker_fraction=getattr(args, "migrate_breaker_fraction", 0.25),
    )
    # TPUC_POLL_SCALE: one multiplier over the reconcilers' lifecycle
    # requeue cadences (attach/visibility/detach/busy/cleanup re-polls).
    # Production runs at 1.0. The proc-mode harnesses (fleet/proc.py,
    # bench_proc_scaling, make proc-smoke) shrink it so a real-process
    # replica's measured throughput is its reconcile capacity, not the
    # polling latency floor — the same cadences every in-proc bench tunes
    # through RequestTiming/ResourceTiming directly. Event-driven safety
    # nets (running_poll, health_poll) stay unscaled on purpose.
    try:
        poll_scale = float(os.environ.get("TPUC_POLL_SCALE", "") or 1.0)
    except ValueError:
        poll_scale = 1.0
    poll_scale = max(0.001, poll_scale)
    _rt, _qt = ResourceTiming(), RequestTiming()
    res_timing = ResourceTiming(
        attach_poll=_rt.attach_poll * poll_scale,
        visibility_poll=_rt.visibility_poll * poll_scale,
        detach_poll=_rt.detach_poll * poll_scale,
        detach_fast=_rt.detach_fast * poll_scale,
        busy_poll=_rt.busy_poll * poll_scale,
        health_failure_threshold=getattr(args, "health_failure_threshold", 3),
        node_degrade_threshold=getattr(args, "node_degrade_threshold", 3),
    )
    req_timing = RequestTiming(
        updating_poll=_qt.updating_poll * poll_scale,
        cleaning_poll=_qt.cleaning_poll * poll_scale,
        repair_poll=_qt.repair_poll * poll_scale,
    )
    req_rec = ComposabilityRequestReconciler(client, fabric,
                                             timing=req_timing,
                                             recorder=mgr.recorder,
                                             scheduler=scheduler,
                                             repair=repair_cfg,
                                             migrate=migrate_cfg,
                                             ownership=ownership)
    mgr.add_controller(req_rec)
    res_rec = ComposableResourceReconciler(client, fabric, agent,
                                           timing=res_timing,
                                           recorder=mgr.recorder,
                                           dispatcher=dispatcher,
                                           ownership=ownership,
                                           decision_ledger=scheduler.ledger)
    mgr.add_controller(res_rec)
    if migrate_on:
        # Node maintenance drains (controllers/maintenance.py): cordon +
        # drain-via-migration + deadline abort. Only with the verb on —
        # the escape hatch constructs no maintenance machinery at all.
        from tpu_composer_torch.controllers.maintenance import (
            MaintenanceTiming,
            NodeMaintenanceReconciler,
        )

        mgr.add_controller(NodeMaintenanceReconciler(
            client,
            timing=MaintenanceTiming(
                default_deadline=getattr(
                    args, "migrate_drain_deadline", 1800.0
                ),
            ),
            recorder=mgr.recorder,
            ownership=ownership,
        ))
    if args.defrag_interval > 0:
        defrag_loop = DefragLoop(
            client, scheduler.defrag,
            period=args.defrag_interval,
            execute=args.defrag_execute,
            recorder=mgr.recorder,
            # Sharded: defrag plans over the whole cluster — exactly one
            # replica may run it. Shard 0's owner holds the duty; it fails
            # over with the lease like any other shard responsibility.
            gate=(
                (lambda: ownership.owns_shard(0))
                if ownership is not None else None
            ),
        )
        mgr.add_runnable(defrag_loop)
        # /debug/defrag (dry-run plan + skip reasons) reads this handle.
        mgr.defrag = defrag_loop
    mgr.add_runnable(UpstreamSyncer(
        client, fabric, period=args.sync_period,
        grace=args.sync_grace,
        recorder=mgr.recorder,
        ownership=ownership,
        # Outage ride-through: freeze the orphan grace clocks while the
        # store breaker is open — a dark store's diff must not reclaim
        # healthy mid-attach devices whose status writes couldn't land.
        suspend=storebreaker.is_open if storebreaker is not None else None,
        # Wire plane v2: while the fabric event session streams, the timed
        # get_resources() relist stretches to a safety net (same
        # multiplier the dispatcher's poll fallback uses) and inventory
        # events trigger immediate passes instead.
        session=session,
        fallback_multiplier=getattr(
            args, "fabric_poll_fallback_mult", 20.0
        ),
    ))
    if session is not None:
        from tpu_composer_torch.agent.publisher import InventoryPublisher

        # Push-fed DRA publication repair: inventory events (not a poll)
        # re-check that every fabric-attached group is still published in
        # its node's ResourceSlice; the timed pass is the same demoted
        # safety net as the syncer's.
        mgr.add_runnable(InventoryPublisher(
            client, fabric, session=session,
            period=args.sync_period,
            fallback_multiplier=getattr(
                args, "fabric_poll_fallback_mult", 20.0
            ),
        ))
    # Event-driven visibility: /dev change events nudge the resource
    # controller instead of waiting out a poll quantum —
    # inotify directly for a local agent, HTTP long-poll per node for the
    # cluster RemoteNodeAgent. Fakes keep the polling safety net only.
    if isinstance(agent, LocalNodeAgent):
        from tpu_composer_torch.agent.watcher import DeviceEventWatcher

        mgr.add_runnable(DeviceEventWatcher(
            agent, res_rec, node_name=os.environ.get("NODE_NAME", "")
        ))
    else:
        from tpu_composer_torch.agent.remote import RemoteNodeAgent
        from tpu_composer_torch.agent.watcher import MultiNodeWatcher

        if isinstance(agent, RemoteNodeAgent):
            mgr.add_runnable(MultiNodeWatcher(agent, res_rec))
    if os.environ.get("ENABLE_WEBHOOKS", "").lower() != "false":
        register_validating_webhooks(client)
        if args.webhook_bind_address:
            # The AdmissionReview wire server (reference :9443 webhook
            # server, cmd/main.go:101-103): validating + pod-mutating
            # endpoints for the API server to call.
            from tpu_composer_torch.admission.server import AdmissionServer

            def serve_webhooks(stop_event):
                certfile = args.webhook_cert or None
                log = logging.getLogger("webhook")
                if certfile:
                    # cert-manager writes the serving cert after our pod
                    # starts (the secret mount is optional) — hold the
                    # listener until it appears. The API server sees
                    # connection-refused and retries, so admission
                    # self-heals the moment the cert lands; serving plain
                    # HTTP instead would fail every TLS handshake forever.
                    warned = False
                    while not os.path.exists(certfile):
                        if not warned:
                            log.warning("waiting for webhook cert %s", certfile)
                            warned = True
                        if stop_event.wait(2.0):
                            return
                webhook = AdmissionServer(
                    client,
                    bind=args.webhook_bind_address,
                    certfile=certfile,
                    keyfile=(args.webhook_key or None) if certfile else None,
                )
                log.info("admission webhooks serving on %s (tls=%s)",
                         webhook.address, webhook.tls)
                webhook.run(stop_event)

            mgr.add_runnable(serve_webhooks)
    # Overload governor (runtime/overload.py): built last so every signal
    # source and stretchable cadence already exists. TPUC_OVERLOAD=0
    # constructs none of it — no governor thread, no shed gate, no
    # cadence stretching.
    if getattr(args, "overload", True):
        from tpu_composer_torch.runtime.metrics import (
            fabric_breaker_state,
            slo_breached as _slo_breached_gauge,
        )
        from tpu_composer_torch.runtime.overload import (
            OverloadGovernor,
            request_shed_gate,
        )

        governor = OverloadGovernor(
            period=getattr(args, "overload_period", 1.0),
            depth_warn=getattr(args, "overload_depth_warn", 256),
            depth_shed=getattr(args, "overload_depth_shed", 1024),
            stretch_factor=getattr(args, "overload_stretch", 4.0),
            shed_quantum=getattr(args, "overload_shed_quantum", 5.0),
            priority_cutoff=getattr(args, "overload_priority_cutoff", 50),
            ledger=scheduler.ledger,
            store_breaker=storebreaker,
            # The fabric breaker publishes per-endpoint state gauges
            # (0 closed / 1 open / 2 half-open): any fully-open endpoint
            # is a Warn signal.
            fabric_open=lambda: any(
                float(v) == 1.0 for _, v in fabric_breaker_state.state()
            ),
            slo_breached=lambda: any(
                float(v) >= 1.0 for _, v in _slo_breached_gauge.state()
            ),
            recorder=mgr.recorder,
        )
        governor.watchdog = watchdog
        # Live queue depths: queues are re-created by Controller.start(),
        # so close over the controller, not today's queue object.
        for c in mgr._controllers:
            governor.add_queue(lambda c=c: len(c.queue))
        # Non-critical cadences stretched in Warn/Shed (all read live
        # each tick by their loops).
        if mgr.defrag is not None:
            governor.stretch(mgr.defrag, "period")
        if mgr.capacity is not None:
            governor.stretch(mgr.capacity, "period")
        if fleet_plane is not None:
            governor.stretch(fleet_plane, "publish_period")
        if scheduler.ledger is not None:
            governor.stretch(scheduler.ledger, "hold_rescan_s")
        # The shed gate guards ONLY the request controller: resource
        # reconciles, health probes, detaches and repairs keep the tight
        # path no matter the state.
        req_rec.shed_gate = request_shed_gate(governor, client)
        mgr.overload = governor
        mgr.add_runnable(governor.run)
    if watchdog is not None:
        # Worker loops beat under their thread names (auto-registered on
        # first beat); the governor runnable is restartable — it is pure
        # policy and respawns safely mid-flight.
        for c in mgr._controllers:
            c.watchdog = watchdog
        if mgr.overload is not None:
            watchdog.register(
                "OverloadGovernor",
                stall_after=max(
                    watchdog.stall_after,
                    10.0 * getattr(args, "overload_period", 1.0),
                ),
                restartable=True,
            )
    return mgr


def trace_merge_main(argv: List[str]) -> int:
    """``tpu-composer trace-merge``: stitch per-replica trace files into
    one connected Chrome/Perfetto trace (see runtime.tracing.merge_chrome
    for the three passes: clock alignment, pid disambiguation, nonce-keyed
    flow stitching)."""
    import json

    from tpu_composer_torch.runtime import tracing

    p = argparse.ArgumentParser(
        prog="tpu-composer trace-merge",
        description="merge per-replica Chrome trace files into one"
                    " stitched trace (open in Perfetto)",
    )
    p.add_argument("inputs", nargs="+",
                   help="per-replica trace JSON files (TPUC_TRACE_FILE"
                        " dumps / /debug/traces exports)")
    p.add_argument("--out", default="",
                   help="write the merged trace here (default: stdout)")
    args = p.parse_args(argv)
    try:
        merged = tracing.merge_files(args.inputs)
    except (OSError, ValueError, TypeError, KeyError, AttributeError) as e:
        # Unreadable file, non-JSON, the Array flavor, or events of an
        # unexpected shape — all surface as one clean CLI error.
        print(f"trace-merge: {e}", file=sys.stderr)
        return 1
    doc = json.dumps(merged)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc)
        meta = merged.get("metadata", {})
        print(
            f"{args.out}: {len(merged['traceEvents'])} events from"
            f" {meta.get('merged_files', len(args.inputs))} file(s),"
            f" {meta.get('stitched_flows', 0)} stitched flow(s)"
        )
    else:
        print(doc)
    return 0


def _format_decision(rec: dict) -> List[str]:
    """Human rendering of one DecisionRecord document."""
    out = [
        f"[{rec.get('at', '?')}] {rec.get('kind', '?')} ->"
        f" {rec.get('outcome', '?')}"
        + (f" (x{rec['repeats']})" if rec.get("repeats", 1) > 1 else "")
        + (f"  id={rec['decision_id']}" if rec.get("decision_id") else ""),
        f"  {rec.get('summary', '')}",
    ]
    binding = rec.get("binding")
    if binding:
        detail = ", ".join(
            f"{k}={v}" for k, v in binding.items() if k != "resource"
        )
        out.append(
            f"  binding: {binding.get('resource', '?')}"
            + (f" ({detail})" if detail else "")
        )
    if rec.get("victims"):
        out.append(
            f"  victims: {', '.join(rec['victims'])}"
            f" — {rec.get('victim_rationale', '')}"
        )
    inputs = rec.get("inputs")
    if inputs:
        out.append(
            f"  saw: {inputs.get('free_chips', '?')} free chips on"
            f" {inputs.get('schedulable_hosts', '?')} hosts,"
            f" fragmentation {inputs.get('fragmentation', '?')},"
            f" queue depth {inputs.get('queue_depth', '?')}"
        )
    rejected = [
        c for c in rec.get("candidates", []) if c.get("verdict") != "ok"
    ]
    if rejected:
        shown = ", ".join(
            f"{c['node']}: {c['verdict']}" for c in rejected[:8]
        )
        more = len(rejected) - 8
        out.append(
            "  rejected: " + shown + (f" (+{more} more)" if more > 0 else "")
        )
    if rec.get("nonces"):
        out.append(f"  executed by intents: {', '.join(rec['nonces'])}")
    return out


def explain_main(argv: List[str]) -> int:
    """``tpu-composer explain <cr>``: print the scheduler's decision ring
    for one request, from a running operator's health port or a
    $TPUC_DECISIONS_FILE crash dump."""
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    p = argparse.ArgumentParser(
        prog="tpu-composer explain",
        description="why did the scheduler place / queue / preempt this"
                    " request the way it did",
    )
    p.add_argument("name", help="ComposabilityRequest name")
    p.add_argument("--addr", default="127.0.0.1:8081",
                   help="running operator's health endpoint"
                        " (default 127.0.0.1:8081)")
    p.add_argument("--file", default="",
                   help="read a decision-ring dump (TPUC_DECISIONS_FILE /"
                        " --decisions-file output) instead of a live"
                        " operator")
    p.add_argument("--json", action="store_true",
                   help="print the raw JSON document instead of the"
                        " human rendering")
    args = p.parse_args(argv)
    if args.file:
        try:
            with open(args.file) as f:
                dump = json.load(f)
        except (OSError, ValueError) as e:
            print(f"explain: {e}", file=sys.stderr)
            return 1
        records = (dump.get("requests") or {}).get(args.name)
        if not records:
            print(f"explain: no decisions recorded for {args.name!r} in"
                  f" {args.file}", file=sys.stderr)
            return 1
        doc = {"request": args.name, "latest": records[-1],
               "decisions": records}
    else:
        url = (f"http://{args.addr}/debug/scheduler/explain/"
               f"{urllib.parse.quote(args.name)}")
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                doc = json.load(resp)
        except urllib.error.HTTPError as e:
            print(f"explain: {e.code} {e.reason} — {e.read().decode(errors='replace')}",
                  file=sys.stderr)
            return 1
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"explain: cannot reach {url}: {e}", file=sys.stderr)
            return 1
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0
    print(f"{args.name}: {len(doc['decisions'])} recorded decision(s)")
    for rec in doc["decisions"]:
        for line in _format_decision(rec):
            print(line)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "trace-merge":
        return trace_merge_main(argv[1:])
    if argv and argv[0] == "explain":
        return explain_main(argv[1:])
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        stream=sys.stderr,
    )
    log = logging.getLogger("setup")

    mgr = build_manager(args)

    stopping = []

    def handle_signal(signum, frame):
        if stopping:
            return
        stopping.append(signum)
        log.info("received signal %s, shutting down", signum)
        mgr.stop()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)

    log.info(
        "starting manager (provider=%s, health=%s, leader_elect=%s)",
        os.environ.get("CDI_PROVIDER_TYPE", "MOCK"),
        args.health_probe_bind_address or "disabled",
        args.leader_elect,
    )
    mgr.start(workers_per_controller=args.workers)
    if getattr(args, "port_file", ""):
        # Written AFTER start so a :0 health bind reports its real port; the
        # tmp+rename makes the appearance of the file itself the readiness
        # signal a supervisor polls on (no half-written JSON window).
        doc = json.dumps({
            "pid": os.getpid(),
            "health_port": mgr.health_port,
            "replica_id": mgr.replica_id,
        })
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(doc + "\n")
        os.replace(tmp, args.port_file)
    mgr.wait()
    if mgr.lost_leadership:
        log.error("exiting: leadership lost (restart to rejoin as standby)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
