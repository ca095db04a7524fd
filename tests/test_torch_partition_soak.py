"""The asymmetric-partition soak on the port's process fleet against the
JAX package's (tests/test_partition_soak.py's twin), marked ``slow`` and
``partition`` as the JAX one is.

Three replicas of each package run seeded churn with each replica's
store wire behind its own TCP chaos proxy; the busiest replica's
responses go dark (``partition("s2c")``) while its requests still land.
On each package: the survivors steal its shard leases within the
takeover bound, the victim stays alive and makes no fabric mutation past
its fencing deadline (the fake fabric's attributed mutation log), and
after the heal the fleet converges with zero pending intents and no
double attach. The two packages' outcomes are compared whole.
"""

from __future__ import annotations

import os
import threading
import time

import pytest
import torch

from tests.test_crash_restart import assert_no_double_attach
from tests.test_torch_proc_fleet import (
    GROUP,
    VERSION,
    _cr_states,
    _pending_intents,
    _pool_attach_events,
    _wait,
)
from tests.torch_operator import ROOTS, twin

torch.set_num_threads(1)

pytestmark = [pytest.mark.slow, pytest.mark.partition]

LEASE_S = 2.0
RENEW_S = 0.25
RENEW_DEADLINE_S = LEASE_S * 2.0 / 3.0
FENCE_SLACK_S = 2.5
TAKEOVER_BOUND_S = 2 * LEASE_S + 4 * RENEW_S + 3.0
PARTITION_HOLD_S = 9.0
WIRE_ENV = {"TPUC_WIRE_PING_PERIOD": "0.5", "TPUC_WIRE_PING_MISSES": "2",
            "TPUC_WIRE_CONNECT_TIMEOUT": "1.0", "TPUC_WIRE_MUX_MAX_FAILS": "5"}


def _soak(root, workdir):
    tw = twin(root)
    seed = int(os.environ.get("TPUC_PARTITION_SEED", "20"))
    plan = tw.churn.generate_plan(seed=seed, requests=18, duration_s=6.0,
                                  nodes=16, chips_per_node=4, min_size=1,
                                  max_size=2, cancel_frac=0.15,
                                  resize_frac=0.2, migrate_frac=0.0)
    fleet = tw.proc.ProcFleet(workdir, nodes=plan.nodes,
                              chips_per_node=plan.chips_per_node, shards=6,
                              expected_replicas=3, lease_duration_s=LEASE_S,
                              lease_renew_s=RENEW_S, extra_env=WIRE_ENV,
                              netchaos=True)
    with fleet:
        for name in ("part-a", "part-b", "part-c"):
            fleet.spawn(name, wait_ready_s=60)
        _wait(lambda: len(fleet.shard_owners()) == fleet.shards
              and len(set(fleet.shard_owners().values())) == 3, 30,
              "shard leases never balanced across all three replicas")
        driver = tw.churn.ChurnDriver(fleet.apiserver.url, plan, GROUP,
                                      VERSION)
        churn = threading.Thread(target=driver.run, daemon=True)
        churn.start()
        try:
            def busiest():
                counts = fleet.in_flight_intents()
                return max(counts, key=counts.get) if counts else None

            try:
                victim = _wait(busiest, 10, "no in-flight intents")
            except TimeoutError:
                victim = "part-a"
            survivors = [r.name for r in fleet.live() if r.name != victim]
            t_partition = time.monotonic()
            fleet.proxy(victim).partition("s2c")
            _wait(lambda: len(fleet.shard_owners()) == fleet.shards
                  and victim not in fleet.shard_owners().values(),
                  TAKEOVER_BOUND_S,
                  f"survivors never stole {victim}'s shards")
            takeover_s = time.monotonic() - t_partition
            stolen_by_survivors = set(fleet.shard_owners().values()) <= set(
                survivors)
            remaining = PARTITION_HOLD_S - (time.monotonic() - t_partition)
            if remaining > 0:
                time.sleep(remaining)
            alive_in_partition = fleet.replicas[victim].alive()
            fence_deadline = t_partition + RENEW_DEADLINE_S + FENCE_SLACK_S
            with fleet.fabric._lock:
                ledger = list(fleet.fabric.mutation_log)
            late = [entry for entry in ledger
                    if entry[0] == victim and entry[1] > fence_deadline]
            fleet.proxy(victim).heal()
        finally:
            driver.stop()
            churn.join(timeout=30)
        _wait(lambda: _cr_states(fleet) and all(
            s == "Running" for s in _cr_states(fleet).values())
            and _pending_intents(fleet) == 0, 90,
            f"fleet never converged after heal: {_cr_states(fleet)}")
        events = _pool_attach_events(fleet)
        assert_no_double_attach(events)
        out = {"stolen_by_survivors": stolen_by_survivors,
               "alive_in_partition": alive_in_partition,
               "ledger": bool(ledger), "late_mutations": late,
               "alive_after": fleet.replicas[victim].alive(),
               "generation": fleet.replicas[victim].generation,
               "attached": bool(events),
               "takeover_in_bound": takeover_s < TAKEOVER_BOUND_S}
        fleet.stop_all()
        return out


def test_partitioned_replica_fences_survivors_steal_heal_converges(tmp_path):
    outs = [_soak(root, str(tmp_path / root)) for root in ROOTS]
    assert outs[0] == outs[1] == {
        "stolen_by_survivors": True, "alive_in_partition": True,
        "ledger": True, "late_mutations": [], "alive_after": True,
        "generation": 1, "attached": True, "takeover_in_bound": True}
