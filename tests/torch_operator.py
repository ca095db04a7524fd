"""Shared helpers for the port's operator twins (tests/test_torch_*.py of
the control plane): the same scripted operations go through the JAX
package's modules and the port's, and their observable results are
compared with the fields below masked.

The control-plane modules keep the JAX package's paths, so one scenario
written against ``twin(root)`` runs on either package.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import random
import time
import uuid
from types import SimpleNamespace

from tpu_composer_torch.analysis import lockdep as _port_lockdep

JAX_ROOT = "tpu_composer"
PORT_ROOT = "tpu_composer_torch"
ROOTS = (JAX_ROOT, PORT_ROOT)

# The port's operator twins run under the port's lock-order witness,
# strict, as the JAX package's suite runs under its own (the acquire that
# closes an order cycle raises LockOrderViolation there, with both
# stacks). Each package's ObservedLocks feed only that package's witness.
# TPUC_LOCKDEP=0 turns both off.
if os.environ.get("TPUC_LOCKDEP", "1") != "0":
    _port_lockdep.enable(strict=True)

#: Fields that differ between two runs of one script whatever the package:
#: identities and clocks (uid, timestamps, intent nonces and the trace ids
#: they become, and the wall-clock stamps the controllers write into
#: annotations). They are replaced by their presence, never dropped.
MASKED = frozenset({
    "uid", "creationTimestamp", "deletionTimestamp", "nonce", "started_at",
    "observed_at", "first_ready_time", "trace_id",
    "tpu.composer.dev/repair-drain-start", "tpu.composer.dev/orphan-first-seen",
})

_MODULES = dict(
    meta="api.meta", types="api.types", dra="api.dra", scheme="api.scheme",
    store="runtime.store", queue="runtime.queue",
    controller="runtime.controller", manager="runtime.manager",
    leader="runtime.leader", metrics="runtime.metrics",
    lifecycle="runtime.lifecycle", tracing="runtime.tracing",
    provider="fabric.provider", inmem="fabric.inmem",
    adapter="fabric.adapter", fevents="fabric.events",
    token="fabric.token", httpx="fabric.httpx", poolapi="fabric.poolapi",
    rest="fabric.rest", layout="fabric.layout", redfish="fabric.redfish",
    breaker="fabric.breaker", chaos="fabric.chaos",
    dispatcher="fabric.dispatcher",
    cdi="agent.cdi", nodeagent="agent.nodeagent", fake="agent.fake",
    publisher="agent.publisher",
    rc="controllers.resource_controller",
    coordinates="admission.coordinates", slices="topology.slices",
    maintenance="api.maintenance", events="runtime.events",
    capacity="runtime.capacity", goodput="runtime.goodput",
    sched="scheduler", sched_core="scheduler.core",
    snapshot="scheduler.snapshot",
    native="scheduler.native", placement="scheduler.placement",
    preemption="scheduler.preemption", ledger="scheduler.ledger",
    defrag="scheduler.defrag",
    req="controllers.request_controller", syncer="controllers.syncer",
    adoption="controllers.adoption", mc="controllers.maintenance",
    lease="api.lease", leases="runtime.leases", shards="runtime.shards",
    cache="runtime.cache", chaosstore="runtime.chaosstore",
    storebreaker="runtime.storebreaker", overload="runtime.overload",
    profiler="runtime.profiler", watchdog="runtime.watchdog",
    contention="runtime.contention",
    fleet_api="api.fleet", lockdep="analysis.lockdep", slo="runtime.slo",
    fleet="runtime.fleet", wiremux="runtime.wiremux",
    kubestore="runtime.kubestore", apiserver="sim.apiserver",
    netchaos="sim.netchaos", churn="sim.churn",
    validating="admission.validating", admission_server="admission.server",
    agent_native="agent.native", watcher="agent.watcher",
    serve="agent.serve", remote="agent.remote", plugin="agent.plugin",
    pb="agent.deviceplugin_pb2", cmd="cmd.main", proc="fleet.proc",
)


def twin(root: str) -> SimpleNamespace:
    """One package's control-plane modules under short names
    (``tw.types``, ``tw.store``, ``tw.rc``, ...)."""
    return SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODULES.items()
    })


def mask(obj):
    """``obj`` (dicts, lists, scalars) with every MASKED key's value
    replaced by whether it was set."""
    if isinstance(obj, dict):
        return {k: (bool(v) if k in MASKED else mask(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    return obj


@contextlib.contextmanager
def seeded_uuids(seed: int = 0):
    """``uuid.uuid4`` drawn from a generator seeded with ``seed`` for the
    duration: generated names (``<type>-<uuid>`` children, uids, nonces)
    come out the same in two runs that make the same calls in the same
    order."""
    rng = random.Random(seed)
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = real


def run_both(scenario, *args, seed: int = 0, **kwargs):
    """Run ``scenario(twin, ...)`` on the JAX package and on the port,
    with Python's ``random`` and ``uuid.uuid4`` seeded the same before
    each; returns the two masked results."""
    out = []
    for root in ROOTS:
        random.seed(seed)
        with seeded_uuids(seed):
            out.append(mask(scenario(twin(root), *args, **kwargs)))
    return out


def outcome(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``'s result (a reconcile ``Result`` as
    ``("requeue", seconds)``), or ``("raised", type, message)``."""
    try:
        out = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__, str(e))
    if hasattr(out, "requeue_after"):
        return ("requeue", out.requeue_after)
    return out


class RequestWorld:
    """One package's request side, stepped by hand: a Store with
    ``n_nodes`` nodes of ``slots`` chip slots, an ``InMemoryPool``, a
    ``FakeNodeAgent``, the request reconciler (its ClusterScheduler built
    on the store) and the resource reconciler joined to its decision
    ledger. ``req_kw`` goes to the request reconciler. With ``pool`` and
    ``fabric`` given (a remote client over a fake fabric server serving
    ``pool``), the reconcilers compose through ``fabric`` while the agent
    and ``view`` read ``pool``."""

    def __init__(self, tw, n_nodes=4, slots=4, chips=None, pool=None,
                 fabric=None, **req_kw):
        self.tw = tw
        t = tw.types
        self.store = tw.store.Store()
        for i in range(n_nodes):
            n = t.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = slots
            n.status.milli_cpu = 8000
            n.status.memory = 64 << 30
            n.status.allowed_pod_number = 100
            self.store.create(n)
        self.pool = pool or tw.inmem.InMemoryPool(chips=chips or {"tpu-v4": 64})
        self.fabric = fabric or self.pool
        self.agent = tw.fake.FakeNodeAgent(pool=self.pool)
        self.req_rec = tw.req.ComposabilityRequestReconciler(
            self.store, self.fabric, **req_kw)
        self.res_rec = tw.rc.ComposableResourceReconciler(
            self.store, self.fabric, self.agent,
            decision_ledger=self.req_rec.scheduler.ledger)

    # -- objects ----------------------------------------------------------
    def request(self, name, size=4, model="tpu-v4", type_=None, priority=0,
                policy="", **resource):
        t = self.tw.types
        type_ = type_ or ("tpu" if model.startswith("tpu-") else "gpu")
        spec = t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(type=type_, model=model, size=size,
                                       **resource),
            priority=priority)
        if policy:
            spec.preemption_policy = policy
        return self.store.create(t.ComposabilityRequest(
            metadata=self.tw.meta.ObjectMeta(name=name), spec=spec))

    def get(self, name):
        return self.store.try_get(self.tw.types.ComposabilityRequest, name)

    def children(self, name):
        t = self.tw.types
        return self.store.list(t.ComposableResource,
                               label_selector={t.LABEL_MANAGED_BY: name})

    def resize(self, name, size):
        req = self.get(name)
        req.spec.resource.size = size
        self.store.update(req)

    def delete(self, name):
        self.store.delete(self.tw.types.ComposabilityRequest, name)

    # -- stepping ---------------------------------------------------------
    def pump(self, steps=40):
        """Step every request and resource reconciler ``steps`` times,
        tolerating the operational errors that land in status."""
        quiet = (self.tw.provider.FabricError, self.tw.slices.TopologyError)
        t = self.tw.types
        for _ in range(steps):
            for r in self.store.list(t.ComposabilityRequest):
                try:
                    self.req_rec.reconcile(r.metadata.name)
                except quiet:
                    pass
            for c in self.store.list(t.ComposableResource):
                try:
                    self.res_rec.reconcile(c.metadata.name)
                except self.tw.provider.FabricError:
                    pass

    def run_to_ready(self, name, max_steps=60):
        for _ in range(max_steps):
            self.pump(1)
            if self.get(name).status.state == self.tw.types.REQUEST_STATE_RUNNING:
                return
        raise AssertionError(f"{name} never reached Running: "
                             f"{self.get(name).status.to_dict()}")

    def settle(self, name, max_steps=60):
        """Pump until request ``name`` and its children are gone."""
        for _ in range(max_steps):
            self.pump(1)
            if self.get(name) is None and not self.children(name):
                return
        raise AssertionError(f"{name} never went away")

    # -- observing --------------------------------------------------------
    def view(self):
        """Every request's state, error, slice and rows; every child's
        spec, state, devices, chip indices and annotations; the pool's
        slice reservations and free chips."""
        t = self.tw.types
        reqs = {r.metadata.name: dict(
            state=r.status.state, error=r.status.error,
            slice=r.status.slice.to_dict(),
            rows={k: v.to_dict() for k, v in r.status.resources.items()},
            deleting=r.being_deleted)
            for r in self.store.list(t.ComposabilityRequest)}
        kids = {c.metadata.name: dict(
            spec=c.spec.to_dict(), state=c.status.state,
            device_ids=list(c.status.device_ids),
            chip_indices=list(c.status.chip_indices),
            owner=c.metadata.labels.get(t.LABEL_MANAGED_BY, ""),
            annotations=dict(c.metadata.annotations),
            deleting=c.being_deleted)
            for c in self.store.list(t.ComposableResource)}
        pool = {n: dict(model=r.model, topology=r.topology,
                        nodes=list(r.nodes),
                        groups={w: len(ids) for w, ids in r.groups.items()})
                for n, r in sorted(self.pool._slices.items())}
        free = {m: self.pool.free_chips(m) for m in sorted(self.pool._chips)}
        return dict(requests=reqs, children=kids, pool=pool, free=free)


def fabric_summary(out):
    """A comparable form of one fabric call's result: an attach result,
    a health answer, a listed device, an error (its class and message),
    or a list of those."""
    if isinstance(out, Exception):
        return ("error", type(out).__name__, str(out))
    if hasattr(out, "cdi_device_id"):
        return ("attach", list(out.device_ids), out.cdi_device_id)
    if hasattr(out, "healthy"):
        return ("health", out.state, out.detail, out.healthy)
    if hasattr(out, "device_id"):
        return ("device", out.device_id, out.node, out.model, out.slice_name,
                out.type, out.resource_name, out.health.state)
    if isinstance(out, (list, tuple)):
        return [fabric_summary(o) for o in out]
    return out


def wait_for(predicate, timeout: float = 10.0, interval: float = 0.02) -> bool:
    """Poll ``predicate`` until true or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def nvidia_host(root, minors=(0, 3), held=None, bus_ids=None,
                driver="host", libtpu=False):
    """A fake NVIDIA host under ``root``: ``dev/`` with ``nvidia<minor>``
    per GPU and the control nodes, ``proc/driver/nvidia`` with the
    driver's per-GPU listing (``Device Minor`` by PCI bus id), a
    ``libcuda.so.1``, and ``proc/<pid>/fd`` links for ``held``
    ({pid: [minor, ...]}). Returns the keyword arguments of a
    LocalNodeAgent over it."""
    dev = os.path.join(root, "dev")
    proc = os.path.join(root, "proc")
    os.makedirs(os.path.join(dev, "nvidia-caps"), exist_ok=True)
    for name in [f"nvidia{m}" for m in minors] + [
            "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset"]:
        open(os.path.join(dev, name), "w").close()
    bus_ids = bus_ids or [f"0000:{0x18 + 0x12 * i:02x}:00.0"
                          for i in range(len(minors))]
    nv = os.path.join(proc, "driver", "nvidia")
    os.makedirs(nv, exist_ok=True)
    if driver == "host":
        with open(os.path.join(nv, "version"), "w") as f:
            f.write("NVRM version: NVIDIA UNIX x86_64 Kernel Module\n")
    for bus, minor in zip(bus_ids, minors):
        d = os.path.join(nv, "gpus", bus)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "information"), "w") as f:
            f.write(f"Model: \t\t NVIDIA H100 80GB HBM3\n"
                    f"IRQ:   \t\t 0\nDevice Minor: \t {minor}\n"
                    f"Bus Location: \t {bus}\n")
    for pid, held_minors in (held or {}).items():
        fd = os.path.join(proc, str(pid), "fd")
        os.makedirs(fd, exist_ok=True)
        with open(os.path.join(proc, str(pid), "comm"), "w") as f:
            f.write("python3\n")
        for i, m in enumerate(held_minors):
            os.symlink(os.path.join(dev, f"nvidia{m}"), os.path.join(fd, str(10 + i)))
    lib = os.path.join(root, "lib", "libcuda.so.1")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    open(lib, "w").close()
    tpu = os.path.join(root, "lib", "libtpu.so")
    if libtpu:
        open(tpu, "w").close()
    return dict(dev_dir=dev, proc_dir=proc, cdi_dir=os.path.join(root, "cdi"),
                state_dir=os.path.join(root, "state"), libtpu_paths=[tpu],
                libcuda_paths=[lib], run_dir=os.path.join(root, "run"))


#: A fake fabric server's knobs and logs as a fresh server starts them.
_SERVER_DEFAULTS = dict(require_auth=False, username="composer",
                        password="secret", token_ttl=300.0, apply_steps=1)


def reset_server(srv, pool, **knobs):
    """Give a running fake fabric server (``tests/fake_fabric`` or
    ``tests/torch_fake_fabric``) ``pool`` and a fresh server's state:
    knobs (overridden by ``knobs``), issued tokens, logs, layout applies
    and forced failures. One server then serves both packages' runs of a
    scenario in turn."""
    with srv._lock:
        srv.pool = pool
        for k, v in {**_SERVER_DEFAULTS, **knobs}.items():
            setattr(srv, k, v)
        srv.valid_tokens = set()
        srv.token_requests = 0
        srv.request_log = []
        srv.mutation_log = []
        srv._applies = {}
        srv._active_apply = None
        srv._forced_failures = []
    return srv


def run_both_served(scenario, srv, pool_factory, *args, seed: int = 0,
                    knobs=None, **kwargs):
    """``run_both`` for scenarios that talk to one fake fabric server:
    before each package's run the server gets a fresh pool from
    ``pool_factory()`` and a fresh server's state (``reset_server``);
    ``scenario(twin, srv, ...)``."""
    def on_server(tw, *a, **kw):
        reset_server(srv, pool_factory(), **(knobs or {}))
        return scenario(tw, srv, *a, **kw)
    return run_both(on_server, *args, seed=seed, **kwargs)
