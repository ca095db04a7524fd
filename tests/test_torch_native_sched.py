"""The port's native placement kernel (tpu_composer_torch/native/tpusched.cc,
bound by tpu_composer_torch/scheduler/native.py) against the JAX package's
pure-Python kernels (tests/test_native_sched.py's differential fuzz).

The port builds its own copy of ``tpusched.cc`` with the host C++
compiler at first use; these tests are that build's first run. Over
seeded random clusters (``build_fuzz_cluster``'s recipe, made the same in
both packages' stores):

- the port's native ``tpus_scan`` on the JAX snapshot's own packed arrays
  equals JAX's ``py_scan`` on them, and the port's ``py_scan`` does too;
- the port's engine on the native kernel equals the JAX engine on
  ``py_scan`` and on the legacy store walks: capacity maps, picked hosts
  (or the exact AllocationError message) and the full candidate
  verdicts;
- the port's native victim search (``tpus_victims``) equals the JAX
  ``Preemptor``'s Python search: victim sets and ``last_search``.

Also: a broken source raises on build with the compiler's output (it
never becomes ``None``), the library is built under the port's own
``build/`` and never loaded from the JAX package's ``native/build``, and
``TPUC_NATIVE_SCHED=0`` gives the legacy engine. Tolerance: exact
everywhere (integer scans). Masked: nothing.
"""

from __future__ import annotations

import random
import shutil
from pathlib import Path

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, twin

torch.set_num_threads(1)

JAX = twin(JAX_ROOT)
PORT = twin(PORT_ROOT)
REPO = Path(__file__).resolve().parent.parent

_PREFIXES = ["worker", "tpu-host", "rack-a", "rack-b"]


def _shape(tw, num_hosts, chips_per_host=4):
    dims = (2, 2, num_hosts) if chips_per_host == 4 else (2, 4 * num_hosts)
    return tw.slices.SliceShape(
        model="tpu-v4" if chips_per_host == 4 else "tpu-v5e", dims=dims,
        num_chips=num_hosts * chips_per_host, num_hosts=num_hosts,
        chips_per_host=chips_per_host)


def _probe_request(tw, name="probe", priority=0, policy="", target="",
                   other=None):
    t = tw.types
    spec = t.ComposabilityRequestSpec(
        resource=t.ResourceDetails(type="tpu", model="tpu-v4", size=4,
                                   target_node=target, other_spec=other),
        priority=priority)
    if policy:
        spec.preemption_policy = policy
    return t.ComposabilityRequest(metadata=tw.meta.ObjectMeta(name=name),
                                  spec=spec)


def build_fuzz_cluster(tw, rng, n_nodes):
    """tests/test_native_sched.build_fuzz_cluster on either package: nodes
    of mixed shape and health, low-priority owners with labeled children,
    placeholder rows, a being-deleted child and an orphan child."""
    t, meta = tw.types, tw.meta
    store = tw.store.Store()
    node_names = []
    for i in range(n_nodes):
        if rng.random() < 0.08:
            name = f"noidx-{i}-x"
        else:
            name = f"{rng.choice(_PREFIXES)}-{i}"
        node_names.append(name)
        n = t.Node(metadata=meta.ObjectMeta(name=name))
        n.status.tpu_slots = rng.choice([0, 4, 4, 8, 8, 16])
        n.status.ready = rng.random() > 0.1
        n.spec.unschedulable = rng.random() < 0.1
        n.status.milli_cpu = rng.choice([0, 4000, 8000, 16000])
        n.status.memory = rng.choice([0, 32 << 30, 64 << 30])
        n.status.ephemeral_storage = rng.choice([0, 100 << 30])
        n.status.allowed_pod_number = rng.choice([0, 50, 100])
        store.create(n)
    child_i = 0
    for o in range(max(1, n_nodes // 6)):
        owner = f"owner-{o}"
        spec = t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(type="tpu", model="tpu-v4", size=4),
            priority=rng.choice([0, 1, 2, 5]))
        if rng.random() < 0.2:
            spec.preemption_policy = t.PREEMPT_NEVER
        req = store.create(t.ComposabilityRequest(
            metadata=meta.ObjectMeta(name=owner), spec=spec))
        req.status.slice.chips_per_host = rng.choice([1, 2, 4])
        for _ in range(rng.randint(0, 3)):
            cname = f"child-{child_i}"
            child_i += 1
            store.create(t.ComposableResource(
                metadata=meta.ObjectMeta(
                    name=cname, labels={t.LABEL_MANAGED_BY: owner}),
                spec=t.ComposableResourceSpec(
                    type="tpu", model="tpu-v4",
                    target_node=rng.choice(node_names),
                    chip_count=rng.choice([1, 2, 4]))))
            req.status.resources[cname] = t.ResourceStatus(
                state="Online", node_name=rng.choice(node_names))
        for p in range(rng.randint(0, 2)):
            req.status.resources[f"{owner}-pending-{p}"] = t.ResourceStatus(
                state="", node_name=rng.choice(node_names))
        store.update_status(req)
    store.create(t.ComposableResource(
        metadata=meta.ObjectMeta(name="orphan-child"),
        spec=t.ComposableResourceSpec(
            type="tpu", model="tpu-v4", target_node=rng.choice(node_names),
            chip_count=2)))
    doomed = store.create(t.ComposableResource(
        metadata=meta.ObjectMeta(
            name="doomed-child", finalizers=["test/hold"],
            labels={t.LABEL_MANAGED_BY: "owner-0"}),
        spec=t.ComposableResourceSpec(
            type="tpu", model="tpu-v4", target_node=rng.choice(node_names),
            chip_count=4)))
    store.delete(t.ComposableResource, doomed.metadata.name)
    return store


def _pick(tw, engine, req, shape, exclude, count, quarantined, used):
    try:
        return engine.pick_slice_hosts(req, shape, exclude=exclude,
                                       count=count, quarantined=quarantined,
                                       used=dict(used))
    except tw.placement.AllocationError as e:
        return f"error: {e}"


def _subset(rng, items, p):
    return {x for x in items if rng.random() < p}


def _worlds(seed, n_nodes):
    """The same fuzz cluster in both packages, with the JAX legacy and
    py_scan engines and the port's native engine."""
    out = {}
    for tw in (JAX, PORT):
        store = build_fuzz_cluster(tw, random.Random(seed), n_nodes)
        snap = tw.snapshot.ChipIndexSnapshot(store)
        assert snap.active
        out[tw.root] = (store, snap)
    jstore, jsnap = out[JAX_ROOT]
    pstore, psnap = out[PORT_ROOT]
    engines = dict(
        jax_legacy=JAX.placement.PlacementEngine(jstore),
        jax_python=JAX.placement.PlacementEngine(jstore, snapshot=jsnap,
                                                 native=None),
        port_native=PORT.placement.PlacementEngine(
            pstore, snapshot=psnap, native=PORT.native.native_lib()),
        port_python=PORT.placement.PlacementEngine(pstore, snapshot=psnap,
                                                   native=None),
    )
    return jstore, pstore, jsnap, engines


def _tw_of(kind):
    return JAX if kind.startswith("jax") else PORT


@pytest.mark.parametrize("seed,n_nodes", [
    (1, 8), (2, 12), (3, 16), (4, 24), (5, 40), (6, 64), (7, 96)])
def test_native_scan_on_jax_packed_arrays_equals_py_scan(seed, n_nodes):
    """The port's tpus_scan fed the JAX snapshot's packed arrays gives
    JAX's py_scan result exactly, for every trial's flags and demand."""
    rng = random.Random(seed)
    jstore = build_fuzz_cluster(JAX, random.Random(seed), n_nodes)
    snap = JAX.snapshot.ChipIndexSnapshot(jstore)
    snap.sync()
    snap.ensure_dense()
    lib = PORT.native.native_lib()
    names = list(snap.names)
    legacy = JAX.placement.PlacementEngine(jstore)
    for trial in range(12):
        used = legacy.used_slots_map(rng.choice(["", "owner-0"]))
        used_arr = snap.pack_used(used)
        flags = snap.pack_flags(_subset(rng, names, 0.15),
                                _subset(rng, names, 0.1))
        other = None
        if rng.random() < 0.4:
            other = PORT.types.OtherSpec(
                milli_cpu=rng.choice([0, 4000, 8000]),
                memory=rng.choice([0, 32 << 30]),
                allowed_pod_number=rng.choice([0, 50]))
        chips, count = rng.choice([1, 2, 4, 8]), rng.choice([0, 1, 2, 3, 5])
        args = (len(names), snap._slots, used_arr, snap._hidx, flags,
                snap._cpu, snap._mem, snap._eph, snap._pods, other, chips,
                count)
        want = JAX.snapshot.py_scan(*args)
        for got in (lib.scan(*args), PORT.snapshot.py_scan(*args)):
            num_ok, free, verd, order, sel = got
            assert num_ok == want[0], (seed, trial)
            assert list(free)[:len(names)] == list(want[1]), (seed, trial)
            assert list(verd)[:len(names)] == list(want[2]), (seed, trial)
            assert list(order)[:len(names)] == list(want[3]), (seed, trial)
            assert sel == want[4], (seed, trial)


@pytest.mark.parametrize("seed,n_nodes", [
    (1, 8), (2, 12), (3, 16), (4, 24), (5, 40), (6, 64), (7, 96)])
def test_fuzz_capacity_hosts_verdicts_match_jax(seed, n_nodes):
    rng = random.Random(seed)
    jstore, pstore, _snap, engines = _worlds(seed, n_nodes)
    names = [n.metadata.name for n in jstore.list(JAX.types.Node)]
    excludable = [""] + [r.name for r in jstore.list(JAX.types.ComposabilityRequest)]
    for trial in range(12):
        excl = rng.choice(excludable)
        want = engines["jax_legacy"].capacity_maps(excl)
        for kind, eng in engines.items():
            assert eng.capacity_maps(excl) == want, (kind, seed, trial)
        quarantined = _subset(rng, names, 0.15)
        exclude = _subset(rng, names, 0.1)
        chips, count = rng.choice([1, 2, 4, 8]), rng.choice([1, 1, 2, 3, 5])
        other = None
        if rng.random() < 0.4:
            other = dict(milli_cpu=rng.choice([0, 4000, 8000]),
                         memory=rng.choice([0, 32 << 30]),
                         allowed_pod_number=rng.choice([0, 50]))
        results = {}
        for kind, eng in engines.items():
            tw = _tw_of(kind)
            req = _probe_request(
                tw, other=None if other is None else tw.types.OtherSpec(**other))
            base = _shape(tw, count, 4 if chips <= 4 else 8)
            shape = tw.slices.SliceShape(
                model=base.model, dims=base.dims, num_chips=count * chips,
                num_hosts=count, chips_per_host=chips)
            used = engines["jax_legacy" if tw is JAX else "port_python"] \
                .used_slots_map(req.name)
            results[kind] = (
                _pick(tw, eng, req, shape, exclude, count, quarantined, used),
                eng.candidate_verdicts(req, chips, quarantined, used,
                                       exclude=exclude),
                eng.candidate_verdicts(req, chips, quarantined, used,
                                       exclude=exclude, cap=5))
        for kind, got in results.items():
            assert got == results["jax_legacy"], (kind, seed, trial)
        assert engines["port_native"].last_scan_kind == "native"


def test_fuzz_survives_store_mutation():
    """After bursts of watch events the port's native engine still agrees
    with the JAX legacy walk over the same mutations."""
    rng = random.Random(99)
    jstore, pstore, _snap, engines = _worlds(99, 24)
    names = [n.metadata.name for n in jstore.list(JAX.types.Node)]
    for round_ in range(6):
        node_name = rng.choice(names)
        churn_node = rng.choice(names)
        row_node = rng.choice(names)
        quarantined = _subset(rng, names, 0.1)
        for tw, store in ((JAX, jstore), (PORT, pstore)):
            t = tw.types
            node = store.get(t.Node, node_name)
            node.spec.unschedulable = not node.spec.unschedulable
            store.update(node)
            store.create(t.ComposableResource(
                metadata=tw.meta.ObjectMeta(
                    name=f"churn-{round_}", labels={t.LABEL_MANAGED_BY: "owner-0"}),
                spec=t.ComposableResourceSpec(
                    type="tpu", model="tpu-v4", target_node=churn_node,
                    chip_count=2)))
            if round_ >= 2:
                store.delete(t.ComposableResource, f"churn-{round_ - 2}")
            owner = store.get(t.ComposabilityRequest, "owner-0")
            owner.status.resources[f"rewrite-{round_}"] = t.ResourceStatus(
                state="", node_name=row_node)
            owner.status.resources.pop(f"rewrite-{round_ - 1}", None)
            store.update_status(owner)
        want = engines["jax_legacy"].capacity_maps("owner-0")
        jreq = _probe_request(JAX)
        want_hosts = _pick(JAX, engines["jax_legacy"], jreq, _shape(JAX, 2),
                           set(), 2, quarantined,
                           engines["jax_legacy"].used_slots_map(jreq.name))
        nat = engines["port_native"]
        preq = _probe_request(PORT)
        assert nat.capacity_maps("owner-0") == want, round_
        assert _pick(PORT, nat, preq, _shape(PORT, 2), set(), 2, quarantined,
                     nat.used_slots_map(preq.name)) == want_hosts, round_


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15, 16, 17, 18])
def test_fuzz_native_victims_equal_jax_python_search(seed):
    # Small dense clusters so preemption is frequently the only way in:
    # infeasible, exhaustive and greedy+prune searches all occur.
    rng = random.Random(seed)
    jstore, pstore, _snap, engines = _worlds(seed, rng.choice([8, 10, 14, 20]))
    names = [n.metadata.name for n in jstore.list(JAX.types.Node)]
    modes = set()
    for trial in range(10):
        prio = rng.choice([3, 6, 10])
        target = rng.choice(names) if rng.random() < 0.2 else ""
        count = 1 if target else rng.choice([1, 2, 3])
        quarantined = _subset(rng, names, 0.1)
        out = {}
        for kind in ("jax_python", "port_native"):
            tw = _tw_of(kind)
            eng = engines[kind]
            req = _probe_request(tw, name=f"pre-{trial}", priority=prio,
                                 policy=tw.types.PREEMPT_LOWER_PRIORITY,
                                 target=target)
            store = jstore if tw is JAX else pstore
            p = tw.preemption.Preemptor(store, eng)
            used = eng.used_slots_map(req.name)
            out[kind] = (p.compute_victims(req, _shape(tw, count), quarantined,
                                           dict(used)), p.last_search)
        assert out["port_native"] == out["jax_python"], (seed, trial)
        modes.add(out["port_native"][1].get("mode"))
    assert modes  # the search ran


def test_native_victim_search_engages():
    """The port's native victim search runs (no quiet fallback) in a
    contended cluster and agrees with the JAX legacy search."""
    results = []
    for tw in (JAX, PORT):
        t, meta = tw.types, tw.meta
        store = tw.store.Store()
        for i in range(4):
            n = t.Node(metadata=meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 4
            store.create(n)
        for i in range(4):
            owner = f"low-{i}"
            store.create(t.ComposabilityRequest(
                metadata=meta.ObjectMeta(name=owner),
                spec=t.ComposabilityRequestSpec(
                    resource=t.ResourceDetails(type="tpu", model="tpu-v4",
                                               size=4))))
            store.create(t.ComposableResource(
                metadata=meta.ObjectMeta(name=f"low-child-{i}",
                                         labels={t.LABEL_MANAGED_BY: owner}),
                spec=t.ComposableResourceSpec(
                    type="tpu", model="tpu-v4", target_node=f"worker-{i}",
                    chip_count=4)))
        req = _probe_request(tw, name="hi", priority=5,
                             policy=t.PREEMPT_LOWER_PRIORITY)
        if tw is JAX:
            eng = tw.placement.PlacementEngine(store)
        else:
            snap = tw.snapshot.ChipIndexSnapshot(store)
            eng = tw.placement.PlacementEngine(
                store, snapshot=snap, native=tw.native.native_lib())
        p = tw.preemption.Preemptor(store, eng)
        used = eng.used_slots_map("hi")
        if tw is PORT:
            assert p._native_search(req, _shape(tw, 2), set(), used,
                                    p._candidates(req, set())) is not None
        results.append((p.compute_victims(req, _shape(tw, 2), set(), dict(used)),
                        p.last_search))
    assert results[0] == results[1]
    assert results[1][1]["mode"] == "exhaustive"
    assert results[1][1]["set_size"] == 2


# -- the build --------------------------------------------------------------

def test_native_library_is_the_ports_own_build():
    lib_path = PORT.native.library_path()
    assert lib_path.parent == REPO / "tpu_composer_torch" / "build"
    assert PORT.native.SOURCE == REPO / "tpu_composer_torch" / "native" / "tpusched.cc"
    lib = PORT.native.native_lib()
    assert lib_path.exists()
    assert lib.version() >= 1
    assert "native/build" not in str(lib_path)
    # The port's handle is its own: the JAX package's load cache is
    # untouched by the port's load.
    assert PORT.native.native_lib() is lib
    assert not isinstance(lib, JAX.native._NativeLib)


def test_broken_source_raises_with_compiler_output(tmp_path):
    broken = tmp_path / "tpusched.cc"
    shutil.copy(PORT.native.SOURCE, broken)
    broken.write_text(broken.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError) as e:
        PORT.native.build_native(broken, tmp_path / "build")
    assert "exited" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_source_hash_names_the_library(tmp_path):
    src = tmp_path / "tpusched.cc"
    shutil.copy(PORT.native.SOURCE, src)
    first = PORT.native.library_path(src, tmp_path)
    src.write_text(src.read_text() + "\n// edited\n")
    assert PORT.native.library_path(src, tmp_path) != first
    built = PORT.native.build_native(src, tmp_path)
    assert built == PORT.native.library_path(src, tmp_path) and built.exists()


def test_kill_switch_selects_the_legacy_engine(monkeypatch):
    monkeypatch.setenv("TPUC_NATIVE_SCHED", "0")
    assert not PORT.native.native_sched_enabled()
    sched = PORT.sched_core.ClusterScheduler(PORT.store.Store())
    assert sched.snapshot is None
    assert sched.engine.kernel_kind == "legacy"
    # A placement then runs on the store walks.
    from tests.torch_operator import RequestWorld

    w = RequestWorld(PORT, n_nodes=2)
    w.request("r", size=4)
    w.run_to_ready("r")
    assert w.req_rec.scheduler.engine.last_scan_kind == "legacy"


def test_default_scheduler_runs_the_native_kernel(monkeypatch):
    monkeypatch.delenv("TPUC_NATIVE_SCHED", raising=False)
    from tests.torch_operator import RequestWorld

    w = RequestWorld(PORT, n_nodes=2)
    assert w.req_rec.scheduler.engine.kernel_kind == "native"
    w.request("r", size=4)
    w.run_to_ready("r")
    assert w.req_rec.scheduler.engine.last_scan_kind == "native"


def test_assume_supersede_and_ttl_match_jax():
    out = []
    for tw in (JAX, PORT):
        t, meta = tw.types, tw.meta
        store = tw.store.Store()
        for i in range(3):
            n = t.Node(metadata=meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 4
            store.create(n)
        snap = tw.snapshot.ChipIndexSnapshot(store)
        req = store.create(t.ComposabilityRequest(
            metadata=meta.ObjectMeta(name="r1"),
            spec=t.ComposabilityRequestSpec(
                resource=t.ResourceDetails(type="tpu", model="tpu-v4", size=4))))
        snap.sync()
        snap.assume("r1", {"worker-0": 4})
        seen = [snap.capacity_views(""), snap.capacity_views("r1")]
        req.status.slice.chips_per_host = 4
        req.status.resources["r1-w0"] = t.ResourceStatus(state="",
                                                        node_name="worker-1")
        store.update_status(req)
        snap.sync()
        seen += [bool(snap._assumed), snap.capacity_views("")]
        store.delete(t.ComposabilityRequest, "r1")
        snap.sync()
        seen.append(snap.capacity_views(""))
        out.append(seen)
    assert out[0] == out[1]
    assert out[1][0][0] == {"worker-0": 4} and out[1][2] is False
