"""The port's native node-agent library (``native/gpunode.cc`` through
``agent/native.py``) and its device event watchers, against the JAX
package's node agent (tests/test_agent.py's native and plugin-lister
cases, tests/test_native_watch.py's twin).

The port builds its library here with the host C++ compiler, so every
native case runs: nothing skips. On this host the JAX package has no
``native/build``, so its agent runs its Python paths; each scenario is
held three ways over one fake host (the JAX agent, the port's agent on
its native library, the port's agent with ``_native`` set to None):
per-chip enumeration (``accel*`` and the per-GPU ``nvidia<minor>``,
never NVIDIA's control nodes), single-sweep fd holders, process names,
the busy error's text, the inotify watch on ``dev`` (create, delete,
timeout) and a live ``/proc`` scan. Then the watchers (nudges, the
runnable loop, the throttle, one watcher per Node) on both packages, and
the kubelet plugin's device lister over a real agent's claims: a TPU
group's exactly as the JAX package lists it, an H100 group's with the
GPU spec's CDI name. Tolerance: exact (paths relative to the host's
root).
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, nvidia_host, twin

torch.set_num_threads(1)

JAX = twin(JAX_ROOT)
PORT = twin(PORT_ROOT)
#: (package, native?) of the three agents each scenario runs on.
MODES = {"jax": (JAX, False), "port_native": (PORT, True),
         "port_python": (PORT, False)}
H100 = "nvidia-h100-sxm"


def _tpu_host(root):
    """tests/test_native_watch.py's fake host: 4 accel nodes; pid 1234
    (comm 'jax-train') holds accel0 and accel1; pid 5678 ('probe') holds
    accel1."""
    dev = os.path.join(root, "dev")
    os.makedirs(dev)
    for i in range(4):
        open(os.path.join(dev, f"accel{i}"), "w").close()
    for pid, comm, held in ((1234, "jax-train", ["accel0", "accel1"]),
                            (5678, "probe", ["accel1"])):
        fd_dir = os.path.join(root, "proc", str(pid), "fd")
        os.makedirs(fd_dir)
        for i, name in enumerate(held):
            os.symlink(os.path.join(dev, name), os.path.join(fd_dir, str(7 + i)))
        with open(os.path.join(root, "proc", str(pid), "comm"), "w") as f:
            f.write(comm + "\n")
    os.makedirs(os.path.join(root, "proc", "not-a-pid"))
    open(os.path.join(root, "libtpu.so"), "w").close()
    return dict(dev_dir=dev, proc_dir=os.path.join(root, "proc"),
                cdi_dir=os.path.join(root, "cdi"),
                state_dir=os.path.join(root, "state"),
                libtpu_paths=[os.path.join(root, "libtpu.so")])


def _agent(mode, kw):
    tw, native = MODES[mode]
    if tw is JAX:
        kw = {k: v for k, v in kw.items()
              if k not in ("libcuda_paths", "run_dir")}
    agent = tw.nodeagent.LocalNodeAgent(**kw)
    if not native:
        agent._native = None
    return agent


def _rel(root, obj):
    return json.loads(json.dumps(obj).replace(str(root), "<root>"))


def _three_ways(tmp_path, host, scenario, modes=tuple(MODES)):
    """``scenario(agent, kw)`` on a fresh copy of ``host`` per mode; the
    results with the root masked."""
    out = {}
    for mode in modes:
        root = tmp_path / mode
        kw = host(str(root))
        out[mode] = _rel(root, scenario(_agent(mode, kw), kw))
    return out


def _same(out):
    values = list(out.values())
    assert all(v == values[0] for v in values), out
    return values[0]


def test_native_library_builds_and_every_agent_loads_it():
    lib = PORT.agent_native.native_lib()
    assert lib is not None and lib.version().startswith("gpunode")
    built = PORT.agent_native.library_path()
    assert lib.path == str(built) and built.exists()
    assert built.parent == PORT.agent_native.SOURCE.parent.parent / "build"
    agent = PORT.nodeagent.LocalNodeAgent(dev_dir="/nonexistent")
    assert agent._native is lib  # the native paths are the default
    assert JAX.agent_native.native_lib() is None  # no native/build here


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="broken.cc"):
        PORT.agent_native.build_native(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_name_carries_the_source_hash(tmp_path):
    a, b = tmp_path / "a.cc", tmp_path / "b.cc"
    a.write_text(PORT.agent_native.SOURCE.read_text())
    b.write_text(PORT.agent_native.SOURCE.read_text() + "\n// edited\n")
    pa = PORT.agent_native.library_path(a, tmp_path)
    assert pa == PORT.agent_native.library_path(a, tmp_path)
    assert pa != PORT.agent_native.library_path(b, tmp_path)
    assert pa.name.startswith("libgpunode-")


def test_enumeration_on_a_tpu_host(tmp_path):
    out = _three_ways(tmp_path, _tpu_host,
                      lambda agent, kw: agent._accel_nodes())
    assert _same(out) == [f"<root>/dev/accel{i}" for i in range(4)]


def test_enumeration_on_an_nvidia_host_skips_the_control_nodes(tmp_path):
    def host(root):
        kw = nvidia_host(root, minors=(0, 3, 12))
        open(os.path.join(kw["dev_dir"], "nvidia12x"), "w").close()
        open(os.path.join(kw["dev_dir"], "accel1"), "w").close()
        return kw

    out = _three_ways(tmp_path, host, lambda agent, kw: agent._accel_nodes(),
                      modes=("port_native", "port_python"))
    assert _same(out) == ["<root>/dev/accel1", "<root>/dev/nvidia0",
                          "<root>/dev/nvidia12", "<root>/dev/nvidia3"]


def test_enumeration_of_a_missing_dir_is_empty():
    assert PORT.agent_native.native_lib().enum_accel(
        "/definitely/not/a/dir") == []


def test_single_sweep_holders_attribute_per_path(tmp_path):
    def scenario(agent, kw):
        paths = [os.path.join(kw["dev_dir"], f"accel{i}") for i in range(4)]
        holders = agent._holders_multi(paths)
        return {"holders": {p: sorted(v) for p, v in holders.items()},
                "empty": agent._holders_multi([]),
                "one": agent._holders(paths[1])}

    out = _same(_three_ways(tmp_path, _tpu_host, scenario))
    assert out["holders"] == {"<root>/dev/accel0": [1234],
                              "<root>/dev/accel1": [1234, 5678],
                              "<root>/dev/accel2": [], "<root>/dev/accel3": []}
    assert out["empty"] == {} and sorted(out["one"]) == [1234, 5678]


def test_holders_of_gpu_nodes(tmp_path):
    def host(root):
        return nvidia_host(root, minors=(0, 3), held={77: [3], 88: [0, 3]})

    def scenario(agent, kw):
        paths = [os.path.join(kw["dev_dir"], f"nvidia{m}") for m in (0, 3)]
        return {p: sorted(v) for p, v in agent._holders_multi(paths).items()}

    out = _three_ways(tmp_path, host, scenario,
                      modes=("port_native", "port_python"))
    assert _same(out) == {"<root>/dev/nvidia0": [88],
                          "<root>/dev/nvidia3": [77, 88]}


def test_process_names(tmp_path):
    out = _three_ways(tmp_path, _tpu_host, lambda agent, kw: [
        agent._proc_name(pid) for pid in (1234, 5678, 99999)])
    assert _same(out) == ["jax-train", "probe", ""]


def test_busy_error_names_the_workload(tmp_path):
    def scenario(agent, kw):
        try:
            agent.drain("n0", ["chip-0", "chip-1"])
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            return [type(e).__name__, str(e)]
        return ["drained"]

    kind, msg = _same(_three_ways(tmp_path, _tpu_host, scenario))
    assert kind == "DeviceBusyError"
    assert "1234(jax-train)" in msg and "5678(probe)" in msg


def _change_later(path, create: bool, delay=0.15):
    def act():
        time.sleep(delay)
        if create:
            open(path, "w").close()
        else:
            os.remove(path)

    t = threading.Thread(target=act)
    t.start()
    return t


@pytest.mark.parametrize("change", ["create", "delete", "none"])
def test_wait_device_event(tmp_path, change):
    def scenario(agent, kw):
        t = None
        if change == "create":
            t = _change_later(os.path.join(kw["dev_dir"], "accel4"), True)
        elif change == "delete":
            t = _change_later(os.path.join(kw["dev_dir"], "accel3"), False)
        start = time.monotonic()
        fired = agent.wait_device_event(timeout=3.0 if t else 0.2)
        took = time.monotonic() - start
        if t is not None:
            t.join()
        assert took < 2.5
        return fired

    assert _same(_three_ways(tmp_path, _tpu_host, scenario)) is (
        change != "none")


def test_an_event_between_two_waits_is_reported(tmp_path):
    """The inotify watch is armed per call; a node created between two
    calls is reported by the cross-call snapshot at once."""

    def scenario(agent, kw):
        first = agent.wait_device_event(timeout=0.05)
        open(os.path.join(kw["dev_dir"], "accel7"), "w").close()
        start = time.monotonic()
        second = agent.wait_device_event(timeout=3.0)
        return [first, second, time.monotonic() - start < 0.5]

    assert _same(_three_ways(tmp_path, _tpu_host, scenario)) == [
        False, True, True]


def test_a_failed_watch_falls_back_to_polling(tmp_path):
    """Where inotify cannot watch ``dev`` (the native call answers -1),
    the agent polls snapshots instead of failing."""
    kw = _tpu_host(str(tmp_path))
    agent = _agent("port_native", kw)
    real = agent._native

    class _NoInotify(type(real)):
        def watch_dev(self, dev_dir, timeout_ms):
            return -1

    agent._native = object.__new__(_NoInotify)
    agent._native.__dict__.update(real.__dict__)
    t = _change_later(os.path.join(kw["dev_dir"], "accel5"), True)
    assert agent.wait_device_event(timeout=3.0)
    t.join()
    assert not agent.wait_device_event(timeout=0.15)


@pytest.mark.parametrize("mode", ["port_native", "port_python", "jax"])
def test_self_held_fd_found_on_live_proc(tmp_path, mode):
    dev = tmp_path / "dev"
    dev.mkdir()
    target = str(dev / "accel0")
    open(target, "w").close()
    agent = _agent(mode, dict(dev_dir=str(dev), proc_dir="/proc",
                              cdi_dir=str(tmp_path / "cdi"),
                              state_dir=str(tmp_path / "state")))
    fd = os.open(target, os.O_RDONLY)
    try:
        assert os.getpid() in agent._holders_multi([target])[target]
    finally:
        os.close(fd)
    assert agent._holders_multi([target])[target] == []


class _StubQueue:
    def __init__(self):
        self.added = []

    def add(self, key):
        self.added.append(key)


class _StubController:
    def __init__(self, store):
        self.store = store
        self.queue = _StubQueue()


def _cr(tw, store, name, node, state=""):
    t = tw.types
    cr = store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="tpu", model="tpu-v4",
                                      target_node=node)))
    if state:
        cr.status.state = state
        store.update_status(cr)


@pytest.mark.parametrize("tw", [JAX, PORT], ids=["jax", "port"])
def test_nudges_target_one_node_and_skip_terminal(tw):
    store = tw.store.Store()
    _cr(tw, store, "a", "host-1")
    _cr(tw, store, "b", "host-2")
    _cr(tw, store, "c", "host-1", state=tw.types.RESOURCE_STATE_DELETING)
    ctrl = _StubController(store)
    scoped = tw.watcher.DeviceEventWatcher(None, ctrl, node_name="host-1")
    assert scoped.nudge() == 1 and ctrl.queue.added == ["a"]
    assert tw.watcher.DeviceEventWatcher(None, ctrl).nudge() == 2


@pytest.mark.parametrize("mode", sorted(MODES))
def test_watcher_loop_nudges_on_events_and_stops(tmp_path, mode):
    tw = MODES[mode][0]
    kw = _tpu_host(str(tmp_path))
    store = tw.store.Store()
    _cr(tw, store, "a", "host-1")
    ctrl = _StubController(store)
    w = tw.watcher.DeviceEventWatcher(_agent(mode, kw), ctrl,
                                      node_name="host-1", wait_timeout=0.1)
    stop = threading.Event()
    t = threading.Thread(target=w, args=(stop,))
    t.start()
    time.sleep(0.1)
    open(os.path.join(kw["dev_dir"], "accel9"), "w").close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not ctrl.queue.added:
        time.sleep(0.05)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert "a" in ctrl.queue.added and w.events_seen >= 1


@pytest.mark.parametrize("tw", [JAX, PORT], ids=["jax", "port"])
def test_fast_false_agent_does_not_spin(tw):
    calls = []

    class _Fast(tw.nodeagent.NodeAgent):
        def wait_device_event(self, node="", timeout=1.0):
            calls.append(node)
            return False

    w = tw.watcher.DeviceEventWatcher(_Fast(), _StubController(
        tw.store.Store()), node_name="h", wait_timeout=0.1)
    stop = threading.Event()
    t = threading.Thread(target=w, args=(stop,))
    t.start()
    time.sleep(0.45)
    stop.set()
    t.join(timeout=5)
    assert 2 <= len(calls) <= 10  # ~4 windows, never hundreds


@pytest.mark.parametrize("tw", [JAX, PORT], ids=["jax", "port"])
def test_one_watcher_per_node_and_retirement(tw):
    seen = set()

    class _Agent(tw.nodeagent.NodeAgent):
        def wait_device_event(self, node="", timeout=1.0):
            seen.add(node)
            return False

    store = tw.store.Store()
    for name in ("host-1", "host-2"):
        store.create(tw.types.Node(metadata=tw.meta.ObjectMeta(name=name)))
    mw = tw.watcher.MultiNodeWatcher(_Agent(), _StubController(store),
                                     wait_timeout=0.05, refresh=0.1)
    stop = threading.Event()
    t = threading.Thread(target=mw, args=(stop,))
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and seen != {"host-1", "host-2"}:
        time.sleep(0.05)
    assert seen == {"host-1", "host-2"}
    store.delete(tw.types.Node, "host-2")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and "host-2" in mw._live:
        time.sleep(0.05)
    assert "host-2" not in mw._live
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()


def test_lister_reflects_tpu_claims_as_the_jax_package(tmp_path):
    def scenario(agent, kw):
        tw = PORT if type(agent).__module__.startswith(PORT_ROOT) else JAX
        spec = tw.cdi.generate_cdi_spec(
            slice_name="train-slice", worker_id=0, chip_indices=[0, 1],
            env={"TPU_WORKER_ID": "0"})
        agent.refresh_device_stack("n0", spec=spec)
        listed = [list(d) for d in tw.plugin.lister_from_agent(agent)()]
        agent.refresh_device_stack("n0", remove_name=spec.name)
        return [listed, tw.plugin.lister_from_agent(agent)()]

    listed, after = _same(_three_ways(tmp_path, _tpu_host, scenario))
    assert listed == [
        ["train-slice-worker0/0", True, "<root>/dev/accel0",
         "tpu.composer.dev/chip=train-slice-worker0"],
        ["train-slice-worker0/1", True, "<root>/dev/accel1",
         "tpu.composer.dev/chip=train-slice-worker0"]]
    assert after == []


@pytest.mark.parametrize("native", [True, False])
def test_lister_reflects_h100_claims(tmp_path, native):
    """An H100 group's claim lists its rebased ``/dev/nvidia<minor>``
    under the GPU spec's CDI name."""
    kw = nvidia_host(str(tmp_path), minors=(0, 3))
    agent = _agent("port_native" if native else "port_python", kw)
    spec = PORT.cdi.generate_cdi_spec("h-slice", 0, [1], env={"A": "1"},
                                      model=H100)
    agent.refresh_device_stack("n0", spec=spec)
    assert PORT.plugin.lister_from_agent(agent)() == [
        ("h-slice-worker0/0", True, os.path.join(kw["dev_dir"], "nvidia3"),
         f"tpu.composer.dev/gpu=h-slice-worker0")]
    assert spec.qualified_name == "tpu.composer.dev/gpu=h-slice-worker0"
