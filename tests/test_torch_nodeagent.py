"""The port's LocalNodeAgent (tpu_composer_torch/agent/nodeagent.py) over a
temporary ``dev``, ``proc`` and ``proc/driver/nvidia`` tree.

TPU hosts: the same scripted operations go through the JAX package's
agent and the port's, each over its own copy of one fake ``accel*`` host
(tests/test_agent.py's fixture), and give the same results with the tree's
root masked out of paths.

NVIDIA hosts (no JAX counterpart; held to the port's own ``cdi``):
the ``/dev/nvidia[0-9]+`` scan that ignores the control nodes, claims
recorded from an H100 spec, the ordinal-to-minor rebase with minors 0 and
3, busy holders named by pid, ``ensure_driver``, and ``check_visible``
turning False once the test removes the node.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from tests.torch_operator import PORT_ROOT, ROOTS, nvidia_host, twin

torch.set_num_threads(1)

PORT = twin(PORT_ROOT)
nodeagent = PORT.nodeagent
cdi = PORT.cdi


def _tpu_host(root):
    """tests/test_agent.py's fake host: four accel nodes, pid 1234 holding
    accel0 open, a libtpu."""
    dev = os.path.join(root, "dev")
    os.makedirs(dev)
    for i in range(4):
        open(os.path.join(dev, f"accel{i}"), "w").close()
    fd = os.path.join(root, "proc", "1234", "fd")
    os.makedirs(fd)
    os.symlink(os.path.join(dev, "accel0"), os.path.join(fd, "7"))
    with open(os.path.join(root, "proc", "1234", "comm"), "w") as f:
        f.write("python3\n")
    os.makedirs(os.path.join(root, "proc", "not-a-pid"))
    open(os.path.join(root, "libtpu.so"), "w").close()
    return dev


def _tpu_agent(tw, root, with_lib=True):
    lib = os.path.join(root, "libtpu.so" if with_lib else "missing.so")
    return tw.nodeagent.LocalNodeAgent(
        dev_dir=os.path.join(root, "dev"), proc_dir=os.path.join(root, "proc"),
        cdi_dir=os.path.join(root, "cdi"), libtpu_paths=[lib],
        state_dir=os.path.join(root, "state"))


def _rel(root, obj):
    return json.loads(json.dumps(obj).replace(root, "<root>"))


def _try(trace, fn, *args, **kw):
    try:
        trace.append(("ok", fn(*args, **kw)))
    except Exception as e:
        trace.append(("raised", type(e).__name__, str(e)))


def tpu_basics(tw, root):
    dev, t = _tpu_host(root), []
    agent = _tpu_agent(tw, root)
    _try(t, agent.ensure_driver, "n0")
    t.append(("missing", type(_raises(_tpu_agent(tw, root, False).ensure_driver, "n0")).__name__))
    t.append(("visible", agent.check_visible("n0", ["a", "b", "c", "d"]),
              agent.check_visible("n0", ["a"] * 5), agent.check_visible("n0", [])))
    t.append(("loads", agent.check_no_loads("n0", ["chip-0"])))
    _try(t, agent.drain, "n0", ["chip-0"])
    _try(t, agent.drain, "n0", ["chip-0"], force=True)
    spec = tw.cdi.generate_cdi_spec("s1", 0, [0, 1], env={"TPU_WORKER_ID": "0"})
    agent.refresh_device_stack("n0", spec=spec)
    t.append(("specs", tw.cdi.list_cdi_specs(agent.cdi_dir)))
    with open(tw.cdi.spec_path(agent.cdi_dir, spec)) as f:
        t.append(("file", json.load(f)))
    t.append(("claims", agent.list_composed_devices()))
    agent.refresh_device_stack("n0", remove_name="s1-worker0")
    t.append(("specs", tw.cdi.list_cdi_specs(agent.cdi_dir), agent.list_composed_devices()))
    agent.create_device_taint("n0", ["chip-a", "chip-b"], "detaching")
    t.append(("taint", agent.has_device_taint("n0", "chip-a")))
    agent.delete_device_taint("n0", ["chip-a", "chip-b"])
    t.append(("taint", agent.has_device_taint("n0", "chip-a")))
    return _rel(root, t)


def _raises(fn, *args):
    try:
        fn(*args)
    except Exception as e:
        return e
    return None


def tpu_group_claims(tw, root):
    dev, t = _tpu_host(root), []
    agent = _tpu_agent(tw, root)
    agent.refresh_device_stack("n0", spec=tw.cdi.generate_cdi_spec("sA", 0, [0, 1]))
    agent.refresh_device_stack("n0", spec=tw.cdi.generate_cdi_spec("sB", 0, [2, 3]))
    t.append((agent.check_visible("n0", ["a1", "a2"], group="sA-worker0"),
              agent.check_visible("n0", ["b1", "b2"], group="sB-worker0")))
    t.append((agent.check_no_loads("n0", ["a1", "a2"], group="sA-worker0"),
              agent.check_no_loads("n0", ["b1", "b2"], group="sB-worker0")))
    _try(t, agent.drain, "n0", ["a1", "a2"], group="sA-worker0")
    _try(t, agent.drain, "n0", ["b1", "b2"], group="sB-worker0")
    os.remove(os.path.join(dev, "accel0"))
    os.remove(os.path.join(dev, "accel1"))
    t.append((agent.check_visible("n0", ["a1", "a2"], group="sA-worker0"),
              agent.check_visible("n0", ["b1", "b2"], group="sB-worker0")))
    agent.refresh_device_stack("n0", remove_name="sA-worker0")
    t.append(agent.check_visible("n0", ["a1", "a2"], group="sA-worker0"))
    vfio = os.path.join(dev, "vfio")
    os.makedirs(vfio)
    for n in ("vfio", "0", "1"):
        open(os.path.join(vfio, n), "w").close()
    agent.refresh_device_stack(
        "n0", spec=tw.cdi.generate_cdi_spec("sV", 0, [0, 1], use_vfio=True))
    t.append(("vfio", agent.check_visible("n0", ["v1", "v2"], group="sV-worker0"),
              agent._claims()["sV-worker0"]))
    os.remove(os.path.join(vfio, "0"))
    t.append(("vfio", agent.check_visible("n0", ["v1", "v2"], group="sV-worker0")))
    return _rel(root, t)


def tpu_device_events(tw, root):
    dev = _tpu_host(root)
    agent = _tpu_agent(tw, root)
    out = [agent.wait_device_event(timeout=0.05)]
    open(os.path.join(dev, "accel9"), "w").close()
    out.append(agent.wait_device_event(timeout=0.05))
    out.append(agent.wait_device_event(timeout=0.05))
    return out


@pytest.mark.parametrize("scenario", [tpu_basics, tpu_group_claims, tpu_device_events],
                         ids=lambda f: f.__name__)
def test_tpu_host_twin(scenario, tmp_path):
    results = [scenario(twin(root), str(tmp_path / root)) for root in ROOTS]
    assert results[1] == results[0]


# -- NVIDIA hosts -----------------------------------------------------------

def _gpu_agent(tmp_path, **host):
    return nodeagent.LocalNodeAgent(**nvidia_host(str(tmp_path), **host))


def _h100_spec(name="cs", worker=0, ordinals=(0,), env=None):
    return cdi.generate_cdi_spec(slice_name=name, worker_id=worker,
                                 chip_indices=list(ordinals), env=env or {},
                                 model="nvidia-h100-sxm")


def test_scan_lists_per_gpu_nodes_only(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(0, 3))
    dev = agent.dev_dir
    assert agent._accel_nodes() == [os.path.join(dev, "nvidia0"),
                                    os.path.join(dev, "nvidia3")]
    for control in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                    "nvidia-modeset", "nvidia-caps"):
        assert os.path.exists(os.path.join(dev, control))


def test_gpus_come_from_the_driver_listing_in_bus_order(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(3, 0),
                       bus_ids=["0000:9A:00.0", "0000:1B:00.0"])
    # PCI bus order, whatever order the minors were numbered in.
    assert agent.gpus() == [("0000:1b:00.0", 0), ("0000:9a:00.0", 3)]


def test_claims_recorded_from_an_h100_spec(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(0, 3))
    spec = _h100_spec(ordinals=(0, 1))
    agent.refresh_device_stack("n0", spec=spec)
    dev = agent.dev_dir
    # The per-GPU nodes, rebased onto dev_dir; never the control nodes.
    assert agent.list_composed_devices() == {
        "cs-worker0": [os.path.join(dev, "nvidia0"), os.path.join(dev, "nvidia3")]}
    assert agent.check_visible("n0", ["g0", "g1"], group="cs-worker0")


@pytest.mark.parametrize("ordinal,minor", [(0, 0), (1, 3)])
def test_ordinals_are_rebased_onto_minors(tmp_path, ordinal, minor):
    agent = _gpu_agent(tmp_path, minors=(0, 3))
    spec = _h100_spec(ordinals=(ordinal,), env={"WORLD_SIZE": "1"})
    assert spec.device_nodes[0] == f"/dev/nvidia{ordinal}"
    agent.refresh_device_stack("n0", spec=spec)
    path = cdi.spec_path(agent.cdi_dir, spec)
    with open(path) as f:
        edits = json.load(f)["devices"][0]["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]] == [
        f"/dev/nvidia{minor}", "/dev/nvidiactl", "/dev/nvidia-uvm",
        "/dev/nvidia-uvm-tools"]
    assert edits["env"] == ["WORLD_SIZE=1"]
    assert [m["hostPath"] for m in edits["mounts"]] == list(cdi.NVIDIA_DRIVER_LIBS)
    assert agent.list_composed_devices()["cs-worker0"] == [
        os.path.join(agent.dev_dir, f"nvidia{minor}")]


def test_an_ordinal_beyond_the_hosts_gpus_is_refused(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(0, 3))
    with pytest.raises(nodeagent.AgentError, match="ordinal 2, but the host lists 2"):
        agent.refresh_device_stack("n0", spec=_h100_spec(ordinals=(2,)))
    assert cdi.list_cdi_specs(agent.cdi_dir, cdi.CDI_CLASS_GPU) == []


def test_busy_holders_are_named_by_pid(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(0, 3), held={4242: [3], 77: [0]})
    agent.refresh_device_stack("n0", spec=_h100_spec("a", ordinals=(1,)))
    agent.refresh_device_stack("n0", spec=_h100_spec("b", ordinals=(0,)))
    assert not agent.check_no_loads("n0", ["g1"], group="a-worker0")
    with pytest.raises(nodeagent.DeviceBusyError) as ei:
        agent.drain("n0", ["g1"], group="a-worker0")
    msg = str(ei.value)
    assert msg == f"{os.path.join(agent.dev_dir, 'nvidia3')} held by 4242(python3)"
    # The other group's holder (pid 77) is not this group's. Only the
    # holder list is searched: the node's path lies under the test's
    # temporary directory, whose name may hold any digits.
    assert msg.rsplit(" held by ", 1)[1] == "4242(python3)"
    agent.drain("n0", ["g1"], force=True, group="a-worker0")
    os.remove(os.path.join(agent.proc_dir, "77", "fd", "10"))
    assert agent.check_no_loads("n0", ["g0"], group="b-worker0")
    agent.drain("n0", ["g0"], group="b-worker0")


@pytest.mark.parametrize("case,expected", [
    ("host", "host"), ("params_only", "host"), ("container", "container"),
    ("no_libcuda", None), ("no_module", None), ("libtpu", "host")])
def test_ensure_driver(tmp_path, case, expected):
    host = nvidia_host(str(tmp_path), driver="none" if case != "host" else "host",
                       libtpu=case == "libtpu")
    nv = os.path.join(host["proc_dir"], "driver", "nvidia")
    if case in ("params_only", "no_libcuda"):
        # A sandboxed runtime (gVisor) exposes the module's params alone.
        open(os.path.join(nv, "params"), "w").close()
    if case == "no_libcuda":
        host["libcuda_paths"] = [os.path.join(str(tmp_path), "nope.so.1")]
    if case == "container":
        host["libcuda_paths"] = [os.path.join(str(tmp_path), "nope.so.1")]
        os.makedirs(os.path.join(host["run_dir"], "nvidia", "driver"))
    agent = nodeagent.LocalNodeAgent(**host)
    if expected is None:
        with pytest.raises(nodeagent.AgentError, match="no NVIDIA driver"):
            agent.ensure_driver("n0")
    else:
        assert agent.ensure_driver("n0") == expected


def test_check_visible_turns_false_once_the_node_goes(tmp_path):
    agent = _gpu_agent(tmp_path, minors=(0, 3))
    agent.refresh_device_stack("n0", spec=_h100_spec(ordinals=(1,)))
    assert agent.check_visible("n0", ["g"], group="cs-worker0")
    os.remove(os.path.join(agent.dev_dir, "nvidia3"))
    assert not agent.check_visible("n0", ["g"], group="cs-worker0")
    # Retracting the publication removes the gpu-class spec and the claim.
    agent.refresh_device_stack("n0", remove_name="cs-worker0")
    assert cdi.list_cdi_specs(agent.cdi_dir, cdi.CDI_CLASS_GPU) == []
    assert agent.list_composed_devices() == {}


def test_without_the_driver_listing_nvml_is_asked(tmp_path, monkeypatch):
    host = nvidia_host(str(tmp_path), minors=(2,))
    import shutil
    shutil.rmtree(os.path.join(host["proc_dir"], "driver", "nvidia", "gpus"))
    monkeypatch.setattr(nodeagent, "nvml_gpus", lambda: [("", 2)])
    agent = nodeagent.LocalNodeAgent(**host)
    assert agent.gpus() == [("", 2)]
    agent.refresh_device_stack("n0", spec=_h100_spec(ordinals=(0,)))
    assert agent.list_composed_devices()["cs-worker0"] == [
        os.path.join(agent.dev_dir, "nvidia2")]


def test_nvml_without_its_library_lists_nothing(monkeypatch):
    def no_library(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(nodeagent.ctypes, "CDLL", no_library)
    assert nodeagent.nvml_gpus() == []


@pytest.mark.parametrize("raw,norm", [("0000:1B:00.0", "0000:1b:00.0"),
                                      ("00000000:4C:00.0", "0000:4c:00.0"),
                                      ("18:00.0", "0000:18:00.0"), ("", "")])
def test_bus_ids_normalize(raw, norm):
    assert nodeagent.normalize_bus_id(raw) == norm


def test_a_tpu_host_lists_no_gpus(tmp_path):
    _tpu_host(str(tmp_path))
    agent = _tpu_agent(PORT, str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "proc", "driver", "nvidia", "gpus"))
    assert agent.gpus() == []
