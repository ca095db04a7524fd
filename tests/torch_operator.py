"""Shared helpers for the port's operator twins (tests/test_torch_*.py of
the control plane): the same scripted operations go through the JAX
package's modules and the port's, and their observable results are
compared with the fields below masked.

The control-plane modules keep the JAX package's paths, so one scenario
written against ``twin(root)`` runs on either package.
"""

from __future__ import annotations

import importlib
import os
import random
import time
from types import SimpleNamespace

JAX_ROOT = "tpu_composer"
PORT_ROOT = "tpu_composer_torch"
ROOTS = (JAX_ROOT, PORT_ROOT)

#: Fields that differ between two runs of one script whatever the package:
#: identities and clocks (uid, timestamps, intent nonces and the trace ids
#: they become). They are replaced by their presence, never dropped.
MASKED = frozenset({
    "uid", "creationTimestamp", "deletionTimestamp", "nonce", "started_at",
    "observed_at", "first_ready_time", "trace_id",
})

_MODULES = dict(
    meta="api.meta", types="api.types", dra="api.dra", scheme="api.scheme",
    store="runtime.store", queue="runtime.queue",
    controller="runtime.controller", manager="runtime.manager",
    leader="runtime.leader", metrics="runtime.metrics",
    lifecycle="runtime.lifecycle", tracing="runtime.tracing",
    provider="fabric.provider", inmem="fabric.inmem",
    adapter="fabric.adapter",
    cdi="agent.cdi", nodeagent="agent.nodeagent", fake="agent.fake",
    rc="controllers.resource_controller",
    coordinates="admission.coordinates", slices="topology.slices",
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


def run_both(scenario, *args, seed: int = 0, **kwargs):
    """Run ``scenario(twin, ...)`` on the JAX package and on the port,
    with Python's ``random`` seeded the same before each; returns the two
    masked results."""
    out = []
    for root in ROOTS:
        random.seed(seed)
        out.append(mask(scenario(twin(root), *args, **kwargs)))
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
