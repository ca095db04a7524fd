"""NodeAgent interface + LocalNodeAgent (real-host implementation), port of
``tpu_composer/agent/nodeagent.py`` for TPU hosts and NVIDIA GPU hosts.

The per-operation mapping from the reference's GPU plumbing (internal/utils):

| reference (gpus.go)                         | node agent                           |
|---------------------------------------------|--------------------------------------|
| EnsureGPUDriverExists (:86, modinfo/chroot) | ensure_driver: libtpu, or the NVIDIA |
|                                             |   module + libcuda present?          |
| CheckGPUVisible (:207, nvidia-smi/RS scan)  | check_visible: device nodes exist    |
| CheckNoGPULoads (:241, query-compute-apps)  | check_no_loads: /proc open-fd scan   |
| DrainGPU (:352, persistence off→fd check→   | drain: taint → fd check → unbind     |
|   rm node→nvidia-smi drain/sysfs remove)    |   accel node → verify gone           |
| CreateDeviceTaint/Delete/Has (:894-977)     | taint/untaint/has_taint              |
| RestartDaemonset / TerminateKubeletPlugin   | refresh_device_stack: (re)write CDI  |
|   (nodes.go:35, gpus.go:1127)               |   specs + signal runtime            |

On an NVIDIA host the per-GPU device nodes are ``/dev/nvidia<minor>``;
``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``, ``nvidia-modeset`` and
``nvidia-caps/`` are shared control nodes and never belong to a group. A
GPU group's CDI spec names GPU *ordinals* (``/dev/nvidia<k>`` for the
host's k-th GPU, as ``agent/cdi.py`` writes them); the agent rebases each
ordinal onto the minor of the host's k-th GPU when it publishes the spec,
because a minor is not an ordinal: a host (or a container that sees some
of its GPUs) may list ``/dev/nvidia0`` and ``/dev/nvidia3`` only. The GPUs
and their minors come from the driver's own listing,
``/proc/driver/nvidia/gpus/<PCI bus id>/information``, in PCI bus order;
where the runtime hides that listing (a sandboxed runtime such as gVisor
exposes ``/proc/driver/nvidia/params`` alone), from NVIDIA's management
library (NVML), which creates no CUDA context. The agent never initialises
CUDA.

The reference reaches nodes via SPDY pod-exec into privileged pods
(gpus.go:1040-1067); our LocalNodeAgent runs *on* the node (deployed as the
node-agent daemonset) and the controller talks to it through this interface —
in-process for single-box runs, RPC in a cluster. The interface is the
dependency-injection seam the tests use (SURVEY.md §4 takeaway: prefer DI
over gomonkey).
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from tpu_composer_torch.agent import cdi as cdimod
from tpu_composer_torch.agent.native import native_lib


class AgentError(Exception):
    pass


class DeviceBusyError(AgentError):
    """A process still holds the device open — drain must not proceed
    (the reference's open-fd guard, gpus.go:416-439)."""


class DriverType:
    NONE = "none"
    HOST = "host"  # libtpu, or the NVIDIA module and libcuda, on the host image
    CONTAINER = "container"  # the runtime supplied by a driver container


#: A per-GPU NVIDIA device node's name: ``nvidia<minor>``. The control
#: nodes (nvidiactl, nvidia-uvm, nvidia-uvm-tools, nvidia-modeset) and the
#: nvidia-caps/ directory never match.
_NVIDIA_GPU_NODE = re.compile(r"nvidia[0-9]+\Z")

#: Where an x86-64 host image keeps CUDA's driver library.
DEFAULT_LIBCUDA_PATHS = [
    "/usr/lib/x86_64-linux-gnu/libcuda.so.1",
    "/lib/x86_64-linux-gnu/libcuda.so.1",
    "/usr/lib64/libcuda.so.1",
    "/usr/local/nvidia/lib64/libcuda.so.1",
]

#: nvmlReturn_t NVML_ERROR_NOT_SUPPORTED: the query has no answer here.
_NVML_NOT_SUPPORTED = 3


class _NvmlPciInfo(ctypes.Structure):
    """nvmlPciInfo_t (nvml.h), as ``nvmlDeviceGetPciInfo_v3`` fills it."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


def normalize_bus_id(bus_id: str) -> str:
    """``dddd:bb:dd.f`` in lower case, whatever width the domain came in
    (the driver's listing writes four digits, NVML eight)."""
    if not bus_id:
        return ""
    parts = bus_id.strip().lower().split(":")
    if len(parts) == 2:
        parts.insert(0, "0")
    domain, bus, devfn = parts
    return f"{int(domain, 16):04x}:{int(bus, 16):02x}:{devfn}"


def nvml_gpus() -> List[Tuple[str, int]]:
    """The GPUs NVML lists, as (PCI bus id, minor) in NVML's index order
    (PCI bus order). The bus id is "" where NVML cannot report it (gVisor
    hides the PCI topology). An empty list without the library. NVML holds
    the device nodes open while initialised; it is shut down before this
    returns."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return []
    nvml.nvmlInit_v2.restype = ctypes.c_int
    nvml.nvmlShutdown.restype = ctypes.c_int
    nvml.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    nvml.nvmlDeviceGetCount_v2.restype = ctypes.c_int
    nvml.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    nvml.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
    nvml.nvmlDeviceGetMinorNumber.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
    nvml.nvmlDeviceGetMinorNumber.restype = ctypes.c_int
    nvml.nvmlDeviceGetPciInfo_v3.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_NvmlPciInfo)]
    nvml.nvmlDeviceGetPciInfo_v3.restype = ctypes.c_int
    rc = nvml.nvmlInit_v2()
    if rc != 0:
        raise AgentError(f"NVML failed to initialise (nvmlReturn_t {rc})")
    try:
        count = ctypes.c_uint()
        _nvml_check(nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)), "count")
        out = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            _nvml_check(nvml.nvmlDeviceGetHandleByIndex_v2(
                i, ctypes.byref(handle)), f"handle {i}")
            minor = ctypes.c_uint()
            _nvml_check(nvml.nvmlDeviceGetMinorNumber(
                handle, ctypes.byref(minor)), f"minor {i}")
            pci = _NvmlPciInfo()
            rc = nvml.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci))
            if rc == _NVML_NOT_SUPPORTED:
                bus_id = ""
            else:
                _nvml_check(rc, f"PCI info {i}")
                bus_id = normalize_bus_id(pci.busId.decode())
            out.append((bus_id, minor.value))
        return out
    finally:
        nvml.nvmlShutdown()


def _nvml_check(rc: int, what: str) -> None:
    if rc != 0:
        raise AgentError(f"NVML {what} failed (nvmlReturn_t {rc})")


# Ceiling on a single wait_device_event block, shared by both sides of the
# RPC seam (serve.py enforces it, remote.py clamps to it so a client never
# believes a longer watch was held than the server actually armed).
MAX_WATCH_S = 30.0


class NodeAgent:
    """All methods take the node name; implementations may ignore it (a local
    agent serves exactly one node) or route RPC (a cluster agent client)."""

    def ensure_driver(self, node: str) -> str:
        """Verify the accelerator runtime stack exists; returns a DriverType.
        Raises AgentError when no usable driver is found
        (EnsureGPUDriverExists, gpus.go:86-95)."""
        raise NotImplementedError

    def check_visible(self, node: str, device_ids: List[str], group: str = "") -> bool:
        """All chips of the group enumerate on the host
        (CheckGPUVisible, gpus.go:207-239). ``group`` is the CDI publication
        name, letting implementations distinguish this group's device nodes
        from co-located groups'."""
        raise NotImplementedError

    def check_no_loads(self, node: str, device_ids: List[str], group: str = "") -> bool:
        """No process holds the chips open
        (CheckNoGPULoads, gpus.go:241-350)."""
        raise NotImplementedError

    def drain(self, node: str, device_ids: List[str], force: bool = False,
              group: str = "") -> None:
        """Quiesce and remove the chips from the host device stack. Raises
        DeviceBusyError if loads remain and not force
        (DrainGPU, gpus.go:352-865)."""
        raise NotImplementedError

    def refresh_device_stack(
        self,
        node: str,
        spec: Optional[cdimod.CdiSpec] = None,
        remove_name: str = "",
    ) -> None:
        """Publish (or retract) the chip group to container workloads — CDI
        spec write/remove (replaces daemonset restarts,
        composableresource_controller.go:252-286)."""
        raise NotImplementedError

    def wait_device_event(self, node: str = "", timeout: float = 1.0) -> bool:
        """Block until a device node appears/vanishes on the node, or
        timeout; True iff an event fired. Default: no watch capability —
        callers degrade to polling."""
        return False

    # -- scheduling quarantine (DeviceTaintRule analog, gpus.go:894-977) ---
    def create_device_taint(self, node: str, device_ids: List[str], reason: str) -> None:
        raise NotImplementedError

    def delete_device_taint(self, node: str, device_ids: List[str]) -> None:
        raise NotImplementedError

    def has_device_taint(self, node: str, device_id: str) -> bool:
        raise NotImplementedError


class LocalNodeAgent(NodeAgent):
    """Operates on the local host's real device stack.

    Uses the native library (``native/gpunode.cc``, built at first use by
    ``agent/native.py``) for device enumeration, ``/proc`` fd scanning,
    process names and the inotify watch on ``dev_dir``; the pure-Python
    paths run only where ``_native`` is None, which the tests set to hold
    the two against each other on one host. Paths are parameterized for
    tests and non-standard images: ``run_dir`` holds a driver container's
    runtime (``libtpu/libtpu.so``, ``nvidia/driver``).
    """

    def __init__(
        self,
        dev_dir: str = "/dev",
        proc_dir: str = "/proc",
        cdi_dir: str = cdimod.DEFAULT_CDI_DIR,
        libtpu_paths: Optional[List[str]] = None,
        state_dir: str = "/var/run/tpu-composer",
        libcuda_paths: Optional[List[str]] = None,
        run_dir: str = "/run",
    ) -> None:
        self.dev_dir = dev_dir
        self.proc_dir = proc_dir
        self.cdi_dir = cdi_dir
        self.libtpu_paths = libtpu_paths or [
            "/lib/libtpu.so",
            "/usr/lib/libtpu.so",
            "/usr/local/lib/libtpu.so",
            "/home/kubernetes/bin/libtpu.so",
        ]
        self.libcuda_paths = libcuda_paths or list(DEFAULT_LIBCUDA_PATHS)
        self.state_dir = state_dir
        self.run_dir = run_dir
        self._native = native_lib()

    # ------------------------------------------------------------------
    def ensure_driver(self, node: str) -> str:
        for p in self.libtpu_paths:
            if os.path.exists(p):
                return DriverType.HOST
        if self._nvidia_module_loaded() and any(
            os.path.exists(p) for p in self.libcuda_paths
        ):
            return DriverType.HOST
        # A driver container mounts its runtime under /run: libtpu, or the
        # containerized NVIDIA driver root /run/nvidia/driver (gpus.go:47).
        if os.path.exists(os.path.join(self.run_dir, "libtpu", "libtpu.so")):
            return DriverType.CONTAINER
        if os.path.isdir(os.path.join(self.run_dir, "nvidia", "driver")):
            return DriverType.CONTAINER
        raise AgentError(
            f"no libtpu and no NVIDIA driver found on {node}; looked in"
            f" {self.libtpu_paths}, {self.libcuda_paths} and"
            f" {os.path.join(self.proc_dir, 'driver', 'nvidia')}"
        )

    def _nvidia_module_loaded(self) -> bool:
        """The NVIDIA kernel module's proc directory: ``version`` on a host
        kernel; a sandboxed runtime (gVisor) exposes ``params`` alone."""
        root = os.path.join(self.proc_dir, "driver", "nvidia")
        return any(os.path.exists(os.path.join(root, f))
                   for f in ("version", "params"))

    def gpus(self) -> List[Tuple[str, int]]:
        """The host's GPUs as (PCI bus id, minor), ordinal k the k-th: the
        driver's listing in PCI bus order, else NVML's (bus id "" where it
        cannot report one). Empty on a host without NVIDIA GPUs."""
        root = os.path.join(self.proc_dir, "driver", "nvidia", "gpus")
        if not os.path.isdir(root):
            return nvml_gpus()
        out = []
        for info in sorted(glob.glob(os.path.join(root, "*", "information"))):
            with open(info) as f:
                fields = dict(
                    line.split(":", 1) for line in f if ":" in line
                )
            minor = fields.get("Device Minor")
            if minor is None:
                raise AgentError(f"{info} names no Device Minor")
            bus = os.path.basename(os.path.dirname(info))
            out.append((normalize_bus_id(bus), int(minor)))
        return sorted(out)

    def _rebase_gpu_nodes(self, spec: cdimod.CdiSpec) -> cdimod.CdiSpec:
        """The spec with each per-GPU node's ordinal replaced by the minor
        of the host's GPU of that ordinal."""
        minors = [m for _, m in self.gpus()]
        nodes = []
        for p in spec.device_nodes:
            base = os.path.basename(p)
            if _NVIDIA_GPU_NODE.match(base):
                k = int(base[len("nvidia"):])
                if k >= len(minors):
                    raise AgentError(
                        f"{spec.name}: GPU ordinal {k}, but the host lists"
                        f" {len(minors)} GPU(s)"
                    )
                p = os.path.join(os.path.dirname(p), f"nvidia{minors[k]}")
            nodes.append(p)
        return dataclasses.replace(spec, device_nodes=nodes)

    def _accel_nodes(self) -> List[str]:
        """Per-chip device nodes: ``accel*`` and the per-GPU ``nvidia<N>``."""
        if self._native is not None:
            return self._native.enum_accel(self.dev_dir)
        try:
            return sorted(
                os.path.join(self.dev_dir, fn)
                for fn in os.listdir(self.dev_dir)
                if fn.startswith("accel") or _NVIDIA_GPU_NODE.match(fn)
            )
        except FileNotFoundError:
            return []

    # -- device-node claims: which accel paths belong to which group -------
    # Recorded at CDI publish time so visibility/load checks are per-group
    # rather than count-based (co-located groups must not satisfy each
    # other's checks).
    def _claims_dir(self) -> str:
        return os.path.join(self.state_dir, "claims")

    def _claim_path(self, group: str) -> str:
        return os.path.join(self._claims_dir(), group.replace("/", "_") + ".json")

    def _record_claim(self, group: str, device_nodes: List[str]) -> None:
        # CDI specs carry container-visible paths (/dev/accelN, /dev/vfio/N
        # or /dev/nvidiaN); rebase onto this agent's dev_dir so checks work
        # under a relocated host root (tests, chrooted agents). Per-chip
        # nodes are accelN, per-GPU nvidiaN and numbered vfio group nodes;
        # the shared control nodes (/dev/vfio/vfio, /dev/nvidiactl,
        # /dev/nvidia-uvm*) are not per-group and are skipped.
        paths = []
        for p in device_nodes:
            base = os.path.basename(p)
            parent = os.path.basename(os.path.dirname(p))
            if base.startswith("accel") or _NVIDIA_GPU_NODE.match(base):
                paths.append(os.path.join(self.dev_dir, base))
            elif parent == "vfio" and base != "vfio":
                paths.append(os.path.join(self.dev_dir, "vfio", base))
        os.makedirs(self._claims_dir(), exist_ok=True)
        with open(self._claim_path(group), "w") as f:
            json.dump(sorted(paths), f)

    def _drop_claim(self, group: str) -> None:
        try:
            os.remove(self._claim_path(group))
        except FileNotFoundError:
            pass

    def list_composed_devices(self) -> Dict[str, List[str]]:
        """Public claim inventory: composed group name -> its device nodes.

        This is the contract the kubelet device plugin builds its device
        list from (agent/plugin.py lister_from_agent) — a stable accessor,
        not internal state."""
        return self._claims()

    def _claims(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        try:
            entries = os.listdir(self._claims_dir())
        except FileNotFoundError:
            return out
        for fn in entries:
            if fn.endswith(".json"):
                with open(os.path.join(self._claims_dir(), fn)) as f:
                    out[fn[:-5]] = json.load(f)
        return out

    def _group_paths(self, group: str, count: int) -> List[str]:
        """The accel paths to inspect for a group: its claimed nodes when the
        claim exists, else the host's accel nodes NOT claimed by others."""
        claims = self._claims()
        key = group.replace("/", "_") if group else ""
        if key and key in claims:
            return claims[key]
        others = {p for g, paths in claims.items() if g != key for p in paths}
        return [p for p in self._accel_nodes() if p not in others][: count or None]

    def check_visible(self, node: str, device_ids: List[str], group: str = "") -> bool:
        # Claimed paths may be accel or vfio nodes; presence on the host is
        # what "visible" means either way (CheckGPUVisible, gpus.go:207-239).
        paths = self._group_paths(group, len(device_ids))
        present = [p for p in paths if os.path.exists(p)]
        return len(present) >= len(device_ids) and bool(device_ids)

    def _holders(self, dev_path: str) -> List[int]:
        return self._holders_multi([dev_path]).get(dev_path, [])

    def _holders_multi(self, dev_paths: List[str]) -> Dict[str, List[int]]:
        """Holder pids for every path in ONE /proc sweep (a group drain
        checks 4+ device nodes; per-path sweeps scale O(paths x processes))."""
        if not dev_paths:
            return {}
        if self._native is not None:
            return self._native.fd_holders_multi(dev_paths, self.proc_dir)
        wanted = set(dev_paths)
        out: Dict[str, List[int]] = {p: [] for p in dev_paths}
        try:
            entries = os.listdir(self.proc_dir)
        except FileNotFoundError:
            return out
        for entry in entries:
            if not entry.isdigit():
                continue
            fd_dir = os.path.join(self.proc_dir, entry, "fd")
            try:
                for fd in os.listdir(fd_dir):
                    try:
                        target = os.readlink(os.path.join(fd_dir, fd))
                    except OSError:
                        continue
                    if target in wanted and int(entry) not in out[target]:
                        out[target].append(int(entry))
            except OSError:
                continue
        return out

    def _proc_name(self, pid: int) -> str:
        if self._native is not None:
            return self._native.proc_name(self.proc_dir, pid)
        try:
            with open(os.path.join(self.proc_dir, str(pid), "comm")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def _describe_holders(self, busy: Dict[str, List[int]]) -> str:
        """'/dev/accel0 held by 1234(python3)' — named-workload diagnostics,
        the parity point for the reference's query-compute-apps pid+name
        reporting (gpus.go:241-350)."""
        parts = []
        for path in sorted(busy):
            procs = ", ".join(
                f"{pid}({self._proc_name(pid) or '?'})" for pid in busy[path]
            )
            parts.append(f"{path} held by {procs}")
        return "; ".join(parts)

    def check_no_loads(self, node: str, device_ids: List[str], group: str = "") -> bool:
        holders = self._holders_multi(self._group_paths(group, len(device_ids)))
        return not any(holders.values())

    def drain(self, node: str, device_ids: List[str], force: bool = False,
              group: str = "") -> None:
        paths = self._group_paths(group, len(device_ids))
        if not force:
            busy = {p: h for p, h in self._holders_multi(paths).items() if h}
            if busy:
                raise DeviceBusyError(self._describe_holders(busy))
        # On a real fabric the unbind happens through the fabric manager; the
        # host-side publication retraction is targeted per group via
        # refresh_device_stack(remove_name=...) — drain must NOT touch CDI
        # specs, or it would destroy co-located groups' publications.

    def refresh_device_stack(self, node, spec=None, remove_name=""):
        if spec is not None:
            if spec.cdi_class == cdimod.CDI_CLASS_GPU:
                spec = self._rebase_gpu_nodes(spec)
            cdimod.write_cdi_spec(self.cdi_dir, spec)
            self._record_claim(spec.name, spec.device_nodes)
        if remove_name:
            # A publication name is one group's, whichever class it has.
            for cdi_class in (cdimod.CDI_CLASS, cdimod.CDI_CLASS_GPU):
                cdimod.remove_cdi_spec(self.cdi_dir, remove_name, cdi_class)
            self._drop_claim(remove_name)

    def _dev_snapshot(self) -> set:
        try:
            return set(os.listdir(self.dev_dir))
        except OSError:
            return set()

    def wait_device_event(self, node: str = "", timeout: float = 1.0) -> bool:
        """Block until a device node appears/vanishes under dev_dir, or
        timeout. True iff an event fired. ``node`` is ignored (a local agent
        serves exactly one host). The native path is an inotify watch
        (``tpun_watch_dev``); the Python path, and the native one when
        inotify fails, compares directory snapshots on a 50ms cadence.

        The inotify watch is armed per call, so an event landing between
        two calls would be invisible to it; a cross-call snapshot diff
        reports any change since the previous call as an immediate
        event."""
        timeout = max(0.0, timeout)
        current = self._dev_snapshot()
        last = getattr(self, "_last_dev_snapshot", None)
        self._last_dev_snapshot = current
        if last is not None and current != last:
            return True
        if self._native is not None:
            rc = self._native.watch_dev(self.dev_dir, int(timeout * 1000))
            if rc >= 0:
                if rc == 1:
                    self._last_dev_snapshot = self._dev_snapshot()
                    return True
                return False
            # inotify failed: the polling loop below
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            _time.sleep(0.05)
            now = self._dev_snapshot()
            if now != current:
                self._last_dev_snapshot = now
                return True
        return False

    # -- taints are marker files under state_dir ------------------------
    def _taint_path(self, device_id: str) -> str:
        safe = device_id.replace("/", "_")
        return os.path.join(self.state_dir, "taints", safe)

    def create_device_taint(self, node, device_ids, reason):
        os.makedirs(os.path.join(self.state_dir, "taints"), exist_ok=True)
        for d in device_ids:
            with open(self._taint_path(d), "w") as f:
                f.write(reason)

    def delete_device_taint(self, node, device_ids):
        for d in device_ids:
            try:
                os.remove(self._taint_path(d))
            except FileNotFoundError:
                pass

    def has_device_taint(self, node, device_id) -> bool:
        return os.path.exists(self._taint_path(device_id))
