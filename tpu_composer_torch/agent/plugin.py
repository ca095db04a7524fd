"""Kubelet device plugin — composed chips become schedulable pod resources
(port of ``tpu_composer/agent/plugin.py``).

The plugin speaks the real kubelet gRPC wire protocol
(deviceplugin.proto, v1beta1):

- serves ``DevicePlugin`` (ListAndWatch stream + Allocate) on a unix socket
  under the kubelet plugin directory;
- registers with the kubelet's ``Registration`` service, advertising the
  extended resource ``tpu.composer.dev/chips``;
- sources its device list from the node agent's CDI claim state, so the
  plugin's advertisement is always exactly what the operator attached;
- ``Allocate`` answers a TPU chip with its CDI device name, its raw
  ``/dev/accel*`` device spec and ``TPU_VISIBLE_CHIPS``, exactly as the JAX
  package does; an NVIDIA GPU (a ``/dev/nvidia<minor>`` node) with its
  group's CDI name (class ``gpu``), its device node and NVIDIA's control
  nodes (``cdi.NVIDIA_CONTROL_NODES``), and ``CUDA_VISIBLE_DEVICES``
  naming the allocated GPUs as the container sees them: the container
  holds only their nodes, so CUDA numbers them ``0..n-1``, in PCI bus
  order under ``CUDA_DEVICE_ORDER=PCI_BUS_ID``.

Reference analog: the reference depends on NVIDIA's external device-plugin
daemonset and merely restarts it after attach/detach
(composableresource_controller.go:252-270, utils/nodes.go:35-76). Building
the plugin into the node agent removes the restart dance entirely: the agent
nudges ``notify()`` on attach/detach and the ListAndWatch stream pushes the
new device list immediately.

gRPC wiring is hand-rolled against the generated protobuf messages
(``deviceplugin_pb2.py``, whose serialized descriptor is byte-identical to
the JAX package's: protobuf's default pool keys it by the file name
``deviceplugin.proto``, and an identical second add is accepted).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import grpc

from tpu_composer_torch.agent import cdi as cdimod
from tpu_composer_torch.agent import deviceplugin_pb2 as pb
from tpu_composer_torch.agent.nodeagent import _NVIDIA_GPU_NODE

RESOURCE_NAME = "tpu.composer.dev/chips"
KUBELET_SOCKET = "kubelet.sock"
PLUGIN_SOCKET = "tpu-composer.sock"
API_VERSION = "v1beta1"

# list_devices() -> [(device_id, healthy, dev_path, cdi_name)]
DeviceLister = Callable[[], Sequence[Tuple[str, bool, str, str]]]


def _gpu_minor(dev_path: str) -> Optional[int]:
    """The minor of a per-GPU node ``/dev/nvidia<minor>``, else None."""
    base = os.path.basename(dev_path)
    if _NVIDIA_GPU_NODE.match(base):
        return int(base[len("nvidia"):])
    return None


class TPUDevicePlugin:
    """One plugin instance per node agent."""

    def __init__(
        self,
        list_devices: DeviceLister,
        plugin_dir: str,
        node_name: str = "",
        resource_name: str = RESOURCE_NAME,
    ) -> None:
        self.list_devices = list_devices
        self.plugin_dir = plugin_dir
        self.node_name = node_name
        self.resource_name = resource_name
        self.log = logging.getLogger("TPUDevicePlugin")
        self._server: Optional[grpc.Server] = None
        self._changed = threading.Condition()
        self._stopped = threading.Event()
        self.allocations: Dict[str, List[str]] = {}  # container hint -> ids

    # ------------------------------------------------------------------
    # service handlers
    # ------------------------------------------------------------------
    def _options(self, request, context) -> pb.DevicePluginOptions:
        return pb.DevicePluginOptions(pre_start_required=False)

    def _snapshot(self) -> List[pb.Device]:
        return [
            pb.Device(ID=dev_id, health="Healthy" if healthy else "Unhealthy")
            for dev_id, healthy, _, _ in self.list_devices()
        ]

    def _list_and_watch(self, request, context):
        """Stream the device list; push an update whenever notify() fires.

        The kubelet holds this stream open for the plugin's lifetime and
        folds every response into node allocatable."""
        last: Optional[List[Tuple[str, str]]] = None
        while not self._stopped.is_set() and context.is_active():
            devices = self._snapshot()
            key = sorted((d.ID, d.health) for d in devices)
            if key != last:
                last = key
                yield pb.ListAndWatchResponse(devices=devices)
            with self._changed:
                self._changed.wait(timeout=1.0)

    def _allocate(self, request: pb.AllocateRequest, context) -> pb.AllocateResponse:
        byid = {d[0]: d for d in self.list_devices()}
        responses = []
        for creq in request.container_requests:
            devspecs: List[pb.DeviceSpec] = []
            cdi: List[pb.CDIDevice] = []
            allocated: List[str] = []
            visible: List[str] = []  # TPU chips
            gpus = 0
            for dev_id in creq.devices_ids:
                dev = byid.get(dev_id)
                if dev is None:
                    context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        f"device {dev_id} not available on this node",
                    )
                _, _, dev_path, cdi_name = dev
                allocated.append(dev_id)
                if _gpu_minor(dev_path) is None:
                    if cdi_name:
                        cdi.append(pb.CDIDevice(name=cdi_name))
                    if dev_path:
                        devspecs.append(_devspec(dev_path))
                    visible.append(dev_id)
                    continue
                gpus += 1
                if cdi_name and cdi_name not in [c.name for c in cdi]:
                    cdi.append(pb.CDIDevice(name=cdi_name))
                devspecs.append(_devspec(dev_path))
            if gpus:
                devspecs += [_devspec(p) for p in cdimod.NVIDIA_CONTROL_NODES]
            self.allocations[",".join(sorted(allocated))] = allocated
            envs = {}
            if visible or not gpus:
                envs["TPU_VISIBLE_CHIPS"] = ",".join(visible)
            if gpus:
                # The container holds only the allocated GPUs' nodes, so
                # CUDA there numbers them 0..n-1, whatever their minors.
                envs["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(gpus)))
                envs["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
            responses.append(
                pb.ContainerAllocateResponse(
                    envs=envs,
                    devices=devspecs,
                    cdi_devices=cdi,
                )
            )
        return pb.AllocateResponse(container_responses=responses)

    def _pre_start(self, request, context) -> pb.PreStartContainerResponse:
        return pb.PreStartContainerResponse()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def socket_path(self) -> str:
        return os.path.join(self.plugin_dir, PLUGIN_SOCKET)

    def notify(self) -> None:
        """Device set changed (attach/detach) — push to the kubelet now."""
        with self._changed:
            self._changed.notify_all()

    def start(self) -> None:
        os.makedirs(self.plugin_dir, exist_ok=True)
        try:
            os.remove(self.socket_path)
        except FileNotFoundError:
            pass
        server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=4))
        handlers = {
            "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                self._options,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.DevicePluginOptions.SerializeToString,
            ),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                self._list_and_watch,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ListAndWatchResponse.SerializeToString,
            ),
            "Allocate": grpc.unary_unary_rpc_method_handler(
                self._allocate,
                request_deserializer=pb.AllocateRequest.FromString,
                response_serializer=pb.AllocateResponse.SerializeToString,
            ),
            "PreStartContainer": grpc.unary_unary_rpc_method_handler(
                self._pre_start,
                request_deserializer=pb.PreStartContainerRequest.FromString,
                response_serializer=pb.PreStartContainerResponse.SerializeToString,
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(f"{API_VERSION}.DevicePlugin", handlers),)
        )
        server.add_insecure_port(f"unix:{self.socket_path}")
        server.start()
        self._server = server
        self.log.info("device plugin serving on %s", self.socket_path)

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None) -> None:
        """Announce ourselves: kubelet then dials our endpoint back."""
        sock = kubelet_socket or os.path.join(self.plugin_dir, KUBELET_SOCKET)
        with grpc.insecure_channel(f"unix:{sock}") as channel:
            register = channel.unary_unary(
                f"/{API_VERSION}.Registration/Register",
                request_serializer=pb.RegisterRequest.SerializeToString,
                response_deserializer=pb.Empty.FromString,
            )
            register(
                pb.RegisterRequest(
                    version=API_VERSION,
                    endpoint=PLUGIN_SOCKET,
                    resource_name=self.resource_name,
                    options=pb.DevicePluginOptions(pre_start_required=False),
                ),
                timeout=5.0,
            )
        self.log.info("registered %s with kubelet at %s", self.resource_name, sock)

    def stop(self) -> None:
        self._stopped.set()
        self.notify()
        if self._server is not None:
            self._server.stop(grace=1.0).wait(timeout=5.0)
            self._server = None
        try:
            os.remove(self.socket_path)
        except FileNotFoundError:
            pass


def _devspec(path: str) -> pb.DeviceSpec:
    return pb.DeviceSpec(container_path=path, host_path=path, permissions="rw")


def lister_from_agent(agent) -> DeviceLister:
    """Adapt a LocalNodeAgent's CDI claim state to the plugin's device list.

    Each claimed group contributes its chips; device id = ``<group>/<idx>``
    with the CDI qualified name for runtime injection: the JAX package's
    ``tpu.composer.dev/chip=<group>`` for TPU chips, the GPU spec's own
    (``tpu.composer.dev/gpu=<group>``) for GPUs. Unclaimed chips are not
    advertised — the scheduler only sees what the operator composed.
    Consumes the agent's public list_composed_devices() contract."""

    def list_devices():
        out = []
        for group, dev_nodes in sorted(agent.list_composed_devices().items()):
            for idx, dev in enumerate(sorted(dev_nodes)):
                cdi_class = (cdimod.CDI_CLASS_GPU if _gpu_minor(dev) is not None
                             else "chip")
                out.append(
                    (f"{group}/{idx}", True, dev,
                     f"{cdimod.CDI_VENDOR}/{cdi_class}={group}")
                )
        return out

    return list_devices
