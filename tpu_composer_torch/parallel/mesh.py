"""Device meshes over a process group (port of
``tpu_composer/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, its dims named in the JAX package's axis order: dp, ep,
pp, sp, tp. Each rank holds its local shards and the port calls its
collectives over a named dim explicitly (``parallel/collectives.py``), as
the JAX package's ``shard_map`` islands do; there is no GSPMD.

Launching ranks is the caller's: :func:`init_world` joins the default
group and sets the rank's card (the JAX package takes its devices from
``jax.devices()`` instead). NCCL refuses two ranks on one card, so a
world of several ranks on one card runs over gloo; the collectives then
stage CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_composer_torch.device import DeviceLike, resolve_device

AXIS_ORDER = ("dp", "ep", "pp", "sp", "tp")


def solve_mesh_axes(
    n_devices: int,
    dp: int = 0,
    sp: int = 0,
    tp: int = 0,
    pp: int = 0,
    ep: int = 0,
) -> Dict[str, int]:
    """Factor ``n_devices`` into named parallelism axis sizes.

    Always solves (dp, sp, tp); pipeline (pp) and expert (ep) axes join
    the mesh only when asked for (nonzero). Fixed (nonzero) degrees are
    kept; free axes take the remainder in the order tp <= 8, then sp,
    then dp takes what is left. Raises if the fixed degrees do not
    divide the device count. The returned dict is in mesh order: dp, ep,
    pp, sp, tp."""
    remaining = n_devices
    for name, v in (("dp", dp), ("ep", ep), ("pp", pp), ("sp", sp),
                    ("tp", tp)):
        if v:
            if remaining % v != 0:
                raise ValueError(
                    f"{name}={v} does not divide remaining device count"
                    f" {remaining}")
            remaining //= v
    if tp == 0:
        tp = 1
        for cand in (8, 4, 2):
            if remaining % cand == 0:
                tp = cand
                break
        remaining //= tp
    if sp == 0:
        sp = 2 if remaining % 2 == 0 and remaining >= 2 else 1
        remaining //= sp
    if dp == 0:
        dp = remaining
        remaining = 1
    total = dp * max(ep, 1) * max(pp, 1) * sp * tp
    if total != n_devices:
        raise ValueError(f"axis product {total} != device count {n_devices}")
    axes = {"dp": dp}
    if ep:
        axes["ep"] = ep
    if pp:
        axes["pp"] = pp
    axes["sp"] = sp
    axes["tp"] = tp
    return axes


def init_world(backend: str, rank: int, world_size: int, init_method: str,
               device: DeviceLike = "cuda",
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return the rank's device: ``cuda:<rank % cards>`` (or the CPU when
    ``device`` is ``"cpu"``), made current. Every collective of the group
    raises after ``timeout_s`` instead of waiting forever."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over the default process group with the dims of
    ``axis_sizes`` in their dict order (default: ``solve_mesh_axes`` of
    the world size). Raises when the product of the sizes is not the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group:"
                           " call init_world first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = solve_mesh_axes(world)
    shape = tuple(axis_sizes.values())
    total = 1
    for v in shape:
        total *= v
    if total != world:
        raise ValueError(
            f"mesh shape {shape} needs {total} devices, have {world}")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_sizes))


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of dim ``name`` of ``mesh``; 1 without a mesh or dim."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along dim ``name``; 0 when the dim is
    absent."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)
