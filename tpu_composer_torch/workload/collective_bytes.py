"""Collective traffic per mesh dim, counted from the port's own collectives
(the counterpart of ``tpu_composer/workload/hlo_collectives.py``).

The JAX package reads the collectives XLA compiled into a program's
post-optimization HLO. The port has no HLO: its collectives are the
calls ``parallel/collectives.py`` makes. :func:`record_collectives`
counts every one this rank sends while it is open, each op the moment it
runs, from the forward and from the backward alike: ``all_reduce``,
``sum_over_`` and the backward of ``enter_parallel`` as all-reduce,
``all_gather`` and the backward of ``shard`` and ``reduce_scatter`` as
all-gather, ``reduce_scatter``, ``all_to_all``, and ``ppermute`` (with
``ring_shift``) as collective-permute. Each is attributed to the mesh dim
(or combination of dims) whose group it ran over, and its bytes are those
of its result on this rank, as the JAX package counts an HLO op's.

How the counts differ from JAX's: JAX counts static HLO instances (an op
inside a loop counts once, and XLA may fuse or split collectives); these
are dynamic calls on one rank over the recorded window, so a ring of n
ranks counts its n − 1 shifts, and a step that reduces its gradients in
one flat buffer per dtype counts one all-reduce for them. The summary
has ``collective_summary``'s schema.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.parallel import collectives
from tpu_composer_torch.parallel.mesh import mesh_shape


def _axis_groups(mesh: Optional[DeviceMesh]) -> Dict[frozenset, str]:
    """The ranks of this rank's group over each dim of ``mesh`` and each
    combination of dims -> its label ("dp", "dp+tp", ...): single dims
    first, then pairs and so on, the first label kept, as
    ``hlo_collectives._axis_partitions`` labels them."""
    out: Dict[frozenset, str] = {}
    if mesh is None or mesh.get_coordinate() is None:
        return out
    names = list(mesh.mesh_dim_names or ())
    grid, coord = mesh.mesh, mesh.get_coordinate()
    for r in range(1, len(names) + 1):
        for combo in itertools.combinations(range(len(names)), r):
            index = tuple(slice(None) if i in combo else coord[i]
                          for i in range(len(names)))
            ranks = frozenset(int(x) for x in grid[index].flatten())
            out.setdefault(ranks, "+".join(names[i] for i in combo))
    return out


class CollectiveRecorder:
    """The collectives this rank sent while recording, keyed by (op,
    dim, bytes per instance)."""

    def __init__(self, mesh: Optional[DeviceMesh]):
        self.mesh_axes = mesh_shape(mesh)
        self._labels = _axis_groups(mesh)
        self._lock = threading.Lock()  # a backward may run in another thread
        self._ops: Dict[Tuple[str, str, int], Dict[str, Any]] = {}

    def note(self, op: str, group, n_bytes: int) -> None:
        ranks = frozenset(dist.get_process_group_ranks(group))
        axis = self._labels.get(ranks, "unmapped")
        with self._lock:
            rec = self._ops.setdefault((op, axis, n_bytes), {
                "op": op, "axis": axis, "group_size": len(ranks),
                "bytes_per_instance": n_bytes, "instances": 0})
            rec["instances"] += 1

    def summary(self) -> Dict[str, Any]:
        """``collective_summary``'s record: ``mesh_axes``, ``ops`` (op,
        axis, group size, bytes per instance, instances; the most bytes
        first), ``per_axis_bytes``, ``op_counts`` and ``total_bytes``."""
        with self._lock:
            ops = sorted((dict(r) for r in self._ops.values()),
                         key=lambda r: -r["bytes_per_instance"]
                         * r["instances"])
        per_axis: Dict[str, int] = {}
        op_counts: Dict[str, int] = {}
        for r in ops:
            total = r["bytes_per_instance"] * r["instances"]
            per_axis[r["axis"]] = per_axis.get(r["axis"], 0) + total
            op_counts[r["op"]] = op_counts.get(r["op"], 0) + r["instances"]
        return {
            "mesh_axes": dict(self.mesh_axes),
            "ops": ops,
            "per_axis_bytes": per_axis,
            "op_counts": op_counts,
            "total_bytes": sum(per_axis.values()),
        }


@contextmanager
def record_collectives(mesh: Optional[DeviceMesh]
                       ) -> Iterator[CollectiveRecorder]:
    """Count the collectives this rank sends inside the block, attributed
    to the dims of ``mesh``; read ``summary()`` of what it yields."""
    rec = CollectiveRecorder(mesh)
    collectives._recorders.append(rec)
    try:
        yield rec
    finally:
        collectives._recorders.remove(rec)
