"""Chip-count → slice-shape solver (port of
``tpu_composer/topology/slices.py``), with the NVIDIA H100 beside the TPU
generations.

TPU rows, copied unchanged so that they solve exactly as the JAX
package's do:

- each TPU generation has an ICI dimensionality (3D torus for v4/v5p, 2D for
  v5e/v6e) and a fixed chips-per-host;
- a multi-host slice's chip count must tile whole hosts, and every torus
  dimension must be a power of two (wrap-around links come in powers of two on
  the optical switch fabric);
- sub-host counts (1 chip, or 2 on 3D generations) are "standalone" shapes
  with no torus requirement.

The solver prefers the most compact (closest-to-cube) shape because compact
tori minimize the worst-case hop count and maximize bisection bandwidth.

The NVIDIA row (:class:`GpuModel`) has no torus. One host's GPUs are
joined all to all through its NVSwitches, so any count from 1 to
``chips_per_host`` is a slice of one host, and every GPU pair is one hop
apart. Beyond one host the hosts meet over the scale-out network
(InfiniBand), which a job uses through NCCL whatever the host count:
such a slice takes whole hosts, any number of them, with no power-of-two
rule. Its topology string is ``"<gpus per host>x<hosts>"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union


class TopologyError(ValueError):
    pass


@dataclass(frozen=True)
class TpuModel:
    """Per-generation fabric constraints."""

    name: str
    ici_dims: int  # 3 = 3D torus (v4/v5p), 2 = 2D (v5e/v6e)
    chips_per_host: int
    max_chips: int
    # Chip counts allowed below one full host (no torus formed).
    standalone_counts: Tuple[int, ...]
    # How one host's chips are arranged on the ICI mesh (the single-full-host
    # slice shape, e.g. v4's 2x2x1 tray).
    host_dims: Tuple[int, ...] = ()


@dataclass(frozen=True)
class GpuModel:
    """A GPU host: ``chips_per_host`` GPUs all to all over NVSwitch,
    whole hosts beyond it."""

    name: str
    chips_per_host: int
    max_chips: int


TPU_MODELS: Dict[str, TpuModel] = {
    m.name: m
    for m in (
        TpuModel("tpu-v4", ici_dims=3, chips_per_host=4, max_chips=4096,
                 standalone_counts=(1, 2), host_dims=(2, 2, 1)),
        TpuModel("tpu-v5p", ici_dims=3, chips_per_host=4, max_chips=8960,
                 standalone_counts=(1, 2), host_dims=(2, 2, 1)),
        TpuModel("tpu-v5e", ici_dims=2, chips_per_host=8, max_chips=256,
                 standalone_counts=(1, 2, 4), host_dims=(2, 4)),
        TpuModel("tpu-v6e", ici_dims=2, chips_per_host=8, max_chips=256,
                 standalone_counts=(1, 2, 4), host_dims=(2, 4)),
    )
}

# An HGX H100 host (DGX H100): 8 SXM GPUs on four NVSwitches. max_chips is
# the largest compute fabric of NVIDIA's DGX SuperPOD reference
# architecture for DGX H100: four scalable units of 32 systems, one slot
# given to the fabric manager, so 127 systems of 8 GPUs.
GPU_MODELS: Dict[str, GpuModel] = {
    m.name: m
    for m in (
        GpuModel("nvidia-h100-sxm", chips_per_host=8, max_chips=127 * 8),
    )
}

Model = Union[TpuModel, GpuModel]
MODELS: Dict[str, Model] = {**TPU_MODELS, **GPU_MODELS}


def is_tpu_model(model: str) -> bool:
    return model in TPU_MODELS


def is_gpu_model(model: str) -> bool:
    return model in GPU_MODELS


def is_chip_group_model(model: str) -> bool:
    """Whether ``model`` is composed as slice-member chip groups: host-local
    chip indices, a CDI spec with the coordinate env, per-group device
    claims. True for the TPU generations and the H100; other models (the
    ``gpu-a100`` compat path) attach as loose devices."""
    return is_tpu_model(model) or is_gpu_model(model)


def is_chip_group(type_: str, model: str) -> bool:
    """Whether a request or member of ``type_`` and ``model`` takes the
    slice path: every ``tpu`` request, as in the JAX package (an unknown
    TPU model then fails in ``solve_slice``), and an H100 request. Other
    gpu models, TPU model names among them, attach as loose devices."""
    return type_ == "tpu" or is_gpu_model(model)


@dataclass(frozen=True)
class SliceShape:
    model: str
    dims: Tuple[int, ...]  # e.g. (2, 2, 4); (gpus per host, hosts) for GPUs
    num_chips: int
    num_hosts: int
    chips_per_host: int

    @property
    def topology(self) -> str:
        return "x".join(str(d) for d in self.dims)

    def worker_chip_indices(self, worker_id: int) -> List[int]:
        """Chip indices (slice-local) owned by one host/worker."""
        start = worker_id * self.chips_per_host
        return list(range(start, min(start + self.chips_per_host, self.num_chips)))


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _parse_dims(topology: str) -> Tuple[int, ...]:
    try:
        dims = tuple(int(p) for p in topology.lower().split("x"))
    except ValueError:
        raise TopologyError(f"unparseable topology {topology!r}") from None
    if not dims or any(d < 1 for d in dims):
        raise TopologyError(f"invalid topology {topology!r}")
    return dims


def _candidate_shapes(model: TpuModel, count: int) -> List[Tuple[int, ...]]:
    """All valid dim-tuples (sorted ascending) for `count` chips."""
    if count in model.standalone_counts:
        # Standalone sub-host shape: a simple line, no torus constraint.
        return [(count,) if model.ici_dims == 2 else (1, 1, count)]
    if count % model.chips_per_host != 0:
        return []
    if count == model.chips_per_host:
        # One full host: the slice shape IS the host tray shape.
        return [tuple(sorted(model.host_dims))]
    out = []
    if model.ici_dims == 3:
        for x in _pow2_divisors(count):
            for y in _pow2_divisors(count // x):
                z = count // (x * y)
                if x <= y <= z and _is_pow2(z) and x >= 2:
                    out.append((x, y, z))
    else:
        for x in _pow2_divisors(count):
            y = count // x
            if x <= y and _is_pow2(y) and x >= 2:
                out.append((x, y))
    return out


def _pow2_divisors(n: int) -> List[int]:
    return [d for d in (2 ** i for i in range(n.bit_length())) if n % d == 0]


def _compactness(dims: Tuple[int, ...]) -> float:
    # Lower is better: max/min aspect ratio; ties broken by perimeter.
    return max(dims) / min(dims) + 1e-3 * sum(dims)


def _gpu_shape(model: GpuModel, count: int) -> Tuple[int, ...]:
    """(gpus per host, hosts) for ``count`` GPUs, or () when the count
    is neither part of one host nor whole hosts."""
    if count <= model.chips_per_host:
        return (count, 1)
    if count % model.chips_per_host:
        return ()
    return (model.chips_per_host, count // model.chips_per_host)


def _solve_gpu(model: GpuModel, count: int, topology: str) -> SliceShape:
    dims = _gpu_shape(model, count)
    if not dims:
        valid = list(range(1, model.chips_per_host + 1)) + list(range(
            2 * model.chips_per_host,
            min(count * 2, model.max_chips) + 1, model.chips_per_host))
        raise TopologyError(
            f"{count} chips of {model.name} cannot form a slice;"
            f" nearby valid counts: {valid[:12]}"
        )
    if topology:
        pinned = _parse_dims(topology)
        want = 1
        for d in pinned:
            want *= d
        if want != count:
            raise TopologyError(
                f"topology {topology!r} has {want} chips but size is {count}"
            )
        if pinned != dims:
            raise TopologyError(
                f"topology {topology!r} is not a valid {model.name} slice"
                f" shape; valid: ['{'x'.join(map(str, dims))}']"
            )
    return SliceShape(model=model.name, dims=dims, num_chips=count,
                      num_hosts=dims[1], chips_per_host=dims[0])


def solve_slice(model_name: str, count: int, topology: str = "") -> SliceShape:
    """Solve `count` chips of `model_name` into a valid slice shape.

    An explicit ``topology`` (e.g. "2x2x4", or "8x2" for two H100 hosts)
    pins the shape after validation; otherwise the most compact valid
    shape is chosen.
    """
    model = MODELS.get(model_name)
    if model is None:
        raise TopologyError(
            f"unknown accelerator model {model_name!r}; known: {sorted(MODELS)}"
        )
    if count < 1:
        raise TopologyError("chip count must be >= 1")
    if count > model.max_chips:
        raise TopologyError(
            f"{model_name} supports at most {model.max_chips} chips, requested {count}"
        )
    if isinstance(model, GpuModel):
        return _solve_gpu(model, count, topology)

    candidates = _candidate_shapes(model, count)
    if not candidates:
        valid = sorted(
            set(model.standalone_counts)
            | {c for c in range(model.chips_per_host, min(count * 2, model.max_chips) + 1, model.chips_per_host)
               if _candidate_shapes(model, c)}
        )
        raise TopologyError(
            f"{count} chips of {model_name} cannot form a slice;"
            f" nearby valid counts: {valid[:12]}"
        )

    if topology:
        dims = _parse_dims(topology)
        want = 1
        for d in dims:
            want *= d
        if want != count:
            raise TopologyError(
                f"topology {topology!r} has {want} chips but size is {count}"
            )
        if tuple(sorted(dims)) not in {tuple(sorted(c)) for c in candidates}:
            raise TopologyError(
                f"topology {topology!r} is not a valid {model_name} slice shape;"
                f" valid: {['x'.join(map(str, c)) for c in candidates]}"
            )
    else:
        dims = min(candidates, key=_compactness)

    num_hosts = max(1, count // model.chips_per_host)
    return SliceShape(
        model=model_name,
        dims=tuple(dims),
        num_chips=count,
        num_hosts=num_hosts,
        chips_per_host=min(count, model.chips_per_host),
    )
