"""Slice topology solving (port of ``tpu_composer/topology/``): a chip
count of one accelerator model solved into a slice shape placed whole
across hosts, for the TPU generations and the NVIDIA H100."""

from tpu_composer_torch.topology.slices import (
    GPU_MODELS,
    MODELS,
    TPU_MODELS,
    GpuModel,
    SliceShape,
    TopologyError,
    TpuModel,
    is_chip_group_model,
    is_gpu_model,
    is_tpu_model,
    solve_slice,
)

__all__ = [
    "GPU_MODELS",
    "GpuModel",
    "MODELS",
    "SliceShape",
    "TopologyError",
    "TpuModel",
    "TPU_MODELS",
    "is_chip_group_model",
    "is_gpu_model",
    "is_tpu_model",
    "solve_slice",
]
