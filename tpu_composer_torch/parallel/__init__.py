"""Training on one card or over a device mesh: the mesh, differentiable
collectives and the allreduce probe, ring/zigzag and Ulysses attention,
the GPipe pipeline, the train step with the live reshard, and
checkpoints.

The names of ``tpu_composer/parallel/__init__.py`` are exported here and
imported on first use: ``models/`` imports ``parallel.collectives``, so
importing the train step while this package initialises would import
the models half-built."""

from importlib import import_module

_EXPORTS = {
    "make_mesh": "mesh",
    "solve_mesh_axes": "mesh",
    "all_gather": "collectives",
    "all_reduce": "collectives",
    "allreduce_bandwidth_gbps": "collectives",
    "reduce_scatter": "collectives",
    "ring_shift": "collectives",
    "ring_attention": "ring_attention",
    "ring_attention_zigzag": "ring_attention",
    "ulysses_attention": "ulysses",
    "pipeline_apply": "pipeline",
    "pipelined_forward": "pipeline",
    "pipelined_loss_fn": "pipeline",
    "stack_layers": "pipeline",
    "stacked_layer_specs": "pipeline",
    "transformer_stage_fn": "pipeline",
    "TrainConfig": "train",
    "make_train_state": "train",
    "abstract_train_state": "train",
    "make_train_step": "train",
    "reshard_train_state": "train",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
