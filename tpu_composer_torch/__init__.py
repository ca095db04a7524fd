"""PyTorch + CUDA port of tpu_composer's workload layer.

The JAX package (``tpu_composer``) is the reference this package is held
against; nothing here imports it. The layout mirrors it module for
module: ``ops/`` holds attention and its hand-written Hopper kernels
(``csrc/``), ``models/`` the transformer, KV-cached decoding, the paged
cache and the continuous-batching engine, ``parallel/`` the device mesh,
collectives, sequence-parallel attention, the train step (one card or a
mesh) and checkpoints, ``data/`` the packed-LM
pipeline, ``workload/`` the training loop and slice qualification, and
``examples/`` a runnable training script.

Entry points that create tensors take a ``device`` (default ``"cuda"``)
and raise when no card is present unless the caller asks for ``"cpu"``.
"""
