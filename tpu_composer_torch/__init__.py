"""PyTorch + CUDA port of tpu_composer.

The JAX package (``tpu_composer``) is the reference this package is held
against; nothing here imports it. The layout mirrors it module for
module: ``ops/`` holds attention and its hand-written Hopper kernels
(``csrc/``), ``models/`` the transformer, KV-cached decoding, the paged
cache and the continuous-batching engine, ``parallel/`` the device mesh,
collectives, sequence-parallel attention, the train step (one card or a
mesh) and checkpoints, ``data/`` the packed-LM
pipeline, ``workload/`` the training loop and slice qualification, and
``examples/`` a runnable training script.

The operator composes the accelerator onto a node: ``api/`` (the API
objects), ``runtime/`` (the object store, work queues, controllers, the
manager and the scheduler's capacity and goodput observatory),
``fabric/`` (the provider interface and the in-memory pool), ``agent/``
(the node agent, ``/dev/accel*`` and ``/dev/nvidia*``, and the CDI spec),
``scheduler/`` (placement, preemption, defragmentation and the decision
ledger, with the native scan of ``native/tpusched.cc`` built by the host
C++ compiler at first use) and ``controllers/`` (the ComposabilityRequest
and ComposableResource reconcilers, the syncer, cold-start adoption and
the NodeMaintenance drain). These import no torch.

Entry points that create tensors take a ``device`` (default ``"cuda"``)
and raise when no card is present unless the caller asks for ``"cpu"``.
"""

GROUP = "tpu.composer.dev"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
