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
objects), ``runtime/`` (the object store and its wire, work queues,
controllers, the manager with its health and TLS metrics ports, leases
and shards, the fleet and SLO planes and the scheduler's capacity and
goodput observatory), ``fabric/`` (the provider interface, the in-memory
pool and the remote backends), ``agent/`` (the node agent over
``/dev/accel*`` and ``/dev/nvidia*`` with its native scan of
``native/gpunode.cc``, the CDI spec, the node-agent daemon and its
client, the device event watchers and the kubelet device plugin),
``admission/`` (the validating webhooks, coordinate injection and the
AdmissionReview server), ``scheduler/`` (placement, preemption,
defragmentation and the decision ledger, with the native scan of
``native/tpusched.cc``; both native libraries are built by the host C++
compiler at first use), ``controllers/`` (the ComposabilityRequest and
ComposableResource reconcilers, the syncer, cold-start adoption and the
NodeMaintenance drain), ``cmd/`` (the operator's command line:
``python -m tpu_composer_torch``, with its ``trace-merge`` and
``explain`` subcommands), ``fleet/`` (a supervisor that runs the
binary's replicas as processes over a served apiserver and fabric) and
the tooling: ``analysis/`` (the lint, ``python -m
tpu_composer_torch.analysis``, and the lock-order witness) and
``api/{crdgen,packaging,validate_manifests}.py`` (the CRDs, the
installer and bundle from ``deploy/``, the manifest checks). These
import no torch.

Entry points that create tensors take a ``device`` (default ``"cuda"``)
and raise when no card is present unless the caller asks for ``"cpu"``.
"""

GROUP = "tpu.composer.dev"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
