"""The simulated-cluster layer (port of ``tpu_composer/sim/``).

Wire-level fakes and workload generators that exercise the real operator
stack:

- ``apiserver``: the kube-apiserver fake speaking the real K8s wire
  protocol (plain HTTP and the ``tpuc-mux/1`` framed transport),
  launchable via ``python -m tpu_composer_torch.sim.apiserver``;
- ``netchaos``: a TCP proxy that injects latency, drops and partitions
  between a client and the apiserver;
- ``churn``: the deterministic, seeded macro-scale churn generator driving
  thousands of concurrent ComposabilityRequests against a simulated
  inventory.

Nothing here runs in production.
"""
