"""tpu_composer_torch.fleet — multi-process operator fleets (port of
``tpu_composer/fleet/``).

The proc-mode supervisor (``proc.py``) spawns N full command-line operator
replicas (``python -m tpu_composer_torch``) as real OS processes against a
shared wire-level store (tpu_composer_torch.sim.apiserver) and a served
fake fabric.

Distinct from tpu_composer_torch.runtime.fleet (the fleet *telemetry*
plane each replica runs); this package is the thing that launches the
replicas.
"""
