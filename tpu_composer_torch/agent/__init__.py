"""The node agent's side of composition (port of ``tpu_composer/agent/``):
only the CDI spec so far. The node agent itself, its device scan and the
native library wait for the control plane's port."""
