"""Admission (port of ``tpu_composer/admission/``): the mutating side's
coordinate injection, for TPU slices and for GPU slices. The validating
webhooks (``admission/validating.py``) wait for the control plane's
port."""

from tpu_composer_torch.admission.coordinates import inject_pod_env, slice_env

__all__ = ["slice_env", "inject_pod_env"]
