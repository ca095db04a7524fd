"""Admission (port of ``tpu_composer/admission/``): the validating rules
for ComposabilityRequest and NodeMaintenance (``validating.py``), the
mutating side's coordinate injection, for TPU slices and for GPU slices
(``coordinates.py``), and the AdmissionReview server that serves both
over HTTP(S) (``server.py``)."""

from tpu_composer_torch.admission.validating import register_validating_webhooks
from tpu_composer_torch.admission.coordinates import inject_pod_env, slice_env

__all__ = ["register_validating_webhooks", "slice_env", "inject_pod_env"]
