"""The control plane's API types (port of ``tpu_composer/api/``).

Only :class:`~tpu_composer_torch.api.types.SliceStatus`, the record a
composed slice's coordinates are derived from, is ported so far; the
rest of the API waits for the control plane's port."""
