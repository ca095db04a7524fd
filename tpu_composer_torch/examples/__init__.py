"""Runnable examples of the port (``python -m tpu_composer_torch.examples.<name>``)."""
