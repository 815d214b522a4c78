"""Runnable examples of the port (``python -m tensoir_tpu_torch.examples.<name>``)."""
