"""Runnable examples of the port (``python -m
paddle_tpu_torch.examples.<name>``)."""
