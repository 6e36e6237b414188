"""Runnable examples of the port: `python -m hades252_tpu_torch.examples.<name>`."""
