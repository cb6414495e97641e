"""Runnable examples of the port (``python -m fewbit_tpu_torch.examples.<name>``)."""
