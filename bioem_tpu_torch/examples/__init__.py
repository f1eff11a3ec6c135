"""End-to-end examples of the port (``python -m bioem_tpu_torch.examples.<name>``)."""
