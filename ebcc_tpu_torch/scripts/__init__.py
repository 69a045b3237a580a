"""Command-line entry points of the port (``python -m ebcc_tpu_torch.scripts.<name>``)."""
