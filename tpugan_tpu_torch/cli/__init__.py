"""Command-line entry points of the port (``python -m tpugan_tpu_torch.cli.<name>``)."""
