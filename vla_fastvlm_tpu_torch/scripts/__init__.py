"""Command-line entry points of the port (``python -m vla_fastvlm_tpu_torch.scripts.<name>``)."""
