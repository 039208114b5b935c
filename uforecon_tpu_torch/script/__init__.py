"""Scripts of the port, run as modules (``python -m uforecon_tpu_torch.script.<name>``)."""
