"""The probe entry points of the port (``python -m
bigsi_tpu_torch.scripts.<name>``) and the timing they share."""
