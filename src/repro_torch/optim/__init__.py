"""Optimizers of the port (``repro_torch.optim.adamw``)."""
