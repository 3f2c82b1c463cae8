"""Pod-local checkpointing of the port (``repro_torch.checkpoint.manager``)."""
