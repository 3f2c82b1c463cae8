"""Synthetic data pipeline of the port (``repro_torch.data.pipeline``)."""
