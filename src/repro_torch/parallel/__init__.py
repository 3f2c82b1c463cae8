"""Distributed-optimization pieces of the port, counterpart of
``repro.parallel``: gradient compression (``compression``)."""
