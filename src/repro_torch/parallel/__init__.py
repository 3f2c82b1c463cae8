"""Distributed pieces of the port, counterpart of ``repro.parallel``:
gradient compression (``compression``), the sharding rules
(``sharding``), activation constraints (``constraints``) and the model
operations DTensor cannot shard by itself (``dtensor_ops``)."""
