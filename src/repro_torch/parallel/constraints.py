"""Activation sharding constraints, the counterpart of
``repro.parallel.constraints``.

Models call ``constrain(x, kind)`` at a few anchor points (the reference's
anchors); a context-scoped policy maps the logical kind to a partition
spec, and a ``DTensor`` is redistributed to that spec's placements.
Without a policy (unit tests, one device), or for a tensor that is not a
``DTensor``, ``constrain`` returns ``x`` itself.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.parallel.sharding import P, mesh_axes, placements_for

__all__ = ["ActivationPolicy", "activation_sharding", "constrain"]

_POLICY = contextvars.ContextVar("repro_torch_activation_policy", default=None)


@dataclasses.dataclass(frozen=True)
class ActivationPolicy:
    mesh: object                       # DeviceMesh (or a shape-only mesh)
    batch_axes: Optional[tuple]        # e.g. ("pod", "data") — None disables
    tensor_axis: Optional[str] = "model"
    # Megatron-style sequence parallelism: the residual stream between TP
    # regions is sharded over the tensor axis on its sequence dim
    seq_shard_hidden: bool = False

    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        sizes = mesh_axes(self.mesh)
        if isinstance(axes, str):
            return sizes[axes]
        return int(math.prod(sizes[a] for a in axes))

    def spec_for(self, kind: str, shape: Tuple[int, ...]) -> Optional[P]:
        batch = self.batch_axes
        if batch is not None and shape[0] % self._axis_size(batch) != 0:
            batch = None
        if kind == "hidden":               # (B, S, D)
            seq = None
            if (self.seq_shard_hidden and self.tensor_axis is not None
                    and shape[1] % self._axis_size(self.tensor_axis) == 0):
                seq = self.tensor_axis
            return P(batch, seq, None)
        if kind == "logits":               # (B, S, V)
            tensor = self.tensor_axis
            if tensor is not None and shape[-1] % self._axis_size(tensor) != 0:
                tensor = None
            return P(batch, None, tensor)
        if kind == "batch":                # (B, ...)
            return P(batch, *(None,) * (len(shape) - 1))
        if kind == "experts":              # (E, ...) expert-major MoE buffer
            tensor = self.tensor_axis
            if tensor is None or shape[0] % self._axis_size(tensor) != 0:
                return None
            return P(tensor, *(None,) * (len(shape) - 1))
        return None


@contextlib.contextmanager
def activation_sharding(policy: ActivationPolicy):
    """Scope ``policy``.  On a ``DeviceMesh`` the scope also lets plain
    tensors (positions, masks, constants the model makes) meet DTensors as
    replicated ones (``implicit_replication``)."""
    token = _POLICY.set(policy)
    try:
        if hasattr(policy.mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _POLICY.reset(token)


def constrain(x, kind: str):
    """``x`` redistributed to the policy's placements for ``kind``; ``x``
    itself without a policy, for a plain tensor, or where the policy has no
    spec for ``kind``."""
    policy = _POLICY.get()
    if policy is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = policy.spec_for(kind, tuple(x.shape))
    if spec is None:
        return x
    placements = placements_for(policy.mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(policy.mesh, placements)
