"""Weights made from the seed on the device, one call per leaf of the port's
parameter tree, each drawn whole (a stacked leaf holds every layer) in the
dtype it is served in.  The draws, in the order a configuration's
``make_weights`` asks for them, are the run's weights; the program and the
reference are handed the same tensors."""
from __future__ import annotations

import math

import torch


class Draws:
    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device

    def normal(self, shape, std: float, dtype, mean: float = 0.0):
        out = torch.randn(shape, generator=self.gen, device=self.device,
                          dtype=dtype).mul_(std)
        return out.add_(mean) if mean else out

    def uniform(self, shape, low: float, high: float, dtype=torch.float32):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=dtype).mul_(high - low).add_(low)

    def a_log(self, shape, low: float = 1.0, high: float = 16.0):
        """Mamba2's A = -exp(A_log), A drawn uniform in [low, high]."""
        return self.uniform(shape, low, high).log_()

    def dt_bias(self, shape, dt_min: float, dt_max: float, floor: float):
        """Softplus^-1 of dt drawn log-uniform in [dt_min, dt_max], floored."""
        dt = self.uniform(shape, math.log(dt_min), math.log(dt_max)).exp_()
        dt = dt.clamp_(min=floor)
        return dt + torch.log(-torch.expm1(-dt))


def padded(vocab: int, multiple: int) -> int:
    return -(-vocab // multiple) * multiple if multiple > 1 else vocab


def head(draws: Draws, d_model: int, vocab: int, multiple: int, dtype):
    """The output head (d_model, padded vocab); the padded columns are
    zero, as a deployment's would be."""
    w = draws.normal((d_model, padded(vocab, multiple)), d_model ** -0.5, dtype)
    w[:, vocab:] = 0
    return w


def shapes(tree: dict, prefix: str = "") -> dict:
    """{path: (shape, dtype)} of a tree of tensors (or of ``meta`` tensors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), v.dtype)
    return out
