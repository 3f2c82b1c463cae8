"""AdamW (+ SGD), the counterpart of ``repro.optim.adamw``.

The optimizer state (mu, nu) is a tree congruent with the parameters, with
float32 moments whatever the parameter dtype.  Global-norm clipping sums
the leaves in the reference's leaf order (sorted dict keys); weight decay
is decoupled.  ``update`` is functional, as the reference's: it returns new
parameter and state trees and leaves its arguments unchanged, so a caller
may keep an earlier state (the FT trainer's cold-restart state, a snapshot
still being written) while training goes on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch._tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw", "sgd", "Optimizer"]


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (new_params, new_state)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    # moments dtype: fp32 master statistics regardless of param dtype
    state_dtype: str = "float32"


def _global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


def _count(params) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def adamw(cfg: AdamWConfig = AdamWConfig()) -> Optimizer:
    sdt = getattr(torch, cfg.state_dtype)

    def init(params):
        # zeros_like: a DTensor parameter's moments are laid out as it is
        zeros = lambda p: torch.zeros_like(p, dtype=sdt)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": _count(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        if cfg.grad_clip_norm is not None:
            gnorm = _global_norm(grads)
            scale = torch.clamp(cfg.grad_clip_norm / gnorm.clamp_min(1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        c = count.float()
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=c.device), c)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=c.device), c)

        def upd(g, m, v, p):
            g32 = g.to(sdt)
            m = cfg.b1 * m + (1 - cfg.b1) * g32
            v = cfg.b2 * v + (1 - cfg.b2) * g32.square()
            # fresh temporaries from here on: updated in place
            step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            p32 = p.to(sdt)
            step.add_(cfg.weight_decay * p32)
            new_p = (p32 - cfg.learning_rate * step).to(p.dtype)
            return new_p, m, v

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        # out's leaves are (param, mu, nu) triples: walk grads' structure
        pick = lambda i: tree_map(lambda _, t: t[i], grads, out)
        return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}

    return Optimizer(init=init, update=update)


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(lambda p: torch.zeros((), dtype=p.dtype,
                                                     device=p.device), params),
                "count": _count(params)}

    def update(grads, state, params):
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                      state["mu"], grads)
        params = tree_map(lambda p, m: (p - lr * m).to(p.dtype), params, mu)
        return params, {"mu": mu, "nu": state["nu"],
                        "count": state["count"] + 1}

    return Optimizer(init=init, update=update)
