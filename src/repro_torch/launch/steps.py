"""Step functions, the counterparts of ``repro.launch.steps``: the train
step (forward, backward, optimizer), the prefill step (a forward over the
prompt that returns the last position's logits) and the one-token decode
step.  The loss is a float32 log-sum-exp cross entropy over the vocab.

The train step differentiates the plain paths: the CUDA kernels have no
backward (nor have the reference's Pallas kernels), and a launch under
grad mode raises.  It is functional, as the reference's jitted step:
``train_step(params, opt_state, batch)`` returns new trees and leaves its
arguments unchanged.  The serving steps run under
``torch.inference_mode``, or ``torch.no_grad`` for DTensor parameters on a
mesh (DTensor makes no views of its tensors in inference mode).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.parallel.dtensor_ops import (is_dtensor, like, replicate,
                                              shard_local, split_rows,
                                              unshard_dim)

__all__ = ["AUX_LOSS_WEIGHT", "cross_entropy", "make_loss_fn",
           "make_train_step", "make_prefill_step", "make_serve_step"]

AUX_LOSS_WEIGHT = 0.01


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """Summed token cross entropy and the count of unmasked labels."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy; labels < 0 are masked.  Logits sharded
    on the vocab (a DTensor) are gathered along it first
    (``parallel.dtensor_ops.unshard_dim``), and each rank sums its own
    rows (``shard_local``)."""
    total, count = shard_local(_nll_sum, (unshard_dim(logits, -1), labels),
                               ((0, None), (0, None)), ("sum", "sum"))
    return total / count.clamp_min(1.0)


def make_loss_fn(model: Model) -> Callable:
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + AUX_LOSS_WEIGHT * aux, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(model: Model, optimizer: Optimizer,
                    *, grad_accum: str = "inside") -> Callable:
    """fwd+bwd+optimizer step.  When ``cfg.train_microbatches > 1`` the
    batch is split along its batch dim and the microbatches run in turn.

    grad_accum:
      * "inside" (default): the gradient of the mean of the microbatch
        losses, each microbatch's backward seeded with ``1 / n`` and the
        gradients summed in the parameters' dtype (the reference
        differentiates through its microbatch scan);
      * "outside": each microbatch's own gradient, summed in float32 and
        divided by ``n``.
    """
    if grad_accum not in ("inside", "outside"):
        raise ValueError(f"unknown grad_accum {grad_accum!r}")
    loss_fn = make_loss_fn(model)
    n_micro = model.config.train_microbatches

    def grads_of(params, mb, seed: float):
        """The loss, its metrics and the gradient of ``seed * loss`` per leaf
        of ``params`` (in ``leaves`` order); on a mesh the loss is whole on
        every rank and each gradient is laid out as its parameter."""
        loss, metrics = loss_fn(params, mb)
        loss = replicate(loss)
        flat = leaves(params)
        grads = torch.autograd.grad(loss, flat,
                                    grad_outputs=torch.full_like(loss, seed),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), \
            {k: replicate(v).detach() for k, v in metrics.items()}, \
            [like(g, p) for g, p in zip(grads, flat)]

    def train_step(params, opt_state, batch):
        # grad leaves share the inputs' storage; the inputs keep their flags
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if n_micro <= 1:
            loss, metrics, flat = grads_of(live, batch, 1.0)
        else:
            micro = _split_microbatches(batch, n_micro)
            losses, metricses, flat = [], [], None
            for i in range(n_micro):
                mb = {k: v[i] for k, v in micro.items()}
                if grad_accum == "inside":
                    loss_i, m_i, g = grads_of(live, mb, 1.0 / n_micro)
                else:
                    loss_i, m_i, g = grads_of(live, mb, 1.0)
                    g = [x.float() for x in g]
                flat = g if flat is None else [a + b for a, b in zip(flat, g)]
                losses.append(loss_i)
                metricses.append(m_i)
            if grad_accum == "outside":
                flat = [g / n_micro for g in flat]
                loss = torch.stack(losses).mean()
            else:
                total = torch.zeros((), dtype=torch.float32,
                                    device=losses[0].device)
                for loss_i in losses:
                    total = total + loss_i
                loss = total / n_micro
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=loss)

    return train_step


def _split_microbatches(batch: dict, n_micro: int) -> dict:
    """Split the batch dim into ``(n_micro, B / n_micro)`` per leaf.  The
    batch dim is axis 0 for every input except ``mrope_positions``
    (layout (n_sections, B, S): batch is axis 1), whose microbatch axis
    moves to the front.  On a mesh each microbatch's rows stay sharded
    over the batch axes (``parallel.dtensor_ops.split_rows``)."""

    def split(name, x):
        axis = 1 if name == "mrope_positions" else 0
        x = split_rows(x, axis, n_micro)
        return torch.movedim(x, axis, 0) if axis else x

    return {k: split(k, v) for k, v in batch.items()}


def _serving(params):
    return torch.no_grad() if is_dtensor(leaves(params)[0]) \
        else torch.inference_mode()


def make_prefill_step(model: Model) -> Callable:
    """Forward-only full-sequence step; returns the last-position logits."""

    def prefill_step(params, batch):
        with _serving(params):
            logits, _ = model.forward(params, batch)
            return logits[:, -1, :]

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode step with a KV/SSM cache (updated in place); returns
    the greedy next token (int32) and the cache.  Logits sharded on the
    vocab (a DTensor) are gathered along it for the argmax, which DTensor
    does not reduce across vocab shards at batch 1."""

    def serve_step(params, cache, tokens, pos):
        with _serving(params):
            logits, cache = model.decode_step(params, cache, tokens, pos)
            last = unshard_dim(logits[:, -1, :], -1)
            return last.argmax(dim=-1).to(torch.int32), cache

    return serve_step
