"""Step builders shared by the trainer and the benchmarks
(``repro/train/steps.py``). The reference's ``jax.value_and_grad`` is
autograd over the model's functions on detached views of the
parameters. On DTensor parameters (a device mesh) the gradients are
DTensors placed like the parameters, and the backward, like the model's
forward, takes plain tensors as replicated."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.transformer import ModelBundle
from repro_torch.parallel.sharding import implicit_replication
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _views(tree):
    """The tree with each leaf a detached view that requires grad."""
    if isinstance(tree, dict):
        return {k: _views(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _grads(tree):
    """The ``.grad`` of each leaf of ``_views``' tree (zeros where the
    loss does not reach the leaf, as the reference's gradient is); a
    DTensor leaf's gradient on the leaf's placements (a partial sum
    reduced)."""
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if tree.grad is None:
        return torch.zeros_like(tree)
    if isinstance(tree, DTensor):
        return tree.grad.redistribute(tree.device_mesh, tree.placements)
    return tree.grad


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss as a
    detached 0-d tensor, the gradients as a tree like ``params``."""
    live = _views(params)
    with torch.enable_grad(), implicit_replication(_any_dtensor(params)):
        loss = loss_fn(live, batch)
        loss.backward()
    return loss.detach(), _grads(live)


def _any_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_dtensor(v) for v in tree.values())
    return isinstance(tree, DTensor)


def accumulate_grads(loss_fn, params, batch, accum_steps: int = 1):
    """``value_and_grad`` over ``accum_steps`` micro-batches (the batch's
    leading dim split evenly), the losses and gradients each divided by
    ``accum_steps`` and summed in micro-batch order."""
    if accum_steps == 1:
        return value_and_grad(loss_fn, params, batch)
    loss, grads = 0.0, None
    for i in range(accum_steps):
        mb = {k: v[i * (v.shape[0] // accum_steps):
                   (i + 1) * (v.shape[0] // accum_steps)]
              for k, v in batch.items()}
        li, gi = value_and_grad(loss_fn, params, mb)
        loss = loss + li / accum_steps
        if grads is None:
            grads = _scaled(gi, accum_steps)
        else:
            _add_scaled(grads, gi, accum_steps)
    return loss, grads


def _scaled(tree, n):
    if isinstance(tree, dict):
        return {k: _scaled(v, n) for k, v in tree.items()}
    return tree / n


def _add_scaled(acc, tree, n):
    for k, v in tree.items():
        if isinstance(v, dict):
            _add_scaled(acc[k], v, n)
        else:
            acc[k] += v / n


def make_train_step(bundle: ModelBundle,
                    opt_cfg: Optional[AdamWConfig] = None,
                    accum_steps: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; the parameters and optimizer state are updated in place.

    With ``accum_steps > 1`` the batch's leading dim is split into
    micro-batches whose gradients are accumulated in a Python loop.
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(bundle.loss, params, batch,
                                       accum_steps)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, dict(loss=loss, **om)

    return train_step
