"""Gradient accumulation over microbatches — the port of
``repro.optim.accumulate``.

The global batch splits into ``n_micro`` microbatches along its first
axis; a Python loop (the reference's ``lax.scan``) takes the value and
gradient of each and sums the gradients in float32.  The loss is the mean
over microbatches, the metrics the last microbatch's, and the gradients
the float32 mean.  With ``n_micro <= 1`` the gradients keep the
parameters' types, as the reference's.  Only the activations of one
microbatch are alive at a time.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["accumulated_value_and_grad", "value_and_grad"]


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradients of the loss with respect to every leaf of
    ``params`` (zeros for a leaf the loss does not read), in its type; the
    loss and metrics detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        args = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(args)
        loss, metrics = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, args, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    it = iter(grads)
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def accumulated_value_and_grad(loss_fn, n_micro: int):
    """loss_fn(params, batch) -> (loss, metrics).  Returns a function
    (params, batch) -> (loss, metrics, grads) averaging over microbatches."""
    if n_micro <= 1:
        return lambda params, batch: value_and_grad(loss_fn, params, batch)

    def split(batch):
        def r(x):
            b = x.shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
            return x.reshape(n_micro, b // n_micro, *x.shape[1:])

        return tree_map(r, batch)

    def accum(params, batch):
        micro = split(batch)
        loss_sum = None
        grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n_micro):
            loss, metrics, grads = value_and_grad(loss_fn, params, tree_map(lambda x: x[i], micro))
            tree_map(lambda a, g: a.add_(g.float()), grads_acc, grads)
            del grads
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
        inv = 1.0 / n_micro
        return loss_sum * inv, metrics, tree_map(lambda g: g.mul_(inv), grads_acc)

    return accum
