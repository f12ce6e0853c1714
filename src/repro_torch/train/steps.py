"""Step builders: train_step / prefill_step / decode_step — the port of
``repro.train.steps``.

They close over the ArchConfig and the optimizer config; ``train_step``
also over the model's kernel bundle (``kernels.ops.KERNELS``, or
``PLAIN`` to hold the kernels against their plain versions).  PyTorch runs them
eagerly: there is nothing to jit.  The train state is {params, opt: {m, v,
step}, err (with gradient compression)}; ``train_step`` updates it in
place (the reference donates it) and returns it with the step's metrics
as 0-d tensors on the device: loss, ce, aux, grad_norm, lr.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.optim import (
    AdamWConfig,
    accumulated_value_and_grad,
    adamw_init,
    adamw_update,
    compress_tree,
    init_error_state,
)

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_train_state", "opt_axes"]


def make_train_state(cfg, optim_cfg: AdamWConfig, generator: torch.Generator, compress: bool = False,
                     device=None) -> dict:
    """Random weights from ``generator`` on ``device`` (the generator's),
    zero AdamW state and, with ``compress``, a zero error buffer.  The
    port's ``init`` returns the parameters alone; their logical axes are
    ``build(cfg).param_axes()``, the state's ``opt_axes`` of those."""
    params = build(cfg).init(generator, device)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["err"] = init_error_state(params)
    return state


def opt_axes(param_axes, compress: bool = False):
    """The train state's logical-axes tree from the parameters' (the
    reference's); the dry-run lays the state out on its mesh by it
    (``launch.dryrun``)."""
    ax = {"params": param_axes, "opt": {"m": param_axes, "v": param_axes, "step": ()}}
    if compress:
        ax["err"] = param_axes
    return ax


def make_train_step(cfg, optim_cfg: AdamWConfig, n_micro: int = 1, compress: bool = False, kernels=ops.KERNELS):
    api = build(cfg, kernels)
    accum = accumulated_value_and_grad(api.loss_fn, n_micro)

    def train_step(state, batch):
        loss, metrics, grads = accum(state["params"], batch)
        if compress:
            grads, state["err"] = compress_tree(grads, state["err"])
        _, _, om = adamw_update(optim_cfg, state["params"], grads, state["opt"])
        return state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(cfg, max_seq: int | None = None):
    api = build(cfg)

    def prefill_step(params, batch):
        seq = batch["tokens"].shape[1]
        return api.prefill(params, batch, max_seq if max_seq is not None else seq)

    return prefill_step


def make_decode_step(cfg):
    api = build(cfg)

    def decode_step(params, token, cache):
        return api.decode_step(params, token, cache)

    return decode_step
