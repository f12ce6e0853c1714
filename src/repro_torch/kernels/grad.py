"""Gradients through the model kernels.

The JAX package has no backward for any of its kernels (no ``custom_vjp``
in ``repro``): it trains through jnp attention and scans.  The port's
model calls its kernels on the training path too, so each of
``flash_attention``, ``ssd_scan``, ``mlstm_chunk``, ``gated_rmsnorm``,
``causal_conv_silu`` and ``rms_norm`` on a CUDA tensor that needs a
gradient runs through ``PlainBackward``: the forward launches the
hand-written kernel as always, and the backward re-runs the kernel's plain
PyTorch version on the saved inputs and differentiates that.  So the
gradients are the plain version's, evaluated where the kernel's outputs
were computed; no backward kernel exists, as none exists in the reference.

``decode_attention`` is on no training path: on the card it refuses
inputs that need a gradient (``refuse``).  On the CPU every wrapper runs
its plain version, which autograd differentiates as it stands.
"""

from __future__ import annotations

import torch

__all__ = ["PlainBackward", "needs_grad", "refuse"]


def needs_grad(*tensors) -> bool:
    """True when grad mode is on and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` naming ``name`` when ``needs_grad(*tensors)``:
    the kernel has no gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name} has no gradient: call it under torch.no_grad() or on inputs that need none")


class PlainBackward(torch.autograd.Function):
    """``PlainBackward.apply(forward, plain, kwargs, *inputs)``: the outputs
    of ``forward(*inputs, **kwargs)`` (a tensor or a tuple of tensors), with
    the gradients of ``plain(*inputs, **kwargs)``, which must compute the
    same function.  ``forward`` is the kernel's launch on the card; the CPU
    tests pass the plain version itself.  An input may be None (an
    optional operand left out); it gets no gradient."""

    @staticmethod
    def forward(ctx, forward, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)  # an output nothing reads gets None, not zeros
        return forward(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grad_outputs):
        inputs = ctx.saved_tensors
        wants = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(w) for t, w in zip(inputs, wants)]
            outs = ctx.plain(*args, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
            sources = [a for a, w in zip(args, wants) if w]
            grads = iter(
                torch.autograd.grad([o for o, _ in pairs], sources, [g for _, g in pairs], allow_unused=True)
                if pairs and sources
                else [None] * len(sources)
            )
        return (None, None, None, *(next(grads) if w else None for w in wants))
