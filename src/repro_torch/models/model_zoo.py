"""Unified model API of the port over every registered configuration:
decoder-only LMs of the ``attn`` (dense or MoE), ``zamba2`` and ``xlstm``
block patterns, and the encoder-decoder (the port of
``repro.models.model_zoo``).

    api = build(cfg)
    params        = api.init(generator, device)
    logits, aux   = api.forward(params, batch)
    loss, metrics = api.loss_fn(params, batch)
    last, cache   = api.prefill(params, batch, max_seq)
    logits, cache = api.decode_step(params, token, cache)
    axes          = api.param_axes()            # the reference's init axes
    cache_axes    = api.decode_cache_axes(long)

``batch`` is {tokens (B, S)}, and for an encoder-decoder also {frames (B,
enc_seq, d)}; ``loss_fn`` also takes {labels (B, S)}.

Both modules declare each parameter and cache tensor once, in a spec tree
(``lm.spec`` / ``encdec.spec`` and their ``decode_cache_spec``): ``init``,
``param_axes``, ``make_decode_cache`` and ``decode_cache_axes`` read it.
``param_shapes(cfg)`` and ``input_specs(cfg, shape)`` read it too, as
meta-device stand-ins for the parameters and for every input of the step
lowered at a shape (no allocation), and ``input_axes`` gives the inputs'
logical axes: the dry-run's arguments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import per_shard
from repro_torch.kernels import ops
from repro_torch.models import encdec, lm
from repro_torch.models.layers import meta_of, torch_dtype

__all__ = ["ModelApi", "build", "input_axes", "input_specs", "param_shapes"]


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    make_decode_cache: Callable
    param_axes: Callable
    decode_cache_axes: Callable


def build(cfg: ArchConfig, kernels: ops.ModelKernels = ops.KERNELS) -> ModelApi:
    """The model's functions bound to ``cfg``; ``kernels`` picks the kernel
    functions (``ops.PLAIN`` holds the kernels against their plain versions
    on the card), each run per rank on DTensor operands."""
    kernels = per_shard.on_shards(kernels)
    if cfg.is_encdec:
        return ModelApi(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init(cfg, generator, device),
            forward=lambda p, batch: encdec.forward(p, batch, cfg, kernels),
            loss_fn=lambda p, batch: encdec.loss_fn(p, batch, cfg, kernels),
            prefill=lambda p, batch, max_seq: encdec.prefill(p, batch, cfg, max_seq, kernels),
            decode_step=lambda p, tok, cache: encdec.decode_step(p, tok, cache, cfg, kernels),
            make_decode_cache=lambda b, m, dt, device=None: encdec.make_decode_cache(cfg, b, m, dt, device),
            param_axes=lambda: encdec.param_axes(cfg),
            decode_cache_axes=lambda long=False: encdec.decode_cache_axes(cfg, long),
        )
    lm.check_supported(cfg)
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: lm.init(cfg, generator, device),
        forward=lambda p, batch: lm.forward(p, batch["tokens"], cfg, kernels),
        loss_fn=lambda p, batch: lm.loss_fn(p, batch, cfg, kernels),
        prefill=lambda p, batch, max_seq: lm.prefill(p, batch["tokens"], cfg, max_seq, kernels),
        decode_step=lambda p, tok, cache: lm.decode_step(p, tok, cache, cfg, kernels),
        make_decode_cache=lambda b, m, dt, device=None: lm.make_decode_cache(cfg, b, m, dt, device),
        param_axes=lambda: lm.param_axes(cfg),
        decode_cache_axes=lambda long=False: lm.decode_cache_axes(cfg, long),
    )


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _module(cfg: ArchConfig):
    return encdec if cfg.is_encdec else lm


def param_shapes(cfg: ArchConfig) -> dict:
    """Meta-device stand-ins for every parameter (nothing is allocated)."""
    return meta_of(_module(cfg).spec(cfg))


def input_specs(cfg: ArchConfig, shape: ShapeSpec, act_dtype=None) -> dict:
    """Meta-device stand-ins for the inputs of the step lowered at this
    shape: {tokens, labels} (train), {tokens} (prefill), and {frames} for an
    encoder-decoder; {token, cache} (decode).  Nothing is allocated."""
    act = torch_dtype(act_dtype or cfg.dtype)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
        if cfg.is_encdec:
            specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), act)
        return specs
    if shape.kind == "decode":
        cache = meta_of(_module(cfg).decode_cache_spec(cfg, b, s, act))
        return {"token": _meta((b, 1), torch.int32), "cache": cache}
    raise ValueError(shape.kind)


def input_axes(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Logical axes matching ``input_specs``."""
    if shape.kind in ("train", "prefill"):
        ax = {"tokens": ("act_batch", None)}
        if shape.kind == "train":
            ax["labels"] = ("act_batch", None)
        if cfg.is_encdec:
            ax["frames"] = ("act_batch", None, None)
        return ax
    long = shape.seq_len > 100_000
    return {"token": ("act_batch", None), "cache": build(cfg).decode_cache_axes(long)}
