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

``batch`` is {tokens (B, S)}, and for an encoder-decoder also {frames (B,
enc_seq, d)}; ``loss_fn`` also takes {labels (B, S)}.  ``input_specs`` and
``input_axes`` come with the dry-run (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import encdec, lm

__all__ = ["ModelApi", "build"]


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    make_decode_cache: Callable


def build(cfg: ArchConfig, kernels: ops.ModelKernels = ops.KERNELS) -> ModelApi:
    """The model's functions bound to ``cfg``; ``kernels`` picks the kernel
    functions (``ops.PLAIN`` holds the kernels against their plain versions
    on the card)."""
    if cfg.is_encdec:
        return ModelApi(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init(cfg, generator, device),
            forward=lambda p, batch: encdec.forward(p, batch, cfg, kernels),
            loss_fn=lambda p, batch: encdec.loss_fn(p, batch, cfg, kernels),
            prefill=lambda p, batch, max_seq: encdec.prefill(p, batch, cfg, max_seq, kernels),
            decode_step=lambda p, tok, cache: encdec.decode_step(p, tok, cache, cfg, kernels),
            make_decode_cache=lambda b, m, dt, device=None: encdec.make_decode_cache(cfg, b, m, dt, device),
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
    )
