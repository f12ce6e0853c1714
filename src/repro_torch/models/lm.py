"""Decoder-only LM for the ``attn`` block pattern — the port of
``repro.models.lm`` for dense attention models.

    init(cfg, generator, device)                   -> params
    forward(params, tokens, cfg)                   -> (logits, aux)
    prefill(params, tokens, cfg, max_seq)          -> (last_logits, cache)
    decode_step(params, token, cache, cfg)         -> (logits, cache)
    make_decode_cache(cfg, batch, max_seq, dtype, device)

Attention runs through the port's kernels (``models.attention``).  MoE
layers and the ``zamba2`` and ``xlstm`` block patterns come with their own
slices and raise ``NotImplementedError`` here.  There is no sharding, remat
or ZeRO-3 gather: they have no meaning on one card in eager PyTorch.
Training (``loss_fn``) comes with ``optim/`` and ``train/`` (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Dtypes,
    embed_tokens,
    embedding_init,
    logits_apply,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)

__all__ = ["check_supported", "decode_step", "forward", "init", "make_decode_cache", "prefill"]


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration whose blocks the
    port does not have yet, naming the ROADMAP item that brings them."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers come with the moe slice (ROADMAP Queue 1 item 9b)")
    if cfg.block_pattern == "zamba2":
        raise NotImplementedError(
            f"{cfg.name}: the zamba2 pattern comes with ssm and ssd_scan (ROADMAP Queue 1 item 9c)"
        )
    if cfg.block_pattern == "xlstm":
        raise NotImplementedError(
            f"{cfg.name}: the xlstm pattern comes with xlstm and mlstm_chunk (ROADMAP Queue 1 item 9d)"
        )
    if cfg.block_pattern != "attn":
        raise ValueError(f"unknown block pattern {cfg.block_pattern}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's shapes, names and standard
    deviations, drawn from ``generator`` on ``device`` (which must be the
    generator's device)."""
    check_supported(cfg)
    dev = device_mod.resolve(device)
    if generator.device.type != dev.type or (dev.index is not None and (generator.device.index or 0) != dev.index):
        raise ValueError(f"generator is on {generator.device}, weights asked for on {dev}")
    dt = Dtypes.from_cfg(cfg)
    params: dict = {"embed": embedding_init(generator, cfg.padded_vocab, cfg.d_model, dt.param)}
    if not cfg.tie_embeddings:
        params["embed_out"] = embedding_init(generator, cfg.padded_vocab, cfg.d_model, dt.param)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dt.param, dev)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "ln1": norm_init(cfg.d_model, cfg.norm, dt.param, dev),
                "attn": attn.attn_init(generator, cfg, dt.param),
                "ln2": norm_init(cfg.d_model, cfg.norm, dt.param, dev),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.glu, dt.param, bias=cfg.mlp_bias),
            }
        )
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------
def _block(lp, x, cfg, kernels, layer_cache=None):
    x = x + attn.attn_apply(lp["attn"], norm_apply(lp["ln1"], x, cfg.norm), cfg, layer_cache=layer_cache, kernels=kernels)
    return x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm), cfg.act, cfg.glu)


def _head(params, x, cfg):
    x = norm_apply(params["final_norm"], x, cfg.norm)
    emb = params["embed_out"] if not cfg.tie_embeddings else params["embed"]
    return logits_apply(emb, x, cfg.vocab_size)


def forward(params, tokens, cfg, kernels=attn.KERNELS):
    """tokens: (B, S) -> (logits (B, S, V), aux_losses)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, Dtypes.from_cfg(cfg).act)
    for lp in params["layers"]:
        x = _block(lp, x, cfg, kernels)
    return _head(params, x, cfg), 0.0


def make_decode_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    check_supported(cfg)
    return attn.make_cache(cfg, batch, max_seq, cfg.n_layers, dtype, device_mod.resolve(device))


def prefill(params, tokens, cfg, max_seq: int, kernels=attn.KERNELS):
    """Run the whole prompt, build the decode cache, return the last
    position's logits (B, 1, V).  Only the last position goes through the
    output head: each position's logits depend on that position alone."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq {max_seq}")
    dt = Dtypes.from_cfg(cfg)
    cache = attn.make_cache(cfg, b, max_seq, cfg.n_layers, dt.act, tokens.device)
    x = embed_tokens(params["embed"], tokens, dt.act)
    for li, lp in enumerate(params["layers"]):
        x = _block(lp, x, cfg, kernels, layer_cache=(cache["k"][li], cache["v"][li]))
    cache["index"] = s
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg, kernels=attn.KERNELS):
    """token: (B, 1) int.  Returns (logits (B, 1, V), cache with index + 1);
    the cache's k and v tensors are updated in place."""
    check_supported(cfg)
    idx = int(cache["index"])
    x = embed_tokens(params["embed"], token, Dtypes.from_cfg(cfg).act)
    for li, lp in enumerate(params["layers"]):
        h, _, _ = attn.attn_decode(
            lp["attn"], norm_apply(lp["ln1"], x, cfg.norm), cfg, cache["k"][li], cache["v"][li], idx, kernels
        )
        x = x + h
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm), cfg.act, cfg.glu)
    return _head(params, x, cfg), {"k": cache["k"], "v": cache["v"], "index": idx + 1}
