"""Decoder-only LM for the ``attn`` (dense or MoE), ``zamba2`` and
``xlstm`` block patterns — the port of ``repro.models.lm``.

    init(cfg, generator, device)                   -> params
    forward(params, tokens, cfg)                   -> (logits, aux)
    prefill(params, tokens, cfg, max_seq)          -> (last_logits, cache)
    decode_step(params, token, cache, cfg)         -> (logits, cache)
    make_decode_cache(cfg, batch, max_seq, dtype, device)

Each entry point takes ``kernels``, the bundle of the four kernel functions
the blocks call (``kernels.ops.KERNELS``, or ``PLAIN`` to hold the kernels
against their plain versions on the card): attention runs
``flash_attention`` / ``decode_attention``, Mamba2 ``ssd_scan`` and mLSTM
``mlstm_chunk``.  In a MoE configuration every ``moe_every``-th ``attn``
layer takes ``models.moe`` in place of its MLP; ``forward`` returns the
sum of those layers' load-balancing losses as ``aux`` (0.0 without MoE
layers).  There is no sharding, remat or ZeRO-3 gather:
they have no meaning on one card in eager PyTorch.  Training (``loss_fn``)
comes with ``optim/`` and ``train/`` (ROADMAP Queue 1 item 10).

Caches: ``attn`` {k, v (layers, B, KV, T, hd), index}; ``zamba2`` {ssm:
{ssm, conv_x, conv_B, conv_C} stacked over the Mamba layers, kv: the
shared block's {k, v, index}, one cache layer per application}; ``xlstm``
{xlstm: one state per layer, index}.  Tensors of the ``attn`` and
``zamba2`` caches are updated in place.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xl
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
    """Raise ``ValueError`` for a configuration this module does not build:
    an encoder-decoder (``models.encdec``) or an unknown block pattern."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: build it with models.encdec")
    if cfg.block_pattern not in ("attn", "zamba2", "xlstm"):
        raise ValueError(f"unknown block pattern {cfg.block_pattern}")


def _is_moe_layer(cfg, li: int) -> bool:
    return cfg.moe is not None and (li + 1) % cfg.moe.moe_every == 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def weights_device(generator: torch.Generator, device=None) -> torch.device:
    """``device`` resolved (the card unless the caller asks for the CPU);
    raises ``ValueError`` unless it is the generator's device."""
    dev = device_mod.resolve(device)
    if generator.device.type != dev.type or (dev.index is not None and (generator.device.index or 0) != dev.index):
        raise ValueError(f"generator is on {generator.device}, weights asked for on {dev}")
    return dev


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's shapes, names and standard
    deviations, drawn from ``generator`` on ``device`` (which must be the
    generator's device)."""
    check_supported(cfg)
    dev = weights_device(generator, device)
    dt = Dtypes.from_cfg(cfg)
    g = generator
    params: dict = {"embed": embedding_init(g, cfg.padded_vocab, cfg.d_model, dt.param)}
    if not cfg.tie_embeddings:
        params["embed_out"] = embedding_init(g, cfg.padded_vocab, cfg.d_model, dt.param)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dt.param, dev)
    layers = []
    for li in range(cfg.n_layers):
        ln = norm_init(cfg.d_model, cfg.norm, dt.param, dev)
        if cfg.block_pattern == "attn":
            lp = {"ln1": ln, "attn": attn.attn_init(g, cfg, dt.param), "ln2": norm_init(cfg.d_model, cfg.norm, dt.param, dev)}
            if _is_moe_layer(cfg, li):
                lp["moe"] = moe_mod.moe_init(g, cfg, dt.param)
            else:
                lp["mlp"] = mlp_init(g, cfg.d_model, cfg.d_ff, cfg.glu, dt.param, bias=cfg.mlp_bias)
            layers.append(lp)
        elif cfg.block_pattern == "zamba2":
            layers.append({"ln": ln, "mamba": ssm_mod.mamba_init(g, cfg, dt.param)})
        elif xl.is_slstm(cfg, li):
            layers.append({"ln": ln, "slstm": xl.slstm_init(g, cfg, dt.param)})
        else:
            layers.append({"ln": ln, "mlstm": xl.mlstm_init(g, cfg, dt.param)})
    params["layers"] = layers
    if cfg.block_pattern == "zamba2":
        params["shared_attn"] = {
            "ln_a": norm_init(cfg.d_model, cfg.norm, dt.param, dev),
            "attn": attn.attn_init(g, cfg, dt.param),
            "ln_m": norm_init(cfg.d_model, cfg.norm, dt.param, dev),
            "mlp": mlp_init(g, cfg.d_model, cfg.d_ff, cfg.glu, dt.param),
        }
    return params


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------
def _ffn(lp, x, cfg) -> tuple:
    """The layer's MLP or MoE FFN on x (already normed): (y, aux)."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], x, cfg, cfg.act)
    return mlp_apply(lp["mlp"], x, cfg.act, cfg.glu), 0.0


def _block(lp, x, cfg, kernels, layer_cache=None) -> tuple:
    x = x + attn.attn_apply(lp["attn"], norm_apply(lp["ln1"], x, cfg.norm), cfg, layer_cache=layer_cache, kernels=kernels)
    y, aux = _ffn(lp, norm_apply(lp["ln2"], x, cfg.norm), cfg)
    return x + y, aux


def _shared_block(sp, x, cfg, kernels, layer_cache=None):
    """zamba2's shared attention + MLP block, after every ``attn_every``-th
    Mamba block; its weights are shared by every application."""
    x = x + attn.attn_apply(sp["attn"], norm_apply(sp["ln_a"], x, cfg.norm), cfg, layer_cache=layer_cache, kernels=kernels)
    return x + mlp_apply(sp["mlp"], norm_apply(sp["ln_m"], x, cfg.norm), cfg.act, cfg.glu)


def _head(params, x, cfg):
    x = norm_apply(params["final_norm"], x, cfg.norm)
    emb = params["embed_out"] if not cfg.tie_embeddings else params["embed"]
    return logits_apply(emb, x, cfg.vocab_size)


def _body(params, x, cfg, kernels, cache=None) -> tuple:
    """Every layer over the whole sequence: (x, the summed MoE aux loss).
    With ``cache`` (a fresh decode cache) the layers write their decode
    state into it."""
    aux_total = 0.0
    if cfg.block_pattern == "attn":
        for li, lp in enumerate(params["layers"]):
            layer_cache = None if cache is None else (cache["k"][li], cache["v"][li])
            x, aux = _block(lp, x, cfg, kernels, layer_cache)
            aux_total = aux_total + aux
    elif cfg.block_pattern == "zamba2":
        ai = 0
        for li, lp in enumerate(params["layers"]):
            y = ssm_mod.mamba_apply(
                lp["mamba"], norm_apply(lp["ln"], x, cfg.norm), cfg, return_state=cache is not None, kernels=kernels
            )
            if cache is not None:
                y, st = y
                for name, t in st.items():
                    cache["ssm"][name][li].copy_(t)
            x = x + y
            if (li + 1) % cfg.attn_every == 0:
                layer_cache = None if cache is None else (cache["kv"]["k"][ai], cache["kv"]["v"][ai])
                x = _shared_block(params["shared_attn"], x, cfg, kernels, layer_cache)
                ai += 1
    else:
        for li, lp in enumerate(params["layers"]):
            h = norm_apply(lp["ln"], x, cfg.norm)
            if xl.is_slstm(cfg, li):
                y = xl.slstm_apply(lp["slstm"], h, cfg, return_state=cache is not None)
            else:
                y = xl.mlstm_apply(lp["mlstm"], h, cfg, return_state=cache is not None, kernels=kernels)
            if cache is not None:
                y, cache["xlstm"][li] = y
            x = x + y
    return x, aux_total


def forward(params, tokens, cfg, kernels=ops.KERNELS):
    """tokens: (B, S) -> (logits (B, S, V), aux_losses)."""
    check_supported(cfg)
    x, aux = _body(params, embed_tokens(params["embed"], tokens, Dtypes.from_cfg(cfg).act), cfg, kernels)
    return _head(params, x, cfg), aux


def make_decode_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    check_supported(cfg)
    dev = device_mod.resolve(device)
    if cfg.block_pattern == "attn":
        return attn.make_cache(cfg, batch, max_seq, cfg.n_layers, dtype, dev)
    if cfg.block_pattern == "zamba2":
        return {
            "ssm": ssm_mod.make_ssm_cache(cfg, batch, cfg.n_layers, dtype, dev),
            "kv": attn.make_cache(cfg, batch, max_seq, cfg.n_layers // cfg.attn_every, dtype, dev),
        }
    return {"xlstm": xl.make_xlstm_cache(cfg, batch, dtype, dev), "index": 0}


def prefill(params, tokens, cfg, max_seq: int, kernels=ops.KERNELS):
    """Run the whole prompt, build the decode cache, return the last
    position's logits (B, 1, V).  Only the last position goes through the
    output head: each position's logits depend on that position alone."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq {max_seq}")
    dt = Dtypes.from_cfg(cfg)
    cache = make_decode_cache(cfg, b, max_seq, dt.act, tokens.device)
    x, _ = _body(params, embed_tokens(params["embed"], tokens, dt.act), cfg, kernels, cache)
    if cfg.block_pattern == "zamba2":
        cache["kv"]["index"] = s
    else:
        cache["index"] = s
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg, kernels=ops.KERNELS):
    """token: (B, 1) int.  Returns (logits (B, 1, V), the cache one position
    on); the ``attn`` and ``zamba2`` caches' tensors are updated in place."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], token, Dtypes.from_cfg(cfg).act)
    if cfg.block_pattern == "attn":
        idx = int(cache["index"])
        for li, lp in enumerate(params["layers"]):
            h, _, _ = attn.attn_decode(
                lp["attn"], norm_apply(lp["ln1"], x, cfg.norm), cfg, cache["k"][li], cache["v"][li], idx, kernels
            )
            x = x + h
            x = x + _ffn(lp, norm_apply(lp["ln2"], x, cfg.norm), cfg)[0]
        cache = {"k": cache["k"], "v": cache["v"], "index": idx + 1}
    elif cfg.block_pattern == "zamba2":
        sp = params["shared_attn"]
        kv = cache["kv"]
        idx = int(kv["index"])
        ai = 0
        for li, lp in enumerate(params["layers"]):
            layer = {name: t[li] for name, t in cache["ssm"].items()}
            y, st = ssm_mod.mamba_decode(lp["mamba"], norm_apply(lp["ln"], x, cfg.norm), cfg, layer)
            for name, t in st.items():
                layer[name].copy_(t)
            x = x + y
            if (li + 1) % cfg.attn_every == 0:
                h, _, _ = attn.attn_decode(
                    sp["attn"], norm_apply(sp["ln_a"], x, cfg.norm), cfg, kv["k"][ai], kv["v"][ai], idx, kernels
                )
                x = x + h
                x = x + mlp_apply(sp["mlp"], norm_apply(sp["ln_m"], x, cfg.norm), cfg.act, cfg.glu)
                ai += 1
        cache = {"ssm": cache["ssm"], "kv": {"k": kv["k"], "v": kv["v"], "index": idx + 1}}
    else:
        states = []
        for li, lp in enumerate(params["layers"]):
            h = norm_apply(lp["ln"], x, cfg.norm)
            if xl.is_slstm(cfg, li):
                y, st = xl.slstm_decode(lp["slstm"], h, cfg, cache["xlstm"][li])
            else:
                y, st = xl.mlstm_decode(lp["mlstm"], h, cfg, cache["xlstm"][li])
            states.append(st)
            x = x + y
        cache = {"xlstm": states, "index": int(cache["index"]) + 1}
    return _head(params, x, cfg), cache
