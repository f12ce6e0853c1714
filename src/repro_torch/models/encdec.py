"""Whisper-style encoder-decoder (arXiv:2212.04356) — the port of
``repro.models.encdec``.

    init(cfg, generator, device)                      -> params
    encode(params, frames, cfg)                       -> memory (B, enc_seq, d)
    forward(params, batch, cfg)                       -> (logits, 0.0)
    loss_fn(params, batch, cfg)                       -> (loss, {ce})
    prefill(params, batch, cfg, max_seq)              -> (last_logits, cache)
    decode_step(params, token, cache, cfg)            -> (logits, cache)
    make_decode_cache(cfg, batch, max_seq, dtype, device)

``batch`` is {frames (B, enc_seq, d), tokens (B, S)}: the conv audio
frontend is a stub, as in the reference, and the model takes precomputed
frame embeddings.  Learned positions (no RoPE), LayerNorm, biased q/k/v and
MLP, tanh GELU, tied embeddings.  Every attention goes through the kernel
bundle ``kernels`` (``kernels.ops.KERNELS``, or ``PLAIN``), computing the
reference's function: the encoder's bidirectional attention and the
cross-attention over the whole memory are ``flash_attention(causal=False)``
(S = T = enc_seq, and S = prompt over T = enc_seq), the decoder's causal
self-attention ``attention.attn_apply`` / ``attn_decode``, and each decode
step's cross-attention ``decode_attention`` with ``length = enc_seq``.

Cache: {k, v (layers, B, KV, T, hd), cross_k, cross_v (layers, B, KV,
enc_seq, hd), index}; the reference's is (layers, B, T, KV, hd)
(``models.convert.cache_to_reference``).  ``k`` and ``v`` are updated in
place.  ``spec`` declares every parameter once and ``decode_cache_spec``
the cache: ``init`` / ``param_axes`` and ``make_decode_cache`` /
``decode_cache_axes`` read them (the cache's T and KV swapped for the
port's layout); activations are constrained at the reference's sites.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.distributed.sharding import constrain, shard_tree
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Dtypes,
    Spec,
    axes_of,
    embed_tokens,
    embedding_spec,
    flat_rows,
    flat_weight,
    logits_apply,
    materialize,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
    split_heads,
    unflatten_rows,
)
from repro_torch.models.lm import ACT_AXES, LOGIT_AXES, cross_entropy, weights_device

__all__ = [
    "DEC_POSITIONS",
    "decode_cache_axes",
    "decode_cache_spec",
    "decode_step",
    "encode",
    "forward",
    "init",
    "loss_fn",
    "make_decode_cache",
    "param_axes",
    "prefill",
    "spec",
]

DEC_POSITIONS = 33024  # the reference's decoder position table: decode_32k (32768) + train_4k


def spec(cfg) -> dict:
    """The spec tree of the parameters: every tensor's shape, dtype, the
    reference's logical axes and initial value, declared once."""
    dt, d = Dtypes.from_cfg(cfg).param, cfg.d_model

    def ln():
        return norm_spec(d, cfg.norm, dt)

    def mlp():
        return mlp_spec(d, cfg.d_ff, cfg.glu, dt, bias=cfg.mlp_bias)

    return {
        "embed": embedding_spec(cfg.padded_vocab, d, dt),
        "enc_pos": Spec((cfg.enc_seq, d), dt, (None, "embed"), std=0.01),
        "dec_pos": Spec((DEC_POSITIONS, d), dt, (None, "embed"), std=0.01),
        "enc_final_norm": ln(),
        "final_norm": ln(),
        "encoder": [
            {"ln1": ln(), "attn": attn.attn_spec(cfg, dt), "ln2": ln(), "mlp": mlp()} for _ in range(cfg.encoder_layers)
        ],
        "decoder": [
            {
                "ln1": ln(),
                "self_attn": attn.attn_spec(cfg, dt),
                "ln_x": ln(),
                "cross_attn": attn.attn_spec(cfg, dt),
                "ln2": ln(),
                "mlp": mlp(),
            }
            for _ in range(cfg.n_layers)
        ],
    }


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's shapes, names and standard
    deviations, drawn from ``generator`` on ``device`` (the generator's)."""
    return materialize(spec(cfg), weights_device(generator, device), generator)


def param_axes(cfg) -> dict:
    """The logical-axes tree of ``init(cfg, ...)``'s parameters, leaf for
    leaf the reference's ``init`` axes."""
    return axes_of(spec(cfg))


def encode(params, frames, cfg, kernels=ops.KERNELS):
    """frames (B, enc_seq, d) stub embeddings -> encoder memory."""
    x = constrain(frames + params["enc_pos"][None, : frames.shape[1]].to(frames.dtype), ACT_AXES)
    for lp in params["encoder"]:
        h = norm_apply(lp["ln1"], x, cfg.norm, kernels=kernels)
        x = x + attn.attn_apply(lp["attn"], h, cfg, causal=False, kernels=kernels)
        x = constrain(x, ACT_AXES)
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm, kernels=kernels), cfg.act, cfg.glu)
        x = constrain(x, ACT_AXES)
    return norm_apply(params["enc_final_norm"], x, cfg.norm, kernels=kernels)


def _memory_kv(params, memory, cfg) -> tuple:
    """The cross-attention's k and v of the encoder memory, (B, KV, T, hd)
    views."""
    b, t, d = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    m2 = flat_rows(memory)
    k = unflatten_rows(split_heads(m2 @ flat_weight(params["wk"]["w"].to(memory.dtype), (d, kv * hd)), kv, hd), b, t)
    v = unflatten_rows(split_heads(m2 @ flat_weight(params["wv"]["w"].to(memory.dtype), (d, kv * hd)), kv, hd), b, t)
    if "b" in params["wk"]:
        k = k + params["wk"]["b"].to(memory.dtype)
        v = v + params["wv"]["b"].to(memory.dtype)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_q(params, x, cfg):
    """The cross-attention's queries of x (B, S, d): (B, S, KV, G, hd)."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = unflatten_rows(split_heads(flat_rows(x) @ flat_weight(params["wq"]["w"].to(x.dtype), (d, h * hd)), h, hd), b, s)
    if "b" in params["wq"]:
        q = q + params["wq"]["b"].to(x.dtype)
    return q.reshape(b, s, kv, h // kv, hd).contiguous()


def _cross_attn(params, x, mem_k, mem_v, cfg, kernels):
    """Cross-attention of x (B, S, d) over the memory's k and v (B, KV, T,
    hd), every position seeing the whole memory."""
    b, s, _ = x.shape
    q = _cross_q(params, x, cfg)
    out = kernels.flash_attention(q.permute(0, 2, 3, 1, 4), mem_k, mem_v, causal=False)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return attn._out_proj(params, out, x, cfg.n_kv_heads)


def _decoder_stack(params, x, cfg, kernels, memory=None, cache=None):
    """The decoder layers over the whole sequence.  Cross-attention reads
    the memory's k and v from ``cache`` (a fresh decode cache whose cross_k
    and cross_v are filled, and whose k and v the layers write), else
    projects ``memory``."""
    # not a reference site: on a mesh the embedded tokens plus the position
    # table are laid out over the batch (value and gradient) before the
    # first layer, or the lookup's backward gets a gradient it cannot flatten
    x = constrain(x, ACT_AXES)
    for li, lp in enumerate(params["decoder"]):
        layer_cache = None if cache is None else (cache["k"][li], cache["v"][li])
        h = norm_apply(lp["ln1"], x, cfg.norm, kernels=kernels)
        x = x + attn.attn_apply(lp["self_attn"], h, cfg, layer_cache=layer_cache, kernels=kernels)
        x = constrain(x, ACT_AXES)
        if cache is None:
            mem_k, mem_v = _memory_kv(lp["cross_attn"], memory, cfg)
        else:
            mem_k, mem_v = cache["cross_k"][li], cache["cross_v"][li]
        h = norm_apply(lp["ln_x"], x, cfg.norm, kernels=kernels)
        x = x + _cross_attn(lp["cross_attn"], h, mem_k, mem_v, cfg, kernels)
        x = constrain(x, ACT_AXES)
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm, kernels=kernels), cfg.act, cfg.glu)
        x = constrain(x, ACT_AXES)
    return x


def _embed(params, tokens, start: int, dtype):
    s = tokens.shape[1]
    return embed_tokens(params["embed"], tokens, dtype) + params["dec_pos"][None, start : start + s].to(dtype)


def _head(params, x, cfg, kernels):
    return logits_apply(params["embed"], norm_apply(params["final_norm"], x, cfg.norm, kernels=kernels), cfg.vocab_size)


def forward(params, batch, cfg, kernels=ops.KERNELS):
    """batch {frames (B, enc_seq, d), tokens (B, S)} -> (logits (B, S, V), 0.0)."""
    dt = Dtypes.from_cfg(cfg)
    memory = encode(params, batch["frames"].to(dt.act), cfg, kernels)
    x = _decoder_stack(params, _embed(params, batch["tokens"], 0, dt.act), cfg, kernels, memory=memory)
    return constrain(_head(params, x, cfg, kernels), LOGIT_AXES), 0.0


def loss_fn(params, batch, cfg, kernels=ops.KERNELS):
    """batch {frames, tokens, labels} -> (loss, {ce}): the decoder's mean
    token cross-entropy (no remat: the reference wraps no encoder-decoder
    block)."""
    logits, _ = forward(params, batch, cfg, kernels)
    loss = cross_entropy(logits, batch["labels"], cfg.loss_impl)
    return loss, {"ce": loss}


def decode_cache_spec(cfg, batch: int, max_seq: int, dtype, long_context: bool = False) -> dict:
    """The decoder's KV cache (a long context shards its T over
    ``cache_seq_long``) and the memory's k and v per layer."""
    tree = attn.kv_cache_spec(cfg, batch, max_seq, cfg.n_layers, dtype, long_context)
    cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim_)
    axes = ("layers", "cache_batch", "kv_heads", None, "head_dim")
    return dict(tree, cross_k=Spec(cross, dtype, axes), cross_v=Spec(cross, dtype, axes))


def make_decode_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    return materialize(decode_cache_spec(cfg, batch, max_seq, dtype), device_mod.resolve(device))


def decode_cache_axes(cfg, long_context: bool = False) -> dict:
    return axes_of(decode_cache_spec(cfg, 1, 1, torch.float32, long_context))


def prefill(params, batch, cfg, max_seq: int, kernels=ops.KERNELS):
    """Encode the frames, run the whole prompt and build the decode cache
    (the memory's k and v per layer included); returns the last position's
    logits (B, 1, V)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq {max_seq}")
    dt = Dtypes.from_cfg(cfg)
    memory = encode(params, batch["frames"].to(dt.act), cfg, kernels)
    cache = shard_tree(make_decode_cache(cfg, b, max_seq, dt.act, tokens.device), decode_cache_axes(cfg))
    for li, lp in enumerate(params["decoder"]):
        mem_k, mem_v = _memory_kv(lp["cross_attn"], memory, cfg)
        cache["cross_k"][li].copy_(mem_k)
        cache["cross_v"][li].copy_(mem_v)
    x = _decoder_stack(params, _embed(params, tokens, 0, dt.act), cfg, kernels, cache=cache)
    cache["index"] = s
    return _head(params, x[:, -1:], cfg, kernels), cache


def decode_step(params, token, cache, cfg, kernels=ops.KERNELS):
    """token: (B, 1) int.  Returns (logits (B, 1, V), the cache one position
    on); the cache's k and v are updated in place."""
    dt = Dtypes.from_cfg(cfg)
    idx = int(cache["index"])
    x = constrain(_embed(params, token, idx, dt.act), ACT_AXES)  # as lm.decode_step's
    b = x.shape[0]
    for li, lp in enumerate(params["decoder"]):
        h = norm_apply(lp["ln1"], x, cfg.norm, kernels=kernels)
        h, _, _ = attn.attn_decode(lp["self_attn"], h, cfg, cache["k"][li], cache["v"][li], idx, kernels)
        x = x + h
        xp = lp["cross_attn"]
        q = _cross_q(xp, norm_apply(lp["ln_x"], x, cfg.norm, kernels=kernels), cfg)
        mem_k, mem_v = cache["cross_k"][li], cache["cross_v"][li]
        out = kernels.decode_attention(q[:, 0], mem_k, mem_v, mem_k.shape[2])  # (B, KV, G, hd)
        x = x + attn._out_proj(xp, out.reshape(b, 1, cfg.n_heads, cfg.head_dim_), x, cfg.n_kv_heads)
        x = x + mlp_apply(lp["mlp"], norm_apply(lp["ln2"], x, cfg.norm, kernels=kernels), cfg.act, cfg.glu)
    return _head(params, x, cfg, kernels), dict(cache, index=idx + 1)
