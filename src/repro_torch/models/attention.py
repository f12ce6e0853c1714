"""GQA / MQA / MHA attention: full sequence (train, prefill) and one-token
decode against a KV cache — the port of ``repro.models.attention``.

The reference runs attention in jnp (``_naive_attn``, or ``_chunked_attn``
past 8192 tokens, chosen by ``cfg.attn_impl``) and names its Pallas kernel
the TPU-target twin.  The port calls its kernels on the model path itself:
full-sequence attention is ``kernels.ops.flash_attention`` and decode is
``kernels.ops.decode_attention``, which compute the same function (a
float32 softmax under the same causal and length masks).  ``cfg.attn_impl``
chooses no other path here.  Each entry point takes ``kernels``, the
model's kernel bundle (``kernels.ops.ModelKernels``, re-exported here):
``KERNELS`` (the wrappers: CUDA kernels on the card, their plain versions
on the CPU) unless the caller passes ``PLAIN`` to hold the kernels against
their plain versions on the card.

Shapes: x (B, S, D); q (B, S, KV, G, hd); k/v (B, S, KV, hd).  The port's
KV cache is (layers, B, KV, T, hd), the kernels' layout, where the
reference's is (layers, B, T, KV, hd) (``models.convert.cache_to_reference``
maps one to the other), so its logical axes (``kv_cache_spec``) are the
reference's with the T and KV labels swapped.  Decode writes the new k and
v into the cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import per_shard
from repro_torch.distributed.sharding import axis_divides, constrain
from repro_torch.kernels.ops import KERNELS, PLAIN, ModelKernels
from repro_torch.models.layers import (
    Spec,
    apply_rope,
    dense_spec,
    flat_rows,
    flat_weight,
    merge_heads,
    norm_apply,
    norm_spec,
    rope_freqs,
    split_heads,
    unflatten_rows,
)

__all__ = [
    "KERNELS",
    "PLAIN",
    "ModelKernels",
    "attn_apply",
    "attn_decode",
    "attn_spec",
    "kv_cache_spec",
]


def attn_spec(cfg, dtype) -> dict:
    """Weights from the attention's input width (``cfg.attn_in_dim``) to
    d_model."""
    d, h, kv, hd = cfg.attn_in_dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bias_ax = ("heads", "head_dim") if cfg.qkv_bias else None
    bias_ax_kv = ("kv_heads", "head_dim") if cfg.qkv_bias else None
    spec = {
        "wq": dense_spec((d, h, hd), ("embed", "heads", "head_dim"), dtype, bias_axis=bias_ax),
        "wk": dense_spec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype, bias_axis=bias_ax_kv),
        "wv": dense_spec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype, bias_axis=bias_ax_kv),
        "wo": dense_spec((h, hd, cfg.d_model), ("heads", "head_dim", "embed"), dtype, scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        spec["q_norm"] = norm_spec(hd, "rmsnorm", dtype, "head_dim")
        spec["k_norm"] = norm_spec(hd, "rmsnorm", dtype, "head_dim")
    return spec


def _project_qkv(params, x, cfg, positions, kernels):
    """q (B, S, KV, G, hd), k and v (B, S, KV, hd), all contiguous."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x2 = flat_rows(x)
    q = unflatten_rows(split_heads(x2 @ flat_weight(params["wq"]["w"].to(x.dtype), (d, h * hd)), h, hd), b, s)
    k = unflatten_rows(split_heads(x2 @ flat_weight(params["wk"]["w"].to(x.dtype), (d, kv * hd)), kv, hd), b, s)
    v = unflatten_rows(split_heads(x2 @ flat_weight(params["wv"]["w"].to(x.dtype), (d, kv * hd)), kv, hd), b, s)
    if "b" in params["wq"]:
        q = q + params["wq"]["b"].to(x.dtype)
        k = k + params["wk"]["b"].to(x.dtype)
        v = v + params["wv"]["b"].to(x.dtype)
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q, "rmsnorm", kernels=kernels)
        k = norm_apply(params["k_norm"], k, "rmsnorm", kernels=kernels)
    if cfg.pos_emb == "rope":
        inv, rot = rope_freqs(hd, cfg.partial_rotary, cfg.rope_theta, device=x.device)
        q = apply_rope(q, positions, inv, rot)
        k = apply_rope(k, positions, inv, rot)
    if type(q) is not torch.Tensor:  # on a mesh the heads split into (KV, G) over KV, if the model axis divides it
        q = constrain(q, ("act_batch", None, "act_heads" if axis_divides("act_heads", kv) else None, None))
    return q.reshape(b, s, kv, h // kv, hd).contiguous(), k.contiguous(), v.contiguous()


def _scale(cfg) -> dict:
    """The kernels' ``scale`` where the configuration's is not their hd^-0.5."""
    return {"scale": cfg.attn_scale} if cfg.hybrid_layer_ids or cfg.attention_multiplier else {}


def _out_proj(params, out, x, kv: int):
    """(B, S, H, hd) attention output through wo (H, hd, D); ``kv`` is the KV
    head count H splits back into."""
    b, s, h, hd = out.shape
    w = params["wo"]["w"]
    return merge_heads(out, kv) @ flat_weight(w.to(x.dtype), (h * hd, w.shape[-1]))


def attn_apply(params, x, cfg, positions=None, causal=True, layer_cache=None, kernels=KERNELS):
    """Full-sequence attention (train / prefill) through
    ``kernels.flash_attention``.  With ``layer_cache`` = (k, v) of one layer
    of the port's cache, (B, KV, T, hd), the sequence's k and v are written
    into positions [0, S) and attention reads them there."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions, kernels)
    if layer_cache is not None:
        layer_k, layer_v = layer_cache
        layer_k[:, :, :s].copy_(k.transpose(1, 2))
        layer_v[:, :, :s].copy_(v.transpose(1, 2))
        k_t, v_t = layer_k[:, :, :s], layer_v[:, :, :s]
    else:
        k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)
    # (B, KV, G, S, hd) views of q's memory; the CUDA kernel writes its
    # output in the same layout, so the permute back is free
    out = kernels.flash_attention(q.permute(0, 2, 3, 1, 4), k_t, v_t, causal=causal, **_scale(cfg))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return _out_proj(params, out, x, cfg.n_kv_heads)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def kv_cache_spec(cfg, batch: int, max_seq: int, n_layers: int, dtype, long_context: bool = False) -> dict:
    """The zeroed KV cache (layers, B, KV, T, hd) and its index; a long
    context shards T over ``cache_seq_long``."""
    shape = (n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim_)
    axes = ("layers", "cache_batch", "kv_heads", "cache_seq_long" if long_context else None, "head_dim")
    return {"k": Spec(shape, dtype, axes), "v": Spec(shape, dtype, axes), "index": 0}


def attn_decode(params, x, cfg, layer_k, layer_v, index: int, kernels=KERNELS):
    """One-token decode: x (B, 1, D); layer_k / layer_v (B, KV, T, hd) of the
    port's cache.  Writes the token's k and v at ``index`` (in place), then
    attends to positions ``<= index`` through ``kernels.decode_attention``
    with ``length = index + 1`` (the reference masks ``arange(T) <= index``).
    Returns (y, layer_k, layer_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, kernels)
    if per_shard.is_dtensor(layer_k):  # on a mesh: the rank holding the position writes it
        per_shard.write_at(layer_k, k_new[:, 0].to(layer_k.dtype), index, 2)
        per_shard.write_at(layer_v, v_new[:, 0].to(layer_v.dtype), index, 2)
    else:
        layer_k[:, :, index] = k_new[:, 0].to(layer_k.dtype)
        layer_v[:, :, index] = v_new[:, 0].to(layer_v.dtype)
    out = kernels.decode_attention(q[:, 0], layer_k, layer_v, index + 1, **_scale(cfg))  # (B, KV, G, hd)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    return _out_proj(params, out, x, cfg.n_kv_heads), layer_k, layer_v
