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
maps one to the other).  Decode writes the new k and v into the cache in
place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import KERNELS, PLAIN, ModelKernels
from repro_torch.models.layers import apply_rope, dense_init, norm_apply, rope_freqs

__all__ = ["KERNELS", "PLAIN", "ModelKernels", "attn_apply", "attn_decode", "attn_init", "make_cache"]


def attn_init(gen, cfg, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bias_ax = ("heads", "head_dim") if cfg.qkv_bias else None
    bias_ax_kv = ("kv_heads", "head_dim") if cfg.qkv_bias else None
    params = {
        "wq": dense_init(gen, (d, h, hd), ("embed", "heads", "head_dim"), dtype, bias_axis=bias_ax),
        "wk": dense_init(gen, (d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype, bias_axis=bias_ax_kv),
        "wv": dense_init(gen, (d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype, bias_axis=bias_ax_kv),
        "wo": dense_init(gen, (h, hd, d), ("heads", "head_dim", "embed"), dtype, scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        params["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=gen.device)}
        params["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=gen.device)}
    return params


def _project_qkv(params, x, cfg, positions):
    """q (B, S, KV, G, hd), k and v (B, S, KV, hd), all contiguous."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x2 = x.reshape(b * s, d)
    q = (x2 @ params["wq"]["w"].to(x.dtype).reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x2 @ params["wk"]["w"].to(x.dtype).reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = (x2 @ params["wv"]["w"].to(x.dtype).reshape(d, kv * hd)).reshape(b, s, kv, hd)
    if "b" in params["wq"]:
        q = q + params["wq"]["b"].to(x.dtype)
        k = k + params["wk"]["b"].to(x.dtype)
        v = v + params["wv"]["b"].to(x.dtype)
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q, "rmsnorm")
        k = norm_apply(params["k_norm"], k, "rmsnorm")
    if cfg.pos_emb == "rope":
        inv, rot = rope_freqs(hd, cfg.partial_rotary, cfg.rope_theta, device=x.device)
        q = apply_rope(q, positions, inv, rot)
        k = apply_rope(k, positions, inv, rot)
    return q.reshape(b, s, kv, h // kv, hd).contiguous(), k.contiguous(), v.contiguous()


def _out_proj(params, out, x):
    """(B, S, H, hd) attention output through wo (H, hd, D)."""
    b, s, h, hd = out.shape
    return out.reshape(b, s, h * hd) @ params["wo"]["w"].to(x.dtype).reshape(h * hd, -1)


def attn_apply(params, x, cfg, positions=None, causal=True, layer_cache=None, kernels=KERNELS):
    """Full-sequence attention (train / prefill) through
    ``kernels.flash_attention``.  With ``layer_cache`` = (k, v) of one layer
    of the port's cache, (B, KV, T, hd), the sequence's k and v are written
    into positions [0, S) and attention reads them there."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    if layer_cache is not None:
        layer_k, layer_v = layer_cache
        layer_k[:, :, :s].copy_(k.transpose(1, 2))
        layer_v[:, :, :s].copy_(v.transpose(1, 2))
        k_t, v_t = layer_k[:, :, :s], layer_v[:, :, :s]
    else:
        k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)
    # (B, KV, G, S, hd) views of q's memory; the CUDA kernel writes its
    # output in the same layout, so the permute back is free
    out = kernels.flash_attention(q.permute(0, 2, 3, 1, 4), k_t, v_t, causal=causal)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return _out_proj(params, out, x)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------
def make_cache(cfg, batch: int, max_seq: int, n_layers: int, dtype, device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    shape = (n_layers, batch, kv, max_seq, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def attn_decode(params, x, cfg, layer_k, layer_v, index: int, kernels=KERNELS):
    """One-token decode: x (B, 1, D); layer_k / layer_v (B, KV, T, hd) of the
    port's cache.  Writes the token's k and v at ``index`` (in place), then
    attends to positions ``<= index`` through ``kernels.decode_attention``
    with ``length = index + 1`` (the reference masks ``arange(T) <= index``).
    Returns (y, layer_k, layer_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    layer_k[:, :, index] = k_new[:, 0].to(layer_k.dtype)
    layer_v[:, :, index] = v_new[:, 0].to(layer_v.dtype)
    out = kernels.decode_attention(q[:, 0], layer_k, layer_v, index + 1)  # (B, KV, G, hd)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    return _out_proj(params, out, x), layer_k, layer_v
