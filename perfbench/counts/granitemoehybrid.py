"""Operations and bytes of GraniteMoeHybrid's published layout
(``perfbench/configs/granite-4.0-h-small.json``'s keys), from a COOK's
shapes: what ``score_mfu.granite``, ``moe_experts_roofline`` and
``ssd_scan_roofline.granite`` read.

Model FLOPs of a token are twice its multiply-adds in the matrix products
(each Mamba2 layer's in_proj and out_proj, each attention layer's q, k, v
and o projections, every layer's router, its top-k experts' SwiGLU and
its shared MLP, the head), plus causal attention: a document of n tokens
adds, in each attention layer, 2 · 2 · heads · head_dim · n (n + 1) / 2
for q·k and p·v.  The SSD scan's own arithmetic is left out (about 3% of
the total at the cell's lengths).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet)


def _widths(conf: dict) -> dict:
    d = conf["hidden_size"]
    d_in = conf["mamba_expand"] * d
    types = conf["layer_types"]
    return {"d": d, "d_in": d_in, "gn": conf["mamba_n_groups"] * conf["mamba_d_state"], "nh": conf["mamba_n_heads"],
            "h": conf["num_attention_heads"], "kv": conf["num_key_value_heads"], "hd": d // conf["num_attention_heads"],
            "mamba": sum(t == "mamba" for t in types), "attention": sum(t == "attention" for t in types),
            "layers": len(types)}


def expert_flops_per_assignment(conf: dict) -> int:
    """FLOPs of one (token, expert) assignment: the SwiGLU's input and
    output products, 2 · 3 · d · f."""
    return 2 * 3 * conf["hidden_size"] * conf["intermediate_size"]


def parameters(conf: dict) -> int:
    """The model's parameters, the tied head counted once."""
    w = _widths(conf)
    d, d_in, nh, gn = w["d"], w["d_in"], w["nh"], w["gn"]
    k = conf["mamba_d_conv"]
    mamba = d * (2 * d_in + 2 * gn + nh) + d_in * d + (k + conf["mamba_conv_bias"]) * (d_in + 2 * gn) + d_in + 3 * nh
    attn = d * (w["h"] + 2 * w["kv"]) * w["hd"] + w["h"] * w["hd"] * d
    e, f, fs = conf["num_local_experts"], conf["intermediate_size"], conf["shared_intermediate_size"]
    ffn = d * e + e * 3 * d * f + 3 * d * fs + 2 * d  # router, experts, shared MLP, the layer's two norms
    return w["mamba"] * mamba + w["attention"] * attn + w["layers"] * ffn + d * conf["vocab_size"] + d


def matmul_macs_per_token(conf: dict) -> int:
    """Multiply-adds of a token in the matrix products (attention's q·k and
    p·v excluded)."""
    w = _widths(conf)
    d, d_in = w["d"], w["d_in"]
    mamba = d * (2 * d_in + 2 * w["gn"] + w["nh"]) + d_in * d
    attn = d * (w["h"] + 2 * w["kv"]) * w["hd"] + w["h"] * w["hd"] * d
    experts = conf["num_experts_per_tok"] * expert_flops_per_assignment(conf) // 2
    ffn = d * conf["num_local_experts"] + experts + 3 * d * conf["shared_intermediate_size"]
    return w["mamba"] * mamba + w["attention"] * attn + w["layers"] * ffn + d * conf["vocab_size"]


def attention_flops(conf: dict, n: int, batch: int = 1) -> int:
    """Causal attention FLOPs of ``batch`` sequences of n positions over
    every attention layer (q·k and p·v)."""
    w = _widths(conf)
    return w["attention"] * batch * 4 * w["h"] * w["hd"] * n * (n + 1) // 2


def model_flops(conf: dict, doc_lengths) -> int:
    """Model FLOPs of documents of these lengths, padding not counted."""
    macs = matmul_macs_per_token(conf)
    return sum(2 * macs * n + attention_flops(conf, n) for n in doc_lengths)


def ssd_bytes(conf: dict, batch: int, seq: int) -> int:
    """The least bytes of one ``ssd_scan`` launch at (batch, seq) (bf16 x,
    B and C, float32 dt read once; float32 y and final state written
    once)."""
    w = _widths(conf)
    p, n = conf["mamba_d_head"], conf["mamba_d_state"]
    rows = batch * seq
    read = 2 * rows * w["nh"] * p + 4 * rows * w["nh"] + 2 * 2 * rows * w["gn"]
    written = 4 * rows * w["nh"] * p + 4 * batch * w["nh"] * p * n
    return read + written
