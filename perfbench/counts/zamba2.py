"""Operations and bytes of Zamba2's published layout (``perfbench/configs/
zamba2-7b.json``'s keys), from a COOK's shapes: what ``score_mfu``,
``flash_attention_roofline`` and ``ssd_scan_roofline`` read.

Model FLOPs of a token are twice its multiply-adds in the matrix products
(every Mamba layer's in_proj and out_proj, each application's shared block
at the concatenated width, its LoRA and its linear, the head), plus
causal attention: a document of n tokens adds, in each application,
2 · 2 · heads · head_dim · n (n + 1) / 2 for q·k and p·v.  The SSD scan's
own arithmetic is left out (under 3% of the total at the cell's lengths).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet)


def _widths(conf: dict) -> dict:
    d = conf["hidden_size"]
    d_in = conf["mamba_expand"] * d
    gn = conf["mamba_ngroups"] * conf["mamba_d_state"]
    h, hd = conf["num_attention_heads"], conf["attention_head_dim"]
    f = conf.get("ffn_hidden_size", conf.get("intermediate_size"))
    return {"d": d, "d_in": d_in, "gn": gn, "h": h, "hd": hd, "f": f, "nh": conf["n_mamba_heads"],
            "apps": len(conf["hybrid_layer_ids"]), "layers": conf["num_hidden_layers"]}


def matmul_macs_per_token(conf: dict) -> int:
    """Multiply-adds of a token in the matrix products (attention's q·k and
    p·v excluded)."""
    w = _widths(conf)
    d, d_in, f = w["d"], w["d_in"], w["f"]
    mamba = d * (2 * d_in + 2 * w["gn"] + w["nh"]) + d_in * d
    d_a = 2 * d
    shared = 3 * d_a * w["h"] * w["hd"] + w["h"] * w["hd"] * d + d * 2 * f + f * d
    app = conf["adapter_rank"] * (d + 2 * f) + d * d
    return w["layers"] * mamba + w["apps"] * (shared + app) + d * conf["vocab_size"]


def attention_flops(conf: dict, n: int, batch: int = 1) -> int:
    """Causal attention FLOPs of ``batch`` sequences of n positions over
    every application (q·k and p·v)."""
    w = _widths(conf)
    return w["apps"] * batch * 4 * w["h"] * w["hd"] * n * (n + 1) // 2


def model_flops(conf: dict, doc_lengths) -> int:
    """Model FLOPs of documents of these lengths, padding not counted."""
    macs = matmul_macs_per_token(conf)
    return sum(2 * macs * n + attention_flops(conf, n) for n in doc_lengths)


def ssd_bytes(conf: dict, batch: int, seq: int) -> int:
    """The least bytes of one grouped ``ssd_scan`` launch at (batch, seq)
    (bf16 x, B and C, float32 dt read once; float32 y and final state
    written once)."""
    w = _widths(conf)
    p, n = conf["mamba_headdim"], conf["mamba_d_state"]
    rows = batch * seq
    read = 2 * rows * w["nh"] * p + 4 * rows * w["nh"] + 2 * 2 * rows * w["gn"]
    written = 4 * rows * w["nh"] * p + 4 * batch * w["nh"] * p * n
    return read + written
