"""Plain PyTorch reference of GraniteMoeHybrid (granite-4.0-h-small's
published layout), float32, one document at a time: no kernels, no cache,
no batching.

    logits = forward(params, tokens, conf)          # tokens (S,) -> (S, V) float32
    lp     = logprobs(params, tokens, conf)         # (S - 1,): log p(token_t | tokens_<t), t >= 1

``conf`` holds the published config's keys (``hidden_size``,
``layer_types``, ``num_local_experts``, ...), as
``perfbench/configs/granite-4.0-h-small.json`` does.  ``params`` is the
program's parameter tree (``embed``, ``final_norm``, ``layers[i]`` {``ln1``,
``mamba`` or ``attn``, ``ln2``, ``moe``}), read leaf by leaf and cast to
float32 one layer at a time (the experts one expert at a time), so that
the whole model never sits in float32 beside the program's own weights.
Matrix products run in float32 with TF32 off (``fp8=True``: each operand
first rounded through float8_e4m3fn with a per-tensor scale, the control a
cell's limits have to refuse).

The equations, as transformers' ``GraniteMoeHybridForCausalLM``
(``modeling_granitemoehybrid.py``) writes them:

- x = E[tokens] · ``embedding_multiplier``.
- Each layer: h = RMSNorm(x); its mixer by ``layer_types``; x = x +
  ``residual_multiplier`` · mixer(h); h = RMSNorm(x); x = x +
  ``residual_multiplier`` · (MoE(h) + shared MLP(h)).
- Attention: causal GQA of ``num_attention_heads`` query and
  ``num_key_value_heads`` KV heads of hidden / heads, no position
  embedding (``position_embedding_type`` "nope"), scores scaled by
  ``attention_multiplier``, no bias.
- Mamba2: z, x, B, C, dt from the input; depthwise causal convs of
  ``mamba_d_conv`` with bias, then SiLU, on x, B and C; dt = softplus(dt +
  dt_bias), unclamped (``time_step_limit`` (0, inf)); the SSD scan in
  chunks of ``mamba_chunk_size`` over ``mamba_n_groups`` B/C groups; y +
  D·x; y·SiLU(z), then RMSNorm over each group's channels (eps
  ``rms_norm_eps``); out_proj.  The same mixer as ``reference.zamba2``'s,
  called with this config's keys.
- MoE: router logits h·W_r in float32; their top ``num_experts_per_tok``
  (``torch.topk``) and a softmax over those; each expert e of
  ``num_local_experts``, run densely on the tokens routed to it:
  SiLU(h·W_in[e][:f]ᵀ) · (h·W_in[e][f:]ᵀ) · W_out[e]ᵀ (``input_linear``'s
  first ``intermediate_size`` rows feed the SiLU), times the token's gate,
  summed.  No token is dropped.  Shared MLP: SiLU(h·W_g)·(h·W_u)·W_d of
  ``shared_intermediate_size``.
- Final RMSNorm, the tied head, logits / ``logits_scaling``.  Every RMSNorm
  in float32 with ``rms_norm_eps``.

Departures from the published description: the weights are whatever the
caller's tree holds (the benchmark's are random, from a seed); the
vocabulary is the config's with no padding rows; the router's linear runs
in float32 (transformers runs it in the model's type, then casts to
float32: the same in a float32 model); the recurrence is the chunked SSD,
with the state passed between chunks as the SSD recurrence defines it,
which transformers' plain path (4.57) does not do (it sums the chunk
decays over the target chunk, as its Zamba2 path does), so the two agree
only within the first chunk; ``attention_mask`` is absent (one unpadded
document a call).  Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import zamba2

_mm, _rms, _no_tf32 = zamba2._mm, zamba2._rms, zamba2._no_tf32


def _w(t, device):
    return t.to(device=device, dtype=torch.float32)


def _mamba_conf(conf: dict) -> dict:
    """This config's Mamba2 keys under ``reference.zamba2``'s names."""
    return {"mamba_expand": conf["mamba_expand"], "hidden_size": conf["hidden_size"],
            "n_mamba_heads": conf["mamba_n_heads"], "mamba_headdim": conf["mamba_d_head"],
            "mamba_d_state": conf["mamba_d_state"], "mamba_ngroups": conf["mamba_n_groups"],
            "use_conv_bias": conf["mamba_conv_bias"], "chunk_size": conf["mamba_chunk_size"]}


def _attention(ap, h, conf: dict, fp8: bool):
    dev = h.device
    s, d = h.shape
    nh, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // nh
    q = _mm(h, _w(ap["wq"]["w"], dev).reshape(d, nh * hd), fp8).reshape(s, nh, hd).transpose(0, 1)
    k, v = (_mm(h, _w(ap[n]["w"], dev).reshape(d, kv * hd), fp8).reshape(s, kv, hd).transpose(0, 1)
            .repeat_interleave(nh // kv, dim=0) for n in ("wk", "wv"))  # head i reads KV head i // (nh / kv)
    scores = _mm(q, k.transpose(1, 2), fp8) * conf["attention_multiplier"]
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, fp8).transpose(0, 1).reshape(s, nh * hd)
    return _mm(o, _w(ap["wo"]["w"], dev).reshape(nh * hd, d), fp8)


def _moe(mp, h, conf: dict, fp8: bool):
    dev = h.device
    e, k, f = conf["num_local_experts"], conf["num_experts_per_tok"], conf["intermediate_size"]
    logits = _mm(h, _w(mp["router"]["w"], dev), fp8)
    top, idx = logits.topk(k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    for ex in range(e):  # every expert, densely on the tokens routed to it
        tok, slot = (idx == ex).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        w_in, w_out = _w(mp["input_linear"]["w"][ex], dev), _w(mp["output_linear"]["w"][ex], dev)
        gate_up = _mm(h[tok], w_in.t(), fp8)
        out = _mm(F.silu(gate_up[:, :f]) * gate_up[:, f:], w_out.t(), fp8)
        y.index_add_(0, tok, out * gates[tok, slot, None])
    sh = mp["shared"]
    shared = F.silu(_mm(h, _w(sh["gate"]["w"], dev), fp8)) * _mm(h, _w(sh["up"]["w"], dev), fp8)
    return y + _mm(shared, _w(sh["down"]["w"], dev), fp8)


def forward(params, tokens, conf: dict, fp8: bool = False, device=None):
    """tokens (S,) int -> logits (S, vocab_size) float32 on ``device``
    (default: the tokens')."""
    _no_tf32()
    dev = torch.device(device) if device is not None else tokens.device
    eps, rm = conf["rms_norm_eps"], conf["residual_multiplier"]
    table = params["embed"]["table"]
    x = table[tokens.to(table.device)].to(device=dev, dtype=torch.float32) * conf["embedding_multiplier"]
    mconf = _mamba_conf(conf)
    for lp, kind in zip(params["layers"], conf["layer_types"]):
        h = _rms(x, lp["ln1"]["scale"], eps)
        if kind == "mamba":
            x = x + rm * zamba2._mamba(lp["mamba"], h, mconf, fp8)
        else:
            x = x + rm * _attention(lp["attn"], h, conf, fp8)
        x = x + rm * _moe(lp["moe"], _rms(x, lp["ln2"]["scale"], eps), conf, fp8)
    x = _rms(x, params["final_norm"]["scale"], eps)
    head = table[: conf["vocab_size"]].to(device=dev, dtype=torch.float32)
    return _mm(x, head.t(), fp8) / conf["logits_scaling"]


def logprobs(params, tokens, conf: dict, fp8: bool = False, device=None):
    """log p(token_t | tokens_<t) for t = 1 .. S-1, float32 (S - 1,)."""
    logits = forward(params, tokens, conf, fp8, device)
    lp = torch.log_softmax(logits[:-1], dim=-1)
    return lp.gather(-1, tokens[1:].to(lp.device, torch.long)[:, None])[:, 0]
