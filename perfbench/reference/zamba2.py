"""Plain PyTorch reference of Zamba2 (Zamba2-7B-Instruct's published
layout), float32, one document at a time: no kernels, no cache, no batching.

    logits = forward(params, tokens, conf)          # tokens (S,) -> (S, V) float32
    lp     = logprobs(params, tokens, conf)         # (S - 1,): log p(token_t | tokens_<t), t >= 1

``conf`` holds the published config's keys (``hidden_size``,
``mamba_ngroups``, ``hybrid_layer_ids``, ...), as
``perfbench/configs/zamba2-7b.json`` does.  ``params`` is the program's
parameter tree (``embed``, ``final_norm``, ``layers[i]`` {``ln``,
``mamba``}, ``mem_blocks[k]``, ``hybrid[j]``), read leaf by leaf and cast
to float32 one layer at a time, so that the whole model never sits in
float32 beside the program's own weights.  Matrix products run in float32
with TF32 off (``fp8=True``: each operand first rounded through
float8_e4m3fn with a per-tensor scale, the control a cell's limits have to
refuse).

The equations, as transformers' ``Zamba2ForCausalLM``
(``modeling_zamba2.py``) writes them:

- x = E[tokens], emb = x.  Before each Mamba layer li of
  ``hybrid_layer_ids`` (application j), shared block j % num_mem_blocks:
  h = RMSNorm(concat(x, emb)) (2·hidden), causal MHA of
  ``num_attention_heads`` heads of ``attention_head_dim`` with RoPE over
  the whole head (θ ``rope_theta``) and scale (head_dim / 2)^-0.5, o_proj
  to hidden, RMSNorm, gate_up = h·W + (h·A_j)·B_j (the application's LoRA
  of ``adapter_rank``), GELU(gate)·up, down; then the application's own
  linear.  That is added to the Mamba layer's input x before its RMSNorm;
  the layer's residual is x itself.
- Mamba2: z, x, B, C, dt from the input; depthwise causal convs of
  ``mamba_d_conv`` with bias, then SiLU, on x, B and C; dt = softplus(dt +
  dt_bias); B and C in ``mamba_ngroups``
  groups (head h reads group h // (heads / groups)); the SSD scan in
  chunks of ``chunk_size``; y + D·x; y·SiLU(z) then RMSNorm per group of
  d_inner / groups channels (eps 1e-5); out_proj.
- Final RMSNorm, the tied head.  Every RMSNorm in float32 with
  ``rms_norm_eps``.

Departures from the published description: the weights are whatever the
caller's tree holds (the benchmark's are random, from a seed); the
vocabulary is the config's with no padding rows; the recurrence is the
chunked SSD (the same sums as the scan, in another order), computed in
float32; ``attention_mask`` is absent (one unpadded document a call).
Two choices where transformers' two Mamba paths differ: dt is not
clamped, as its CUDA path leaves it with ``time_step_limit`` null (its
plain path clamps it below at ``time_step_min``); and the state passes
between chunks as the SSD recurrence defines it, which its plain path
(transformers 4.57) does not do: it sums the chunk decays over the target
chunk instead of the source (``result = (...).sum(dim=2)``), so the two
agree only within the first chunk.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(t):
    """``t`` through float8_e4m3fn, scaled per tensor so that its largest
    magnitude maps to 448."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, fp8: bool):
    if fp8:
        a, b = _round_fp8(a), _round_fp8(b)
    return a @ b


def _w(p, device):
    return p["w"].to(device=device, dtype=torch.float32)


def _rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.to(x.device, torch.float32)


def _rope(x, theta: float):
    """x (H, S, hd): rotate_half's RoPE over the whole head."""
    hd, s = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    cos, sin = torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _shared_block(bp, ap, x, emb, conf, fp8: bool):
    dev = x.device
    eps = conf["rms_norm_eps"]
    nh, hd = conf["num_attention_heads"], conf["attention_head_dim"]
    s = x.shape[0]
    h = _rms(torch.cat([x, emb], -1), bp["ln_a"]["scale"], eps)
    at = bp["attn"]
    q, k, v = (_mm(h, _w(at[n], dev).reshape(h.shape[-1], nh * hd), fp8).reshape(s, nh, hd).transpose(0, 1)
               for n in ("wq", "wk", "wv"))
    if conf["use_mem_rope"]:
        q, k = _rope(q, conf["rope_theta"]), _rope(k, conf["rope_theta"])
    scores = _mm(q, k.transpose(1, 2), fp8) * (hd / 2) ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, fp8).transpose(0, 1).reshape(s, nh * hd)
    h = _mm(o, _w(at["wo"], dev).reshape(nh * hd, -1), fp8)
    h = _rms(h, bp["ln_m"]["scale"], eps)
    mlp = bp["mlp"]
    gate_up = _mm(h, _w(mlp["gate_up"], dev), fp8) + _mm(_mm(h, _w(ap["lora_a"], dev), fp8), _w(ap["lora_b"], dev), fp8)
    gate, up = gate_up.chunk(2, dim=-1)
    h = _mm(F.gelu(gate) * up, _w(mlp["down"], dev), fp8)
    return _mm(h, _w(ap["linear"], dev), fp8)


def _causal_conv_silu(x, w, b):
    """x (S, C), w (K, C), b (C,): the depthwise causal conv then SiLU."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xp[i : i + x.shape[0]] * w[i] for i in range(k)) + b
    return F.silu(y)


def _segsum(a):
    """a (..., L) -> (..., L, L): sum of a over (j, i] below the diagonal, -inf above."""
    L = a.shape[-1]
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    return out.masked_fill(~torch.ones((L, L), dtype=torch.bool, device=a.device).tril(), float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan of one sequence: x (S, H, P), dt (S, H), A (H,), B and C
    (S, H, N), each head its own B and C -> y (S, H, P), float32.  The
    sequence is padded to whole chunks with dt = 0 (no decay, no input)."""
    s, h, p = x.shape
    pad = -s % chunk
    x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (x, dt, B, C))
    c = x.shape[0] // chunk
    xc = (x * dt[..., None]).reshape(c, chunk, h, p)
    Bc, Cc = B.reshape(c, chunk, h, -1), C.reshape(c, chunk, h, -1)
    a = (dt * A).reshape(c, chunk, h).permute(2, 0, 1)  # (H, c, L)
    cs = torch.cumsum(a, -1)
    L = torch.exp(_segsum(a))  # (H, c, L, L)
    y_diag = torch.einsum("clhn,cshn,hcls,cshp->clhp", Cc, Bc, L, xc)
    decay = torch.exp(cs[..., -1:] - cs)  # (H, c, L)
    states = torch.einsum("clhn,hcl,clhp->chpn", Bc, decay, xc)
    states = torch.cat([torch.zeros_like(states[:1]), states], 0)  # the state before chunk 0, then each chunk's own
    carry = torch.exp(_segsum(F.pad(cs[..., -1], (1, 0))))  # (H, c+1, c+1)
    before = torch.einsum("hzc,chpn->zhpn", carry, states)[:-1]  # the state before each chunk
    y_off = torch.einsum("clhn,chpn,hcl->clhp", Cc, before, torch.exp(cs))
    return (y_diag + y_off).reshape(c * chunk, h, p)[:s]


def _mamba(mp, h, conf, fp8: bool):
    dev = h.device
    d_in = conf["mamba_expand"] * conf["hidden_size"]
    nh, hp, n, g = conf["n_mamba_heads"], conf["mamba_headdim"], conf["mamba_d_state"], conf["mamba_ngroups"]
    s = h.shape[0]
    z, xs, Bm, Cm, dt = (_mm(h, _w(mp[k], dev), fp8) for k in ("wz", "wx", "wB", "wC", "wdt"))
    f32 = {"device": dev, "dtype": torch.float32}
    bias = (lambda name, c: mp[name].to(**f32)) if conf["use_conv_bias"] else (lambda name, c: torch.zeros(c, **f32))
    xs = _causal_conv_silu(xs, mp["conv_x"].to(**f32), bias("conv_x_b", d_in))
    Bm = _causal_conv_silu(Bm, mp["conv_B"].to(**f32), bias("conv_B_b", g * n))
    Cm = _causal_conv_silu(Cm, mp["conv_C"].to(**f32), bias("conv_C_b", g * n))
    dt = F.softplus(dt + mp["dt_bias"].to(**f32))
    A = -torch.exp(mp["A_log"].to(**f32))
    heads = lambda t: t.reshape(s, g, n).repeat_interleave(nh // g, dim=1)  # noqa: E731 - each head's group
    xh = xs.reshape(s, nh, hp)
    y = ssd(xh, dt, A, heads(Bm), heads(Cm), conf["chunk_size"]) + mp["D"].to(**f32)[:, None] * xh
    y = y.reshape(s, d_in) * F.silu(z)
    yg = y.reshape(s, g, d_in // g)
    y = (yg * torch.rsqrt(yg.square().mean(-1, keepdim=True) + 1e-5)).reshape(s, d_in)
    y = y * mp["norm"]["scale"].to(**f32)
    return _mm(y, _w(mp["out"], dev), fp8)


def forward(params, tokens, conf: dict, fp8: bool = False, device=None):
    """tokens (S,) int -> logits (S, vocab_size) float32 on ``device``
    (default: the tokens')."""
    _no_tf32()
    dev = torch.device(device) if device is not None else tokens.device
    eps = conf["rms_norm_eps"]
    table = params["embed"]["table"]
    x = table[tokens.to(table.device)].to(device=dev, dtype=torch.float32)
    emb = x
    apps = {li: j for j, li in enumerate(conf["hybrid_layer_ids"])}
    for li, lp in enumerate(params["layers"]):
        inp = x
        if li in apps:
            j = apps[li]
            inp = x + _shared_block(params["mem_blocks"][j % conf["num_mem_blocks"]], params["hybrid"][j], x, emb,
                                    conf, fp8)
        x = x + _mamba(lp["mamba"], _rms(inp, lp["ln"]["scale"], eps), conf, fp8)
    x = _rms(x, params["final_norm"]["scale"], eps)
    head = table[: conf["vocab_size"]].to(device=dev, dtype=torch.float32)
    return _mm(x, head.t(), fp8)


def logprobs(params, tokens, conf: dict, fp8: bool = False, device=None):
    """log p(token_t | tokens_<t) for t = 1 .. S-1, float32 (S - 1,)."""
    logits = forward(params, tokens, conf, fp8, device)
    lp = torch.log_softmax(logits[:-1], dim=-1)
    return lp.gather(-1, tokens[1:].to(lp.device, torch.long)[:, None])[:, 0]
