"""Decoder-only LM for the ``attn`` (dense or MoE), ``zamba2``, ``xlstm``
and ``hybrid_moe`` block patterns — the port of ``repro.models.lm``
(``hybrid_moe`` is the port's own).

    spec(cfg)                                      -> the parameters' spec tree
    init(cfg, generator, device)                   -> params
    forward(params, tokens, cfg)                   -> (logits, aux)
    loss_fn(params, batch, cfg)                    -> (loss, {ce, aux})
    prefill(params, tokens, cfg, max_seq)          -> (last_logits, cache)
    decode_step(params, token, cache, cfg)         -> (logits, cache)
    make_decode_cache(cfg, batch, max_seq, dtype, device)

Each entry point takes ``kernels``, the bundle of the kernel functions the
blocks call (``kernels.ops.KERNELS``, or ``PLAIN`` to hold the kernels
against their plain versions on the card): attention runs
``flash_attention`` / ``decode_attention``, Mamba2 ``causal_conv_silu``,
``ssd_scan`` and ``gated_rmsnorm``, mLSTM ``causal_conv_silu`` and
``mlstm_chunk``, sLSTM ``causal_conv_silu``.  In a MoE configuration every
``moe_every``-th ``attn`` layer takes ``models.moe`` in place of its MLP;
``forward`` returns the sum of those layers' load-balancing losses as
``aux`` (0.0 without MoE layers).

Declarations: ``spec(cfg)`` declares every parameter once
(``layers.Spec``: shape, dtype, logical axes, initial value) and
``decode_cache_spec`` every cache tensor.  ``init`` and ``param_axes``
read the one, ``make_decode_cache`` and ``decode_cache_axes`` the other
(the reference's axes, with the KV cache's T and KV labels swapped for
the port's layout), so the branch on the block pattern for the tensor
layout is written once.

Sharding: the activations are constrained at the reference's sites
(``distributed.sharding.constrain``: its input itself outside a mesh), and
with ``cfg.zero3_gather`` each ``attn`` block re-lays its weights out
TP-only at use (``_gather_weights``), the reference's ZeRO-3
unshard-at-use.

Training: ``loss_fn`` is the mean token cross-entropy (``cross_entropy``,
``cfg.loss_impl`` ``logp`` or ``lse``) plus ``router_aux_weight`` times
``aux`` under MoE.  With ``cfg.remat`` and grad mode on, ``forward``
recomputes in the backward what the reference's ``jax.checkpoint`` does
(``torch.utils.checkpoint``, non-reentrant): each ``attn`` block and each
zamba2 Mamba2 block, not zamba2's shared block nor any xlstm block;
``remat_policy="dots"`` keeps the matrix products' outputs
(``mm``/``bmm``/``addmm``) and recomputes the rest.  A recomputed block
launches its kernels again.  The kernels' gradients are their plain
versions' (``kernels.grad``).

zamba2 has two layouts.  The reference's (zamba2-1.2b): one shared
attention + MLP block over the stream, with residuals, after every
``attn_every``-th Mamba block.  The published one (zamba2-7b), chosen by a
non-empty ``cfg.hybrid_layer_ids``: before each Mamba layer listed,
shared block ``j % n_mem_blocks`` of application j reads
concat(stream, embedding output) (RMSNorm over 2·d_model, attention at
``cfg.attn_scale``, o_proj to d_model, RMSNorm, a GLU MLP whose gate_up
adds the application's own LoRA), with no residual inside; its output
goes through the application's own d_model² ``linear`` and is added to
that Mamba layer's *input* (before its norm), not to the stream.  Its
parameters: ``mem_blocks`` (the shared blocks) and ``hybrid`` (per
application: ``lora_a``, ``lora_b``, ``linear``).

``hybrid_moe`` (granitemoehybrid, granite-4.0-h-small) has no reference
counterpart: each layer is RMSNorm → its mixer (Mamba2 or attention, as
``cfg.layer_types`` says) → the branch times ``cfg.residual_multiplier``
added to the stream → RMSNorm → the MoE (``models.moe``, the config's
dispatch) plus the shared MLP → the same multiplier and residual.  The
embedding is multiplied by ``cfg.embedding_multiplier`` and the logits
divided by ``cfg.logits_scaling``; attention has no position embedding
and scales its scores by ``cfg.attn_scale``.  One walk
(``_hybrid_moe_walk``) serves ``forward``, ``prefill`` and
``decode_step``.

Caches: ``attn`` {k, v (layers, B, KV, T, hd), index}; ``hybrid_moe`` the
same over its attention layers, and ``ssm`` (as zamba2's) over its Mamba2
layers; ``zamba2`` {ssm:
{ssm, conv_x, conv_B, conv_C} stacked over the Mamba layers, kv: the
shared block's {k, v, index}, one cache layer per application}; ``xlstm``
{xlstm: one state per layer, index}.  Tensors of the ``attn`` and
``zamba2`` caches are updated in place.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import device as device_mod
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (
    ACT,
    Dtypes,
    axes_of,
    dense_spec,
    embed_tokens,
    embedding_spec,
    logits_apply,
    materialize,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
)

__all__ = [
    "check_supported",
    "cross_entropy",
    "decode_cache_axes",
    "decode_cache_spec",
    "decode_step",
    "forward",
    "init",
    "loss_fn",
    "make_decode_cache",
    "param_axes",
    "prefill",
    "spec",
]

ACT_AXES = ("act_batch", None, None)
LOGIT_AXES = ("act_batch", None, "act_vocab")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a configuration this module does not build:
    an encoder-decoder (``models.encdec``) or an unknown block pattern."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: build it with models.encdec")
    if cfg.block_pattern not in ("attn", "zamba2", "xlstm", "hybrid_moe"):
        raise ValueError(f"unknown block pattern {cfg.block_pattern}")


def _is_moe_layer(cfg, li: int) -> bool:
    return cfg.moe is not None and (li + 1) % cfg.moe.moe_every == 0


def _is_mamba(cfg, li: int) -> bool:
    """``hybrid_moe``: layer li mixes with Mamba2 (else with attention)."""
    return cfg.layer_types[li] == "mamba"


def _published_zamba2(cfg) -> bool:
    """zamba2's published layout (``hybrid_layer_ids``), not the reference's."""
    return cfg.block_pattern == "zamba2" and bool(cfg.hybrid_layer_ids)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def weights_device(generator: torch.Generator, device=None) -> torch.device:
    """``device`` resolved (the card unless the caller asks for the CPU);
    raises ``ValueError`` unless it is the generator's device."""
    dev = device_mod.resolve(device)
    if dev.type == "meta":
        raise ValueError("unsupported device 'meta' for weights: they are drawn on cuda or cpu")
    if generator.device.type != dev.type or (dev.index is not None and (generator.device.index or 0) != dev.index):
        raise ValueError(f"generator is on {generator.device}, weights asked for on {dev}")
    return dev


def spec(cfg) -> dict:
    """The spec tree of the parameters: every tensor's shape, dtype, the
    reference's logical axes and initial value, declared once."""
    check_supported(cfg)
    dt = Dtypes.from_cfg(cfg).param
    d = cfg.d_model

    def ln(width=d):
        return norm_spec(width, cfg.norm, dt)

    tree: dict = {"embed": embedding_spec(cfg.padded_vocab, d, dt)}
    if not cfg.tie_embeddings:
        tree["embed_out"] = embedding_spec(cfg.padded_vocab, d, dt)
    tree["final_norm"] = ln()
    layers = []
    for li in range(cfg.n_layers):
        if cfg.block_pattern == "attn":
            lp = {"ln1": ln(), "attn": attn.attn_spec(cfg, dt), "ln2": ln()}
            if _is_moe_layer(cfg, li):
                lp["moe"] = moe_mod.moe_spec(cfg, dt)
            else:
                lp["mlp"] = mlp_spec(d, cfg.d_ff, cfg.glu, dt, bias=cfg.mlp_bias)
            layers.append(lp)
        elif cfg.block_pattern == "zamba2":
            layers.append({"ln": ln(), "mamba": ssm_mod.mamba_spec(cfg, dt)})
        elif cfg.block_pattern == "hybrid_moe":
            mixer = {"mamba": ssm_mod.mamba_spec(cfg, dt)} if _is_mamba(cfg, li) else {"attn": attn.attn_spec(cfg, dt)}
            layers.append({"ln1": ln(), **mixer, "ln2": ln(), "moe": moe_mod.moe_spec(cfg, dt)})
        elif xl.is_slstm(cfg, li):
            layers.append({"ln": ln(), "slstm": xl.slstm_spec(cfg, dt)})
        else:
            layers.append({"ln": ln(), "mlstm": xl.mlstm_spec(cfg, dt)})
    tree["layers"] = layers
    f, r = cfg.d_ff, cfg.adapter_rank
    if _published_zamba2(cfg):  # the shared blocks, then each application's own weights
        tree["mem_blocks"] = [
            {"ln_a": ln(cfg.attn_in_dim), "attn": attn.attn_spec(cfg, dt), "ln_m": ln(),
             "mlp": {"gate_up": dense_spec((d, 2 * f), ("embed", "ffn"), dt),
                     "down": dense_spec((f, d), ("ffn", "embed"), dt, scale=f**-0.5)}}
            for _ in range(cfg.n_mem_blocks)
        ]
        tree["hybrid"] = [
            {"lora_a": dense_spec((d, r), ("embed", None), dt),
             "lora_b": dense_spec((r, 2 * f), (None, "ffn"), dt),
             "linear": dense_spec((d, d), ("embed", None), dt)}
            for _ in cfg.hybrid_layer_ids
        ]
    elif cfg.block_pattern == "zamba2":
        tree["shared_attn"] = {"ln_a": ln(), "attn": attn.attn_spec(cfg, dt), "ln_m": ln(),
                               "mlp": mlp_spec(d, f, cfg.glu, dt)}
    return tree


def init(cfg, generator: torch.Generator, device=None) -> dict:
    """Random weights with the reference's shapes, names and standard
    deviations, drawn from ``generator`` on ``device`` (which must be the
    generator's device)."""
    return materialize(spec(cfg), weights_device(generator, device), generator)


def param_axes(cfg) -> dict:
    """The logical-axes tree of ``init(cfg, ...)``'s parameters, leaf for
    leaf the reference's ``init`` axes."""
    return axes_of(spec(cfg))


def _gather_weights(tree, axes_tree):
    """Explicit ZeRO-3 unshard-at-use: every DTensor weight of ``tree``
    redistributed to its TP-only layout ('model' axes kept, 'data' / 'pod'
    dropped), so each use all-gathers a weight instead of reducing
    activation-sized partial sums over the FSDP axis.  ``tree`` itself
    outside a mesh."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return tree
    tp_rules = {}
    for k, v in sharding.DEFAULT_RULES.items():
        axes = (v,) if isinstance(v, str) else tuple(v)
        tp_rules[k] = tuple(a for a in axes if a == "model")

    def one(ax, p):
        if ax is None or not hasattr(p, "placements"):
            return p
        placements = sharding.placements_for(sharding.pspec_for(ax, p.shape, mesh, tp_rules), mesh)
        return p if tuple(p.placements) == placements else p.redistribute(p.device_mesh, placements)

    return sharding.map_with_axes(one, axes_tree, tree)


def _maybe_gather(cfg, subtree, axes_subtree):
    if not cfg.zero3_gather or axes_subtree is None:
        return subtree
    return _gather_weights(subtree, axes_subtree)


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------
def _ffn(lp, x, cfg, kernels) -> tuple:
    """The layer's MLP or MoE FFN on x (already normed): (y, aux)."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], x, cfg, cfg.act, kernels)
    return mlp_apply(lp["mlp"], x, cfg.act, cfg.glu), 0.0


def _block(lp, x, cfg, kernels, layer_cache=None, lp_axes=None) -> tuple:
    lp = _maybe_gather(cfg, lp, lp_axes)
    h = norm_apply(lp["ln1"], x, cfg.norm, kernels=kernels)
    x = x + attn.attn_apply(lp["attn"], h, cfg, layer_cache=layer_cache, kernels=kernels)
    x = constrain(x, ACT_AXES)
    y, aux = _ffn(lp, norm_apply(lp["ln2"], x, cfg.norm, kernels=kernels), cfg, kernels)
    return constrain(x + y, ACT_AXES), aux


def _mamba_block(lp, x, cfg, kernels, return_state: bool = False):
    """One zamba2 layer's Mamba2 block on x: its residual branch."""
    h = norm_apply(lp["ln"], x, cfg.norm, kernels=kernels)
    return ssm_mod.mamba_apply(lp["mamba"], h, cfg, return_state, kernels)


def _shared_block(sp, x, cfg, kernels, layer_cache=None):
    """zamba2's shared attention + MLP block, after every ``attn_every``-th
    Mamba block; its weights are shared by every application."""
    h = norm_apply(sp["ln_a"], x, cfg.norm, kernels=kernels)
    x = constrain(x + attn.attn_apply(sp["attn"], h, cfg, layer_cache=layer_cache, kernels=kernels), ACT_AXES)
    h = norm_apply(sp["ln_m"], x, cfg.norm, kernels=kernels)
    return constrain(x + mlp_apply(sp["mlp"], h, cfg.act, cfg.glu), ACT_AXES)


def _mem_block(params, j: int, x, emb, cfg, kernels, layer_cache=None, index=None):
    """Application j of zamba2's published shared blocks on the stream x
    and the embedding output emb: what it adds to the next Mamba layer's
    input.  ``index`` set: one decode step at that position, its k and v
    written into ``layer_cache`` (k, v)."""
    bp, ap = params["mem_blocks"][j % cfg.n_mem_blocks], params["hybrid"][j]
    h = norm_apply(bp["ln_a"], torch.cat([x, emb], dim=-1), cfg.norm, cfg.norm_eps, kernels=kernels)
    if index is None:
        h = attn.attn_apply(bp["attn"], h, cfg, layer_cache=layer_cache, kernels=kernels)
    else:
        h = attn.attn_decode(bp["attn"], h, cfg, *layer_cache, index, kernels)[0]
    h = norm_apply(bp["ln_m"], h, cfg.norm, cfg.norm_eps, kernels=kernels)
    mlp = bp["mlp"]
    gate_up = h @ mlp["gate_up"]["w"].to(h.dtype) + (h @ ap["lora_a"]["w"].to(h.dtype)) @ ap["lora_b"]["w"].to(h.dtype)
    gate, up = gate_up.chunk(2, dim=-1)
    h = (ACT[cfg.act](gate) * up) @ mlp["down"]["w"].to(h.dtype)
    return h @ ap["linear"]["w"].to(h.dtype)


def _published_body(params, x, cfg, kernels, cache=None):
    """zamba2's published layout over the whole sequence; with ``cache``
    the layers write their decode state into it."""
    emb = x
    apps = {li: j for j, li in enumerate(cfg.hybrid_layer_ids)}
    for li, lp in enumerate(params["layers"]):
        inp = x
        if li in apps:
            j = apps[li]
            layer_cache = None if cache is None else (cache["kv"]["k"][j], cache["kv"]["v"][j])
            inp = x + _mem_block(params, j, x, emb, cfg, kernels, layer_cache)
        h = norm_apply(lp["ln"], inp, cfg.norm, cfg.norm_eps, kernels=kernels)
        if cache is None:
            mamba = functools.partial(ssm_mod.mamba_apply, lp["mamba"], cfg=cfg, kernels=kernels)
            y = _remat_wrap(cfg, mamba)(h)
        else:
            y, st = ssm_mod.mamba_apply(lp["mamba"], h, cfg, True, kernels)
            for name, t in st.items():
                cache["ssm"][name][li].copy_(t)
        x = constrain(x + y, ACT_AXES)
    return x


def _published_decode(params, x, cache, cfg, kernels):
    """One decode step of zamba2's published layout at the cache's index."""
    emb = x
    kv = cache["kv"]
    idx = int(kv["index"])
    apps = {li: j for j, li in enumerate(cfg.hybrid_layer_ids)}
    for li, lp in enumerate(params["layers"]):
        inp = x
        if li in apps:
            j = apps[li]
            inp = x + _mem_block(params, j, x, emb, cfg, kernels, (kv["k"][j], kv["v"][j]), idx)
        layer = {name: t[li] for name, t in cache["ssm"].items()}
        h = norm_apply(lp["ln"], inp, cfg.norm, cfg.norm_eps, kernels=kernels)
        y, st = ssm_mod.mamba_decode(lp["mamba"], h, cfg, layer, kernels)
        for name, t in st.items():
            layer[name].copy_(t)
        x = x + y
    return x, {"ssm": cache["ssm"], "kv": {"k": kv["k"], "v": kv["v"], "index": idx + 1}}


def _hybrid_moe_layer(lp, x, cfg, kernels, state=None, index=None):
    """One ``hybrid_moe`` layer on the stream x: (x, the MoE's aux loss).
    ``state``: the layer's decode state (a Mamba2 layer's {ssm, conv_x,
    conv_B, conv_C}, an attention layer's (k, v)), which prefill writes and
    a decode step at position ``index`` reads and writes."""
    h = norm_apply(lp["ln1"], x, cfg.norm, cfg.norm_eps, kernels=kernels)
    if "mamba" in lp:
        if state is None:
            y = ssm_mod.mamba_apply(lp["mamba"], h, cfg, kernels=kernels)
        else:
            if index is None:
                y, st = ssm_mod.mamba_apply(lp["mamba"], h, cfg, True, kernels)
            else:
                y, st = ssm_mod.mamba_decode(lp["mamba"], h, cfg, state, kernels)
            for name, t in st.items():
                state[name].copy_(t)
    elif index is None:
        y = attn.attn_apply(lp["attn"], h, cfg, layer_cache=state, kernels=kernels)
    else:
        y = attn.attn_decode(lp["attn"], h, cfg, *state, index, kernels)[0]
    x = constrain(x + y * cfg.residual_multiplier, ACT_AXES)
    h = norm_apply(lp["ln2"], x, cfg.norm, cfg.norm_eps, kernels=kernels)
    y, aux = moe_mod.moe_apply(lp["moe"], h, cfg, cfg.act, kernels)
    return constrain(x + y * cfg.residual_multiplier, ACT_AXES), aux


def _hybrid_moe_walk(params, x, cfg, kernels, cache=None, index=None) -> tuple:
    """Every ``hybrid_moe`` layer once, from the embedding's output x:
    (x, the summed aux loss).  Over the whole sequence with ``index``
    None (``cache``: a fresh decode cache the layers fill), or one decode
    step at position ``index`` through ``cache``."""
    x = x * cfg.embedding_multiplier
    aux_total, mi, ai = 0.0, 0, 0
    for li, lp in enumerate(params["layers"]):
        state = None
        if cache is not None and "mamba" in lp:
            state = {name: t[mi] for name, t in cache["ssm"].items()}
        elif cache is not None:
            state = (cache["k"][ai], cache["v"][ai])
        mi, ai = mi + ("mamba" in lp), ai + ("attn" in lp)
        layer = functools.partial(_hybrid_moe_layer, lp, cfg=cfg, kernels=kernels, state=state, index=index)
        x, aux = (layer if cache is not None else _remat_wrap(cfg, layer))(x)
        aux_total = aux_total + aux
    return x, aux_total


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the matrix products' outputs, recompute
    the rest (the reference's ``checkpoint_dots``)."""
    return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg, fn):
    """``fn`` recomputed in the backward when ``cfg.remat`` and grad mode
    is on, else ``fn`` itself.  The model draws no random numbers, so no RNG
    state is kept for the recomputation."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_products)
    return functools.partial(checkpoint, fn, **kwargs)


def _head(params, x, cfg, kernels):
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps, kernels=kernels)
    emb = params["embed_out"] if not cfg.tie_embeddings else params["embed"]
    logits = logits_apply(emb, x, cfg.vocab_size)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return constrain(logits, LOGIT_AXES)


def _body(params, x, cfg, kernels, cache=None) -> tuple:
    """Every layer over the whole sequence: (x, the summed MoE aux loss).
    With ``cache`` (a fresh decode cache) the layers write their decode
    state into it."""
    aux_total = 0.0
    x = constrain(x, ACT_AXES)
    if cfg.block_pattern == "attn":
        gather_axes = param_axes(cfg)["layers"] if cfg.zero3_gather else [None] * cfg.n_layers
        for li, lp in enumerate(params["layers"]):
            if cache is None:
                block = functools.partial(_block, lp, cfg=cfg, kernels=kernels, lp_axes=gather_axes[li])
                x, aux = _remat_wrap(cfg, block)(x)
            else:
                x, aux = _block(lp, x, cfg, kernels, (cache["k"][li], cache["v"][li]), gather_axes[li])
            aux_total = aux_total + aux
    elif cfg.block_pattern == "hybrid_moe":
        x, aux_total = _hybrid_moe_walk(params, x, cfg, kernels, cache)
    elif _published_zamba2(cfg):
        x = _published_body(params, x, cfg, kernels, cache)
    elif cfg.block_pattern == "zamba2":
        ai = 0
        for li, lp in enumerate(params["layers"]):
            if cache is None:
                y = _remat_wrap(cfg, functools.partial(_mamba_block, lp, cfg=cfg, kernels=kernels))(x)
            else:
                y, st = _mamba_block(lp, x, cfg, kernels, return_state=True)
                for name, t in st.items():
                    cache["ssm"][name][li].copy_(t)
            x = constrain(x + y, ACT_AXES)
            if (li + 1) % cfg.attn_every == 0:
                layer_cache = None if cache is None else (cache["kv"]["k"][ai], cache["kv"]["v"][ai])
                x = _shared_block(params["shared_attn"], x, cfg, kernels, layer_cache)
                ai += 1
    else:
        for li, lp in enumerate(params["layers"]):
            h = norm_apply(lp["ln"], x, cfg.norm, kernels=kernels)
            if xl.is_slstm(cfg, li):
                y = xl.slstm_apply(lp["slstm"], h, cfg, return_state=cache is not None, kernels=kernels)
            else:
                y = xl.mlstm_apply(lp["mlstm"], h, cfg, return_state=cache is not None, kernels=kernels)
            if cache is not None:
                y, cache["xlstm"][li] = y
            x = constrain(x + y, ACT_AXES)
    return x, aux_total


def forward(params, tokens, cfg, kernels=ops.KERNELS):
    """tokens: (B, S) -> (logits (B, S, V), aux_losses)."""
    check_supported(cfg)
    x, aux = _body(params, embed_tokens(params["embed"], tokens, Dtypes.from_cfg(cfg).act), cfg, kernels)
    return _head(params, x, cfg, kernels), aux


def cross_entropy(logits, labels, impl: str = "logp"):
    """Mean token cross-entropy in float32.  ``logp`` materialises the
    log-softmax; ``lse`` is logsumexp(z) minus the label's logit."""
    labels = labels[..., None].long()
    z32 = logits.float()
    if impl == "lse":
        return (torch.logsumexp(z32, dim=-1) - torch.gather(z32, -1, labels)[..., 0]).mean()
    return -torch.gather(torch.log_softmax(z32, dim=-1), -1, labels)[..., 0].mean()


def loss_fn(params, batch, cfg, kernels=ops.KERNELS):
    """batch {tokens, labels (B, S)} -> (loss, {ce, aux}), float32 0-d
    tensors; the loss adds ``router_aux_weight`` times the MoE layers'
    load-balancing loss."""
    logits, aux = forward(params, batch["tokens"], cfg, kernels)
    ce = cross_entropy(logits, batch["labels"], cfg.loss_impl)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + cfg.moe.router_aux_weight * aux if cfg.moe is not None else ce
    return loss, {"ce": ce, "aux": aux}


def decode_cache_spec(cfg, batch: int, max_seq: int, dtype, long_context: bool = False) -> dict:
    """The spec tree of the decode cache; a long context shards the KV
    cache's T over ``cache_seq_long``."""
    check_supported(cfg)
    if cfg.block_pattern == "attn":
        return attn.kv_cache_spec(cfg, batch, max_seq, cfg.n_layers, dtype, long_context)
    if cfg.block_pattern == "hybrid_moe":
        n_mamba = sum(t == "mamba" for t in cfg.layer_types)
        return dict(attn.kv_cache_spec(cfg, batch, max_seq, cfg.n_layers - n_mamba, dtype, long_context),
                    ssm=ssm_mod.ssm_cache_spec(cfg, batch, n_mamba, dtype))
    if cfg.block_pattern == "zamba2":
        apps = len(cfg.hybrid_layer_ids) if cfg.hybrid_layer_ids else cfg.n_layers // cfg.attn_every
        return {
            "ssm": ssm_mod.ssm_cache_spec(cfg, batch, cfg.n_layers, dtype),
            "kv": attn.kv_cache_spec(cfg, batch, max_seq, apps, dtype, long_context),
        }
    return {"xlstm": xl.xlstm_cache_spec(cfg, batch, dtype), "index": 0}


def make_decode_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    return materialize(decode_cache_spec(cfg, batch, max_seq, dtype), device_mod.resolve(device))


def decode_cache_axes(cfg, long_context: bool = False):
    """The logical axes of ``make_decode_cache``'s tree (they depend on no
    size)."""
    return axes_of(decode_cache_spec(cfg, 1, 1, torch.float32, long_context))


def prefill(params, tokens, cfg, max_seq: int, kernels=ops.KERNELS):
    """Run the whole prompt, build the decode cache, return the last
    position's logits (B, 1, V).  Only the last position goes through the
    output head: each position's logits depend on that position alone."""
    check_supported(cfg)
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq {max_seq}")
    dt = Dtypes.from_cfg(cfg)
    cache = sharding.shard_tree(make_decode_cache(cfg, b, max_seq, dt.act, tokens.device), decode_cache_axes(cfg))
    x, _ = _body(params, embed_tokens(params["embed"], tokens, dt.act), cfg, kernels, cache)
    if cfg.block_pattern == "zamba2":
        cache["kv"]["index"] = s
    else:
        cache["index"] = s
    return _head(params, x[:, -1:], cfg, kernels), cache


def decode_step(params, token, cache, cfg, kernels=ops.KERNELS):
    """token: (B, 1) int.  Returns (logits (B, 1, V), the cache one position
    on); the ``attn`` and ``zamba2`` caches' tensors are updated in place."""
    check_supported(cfg)
    # not a reference site: on a mesh the vocab-sharded lookup's partial sums
    # must reduce before the first norm, which DTensor cannot do in place
    x = constrain(embed_tokens(params["embed"], token, Dtypes.from_cfg(cfg).act), ACT_AXES)
    if cfg.block_pattern == "attn":
        idx = int(cache["index"])
        for li, lp in enumerate(params["layers"]):
            h = norm_apply(lp["ln1"], x, cfg.norm, kernels=kernels)
            h, _, _ = attn.attn_decode(lp["attn"], h, cfg, cache["k"][li], cache["v"][li], idx, kernels)
            x = x + h
            x = x + _ffn(lp, norm_apply(lp["ln2"], x, cfg.norm, kernels=kernels), cfg, kernels)[0]
        cache = {"k": cache["k"], "v": cache["v"], "index": idx + 1}
    elif cfg.block_pattern == "hybrid_moe":
        idx = int(cache["index"])
        x, _ = _hybrid_moe_walk(params, x, cfg, kernels, cache, idx)
        cache = dict(cache, index=idx + 1)
    elif _published_zamba2(cfg):
        x, cache = _published_decode(params, x, cache, cfg, kernels)
    elif cfg.block_pattern == "zamba2":
        sp = params["shared_attn"]
        kv = cache["kv"]
        idx = int(kv["index"])
        ai = 0
        for li, lp in enumerate(params["layers"]):
            layer = {name: t[li] for name, t in cache["ssm"].items()}
            h = norm_apply(lp["ln"], x, cfg.norm, kernels=kernels)
            y, st = ssm_mod.mamba_decode(lp["mamba"], h, cfg, layer, kernels)
            for name, t in st.items():
                layer[name].copy_(t)
            x = x + y
            if (li + 1) % cfg.attn_every == 0:
                h = norm_apply(sp["ln_a"], x, cfg.norm, kernels=kernels)
                h, _, _ = attn.attn_decode(sp["attn"], h, cfg, kv["k"][ai], kv["v"][ai], idx, kernels)
                x = x + h
                x = x + mlp_apply(sp["mlp"], norm_apply(sp["ln_m"], x, cfg.norm, kernels=kernels), cfg.act, cfg.glu)
                ai += 1
        cache = {"ssm": cache["ssm"], "kv": {"k": kv["k"], "v": kv["v"], "index": idx + 1}}
    else:
        states = []
        for li, lp in enumerate(params["layers"]):
            h = norm_apply(lp["ln"], x, cfg.norm, kernels=kernels)
            if xl.is_slstm(cfg, li):
                y, st = xl.slstm_decode(lp["slstm"], h, cfg, cache["xlstm"][li], kernels)
            else:
                y, st = xl.mlstm_decode(lp["mlstm"], h, cfg, cache["xlstm"][li], kernels)
            states.append(st)
            x = x + y
        cache = {"xlstm": states, "index": int(cache["index"]) + 1}
    return _head(params, x, cfg, kernels), cache
