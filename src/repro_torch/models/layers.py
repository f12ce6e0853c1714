"""Model substrate of the port: the reference's layers on torch tensors
(the port of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's names and
shapes — ``wq["w"]`` is (d, h, hd), ``embed["table"]`` is (V, d) — so the
reference's weights carry over by name (``models.convert``).  Each tensor
is declared once, as a ``Spec`` (shape, dtype, the reference's logical
sharding axes, and how its value starts), in a block's spec tree
(``dense_spec``, ``norm_spec``, ``embedding_spec``, ``mlp_spec`` here, the
others beside their blocks).  Three readers walk a spec tree:
``materialize`` makes the tensors, ``axes_of`` the logical-axes tree
(``repro_torch.distributed.sharding`` maps it onto a mesh) and ``meta_of``
empty meta tensors of each shape (the dry-run's).  Weights are drawn from
an explicit ``torch.Generator`` with the reference's standard deviations
(its ``jax.random`` bits cannot be reproduced, so tests convert weights).

The reference's ``causal_conv_silu`` (the depthwise causal conv and SiLU at
the front of the Mamba2 and xLSTM blocks) is a kernel in the port:
``kernels.causal_conv``, whose ``causal_conv_silu_plain`` keeps the
expressions that stood here; so is ``norm_apply``'s RMSNorm
(``kernels.rms_norm``, ``rms_norm_plain``).  The blocks call them through
their kernel bundle: the CUDA kernel on card tensors, the plain version on
CPU and meta tensors and wherever a caller passes ``kernels.ops.PLAIN``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import axis_divides, constrain, current_mesh, layout_grad, sharding_for
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

__all__ = [
    "ACT",
    "Dtypes",
    "Spec",
    "apply_rope",
    "axes_of",
    "dense_apply",
    "dense_spec",
    "embed_tokens",
    "embedding_spec",
    "flat_rows",
    "flat_weight",
    "logits_apply",
    "materialize",
    "merge_heads",
    "meta_of",
    "mlp_apply",
    "mlp_spec",
    "norm_apply",
    "norm_spec",
    "normal",
    "rope_freqs",
    "softplus",
    "split_heads",
    "torch_dtype",
    "unflatten_rows",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` / ``param_dtype`` string."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class Dtypes:
    param: torch.dtype
    act: torch.dtype

    @staticmethod
    def from_cfg(cfg) -> "Dtypes":
        return Dtypes(param=torch_dtype(cfg.param_dtype), act=torch_dtype(cfg.dtype))


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,  # erf's GELU (transformers' "gelu")
    "relu": F.relu,
}


def normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then cast."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * std).to(dtype)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One tensor's declaration.  Its value starts as N(0, ``std``²)
    (``normal``) when ``std`` is set, else full of ``fill``, or ``fill(device)``
    when that is a function."""

    shape: tuple
    dtype: torch.dtype
    axes: tuple
    std: float | None = None
    fill: float | Callable = 0.0


def materialize(tree, device, generator: torch.Generator | None = None):
    """The tensors of a spec tree on ``device``, the ``normal`` leaves drawn
    from ``generator`` (on its own device) depth-first in the tree's order;
    other leaves (a cache's int index) as they are."""

    def one(s):
        if not isinstance(s, Spec):
            return s
        if s.std is not None:
            return normal(generator, s.shape, s.std, s.dtype)
        if callable(s.fill):
            return s.fill(device)
        return torch.full(s.shape, s.fill, dtype=s.dtype, device=device)

    return tree_map(one, tree)


def axes_of(tree):
    """The logical-axes tree of a spec tree; an int leaf's axes are ()."""
    return tree_map(lambda s: s.axes if isinstance(s, Spec) else (), tree)


def meta_of(tree):
    """Empty meta-device tensors of a spec tree's shapes and dtypes (nothing
    is allocated); other leaves as they are."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta") if isinstance(s, Spec) else s, tree)


def softplus(x):
    """``jax.nn.softplus``'s form, log1p(exp(-|x|)) + max(x, 0), exact for
    every x (``F.softplus`` returns x itself above a threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------
def dense_spec(shape, axes, dtype, bias_axis=None, scale=None) -> dict:
    """General dense weight: ``shape``/``axes`` are aligned tuples; the axes
    named "embed" make the fan-in, as in the reference."""
    fan_in = int(np.prod([s for s, a in zip(shape, axes) if a == "embed"])) or shape[0]
    std = scale if scale is not None else fan_in**-0.5
    spec = {"w": Spec(tuple(shape), dtype, tuple(axes), std=std)}
    if bias_axis is not None:
        out = [(s, a) for s, a in zip(shape, axes) if a in bias_axis]
        spec["b"] = Spec(tuple(s for s, _ in out), dtype, tuple(a for _, a in out))
    return spec


class _FlatWeight(torch.autograd.Function):
    """A DTensor weight viewed as 2-D, whose gradient is laid out whole
    along the flat dim before it is viewed back (DTensor cannot split a
    sharded dim over a head count its mesh axis does not divide)."""

    @staticmethod
    def forward(ctx, w, shape):
        ctx.w_shape, ctx.flat = w.shape, shape
        return w.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        split = 1 if ctx.w_shape[0] == ctx.flat[0] else 0  # the flat dim: (d, n·hd) or (n·hd, d)
        placements = [Replicate() if p.is_shard(split) else p for p in g.placements]
        return g.redistribute(g.device_mesh, placements).reshape(ctx.w_shape), None


def flat_weight(w, shape):
    """``w.reshape(shape)``; for a DTensor the gradient is taken back through
    ``_FlatWeight`` so that it can be viewed as ``w`` again."""
    if type(w) is torch.Tensor:
        return w.reshape(shape)
    return _FlatWeight.apply(w, tuple(shape))


def merge_heads(y, n: int):
    """y (..., h, hd) as (..., h·hd).  On a mesh the gradient comes back laid
    out as ``n`` allows, sharded over the heads' mesh axis only when it
    divides n (the head count the gradient is split back over: KV for
    grouped attention), and over the batch axes on the leading dim."""
    flat = y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])
    mesh = current_mesh()
    if mesh is None or type(y) is torch.Tensor:
        return flat
    axes = ("act_batch",) + (None,) * (flat.dim() - 2) + ("act_heads" if axis_divides("act_heads", n) else None,)
    return layout_grad(flat, sharding_for(axes, flat.shape))


def flat_rows(x):
    """x (B, S, D) as (B·S, D).  On a mesh the rows are first laid out over
    the batch axes alone (a sharded dim flattens only as the outer one)."""
    b, s, d = x.shape
    return constrain(x, ("act_batch", None, None)).reshape(b * s, d)


def unflatten_rows(y, b: int, s: int):
    """y (B·S, ...) as (B, S, ...).  On a mesh its gradient comes back laid
    out as the value is, which the backward's flatten can take (DTensor
    may otherwise hand it back sharded over S)."""
    out = y.reshape(b, s, *y.shape[1:])
    if type(out) is torch.Tensor:
        return out
    return layout_grad(out, out.placements)


def split_heads(y, n: int, hd: int):
    """y (..., n·hd) as (..., n, hd).  On a mesh the flat dim is first laid
    out as the head count allows, sharded over the heads' mesh axis only
    when it divides n (a sharded dim splits only over its outer part), and
    the leading dim over the batch axes."""
    if type(y) is not torch.Tensor:  # a DTensor; a plain tensor (the card's path) splits as it is
        lead = ("act_batch",) + (None,) * (y.dim() - 2)
        y = constrain(y, lead + ("act_heads" if axis_divides("act_heads", n) else None,))
    return y.reshape(*y.shape[:-1], n, hd)


def dense_apply(params, x, contract: str):
    """einsum-style apply.  ``contract`` like 'bsd,dh->bsh'."""
    y = torch.einsum(contract, x, params["w"].to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_spec(d: int, kind: str, dtype, axis="embed") -> dict:
    spec = {"scale": Spec((d,), dtype, (axis,), fill=1.0)}
    if kind != "rmsnorm":
        spec["bias"] = Spec((d,), dtype, (axis,))
    return spec


def norm_apply(params, x, kind: str, eps: float = 1e-6, kernels=ops.KERNELS):
    """RMSNorm through ``kernels.rms_norm`` (the model's kernel bundle), or
    layer norm in plain PyTorch."""
    if kind == "rmsnorm":
        return kernels.rms_norm(x, params["scale"], eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------
def embedding_spec(vocab: int, d: int, dtype) -> dict:
    return {"table": Spec((vocab, d), dtype, ("vocab", "embed"), std=d**-0.5)}


def embed_tokens(params, tokens, act_dtype):
    # gather, then cast: the rows the reference takes from the cast table.
    # On a mesh the lookup reads a vocab-whole table (not a reference site):
    # DTensor's vocab-sharded lookup leaves masked partial sums whose
    # gradient it cannot take back
    table = constrain(params["table"], (None, "embed"), site="embed_whole")
    return F.embedding(tokens, table).to(act_dtype)


def logits_apply(emb_params, x, real_vocab: int):
    """Tied (or untied) output head with padded-vocab masking."""
    table = emb_params["table"].to(x.dtype)
    logits = x @ table.t()
    if table.shape[0] != real_vocab:
        logits[..., real_vocab:] = -1e9
    return logits


# ---------------------------------------------------------------------------
# MLP (plain or gated)
# ---------------------------------------------------------------------------
def mlp_spec(d: int, d_ff: int, glu: bool, dtype, bias: bool = False) -> dict:
    spec = {"up": dense_spec((d, d_ff), ("embed", "ffn"), dtype, bias_axis=("ffn",) if bias else None)}
    if glu:
        spec["gate"] = dense_spec((d, d_ff), ("embed", "ffn"), dtype)
    spec["down"] = dense_spec(
        (d_ff, d), ("ffn", "embed"), dtype, bias_axis=("embed",) if bias else None, scale=d_ff**-0.5
    )
    return spec


def mlp_apply(params, x, act: str, glu: bool):
    h = dense_apply(params["up"], x, "bsd,df->bsf")
    if glu:
        g = dense_apply(params["gate"], x, "bsd,df->bsf")
        h = ACT[act](g) * h
    else:
        h = ACT[act](h)
    return dense_apply(params["down"], h, "bsf,fd->bsd")


# ---------------------------------------------------------------------------
# rotary position embedding (partial-rotary supported)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, rotary_frac: float, theta: float, device=None):
    """(inverse frequencies float32 (rot/2,), rot): the first ``rot`` dims of
    each head rotate.  Computed in float64 on ``device`` itself, as the
    reference computes them in numpy: a host array copied to the card would
    make every layer's call wait for the card's queue to drain."""
    rot = int(head_dim * rotary_frac) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float64, device=device) / rot))
    return inv.float(), rot


def apply_rope(x, positions, inv_freq, rot: int):
    """x: (B, S, H, hd); positions: (B, S) or (S,).  cos and sin are taken
    in float32 and cast to x's type, as in the reference."""
    if rot == 0:
        return x
    ang = positions.float()[..., None] * inv_freq  # (B, S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.dim() < x.dim():  # broadcast over the head dim
        cos, sin = cos[..., None, :], sin[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2 :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, xp], dim=-1) if rot < x.shape[-1] else rotated
