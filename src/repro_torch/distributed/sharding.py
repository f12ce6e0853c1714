"""Logical-axis sharding rules with divisibility-aware fallback — the port of
``repro.distributed.sharding`` onto ``DeviceMesh`` and DTensor.

Models name every parameter and activation dim with a *logical* axis (the
``*_axes`` functions of ``repro_torch.models``).  This module maps logical
names to mesh axes and builds DTensor placements.  An axis that does not
evenly divide a dim is dropped (replicated) for that tensor, as in the
reference, so ten heterogeneous architectures all lay out on one
production mesh.

A *partition tuple* is the reference's ``PartitionSpec`` as a plain tuple:
one entry per leading tensor dim, each None, a mesh axis name or a tuple of
names, trailing Nones trimmed.  ``pspec_for`` reads only the mesh's axis
names and sizes, so it plans on a ``DeviceMesh`` and on a plain
``(names, sizes)`` description alike.  ``placements_for`` turns a tuple into
one placement per mesh dim: ``Shard(dim)`` where a tensor dim names that
mesh axis, else ``Replicate()``.  A tensor dim over several mesh axes is
split over them in mesh order (the reference's major-to-minor order when
the rule lists the axes in mesh order, as every default rule does).

The active (mesh, rules) pair is installed with ``use_mesh``; model code
calls ``constrain`` unconditionally.  Outside a mesh it returns its input
after one thread-local read; inside, it redistributes a DTensor to the
rule's placements and lays its gradient out the same way, as
``with_sharding_constraint`` constrains the value and its cotangent.

``cost_site`` names the work a mesh runs at a site that the reference does
not have (a DTensor workaround), so that the dry-run's cost modes
(``roofline.analysis``) can count it apart.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = [
    "DEFAULT_RULES",
    "Rules",
    "axis_divides",
    "constrain",
    "cost_site",
    "current_cost_site",
    "current_mesh",
    "distribute_tree",
    "is_axes_leaf",
    "layout_grad",
    "map_with_axes",
    "mesh_axis_sizes",
    "placements_for",
    "pspec_for",
    "shard_tensor",
    "shard_tree",
    "sharding_for",
    "tree_pspecs",
    "tree_shardings",
    "use_mesh",
]

# logical axis -> tuple of mesh axes (tried in order, first that divides wins)
DEFAULT_RULES = {
    # params
    "embed": ("data",),          # FSDP / ZeRO-3
    "heads": ("model",),         # TP
    "kv_heads": ("model",),
    "head_dim": (),
    "ffn": ("model",),
    "experts": ("model",),       # EP
    "vocab": ("model",),
    "ssm_in": ("model",),
    "ssm_heads": ("model",),
    "state": (),
    "layers": (),
    "conv_k": (),
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_seq_sharded": ("data",),  # sequence parallelism (opt-in)
    "act_embed": (),
    "act_heads": ("model",),
    "act_ffn": ("model",),
    "act_experts": ("model",),
    "act_vocab": ("model",),
    # kv cache
    "cache_batch": ("pod", "data"),
    "cache_seq_long": ("data",),  # long-context: shard the cache over seq
}


class Rules(dict):
    def merged(self, overrides: dict | None) -> "Rules":
        r = Rules(self)
        if overrides:
            r.update(overrides)
        return r


_ctx = threading.local()


@contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Install ``mesh`` (a ``DeviceMesh``) and the default rules merged with
    ``rules`` for ``constrain`` in this thread."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, Rules(DEFAULT_RULES).merged(rules))
    try:
        yield
    finally:
        _ctx.state = prev


@contextmanager
def cost_site(name: str):
    """Files the collectives and local ops run inside, in this thread, under
    ``name`` (read by ``current_cost_site``)."""
    prev = getattr(_ctx, "site", None)
    _ctx.site = name
    try:
        yield
    finally:
        _ctx.site = prev


def current_cost_site():
    return getattr(_ctx, "site", None)


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``(names, sizes)`` pair."""
    if isinstance(mesh, tuple):
        names, sizes = mesh
    else:
        names, sizes = mesh.mesh_dim_names, mesh.shape
    if names is None or len(names) != len(sizes):
        raise ValueError(f"a mesh needs one name per dim, got names {names} for shape {tuple(sizes)}")
    return dict(zip(names, (int(s) for s in sizes)))


def pspec_for(logical_axes, shape, mesh, rules: dict) -> tuple:
    """The partition tuple of a tensor of ``shape`` with ``logical_axes``,
    dropping mesh axes that don't divide dims."""
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        cand = rules.get(name, ())
        if isinstance(cand, str):
            cand = (cand,)
        picked = []
        prod = 1
        for ax in cand:
            if ax in used or ax not in sizes:
                continue
            if dim % (prod * sizes[ax]) == 0:
                picked.append(ax)
                prod *= sizes[ax]
        for ax in picked:
            used.add(ax)
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: tuple, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh`` for the partition tuple
    ``spec``: ``Shard(d)`` where tensor dim d names that mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for ax in (entry,) if isinstance(entry, str) else (entry or ()):
            where[ax] = d
    return tuple(Shard(where[ax]) if ax in where else Replicate() for ax in mesh_axis_sizes(mesh))


def sharding_for(logical_axes, shape, mesh=None, rules: dict | None = None) -> tuple:
    """Placements for a tensor of ``shape``; the mesh and rules default to
    the ones ``use_mesh`` installed."""
    st = getattr(_ctx, "state", None)
    if mesh is None:
        if st is None:
            raise RuntimeError("sharding_for without a mesh needs use_mesh")
        mesh, rules = st
    elif rules is None:
        rules = st[1] if st else Rules(DEFAULT_RULES)
    return placements_for(pspec_for(logical_axes, shape, mesh, rules), mesh)


def axis_divides(logical: str, size: int) -> bool:
    """Under ``use_mesh``: whether ``logical``'s rule shards a dim of
    ``size`` (some of its mesh axes divide it); False outside a mesh."""
    st = getattr(_ctx, "state", None)
    return st is not None and pspec_for((logical,), (size,), st[0], st[1]) != ()


class _GradLayout(torch.autograd.Function):
    """Identity on a DTensor whose gradient is redistributed to
    ``placements`` (fixed when the forward ran, as is the cost site: the
    backward may run on another thread, outside ``use_mesh``)."""

    @staticmethod
    def forward(ctx, x, placements, site):
        ctx.placements, ctx.site = placements, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g, None, None
        with cost_site(ctx.site):
            return g.redistribute(g.device_mesh, ctx.placements), None, None


def layout_grad(x, placements, site: str | None = None):
    """The DTensor ``x``, its gradient laid out as ``placements`` (that work
    filed under the cost site ``site``); ``x`` itself when no gradient
    flows through it."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradLayout.apply(x, tuple(placements), site)


def constrain(x, logical_axes, site: str | None = None):
    """Redistribute the DTensor ``x`` to its rule's placements, and lay its
    gradient out the same way; ``x`` itself outside a mesh context or when
    it is no DTensor.  ``site`` names a layout the reference does not have:
    both redistributions are filed under that cost site."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = st
    placements = placements_for(pspec_for(logical_axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) != placements:
        with cost_site(site or current_cost_site()):
            x = x.redistribute(x.device_mesh, placements)
    return layout_grad(x, placements, site)


def shard_tensor(t, mesh, placements):
    """``t`` (held whole by every rank) as a DTensor on ``mesh`` with
    ``placements``: each rank keeps its own slice, with no communication."""
    from torch.distributed.tensor import DTensor

    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            size = local.shape[p.dim] // mesh.size(i)
            local = local.narrow(p.dim, coord[i] * size, size)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False, shape=t.shape, stride=t.stride())


def shard_tree(tree, axes_tree):
    """Under ``use_mesh``: every tensor of ``tree`` laid out by its logical
    axes (a plain tensor sliced with ``shard_tensor``, a DTensor
    redistributed); outside a mesh, ``tree`` itself.  Other leaves (a
    cache's int index) stay as they are."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return tree
    import torch
    from torch.distributed.tensor import DTensor

    mesh, rules = st

    def one(axes, t):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            return constrain(t, axes or ())
        return shard_tensor(t, mesh, placements_for(pspec_for(axes or (), t.shape, mesh, rules), mesh))

    return map_with_axes(one, axes_tree, tree)


def is_axes_leaf(a) -> bool:
    """A leaf of a logical-axes tree: None or a tuple of names / Nones."""
    return a is None or (isinstance(a, tuple) and all(x is None or isinstance(x, str) for x in a))


def map_with_axes(fn, axes_tree, tree, is_leaf=is_axes_leaf):
    """``fn(axes_leaf, subtree)`` over the leaves of ``axes_tree`` (as
    ``is_leaf`` tells them), with ``tree``'s node at the same place; the
    result has ``axes_tree``'s structure."""
    if is_leaf(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: map_with_axes(fn, axes_tree[k], tree[k], is_leaf) for k in axes_tree}
    return [map_with_axes(fn, a, t, is_leaf) for a, t in zip(axes_tree, tree, strict=True)]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def tree_pspecs(axes_tree, params_tree, mesh, rules: dict | None = None):
    """The partition tuple of every leaf of ``params_tree`` (tensors, or
    anything with a ``shape``; other leaves take ``()``)."""
    rules = Rules(DEFAULT_RULES).merged(rules)

    def one(axes, p):
        if axes is None:
            return ()
        return pspec_for(axes, _shape(p), mesh, rules)

    return map_with_axes(one, axes_tree, params_tree)


def tree_shardings(axes_tree, params_tree, mesh, rules: dict | None = None):
    """The DTensor placements of every leaf of ``params_tree`` on ``mesh``."""
    specs = tree_pspecs(axes_tree, params_tree, mesh, rules)
    return map_with_axes(lambda _, spec: placements_for(spec, mesh), axes_tree, specs)


def distribute_tree(tree, placements_tree, mesh):
    """Every tensor of ``tree`` (held whole by every rank) as a DTensor with
    the placements at its place in ``placements_tree`` (``tree_shardings``'
    result), sliced with ``shard_tensor``; other leaves as they are."""
    import torch

    def one(placements, t):
        return shard_tensor(t, mesh, placements) if isinstance(t, torch.Tensor) else t

    return map_with_axes(one, placements_tree, tree, is_leaf=lambda p: isinstance(p, tuple))
