"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``) on the CPU, in float32, from the same weights: both
dispatch modes, top-1 (reduced llama4-scout) and top-2 (reduced moonshot)
routing, slots dropped at capacity, tied router probabilities and the
load-balancing loss; the whole MoE LM through the einsum dispatch.

Tolerance: 1e-4 absolute and relative on outputs and logits, as in
tests/test_torch_models.py (both sides compute in float32 and differ only
in the order of the sums inside matrix products and softmaxes); 1e-5 on
the load-balancing loss, a mean of products of probabilities.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, lm, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import materialize  # noqa: E402

MOE = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]  # top-2 and top-1 at reduced size
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **moe_changes):
    """(reference cfg, port cfg) of the reduced configuration, with
    ``moe_changes`` applied to both MoE configs (``moe_dispatch`` to both
    configs)."""
    dispatch = moe_changes.pop("moe_dispatch", "scatter")

    def change(cfg):
        return dataclasses.replace(cfg, moe_dispatch=dispatch, moe=dataclasses.replace(cfg.moe, **moe_changes))

    return change(ref_config(arch).reduced()), change(get_config(arch).reduced())


def _layer(rcfg, cfg, seed=0, router=None):
    """(reference MoE params, the port's) from the reference's init; with
    ``router`` (d, E) numpy, both take that router weight."""
    rp, _ = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    rp = jax.tree.map(np.asarray, rp)
    if router is not None:
        rp["router"]["w"] = router.astype(np.float32)
    return jax.tree.map(jnp.asarray, rp), jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)


def _x(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _ref_slots(rparams, x, rcfg):
    """The reference's routing of x (its router, softmax and ``lax.top_k``)
    and the number of its slots past capacity, per batch row as its
    scatter dispatch counts them."""
    m = rcfg.moe
    b, s, _ = x.shape
    cap = min(max(1, int((s * m.top_k / m.n_experts) * m.capacity_factor + 0.9999)), s * m.top_k)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), rparams["router"]["w"]), axis=-1)
    _, gate_i = jax.lax.top_k(probs, m.top_k)
    oh = jax.nn.one_hot(gate_i.reshape(b, -1), m.n_experts, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(oh, axis=1) * oh, axis=-1) - 1
    return np.asarray(gate_i), int((pos >= cap).sum())


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, dispatch):
    """y and the load-balancing loss, both dispatch modes (einsum over three
    groups of 16 tokens)."""
    rcfg, cfg = _cfgs(arch, moe_dispatch=dispatch, group_size=16)
    rp, tp = _layer(rcfg, cfg)
    x = _x(cfg)
    want_y, want_aux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg, rcfg.act)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, cfg.act)
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-5


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_drops_slots_at_capacity_like_reference(arch, dispatch):
    """A capacity factor of 0.5 drops slots; both sides drop the same ones
    (the same count, and the same y, where a dropped slot adds nothing)."""
    rcfg, cfg = _cfgs(arch, moe_dispatch=dispatch, capacity_factor=0.5, group_size=24)
    rp, tp = _layer(rcfg, cfg, seed=2)
    x = _x(cfg, seed=3)
    _, _, gate_i = moe.route(tp, torch.from_numpy(x), cfg)
    _, _, keep = moe.slot_positions(gate_i, cfg.moe.n_experts, moe.scatter_capacity(24, cfg))
    want_i, want_dropped = _ref_slots(rp, x, rcfg)
    assert int((~keep).sum()) == want_dropped > 0
    assert np.array_equal(gate_i.numpy(), want_i)
    want_y, want_aux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg, rcfg.act)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, cfg.act)
    assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-5


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_tied_router_probabilities_go_to_the_lower_expert(arch, dispatch):
    """A router whose columns are zero but the last: every token's experts
    but the last tie exactly, and both sides take the lower indices, as
    ``jax.lax.top_k`` does."""
    rcfg, cfg = _cfgs(arch, moe_dispatch=dispatch, group_size=16)
    e = cfg.moe.n_experts
    router = np.zeros((cfg.d_model, e), np.float32)
    router[:, -1] = np.random.default_rng(4).normal(size=cfg.d_model) * cfg.d_model**-0.5
    rp, tp = _layer(rcfg, cfg, seed=5, router=router)
    x = _x(cfg, seed=6)
    _, _, gate_i = moe.route(tp, torch.from_numpy(x), cfg)
    want_i, _ = _ref_slots(rp, x, rcfg)
    assert np.array_equal(gate_i.numpy(), want_i)
    top = gate_i[..., 0].numpy()
    assert set(np.unique(top)) == {0, e - 1}  # the tie went to expert 0 wherever the last lost
    want_y, want_aux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg, rcfg.act)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, cfg.act)
    assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-5


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_einsum_dispatch_matches_reference(arch):
    """The whole LM through the einsum dispatch (groups of 16 tokens):
    forward logits and aux, prefill and three decode steps."""
    rcfg, cfg = _cfgs(arch, moe_dispatch="einsum", group_size=16)
    rapi, api = ref_build(rcfg), build(cfg)
    rparams, _ = rapi.init(jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, want_aux = rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, got_aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(got_aux) - float(want_aux)) < 1e-5
    want, want_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks[:, :16])}, 20)
    got, got_cache = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :16])}, 20)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(16, 19):
        t = toks[:, i : i + 1]
        want, want_cache = rapi.decode_step(rparams, jnp.asarray(t), want_cache)
        got, got_cache = api.decode_step(params, torch.from_numpy(t), got_cache)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_einsum_dispatch_equals_scatter(arch):
    """tests/test_variants.py::test_moe_einsum_dispatch_equals_scatter on
    the port: the two dispatch modes compute the same function when
    nothing drops."""
    cfg = get_config(arch).reduced()
    cfg_e = dataclasses.replace(cfg, moe_dispatch="einsum", moe=dataclasses.replace(cfg.moe, group_size=16))
    api_s, api_e = build(cfg), build(cfg_e)
    params = api_s.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    ls, aux_s = api_s.forward(params, {"tokens": toks})
    le, aux_e = api_e.forward(params, {"tokens": toks})
    assert float((ls - le).abs().max()) / float(ls.abs().max()) < 1e-3
    assert abs(float(aux_s) - float(aux_e)) < 1e-4


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_matches_reference_shapes_and_scales(arch):
    """The port draws the experts with the reference's names, shapes and
    standard deviations: ``up`` and ``gate`` d^-1/2, ``down`` f^-1/2."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    params = materialize(moe.moe_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(0))
    rtree = jax.eval_shape(lambda k: ref_moe.moe_init(k, rcfg, jnp.float32)[0], jax.random.PRNGKey(0))
    mine = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), params))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), rtree))[0]
    assert [(jax.tree_util.keystr(p), s) for p, s in mine] == [(jax.tree_util.keystr(p), s) for p, s in want]
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for name, std in (("router", d**-0.5), ("up", d**-0.5), ("gate", d**-0.5), ("down", f**-0.5)):
        assert abs(float(params[name]["w"].std()) - std) < 0.1 * std, name


@pytest.mark.parametrize("arch", MOE)
def test_moe_entry_points_default_to_the_card(arch):
    cfg = get_config(arch).reduced()
    if torch.cuda.is_available():
        assert lm.make_decode_cache(cfg, 1, 8, torch.float32)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        lm.make_decode_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg).init(torch.Generator())


# ---------------------------------------------------------------------------
# the dropless dispatch (granite-4.0-h-small's): the port's own, no reference counterpart
# ---------------------------------------------------------------------------
GRANITE = get_config("granite-4.0-h-small").reduced()


def _granite_layer(seed=0):
    return materialize(moe.moe_spec(GRANITE, torch.float32), "cpu", torch.Generator().manual_seed(seed))


def test_dropless_dispatch_is_each_tokens_dense_loop_over_its_top_k():
    """Every token through its own top-k experts one at a time (float32
    router logits, their top k, a softmax over those k; SiLU of
    ``input_linear``'s first half times its second, ``output_linear``) plus
    the shared MLP: the dispatch's output within 1e-5 (sums in other
    orders), with exactly tokens × k assignments counted and none dropped."""
    params = _granite_layer()
    x = torch.from_numpy(_x(GRANITE, b=3, s=21, seed=4))
    before = moe.STATS.snapshot()
    y, aux = moe.moe_apply(params, x, GRANITE, "silu")
    after = moe.STATS.snapshot()
    k, f = GRANITE.moe.top_k, GRANITE.moe.d_ff_expert
    want = torch.zeros_like(x)
    for bi in range(3):
        for t in range(21):
            h = x[bi, t]
            logits = h @ params["router"]["w"]
            top, idx = logits.topk(k)
            for g, e in zip(torch.softmax(top, -1), idx.tolist()):
                gu = params["input_linear"]["w"][e] @ h
                want[bi, t] += g * (params["output_linear"]["w"][e] @ (torch.nn.functional.silu(gu[:f]) * gu[f:]))
            sh = params["shared"]
            want[bi, t] += (torch.nn.functional.silu(h @ sh["gate"]["w"]) * (h @ sh["up"]["w"])) @ sh["down"]["w"]
    assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert after["assignments"] - before["assignments"] == 3 * 21 * k
    assert after["tokens"] - before["tokens"] == 63 and after["forwards"] - before["forwards"] == 1
    assert after["dropped"] == before["dropped"] and float(aux) > 0


def test_dropless_dispatch_scores_a_token_whatever_shares_its_batch():
    """A document's rows give the same output alone and beside others: no
    capacity couples tokens (the scatter dispatch's drops would)."""
    params = _granite_layer(1)
    x = torch.from_numpy(_x(GRANITE, b=4, s=16, seed=5))
    together, _ = moe.moe_apply_dropless(params, x, GRANITE, "silu")
    alone, _ = moe.moe_apply_dropless(params, x[2:3], GRANITE, "silu")
    assert_allclose(together[2:3].numpy(), alone.numpy(), rtol=1e-6, atol=1e-6)


def test_a_capacity_dropping_dispatch_fails_the_logits_comparison():
    """The same model through the scatter dispatch at capacity factor 1
    drops slots (counted in ``STATS``) and its logits leave the dropless
    path's by far more than the 1e-4 the port is held to against the
    reference: the comparison sees drops."""
    cfg_drop = dataclasses.replace(GRANITE, moe_dispatch="scatter",
                                   moe=dataclasses.replace(GRANITE.moe, capacity_factor=1.0))
    api, api_drop = build(GRANITE), build(cfg_drop)
    params = api.init(torch.Generator().manual_seed(7), "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, GRANITE.vocab_size, (2, 48)))
    want, _ = api.forward(params, {"tokens": toks})
    before = moe.STATS.snapshot()
    got, _ = api_drop.forward(params, {"tokens": toks})
    assert moe.STATS.snapshot()["dropped"] > before["dropped"]
    assert float((got - want).abs().max()) > 100 * 1e-4 * float(want.abs().max())
    roomy = dataclasses.replace(cfg_drop, moe=dataclasses.replace(cfg_drop.moe, capacity_factor=GRANITE.moe.n_experts))
    full, _ = build(roomy).forward(params, {"tokens": toks})  # a capacity that holds every slot: the same function
    assert float((full - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_grouped_products_plain_version_is_pytorchs_grouped_gemm():
    """``grouped_mm_plain`` against ``torch._grouped_mm`` (the card path's
    op, which this PyTorch also runs on the CPU) on segments with an empty
    one, the weights as the published transposed views."""
    from repro_torch.kernels.grouped_mm import grouped_mm, grouped_mm_plain

    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((37, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 24, 16)).astype(np.float32)).transpose(1, 2)
    offs = torch.tensor([5, 5, 30, 37], dtype=torch.int32)
    want = torch._grouped_mm(a, w, offs=offs)
    assert_allclose(grouped_mm_plain(a, w, offs).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(grouped_mm(a, w, offs), grouped_mm_plain(a, w, offs))
