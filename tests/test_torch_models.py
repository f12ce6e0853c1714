"""The port's LM (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU, in float32, from the same weights carried
over with ``params_from_numpy``: forward logits, prefill's last logits and
decode cache, and three decode steps, for every reduced dense attention
configuration, the two MoE configurations (moonshot top-2 and llama4-scout
top-1 at reduced size, load-balancing loss included) and reduced
zamba2-1.2b (Mamba2 + shared attention) and xlstm-125m (mLSTM + sLSTM);
every registered configuration builds and serves at reduced size.

Tolerance: 1e-4 absolute and relative on logits and cache entries (about
|logit| ≤ 5).  Both sides compute in float32 and differ only in the order of
the sums inside matrix products, softmaxes and the chunked scans, which
moves results by a few float32 ulps a layer (measured: under 3e-5 over
four or five layers).
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
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import build, layers, lm  # noqa: E402
from repro_torch.models.convert import cache_to_reference, params_from_numpy  # noqa: E402

DENSE = ["paper-lm-100m", "qwen1.5-0.5b", "gemma-2b", "stablelm-1.6b", "granite-3-8b", "chameleon-34b"]
HYBRID = ["zamba2-1.2b", "xlstm-125m"]
MOE = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _assert_cache_close(mine, want):
    """A port cache in the reference's layout (``cache_to_reference``)
    against the reference's cache: the same tree, every leaf within TOL."""
    got = jax.tree_util.tree_flatten_with_path(mine)[0]
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, g), (_, w) in zip(got, ref):
        assert np.shape(g) == np.shape(w), jax.tree_util.keystr(path)
        assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **TOL, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=DENSE + MOE + HYBRID)
def pair(request):
    """(reference api, reference params, port api, port params) of one
    reduced configuration, with the reference's weights carried over."""
    arch = request.param
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rapi, api = ref_build(rcfg), build(cfg)
    rparams, _ = rapi.init(jax.random.PRNGKey(1))
    return rapi, rparams, api, params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")


def _tokens(cfg, b=2, s=21, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_matches_reference(pair):
    rapi, rparams, api, params = pair
    toks = _tokens(api.cfg)
    want, want_aux = rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 21, api.cfg.padded_vocab)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the summed load-balancing loss of the MoE layers; 0.0 on both sides without them
    assert abs(float(aux) - float(want_aux)) < 1e-5 and (api.cfg.moe is not None or aux == 0.0)


def test_prefill_matches_reference(pair):
    rapi, rparams, api, params = pair
    toks = _tokens(api.cfg)[:, :18]
    want, want_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)}, 23)
    got, got_cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, 23)
    assert got.shape == (2, 1, api.cfg.padded_vocab)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)


def test_decode_steps_match_reference(pair):
    """Three decode steps after an 18-token prefill, at the odd cache
    lengths of tests/test_models_smoke.py (cache of 23, positions 18-20)."""
    rapi, rparams, api, params = pair
    toks = _tokens(api.cfg)
    k = 18
    _, want_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks[:, :k])}, 23)
    _, got_cache = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :k])}, 23)
    for i in range(3):
        t = toks[:, k + i : k + i + 1]
        want, want_cache = rapi.decode_step(rparams, jnp.asarray(t), want_cache)
        got, got_cache = api.decode_step(params, torch.from_numpy(t), got_cache)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)


@pytest.mark.parametrize("arch", HYBRID)
def test_long_prompt_prefill_and_decode_match_reference(arch):
    """zamba2 and xlstm over a 70-token prompt: several SSD chunks (32 at
    reduced width) and a ragged tail, then four decode steps, caches
    included."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rapi, api = ref_build(rcfg), build(cfg)
    rparams, _ = rapi.init(jax.random.PRNGKey(7))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    toks = _tokens(cfg, s=74, seed=8)
    want, want_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks[:, :70])}, 80)
    got, got_cache = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :70])}, 80)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)
    for i in range(70, 74):
        want, want_cache = rapi.decode_step(rparams, jnp.asarray(toks[:, i : i + 1]), want_cache)
        got, got_cache = api.decode_step(params, torch.from_numpy(toks[:, i : i + 1]), got_cache)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
def test_init_matches_reference_shapes_and_scales(arch):
    """The port draws its own weights with the reference's names, shapes and
    standard deviations."""
    cfg = get_config(arch).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rtree = jax.eval_shape(lambda k: ref_build(ref_config(arch).reduced()).init(k)[0], jax.random.PRNGKey(0))
    mine = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), params))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), rtree))[0]
    assert [(jax.tree_util.keystr(p), s) for p, s in mine] == [(jax.tree_util.keystr(p), s) for p, s in want]
    d = cfg.d_model
    assert abs(float(params["embed"]["table"].std()) - d**-0.5) < 0.1 * d**-0.5
    attn = params["shared_attn"]["attn"] if "shared_attn" in params else params["layers"][0].get("attn")
    if attn is None:  # xlstm: the mLSTM up projection, std d^-1/2
        up = params["layers"][0]["mlstm"]["up"]["w"]
        assert abs(float(up.std()) - d**-0.5) < 0.1 * d**-0.5
        return
    wo = attn["wo"]["w"]
    assert abs(float(wo.std()) - (cfg.n_heads * cfg.head_dim_) ** -0.5) < 0.1 * (cfg.n_heads * cfg.head_dim_) ** -0.5


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID)
def test_decode_matches_forward(arch):
    """The port's own consistency: prefill + decode give the forward logits
    (as tests/test_models_smoke.py::test_decode_matches_forward checks the
    reference)."""
    cfg = get_config(arch).reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(cfg))
    full, _ = api.forward(params, {"tokens": toks})
    k = 18
    last, cache = api.prefill(params, {"tokens": toks[:, :k]}, 23)
    errs = [float((last[:, -1] - full[:, k - 1]).abs().max())]
    for i in range(3):
        logits, cache = api.decode_step(params, toks[:, k + i : k + i + 1], cache)
        errs.append(float((logits[:, 0] - full[:, k + i]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-3


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_configuration_builds(arch):
    """Every configuration the port registers builds and serves at reduced
    size on the CPU: forward, prefill and a decode step give finite logits
    of the padded vocabulary, and the cache index moves on."""
    cfg = get_config(arch).reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(2), "cpu")
    r = np.random.default_rng(9)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, s=9))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(r.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    logits, _ = api.forward(params, batch)
    assert logits.shape == (2, 9, cfg.padded_vocab) and torch.isfinite(logits).all()
    last, cache = api.prefill(params, batch, 12)
    assert last.shape == (2, 1, cfg.padded_vocab)
    logits, cache = api.decode_step(params, batch["tokens"][:, :1], cache)
    assert logits.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(logits).all()
    assert (cache["kv"] if cfg.block_pattern == "zamba2" else cache)["index"] == 10


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_configurations_build_and_run(arch):
    """zamba2 and xlstm, which raised before their slice, build and serve:
    forward, prefill and a decode step give finite logits, and the cache
    index moves on."""
    cfg = get_config(arch).reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(_tokens(cfg, s=9))
    logits, aux = api.forward(params, {"tokens": toks})
    assert logits.shape == (2, 9, cfg.padded_vocab) and aux == 0.0 and torch.isfinite(logits).all()
    last, cache = api.prefill(params, {"tokens": toks}, 12)
    logits, cache = api.decode_step(params, toks[:, :1], cache)
    assert torch.isfinite(logits).all()
    assert (cache["kv"] if cfg.block_pattern == "zamba2" else cache)["index"] == 10


@pytest.mark.parametrize("arch", HYBRID)
def test_bfloat16_hybrid_prefill_and_decode_on_the_cpu(arch):
    """The serving dtype through the kernels' plain versions: bfloat16
    activations, float32 scan states, and logits within bfloat16 rounding
    of the float32 model's."""
    cfg32 = get_config(arch).reduced()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16", param_dtype="bfloat16")
    p32 = build(cfg32).init(torch.Generator().manual_seed(4), "cpu")
    keep_f32 = ("A_log", "D", "dt_bias")  # float32 under any parameter type, as in the reference
    p16 = jax.tree_util.tree_map_with_path(
        lambda path, t: t if path[-1].key in keep_f32 else t.to(torch.bfloat16), p32
    )
    toks = torch.from_numpy(_tokens(cfg32, s=40))
    want, _ = build(cfg32).prefill(jax.tree.map(lambda t: t.float(), p16), {"tokens": toks}, 44)
    got, cache = build(cfg16).prefill(p16, {"tokens": toks}, 44)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 5e-2 * float(want.abs().max())
    logits, cache = build(cfg16).decode_step(p16, toks[:, :1], cache)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()


def test_bfloat16_prefill_and_decode_on_the_cpu():
    """The serving dtype: a bfloat16 granite at reduced width keeps bfloat16
    activations and cache and stays within bfloat16 rounding of the float32
    model's logits."""
    cfg32 = get_config("granite-3-8b").reduced()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16", param_dtype="bfloat16")
    p32 = build(cfg32).init(torch.Generator().manual_seed(4), "cpu")
    p16 = jax.tree.map(lambda t: t.to(torch.bfloat16), p32)
    toks = torch.from_numpy(_tokens(cfg32, s=12))
    want, _ = build(cfg32).prefill(jax.tree.map(lambda t: t.float(), p16), {"tokens": toks}, 16)
    got, cache = build(cfg16).prefill(p16, {"tokens": toks}, 16)
    assert got.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    # bfloat16 keeps 8 bits of mantissa: 4 layers of rounded activations
    assert float((got.float() - want).abs().max()) < 5e-2 * float(want.abs().max())
    logits, cache = build(cfg16).decode_step(p16, toks[:, :1], cache)
    assert logits.dtype == torch.bfloat16 and cache["index"] == 13
    assert torch.isfinite(logits.float()).all()


def test_layers_match_reference():
    """The pieces the six configurations do not all reach: partial rotary,
    LayerNorm, tanh GELU and the padded-vocab mask."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None, :] + 40
    for frac in (1.0, 0.25, 0.5):
        inv_j, rot_j = ref_layers.rope_freqs(32, frac, 10000.0)
        inv_t, rot_t = layers.rope_freqs(32, frac, 10000.0)
        assert rot_j == rot_t
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv_j, rot_j)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv_t, rot_t)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3 + 1
    norm = {"scale": rng.normal(size=16).astype(np.float32), "bias": rng.normal(size=16).astype(np.float32)}
    for kind in ("layernorm", "rmsnorm"):
        want = ref_layers.norm_apply({k: jnp.asarray(v) for k, v in norm.items()}, jnp.asarray(h), kind)
        got = layers.norm_apply({k: torch.from_numpy(v) for k, v in norm.items()}, torch.from_numpy(h), kind)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for act in ("gelu", "silu", "relu"):
        assert_allclose(layers.ACT[act](torch.from_numpy(h)).numpy(), np.asarray(ref_layers.ACT[act](jnp.asarray(h))), rtol=1e-5, atol=1e-5)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    want = ref_layers.logits_apply({"table": jnp.asarray(table)}, jnp.asarray(h), 50)
    got = layers.logits_apply({"table": torch.from_numpy(table)}, torch.from_numpy(h), 50)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(got[..., 50:].max()) == -1e9


def test_entry_points_default_to_the_card():
    """Without a card, the model's entry points refuse the default device
    instead of running on the CPU; on a card they take it."""
    cfg = get_config("granite-3-8b").reduced()
    if torch.cuda.is_available():
        assert lm.make_decode_cache(cfg, 1, 8, torch.float32)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        lm.make_decode_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init(cfg, torch.Generator())
    with pytest.raises(ValueError, match="unsupported device"):
        lm.init(cfg, torch.Generator(), "meta")


@pytest.mark.parametrize("arch", HYBRID)
def test_hybrid_entry_points_default_to_the_card(arch):
    cfg = get_config(arch).reduced()
    if torch.cuda.is_available():
        cache = lm.make_decode_cache(cfg, 1, 8, torch.float32)
        leaf = cache["ssm"]["ssm"] if "ssm" in cache else cache["xlstm"][0]["C"]
        assert leaf.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        lm.make_decode_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init(cfg, torch.Generator())
