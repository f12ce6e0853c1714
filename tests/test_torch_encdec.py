"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's (``repro.models.encdec``) on reduced whisper-small, on the
CPU, in float32, from the same weights carried over with
``params_from_numpy``: the encoder memory, forward logits, prefill's last
logits and cache (the cross-attention's k and v included, through
``cache_to_reference``) and three decode steps; the port's decode against
its own forward; a bfloat16 prefill and decode.

Tolerance: 1e-4 absolute and relative, as in tests/test_torch_models.py.
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
from repro.models import encdec as ref_encdec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, encdec  # noqa: E402
from repro_torch.models.convert import cache_to_reference, params_from_numpy  # noqa: E402

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(reference api, reference params, port api, port params) of reduced
    whisper-small, with the reference's weights carried over."""
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    rapi, api = ref_build(rcfg), build(cfg)
    rparams, _ = rapi.init(jax.random.PRNGKey(1))
    return rapi, rparams, api, params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")


def _batch(cfg, b=2, s=21, seed=3):
    r = np.random.default_rng(seed)
    return {
        "tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "frames": r.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32),
    }


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_cache_close(mine, want):
    got = jax.tree_util.tree_flatten_with_path(mine)[0]
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, g), (_, w) in zip(got, ref):
        assert np.shape(g) == np.shape(w), jax.tree_util.keystr(path)
        assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **TOL, err_msg=jax.tree_util.keystr(path))


def test_encode_matches_reference(pair):
    rapi, rparams, api, params = pair
    frames = _batch(api.cfg)["frames"]
    want = ref_encdec.encode(rparams, jnp.asarray(frames), rapi.cfg)
    got = encdec.encode(params, torch.from_numpy(frames), api.cfg)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_reference(pair):
    rapi, rparams, api, params = pair
    batch = _batch(api.cfg)
    want, _ = rapi.forward(rparams, _jax(batch))
    got, aux = api.forward(params, _torch(batch))
    assert got.shape == (2, 21, api.cfg.padded_vocab) and aux == 0.0
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_cross_cache_match_reference(pair):
    rapi, rparams, api, params = pair
    batch = _batch(api.cfg, s=18)
    want, want_cache = rapi.prefill(rparams, _jax(batch), 23)
    got, got_cache = api.prefill(params, _torch(batch), 23)
    assert got.shape == (2, 1, api.cfg.padded_vocab)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got_cache["cross_k"].shape == (api.cfg.n_layers, 2, api.cfg.n_kv_heads, api.cfg.enc_seq, api.cfg.head_dim_)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)


def test_decode_steps_match_reference(pair):
    """Three decode steps after an 18-token prefill (cache of 23,
    positions 18-20)."""
    rapi, rparams, api, params = pair
    batch = _batch(api.cfg)
    toks = batch["tokens"]
    k = 18
    pre = dict(batch, tokens=toks[:, :k])
    _, want_cache = rapi.prefill(rparams, _jax(pre), 23)
    _, got_cache = api.prefill(params, _torch(pre), 23)
    for i in range(3):
        t = toks[:, k + i : k + i + 1]
        want, want_cache = rapi.decode_step(rparams, jnp.asarray(t), want_cache)
        got, got_cache = api.decode_step(params, torch.from_numpy(t), got_cache)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_cache_close(cache_to_reference(got_cache), want_cache)


def test_init_matches_reference_shapes_and_scales():
    cfg = get_config(ARCH).reduced()
    params = encdec.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rtree = jax.eval_shape(lambda k: ref_build(ref_config(ARCH).reduced()).init(k)[0], jax.random.PRNGKey(0))
    mine = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), params))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), rtree))[0]
    assert [(jax.tree_util.keystr(p), s) for p, s in mine] == [(jax.tree_util.keystr(p), s) for p, s in want]
    assert params["dec_pos"].shape == (encdec.DEC_POSITIONS, cfg.d_model)
    assert abs(float(params["dec_pos"].std()) - 0.01) < 1e-3
    wo = params["decoder"][0]["cross_attn"]["wo"]["w"]
    assert abs(float(wo.std()) - (cfg.n_heads * cfg.head_dim_) ** -0.5) < 0.1 * (cfg.n_heads * cfg.head_dim_) ** -0.5


def test_decode_matches_forward():
    """The port's own consistency: prefill + decode give the forward logits."""
    cfg = get_config(ARCH).reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(1), "cpu")
    batch = _torch(_batch(cfg))
    full, _ = api.forward(params, batch)
    k = 18
    last, cache = api.prefill(params, dict(batch, tokens=batch["tokens"][:, :k]), 23)
    errs = [float((last[:, -1] - full[:, k - 1]).abs().max())]
    for i in range(3):
        logits, cache = api.decode_step(params, batch["tokens"][:, k + i : k + i + 1], cache)
        errs.append(float((logits[:, 0] - full[:, k + i]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-3


def test_bfloat16_prefill_and_decode_on_the_cpu():
    """The serving dtype through the kernels' plain versions: bfloat16
    activations and caches, logits within bfloat16 rounding of the float32
    model's."""
    cfg32 = get_config(ARCH).reduced()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16", param_dtype="bfloat16")
    p32 = build(cfg32).init(torch.Generator().manual_seed(4), "cpu")
    p16 = jax.tree.map(lambda t: t.to(torch.bfloat16), p32)
    batch = _torch(_batch(cfg32, s=12))
    want, _ = build(cfg32).prefill(jax.tree.map(lambda t: t.float(), p16), batch, 16)
    got, cache = build(cfg16).prefill(p16, batch, 16)
    assert got.dtype == torch.bfloat16 and cache["cross_k"].dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 5e-2 * float(want.abs().max())
    logits, cache = build(cfg16).decode_step(p16, batch["tokens"][:, :1], cache)
    assert logits.dtype == torch.bfloat16 and cache["index"] == 13
    assert torch.isfinite(logits.float()).all()


def test_encdec_entry_points_default_to_the_card():
    cfg = get_config(ARCH).reduced()
    if torch.cuda.is_available():
        assert encdec.make_decode_cache(cfg, 1, 8, torch.float32)["cross_k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        encdec.make_decode_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg).init(torch.Generator())
