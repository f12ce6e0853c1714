"""Training in the port (``repro_torch.models`` loss functions and remat,
``repro_torch.train``, gradients through ``repro_torch.kernels``) against
the JAX package on the CPU, in float32 on reduced configurations, and the
mirrors of ``tests/test_data_trainer.py`` through a port ``FairdServer``
and ``TorchFeed``.

Tolerances: the loss within 1e-5 relative; each gradient leaf within tol ×
the largest |gradient| of the whole tree, tol 1e-4 for ``attn`` (dense and
MoE) and the encoder-decoder, 2e-4 for zamba2 and 5e-4 for xlstm (the
kernel tolerances of tests/test_kernels.py: the reference's mLSTM is a
sequential scan, the port's chunked).  The scale is the tree's, not the
leaf's: the k projections' biases have a gradient that is zero in exact
arithmetic (softmax ignores a shift of every score) and holds rounding
noise alone on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_models_smoke import ASSIGNED  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.checkpoint.manager import _flatten, to_host  # noqa: E402
from repro_torch.client import LocalNetwork  # noqa: E402
from repro_torch.client.torch_adapter import TorchFeed, tokens_from_blob_column  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import ExecutorConfig  # noqa: E402
from repro_torch.data import training_dag, write_token_corpus  # noqa: E402
from repro_torch.kernels import grad, ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.accumulate import value_and_grad  # noqa: E402
from repro_torch.server import FairdServer  # noqa: E402
from repro_torch.train import Trainer, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tol(cfg) -> float:
    return {"zamba2": 2e-4, "xlstm": 5e-4}.get(cfg.block_pattern, 1e-4)


def _batch(cfg, seed=0, b=2, s=24) -> dict:
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = r.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, **changes):
    """(reference api, its numpy params, port config, port params) of a
    reduced configuration, the reference's weights carried over."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rapi = ref_build(rcfg)
    rparams = jax.tree.map(np.asarray, rapi.init(jax.random.PRNGKey(1))[0])
    return rapi, rparams, cfg, params_from_numpy(rparams, cfg, "cpu")


def _assert_grads_close(got, want, tol):
    g, w = _flatten(got), _flatten(jax.tree.map(np.asarray, want))
    assert set(g) == set(w)
    scale = max(float(np.abs(a).max()) for a in w.values())
    for k in sorted(w):
        assert g[k].shape == w[k].shape, k
        err = float(np.abs(g[k].numpy() - w[k]).max())
        assert err <= tol * scale, f"{k}: max |Δ| {err} above {tol} × {scale}"


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` + backward against ``jax.value_and_grad(loss_fn)``:
    loss, metrics and every gradient leaf; then remat (``full`` and
    ``dots``) gives the same gradients as none, and ``lse`` the same loss
    as ``logp``."""
    rapi, rparams, cfg, params = _pair(arch)
    batch = _batch(cfg)
    (want, wm), wg = jax.jit(jax.value_and_grad(rapi.loss_fn, has_aux=True))(rparams, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = value_and_grad(build(cfg).loss_fn, params, _torch_batch(batch))
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for k, v in wm.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    _assert_grads_close(grads, wg, _tol(cfg))
    flat = _flatten(grads)
    for policy in ("full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        rl, _, rg = value_and_grad(build(rcfg).loss_fn, params, _torch_batch(batch))
        assert float(rl) == float(loss)
        for k, g in _flatten(rg).items():
            torch.testing.assert_close(g, flat[k], rtol=0, atol=0, msg=f"remat {policy}: {k}")
    lse, _, _ = value_and_grad(build(dataclasses.replace(cfg, loss_impl="lse")).loss_fn, params, _torch_batch(batch))
    assert float(lse) == pytest.approx(float(loss), rel=1e-6)


def test_lse_loss_and_grads_match_reference():
    rapi, rparams, cfg, params = _pair("granite-3-8b", loss_impl="lse")
    batch = _batch(cfg, seed=1)
    (want, _), wg = jax.jit(jax.value_and_grad(rapi.loss_fn, has_aux=True))(rparams, jax.tree.map(jnp.asarray, batch))
    loss, _, grads = value_and_grad(build(cfg).loss_fn, params, _torch_batch(batch))
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    _assert_grads_close(grads, wg, _tol(cfg))


def test_train_step_matches_reference():
    """One train step of reduced granite (two microbatches, clipping, a
    warmup_cosine lr) against the reference's: loss, grad norm, lr and the
    updated weights, m and v."""
    from repro.optim import warmup_cosine as ref_warmup_cosine
    from repro_torch.optim import adamw_init, warmup_cosine

    rapi, rparams, cfg, params = _pair("granite-3-8b")
    batch = _batch(cfg, seed=2, b=4)
    rstate = {"params": jax.tree.map(jnp.asarray, rparams)}
    rstate["opt"] = jax.tree.map(jnp.asarray, {"m": jax.tree.map(np.zeros_like, rparams),
                                               "v": jax.tree.map(np.zeros_like, rparams), "step": np.int32(0)})
    rstep = jax.jit(ref_make_train_step(rapi.cfg, RefAdamWConfig(lr=ref_warmup_cosine(1e-3, 1, 10), grad_clip=0.5), 2))
    rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
    state = {"params": params, "opt": adamw_init(params)}
    state, m = make_train_step(cfg, AdamWConfig(lr=warmup_cosine(1e-3, 1, 10), grad_clip=0.5), 2)(state, _torch_batch(batch))
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    assert float(rm["grad_norm"]) > 0.5  # clipping is active
    # AdamW's first step moves each weight by lr · g / (|g| + eps): an
    # element whose gradient is near zero moves its update by its gradient's
    # relative error, so the weights are held to a hundredth of the lr, and
    # m and v to 1e-4 of their largest element
    for part in ("params", "m", "v"):
        got = state["params"] if part == "params" else state["opt"][part]
        want = rstate["params"] if part == "params" else rstate["opt"][part]
        g, w = _flatten(got), _flatten(jax.tree.map(np.asarray, want))
        atol = 1e-5 if part == "params" else 1e-4 * max(float(np.abs(a).max()) for a in w.values())
        for k in w:
            assert_allclose(g[k].numpy(), w[k], rtol=1e-4, atol=atol, err_msg=f"{part} {k}")


# ---------------------------------------------------------------------------
# the kernels' gradient Function, run on the CPU
# ---------------------------------------------------------------------------
def _cases(rng):
    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    return [
        ("flash_attention", ops.flash_attention_plain, (t(2, 2, 2, 33, 32), t(2, 2, 33, 32), t(2, 2, 33, 32)),
         {"causal": True}),
        ("ssd_scan", ops.ssd_scan_plain,
         (t(2, 70, 4, 32), t(2, 70, 4).abs() * 0.1, -torch.exp(t(4).abs()), t(2, 70, 16), t(2, 70, 16)),
         {"chunk": 32}),
        ("mlstm_chunk", ops.mlstm_chunk_plain, (t(2, 40, 2, 32), t(2, 40, 2, 32), t(2, 40, 2, 32), t(2, 40, 2),
                                                t(2, 40, 2, shift=-1.0)), {"chunk": 16}),
    ]


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan", "mlstm_chunk"])
def test_plain_backward_function_gives_the_plain_versions_gradients(which):
    """``grad.PlainBackward`` with the plain version as its forward (the
    card passes the kernel's launch) returns the plain version's outputs
    and gradients: every output used, and the first alone (the others get
    no gradient); an input that needs none gets none."""
    rng = np.random.default_rng(4)
    name, plain, inputs, kwargs = next(c for c in _cases(rng) if c[0] == which)
    want_outs = plain(*inputs, **kwargs)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    gouts = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32)) for o in want_outs]
    for used in (range(len(gouts)), (0,)):
        for frozen in (None, 0):
            args = [x.clone().requires_grad_(i != frozen) for i, x in enumerate(inputs)]
            outs = grad.PlainBackward.apply(plain, plain, kwargs, *args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            assert all(type(o.grad_fn).__name__ == "PlainBackwardBackward" for o in outs)
            for o, w in zip(outs, want_outs):
                assert torch.equal(o, w)
            live = [a for a in args if a.requires_grad]
            got = torch.autograd.grad([outs[i] for i in used], live, [gouts[i] for i in used], allow_unused=True)
            pargs = [x.clone().requires_grad_(i != frozen) for i, x in enumerate(inputs)]
            pouts = plain(*pargs, **kwargs)
            pouts = pouts if isinstance(pouts, tuple) else (pouts,)
            plive = [a for a in pargs if a.requires_grad]
            want = torch.autograd.grad([pouts[i] for i in used], plive, [gouts[i] for i in used], allow_unused=True)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_grad_guard_logic():
    """``needs_grad`` / ``refuse`` (decode_attention's guard on the card):
    grad mode on and an input that requires grad; otherwise no refusal."""
    q, k = torch.zeros(2, 2, requires_grad=True), torch.zeros(2, 2)
    assert grad.needs_grad(k, q) and not grad.needs_grad(k, 3)
    with pytest.raises(RuntimeError, match="decode_attention has no gradient"):
        grad.refuse("decode_attention", q, k)
    grad.refuse("decode_attention", k)
    with torch.no_grad():
        assert not grad.needs_grad(q)
        grad.refuse("decode_attention", q, k)
    # the CPU wrapper is the plain version and stays differentiable
    qd = torch.randn(1, 1, 2, 32, requires_grad=True)
    out = ops.decode_attention(qd, torch.randn(1, 1, 5, 32), torch.randn(1, 1, 5, 32), 4)
    assert out.grad_fn is not None


# ---------------------------------------------------------------------------
# mirrors of tests/test_data_trainer.py: DACP feed → TorchFeed → Trainer
# ---------------------------------------------------------------------------
@pytest.fixture()
def corpus_client(tmp_path):
    write_token_corpus(str(tmp_path / "corpus" / "docs.jsonl"), docs=64, seed=3)
    net = LocalNetwork()
    s = FairdServer("data:3101", executor=ExecutorConfig(device="cpu"))
    s.catalog.register_path("corpus", str(tmp_path / "corpus"))
    net.register(s)
    yield net.client_for("data:3101")
    s.shutdown()


def _feed(client, seq=32, batch=8):
    dag = training_dag("dacp://data:3101/corpus/docs.jsonl", seq_len=seq, batch_rows=8)

    def feed():
        return iter(TorchFeed(lambda: client.cook(dag), token_column="tokens", seq_len=seq + 1, global_batch=batch,
                              device="cpu"))

    return feed


def test_pipeline_tokens_shape_and_feed(corpus_client):
    dag = training_dag("dacp://data:3101/corpus/docs.jsonl", seq_len=64, batch_rows=8)
    toks = tokens_from_blob_column(next(iter(corpus_client.cook(dag).iter_batches())), "tokens", 65)
    assert toks.shape == (8, 65) and toks.dtype == np.int32 and (toks >= 0).all() and (toks < 259).all()
    b1 = next(_feed(corpus_client, batch=16)())
    assert b1["tokens"].shape == (16, 32) and b1["labels"].shape == (16, 32)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_trainer_runs_and_resumes(corpus_client, tmp_path):
    cfg = get_config("paper-lm-100m").reduced()
    feed = _feed(corpus_client)
    ck = str(tmp_path / "ckpt")
    tr = Trainer(cfg, feed, AdamWConfig(lr=1e-3), ckpt_dir=ck, ckpt_every=5, log_every=2, device="cpu")
    m = tr.run(6)
    assert np.isfinite(m["loss"]) and tr.step == 6
    first_losses = [x["loss"] for x in tr.metrics_log]
    # restart: a fresh Trainer must resume from step 6's checkpoint
    tr2 = Trainer(cfg, feed, AdamWConfig(lr=1e-3), ckpt_dir=ck, ckpt_every=5, log_every=2, device="cpu")
    assert tr2.step == 6
    m2 = tr2.run(4)
    assert tr2.step == 10 and np.isfinite(m2["loss"])
    assert m2["loss"] < first_losses[0]


def test_trainer_loss_decreases(corpus_client):
    cfg = get_config("paper-lm-100m").reduced()
    tr = Trainer(cfg, _feed(corpus_client), AdamWConfig(lr=3e-3), log_every=1, device="cpu")
    tr.run(30)
    losses = [x["loss"] for x in tr.metrics_log]
    assert losses[-1] < losses[0] * 0.8, losses


def test_bf16_trainer_resumes_bit_for_bit(corpus_client, tmp_path):
    """Reduced zamba2 in bfloat16 with accumulation and compression: two
    steps, an async save, and a new Trainer resumes at step 2 with params,
    m, v, step and error buffer equal bit for bit, then takes a third step.
    The reference's Trainer cannot resume such a run: its checkpoints hold
    bfloat16 as raw 2-byte voids, which it cannot cast back
    (``repro.train.loop``)."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), param_dtype="bfloat16", dtype="bfloat16")
    feed = _feed(corpus_client, seq=48, batch=4)
    ck = str(tmp_path / "ckpt")

    def trainer():
        return Trainer(cfg, feed, AdamWConfig(lr=1e-3), ckpt_dir=ck, ckpt_every=2, n_micro=2, compress_grads=True,
                       seed=7, log_every=1, device="cpu")

    first = trainer()
    first.run(2)
    saved = {k: to_host(v).tobytes() for k, v in _flatten(first.state).items()}
    assert first.state["params"]["embed"]["table"].dtype == torch.bfloat16
    resumed = trainer()
    assert resumed.step == 2
    assert {k: to_host(v).tobytes() for k, v in _flatten(resumed.state).items()} == saved
    m = resumed.run(1)
    assert resumed.step == 3 and np.isfinite(m["loss"])
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(resumed.state["params"]["layers"][0]["mamba"]["out"]))
