"""The port's optimizer substrate and checkpoint manager
(``repro_torch.optim``, ``repro_torch.checkpoint``) against the JAX
package's on the CPU, and the mirrors of ``tests/test_optim_checkpoint.py``.

Tolerances: AdamW, the schedules and accumulation compute the same float32
arithmetic on both sides; they differ only where a library fuses or
reorders an operation, a few float32 ulps (rtol 1e-6).  The int8
compression's quantized values are equal exactly (the same float32 scale,
round half to even on both sides); its residual within 1e-7.  Checkpoints
are compared bit for bit, bfloat16 as its bits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.train import make_train_state as ref_make_train_state  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten, to_host, to_tensor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    accumulated_value_and_grad,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_tree,
    constant,
    global_norm,
    init_error_state,
    warmup_cosine,
)
from repro_torch.train import make_train_state  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

RTOL = 1e-6


def _pairs(got, want) -> list:
    """(port leaf, reference leaf as numpy) under each tree path."""
    g, w = _flatten(got), _flatten(jax.tree.map(np.asarray, want))
    assert set(g) == set(w)
    return [(g[k], w[k]) for k in sorted(w)]


def _bits(a) -> bytes:
    """The bytes of an array or tensor, bfloat16 (ml_dtypes or torch) as its bits."""
    if isinstance(a, torch.Tensor):
        return to_host(a).tobytes()
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 100, 250])
def test_schedules_match_reference(step):
    want = float(ref_optim.warmup_cosine(3e-3, 10, 100)(jnp.asarray(step)))
    got = float(warmup_cosine(3e-3, 10, 100)(torch.tensor(step)))
    assert got == pytest.approx(want, rel=RTOL, abs=1e-12)
    assert float(constant(0.25)(torch.tensor(step))) == float(ref_optim.constant(0.25)(jnp.asarray(step)))


def test_adamw_matches_reference_with_clipping_and_schedule():
    """Three AdamW steps given identical gradients, the global norm above
    the clip (so every gradient is scaled) and a warmup_cosine lr: params
    (float32 and bfloat16 leaves), m, v, grad_norm and lr."""
    rng = np.random.default_rng(0)
    shapes = {"w": np.zeros((8, 6)), "b": np.zeros(6), "layers": [np.zeros(5), np.zeros((3, 4))]}
    params_np = tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    lr = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6)
    ref_cfg = ref_optim.AdamWConfig(lr=ref_optim.warmup_cosine(**lr), grad_clip=0.5)
    cfg = AdamWConfig(lr=warmup_cosine(**lr), grad_clip=0.5)
    rp = jax.tree.map(jnp.asarray, params_np)
    rp["b"] = rp["b"].astype(jnp.bfloat16)
    params = tree_map(torch.from_numpy, params_np)
    params["b"] = params["b"].to(torch.bfloat16)
    rstate, state = ref_optim.adamw_init(rp), adamw_init(params)
    for _ in range(3):
        grads_np = tree_map(lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), shapes)
        rp, rstate, rm = ref_optim.adamw_update(ref_cfg, rp, jax.tree.map(jnp.asarray, grads_np), rstate)
        params, state, m = adamw_update(cfg, params, tree_map(torch.from_numpy, grads_np), state)
        assert float(rm["grad_norm"]) > 0.5  # clipping is active
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=RTOL)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=RTOL)
        assert int(state["step"]) == int(rstate["step"])
        for got, want in ((params, rp), (state["m"], rstate["m"]), (state["v"], rstate["v"])):
            for g, w in _pairs(got, want):
                assert_allclose(g.float().numpy(), w.astype(np.float32), rtol=RTOL, atol=1e-9)
    assert params["b"].dtype == torch.bfloat16 and state["m"]["b"].dtype == torch.float32


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32) * 40, "b": [rng.normal(size=(5,)).astype(np.float32)]}
    want, wnorm = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    got, norm = clip_by_global_norm(tree_map(torch.from_numpy, tree), 1.0)
    assert float(norm) == pytest.approx(float(wnorm), rel=RTOL)
    assert float(global_norm(tree_map(torch.from_numpy, tree))) == pytest.approx(float(wnorm), rel=RTOL)
    for g, w in _pairs(got, want):
        assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-9)


def test_compress_tree_matches_reference_including_ties():
    """Quantized values equal exactly (deq = q × the same scale), residual
    within 1e-7; a max of 127 makes the scale exactly 1, so ±x.5 are ties
    that round half to even on both sides."""
    rng = np.random.default_rng(2)
    ties = np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5], np.float32)
    grads = {"t": ties, "g": [rng.normal(size=(33,)).astype(np.float32), rng.normal(size=(4, 4)).astype(np.float32)]}
    err = {"t": np.zeros(7, np.float32), "g": [rng.normal(size=(33,)).astype(np.float32) * 1e-3, np.zeros((4, 4), np.float32)]}
    rdeq, rerr = ref_optim.compress_tree(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
    deq, new_err = compress_tree(tree_map(torch.from_numpy, grads), tree_map(torch.from_numpy, err))
    for g, w in _pairs(deq, rdeq):
        assert g.numpy().tobytes() == w.tobytes()
    for g, w in _pairs(new_err, rerr):
        assert_allclose(g.numpy(), w, rtol=0, atol=1e-7)
    assert deq["t"].tolist() == [127.0, 2.0, -4.0, 0.0, 2.0, -0.0, 126.0]


def test_accumulation_matches_reference():
    """n_micro = 2 against the reference's scan: loss, last microbatch's
    metrics and float32 gradients."""

    def ref_loss(params, batch):
        pred = (batch["x"] @ params["w"]) * params["s"]
        return jnp.mean((pred - batch["y"]) ** 2), {"first": pred[0]}

    def loss(params, batch):
        pred = (batch["x"] @ params["w"]) * params["s"]
        return torch.mean((pred - batch["y"]) ** 2), {"first": pred[0]}

    r = np.random.default_rng(3)
    params = {"w": r.normal(size=(6,)).astype(np.float32), "s": np.array(1.5, np.float32)}
    batch = {"x": r.normal(size=(8, 6)).astype(np.float32), "y": r.normal(size=(8,)).astype(np.float32)}
    wl, wm, wg = ref_optim.accumulated_value_and_grad(ref_loss, 2)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch)
    )
    gl, gm, gg = accumulated_value_and_grad(loss, 2)(tree_map(torch.from_numpy, params), tree_map(torch.from_numpy, batch))
    assert float(gl) == pytest.approx(float(wl), rel=RTOL)
    assert float(gm["first"]) == pytest.approx(float(wm["first"]), rel=RTOL)
    for k in params:
        assert gg[k].dtype == torch.float32
        assert_allclose(gg[k].numpy(), np.asarray(wg[k]), rtol=RTOL, atol=1e-7)


@pytest.fixture(scope="module")
def bf16_cfgs():
    """Reduced zamba2 with bfloat16 parameters (A_log, D and dt_bias stay
    float32), the reference's and the port's."""
    import dataclasses

    bf16 = dict(param_dtype="bfloat16", dtype="bfloat16")
    return (dataclasses.replace(ref_config("zamba2-1.2b").reduced(), **bf16),
            dataclasses.replace(get_config("zamba2-1.2b").reduced(), **bf16))


def test_port_restores_a_reference_checkpoint(tmp_path, bf16_cfgs):
    """The reference's CheckpointManager saves a JAX train state (bfloat16
    params, float32 m / v / err, int32 step); the port restores it onto its
    own state bit for bit."""
    rcfg, cfg = bf16_cfgs
    rstate, _ = ref_make_train_state(rcfg, ref_optim.AdamWConfig(), jax.random.PRNGKey(4), compress=True)
    RefCheckpointManager(str(tmp_path)).save(3, rstate)
    restored, manifest = CheckpointManager(str(tmp_path)).restore_latest()
    assert manifest["step"] == 3
    skeleton = make_train_state(cfg, AdamWConfig(), torch.Generator().manual_seed(0), True, "cpu")
    state = tree_map(lambda cur, new: to_tensor(new, cur), skeleton, restored)
    got, want = _flatten(state), _flatten(jax.tree.map(np.asarray, rstate))
    assert set(got) == set(want) and len(got) == manifest["n_arrays"]
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_reference_restores_a_port_checkpoint(tmp_path, bf16_cfgs):
    """The port saves its train state; the reference's restore returns equal
    arrays (bfloat16 as its bits) under the same keys."""
    _, cfg = bf16_cfgs
    state = make_train_state(cfg, AdamWConfig(), torch.Generator().manual_seed(5), True, "cpu")
    state["opt"]["step"].fill_(7)
    CheckpointManager(str(tmp_path)).save(7, state)
    restored, manifest = RefCheckpointManager(str(tmp_path)).restore_latest()
    assert manifest["step"] == 7
    got, want = _flatten(restored), _flatten(state)
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
        assert np.asarray(got[k]).shape == tuple(want[k].shape), k


# ---------------------------------------------------------------------------
# mirrors of tests/test_optim_checkpoint.py
# ---------------------------------------------------------------------------
def quad_loss(params, batch):
    return torch.sum((params["x"] - batch["target"]) ** 2), {}


def test_adamw_converges():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"x": torch.zeros(8)}
    state = adamw_init(params)
    batch = {"target": torch.arange(8.0)}
    vg = accumulated_value_and_grad(quad_loss, 1)
    for _ in range(300):
        loss, _, g = vg(params, batch)
        params, state, _ = adamw_update(cfg, params, g, state)
    assert float(loss) < 1e-2


def test_grad_clip_and_lr_schedule():
    sched = warmup_cosine(1.0, 10, 100)
    assert float(sched(torch.tensor(0))) == 0.0
    assert float(sched(torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(sched(torch.tensor(100))) == pytest.approx(0.1, abs=1e-2)
    cfg = AdamWConfig(lr=0.1, grad_clip=1.0)
    params = {"x": torch.zeros(4)}
    state = adamw_init(params)
    _, _, m = adamw_update(cfg, params, {"x": torch.full((4,), 1e9)}, state)
    assert float(m["grad_norm"]) == pytest.approx(2e9, rel=1e-3)


def test_accumulation_equivalence():
    """n_micro grads must equal full-batch grads (linearity of mean-loss)."""

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {"d": torch.zeros(())}

    r = np.random.default_rng(0)
    params = {"w": torch.from_numpy(r.normal(size=(6,)).astype(np.float32))}
    batch = {"x": torch.from_numpy(r.normal(size=(8, 6)).astype(np.float32)),
             "y": torch.from_numpy(r.normal(size=(8,)).astype(np.float32))}
    _, _, g1 = accumulated_value_and_grad(loss_fn, 1)(params, batch)
    _, _, g4 = accumulated_value_and_grad(loss_fn, 4)(params, batch)
    assert_allclose(g1["w"].numpy(), g4["w"].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        accumulated_value_and_grad(loss_fn, 3)(params, batch)


def test_grad_compression_error_feedback():
    """Lossy per step, but error feedback keeps the running sum faithful:
    the residual never exceeds one quantization bucket."""
    r = np.random.default_rng(1)
    g_true = [r.normal(size=(64,)).astype(np.float32) for _ in range(50)]
    err = init_error_state({"g": torch.zeros(64)})
    total_sent = np.zeros(64, np.float32)
    total_true = np.zeros(64, np.float32)
    for g in g_true:
        sent, err = compress_tree({"g": torch.from_numpy(g)}, err)
        total_sent += sent["g"].numpy()
        total_true += g
    assert np.abs(total_sent - total_true).max() <= 2 * np.abs(np.asarray(g_true)).max() / 127.0


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": {"b": torch.arange(10, dtype=torch.float32)}, "list": [torch.ones(3), torch.zeros(2)],
            "step": torch.tensor(7, dtype=torch.int32), "h": torch.linspace(-2, 2, 5).to(torch.bfloat16)}
    for step in (1, 2, 3):
        cm.save(step, tree)
    assert cm.list_steps() == [2, 3]
    restored, manifest = cm.restore_latest()
    assert manifest["step"] == 3 and manifest["n_arrays"] == 5
    assert_allclose(restored["a"]["b"], tree["a"]["b"].numpy())
    assert_allclose(restored["list"][1], tree["list"][1].numpy())
    assert restored["h"].dtype == np.dtype("V2") and _bits(restored["h"]) == _bits(tree["h"])
    assert torch.equal(to_tensor(restored["h"], tree["h"]), tree["h"])


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    tree = {"w": torch.arange(100, dtype=torch.float32)}
    cm.save(1, tree)
    cm.save(2, tree)
    d = os.path.join(str(tmp_path), "step_0000000002")
    shard = [f for f in os.listdir(d) if f.startswith("shard")][0]
    with open(os.path.join(d, shard), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    restored, manifest = cm.restore_latest()
    assert manifest["step"] == 1  # fell back to the valid checkpoint
    with pytest.raises(FileNotFoundError):
        cm.restore(2)


def test_checkpoint_async(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(5, {"x": torch.ones(4)})
    cm.wait()
    restored, mf = cm.restore_latest()
    assert mf["step"] == 5 and restored["x"].sum() == 4
