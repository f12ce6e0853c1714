"""The front of the Mamba2 and xLSTM blocks (``kernels.causal_conv``) on
the CPU: ``causal_conv_silu_plain`` bit for bit against the expressions the
model ran inline before the kernel (prefill with no state, a decode step
from a state, fewer positions than the state holds; float32 and bfloat16;
with and without a bias); the wrapper's CPU route, its next state and its
launch checks; the plain backward with optional operands
left out; and the blocks' use of the bundle's conv.  The kernel itself is
held to the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.per_shard import on_shards  # noqa: E402
from repro_torch.kernels import causal_conv, grad, ops  # noqa: E402
from repro_torch.kernels.causal_conv import (  # noqa: E402
    MAX_K,
    _check,
    causal_conv_silu,
    causal_conv_silu_plain,
    next_state,
)
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.models.layers import materialize  # noqa: E402

def _old_conv(x, w, state=None, bias=None):
    """``models.layers.causal_conv_silu`` as it stood before the kernel."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return F.silu(y), (xp[:, -(k - 1) :, :] if k > 1 else None)


def _inputs(seed, b, s, c, k, dtype, with_state=False, with_bias=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)  # noqa: E731
    x, w = f(b, s, c), f(k, c)
    return x, w, f(b, k - 1, c) if with_state else None, f(c) if with_bias else None


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().tobytes()


FORMS = {  # (S, with a state): prefill from zeros, a decode step, fewer positions than the state holds
    "prefill": (37, False),
    "decode": (1, True),
    "short": (2, True),
    "short_no_state": (2, False),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_plain_version_is_bit_identical_to_the_inline_expressions(form, dtype, with_bias):
    s, with_state = FORMS[form]
    x, w, state, bias = _inputs(len(form), 3, s, 40, 4, dtype, with_state, with_bias)
    got, got_state = causal_conv_silu_plain(x, w, state, bias)
    want, want_state = _old_conv(x, w, state, bias)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (3, s, 40)
    assert _bits(got) == _bits(want)
    assert got_state.shape == want_state.shape == (3, 3, 40) and _bits(got_state) == _bits(want_state)


@pytest.mark.parametrize("k", range(1, MAX_K + 1))
@pytest.mark.parametrize("s", [1, 2, 3, 5])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_the_card_routes_next_state_is_the_plain_versions(k, s, with_state):
    """The wrapper's next state on the card (a view of x, or the small cat
    where S < K-1) holds the plain version's values; none at K 1."""
    x, w, state, _ = _inputs(k * 10 + s, 2, s, 16, k, torch.bfloat16, with_state)
    want = causal_conv_silu_plain(x, w, state)[1]
    got = next_state(x, state, k)
    if k == 1:
        assert got is None and want is None
    else:
        assert got.shape == want.shape == (2, k - 1, 16) and _bits(got) == _bits(want)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    before = ops.LAUNCHES["causal_conv_silu"].value
    x, w, state, bias = _inputs(3, 2, 5, 24, 4, torch.bfloat16, True, True)
    got = causal_conv_silu(x, w, state, bias)
    want = causal_conv_silu_plain(x, w, state, bias)
    assert all(_bits(a) == _bits(b) for a, b in zip(got, want))
    meta = causal_conv_silu(*(t.to("meta") for t in (x, w, state, bias)))  # shapes alone: the plain version's
    assert meta[0].shape == (2, 5, 24) and meta[0].dtype == torch.bfloat16 and meta[1].shape == (2, 3, 24)
    assert ops.LAUNCHES["causal_conv_silu"].value == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        causal_conv_silu(other, w)


def test_the_bundles_carry_the_kernel_and_its_plain_version():
    assert ops.KERNELS.causal_conv_silu is causal_conv_silu
    assert ops.PLAIN.causal_conv_silu is causal_conv_silu_plain
    assert ops.LAUNCHES["causal_conv_silu"] is causal_conv.launches
    x, w, _, bias = _inputs(4, 2, 7, 16, 4, torch.float32, with_bias=True)
    got = on_shards(ops.KERNELS).causal_conv_silu(x, w, None, bias)  # plain tensors go straight to the wrapper
    assert all(_bits(a) == _bits(b) for a, b in zip(got, causal_conv_silu_plain(x, w, None, bias)))


def _base(change):
    dtype = change.get("dtype", torch.bfloat16)
    x, w, state, bias = _inputs(5, 2, 6, change.get("c", 16), change.get("k", 4), dtype, True, True)
    if "w_rows" in change:
        w = torch.zeros((change["w_rows"], x.shape[2]), dtype=dtype)
    if change.get("transposed"):  # same shape, not row-major
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    if "state_len" in change:
        state = state[:, : change["state_len"]].contiguous()
    if "bias_len" in change:
        bias = bias[: change["bias_len"]]
    if "w_cols" in change:
        w = w[:, : change["w_cols"]].contiguous()
    if change.get("flat"):
        x = x[0]
    if change.get("empty"):
        x = x[:, :0]
    return x, w, state, bias


@pytest.mark.parametrize(
    "change,error,match",
    [
        ({"dtype": torch.float16}, TypeError, "float32 or bfloat16"),
        ({"dtype": torch.float64}, TypeError, "float32 or bfloat16"),
        ({"w_rows": MAX_K + 1}, ValueError, "K from 1 to 4"),
        ({"w_rows": 0}, ValueError, "K from 1 to 4"),
        ({"w_cols": 8}, ValueError, "expected \\(K, 16\\)"),
        ({"state_len": 2}, ValueError, "state has shape"),
        ({"bias_len": 8}, ValueError, "bias has shape"),
        ({"flat": True}, ValueError, "3 dimensions"),
        ({"transposed": True}, ValueError, "contiguous"),
        ({"empty": True}, ValueError, "empty input"),
    ],
    ids=["f16", "f64", "k5", "k0", "w_width", "state_shape", "bias_shape", "rank", "non_contiguous", "empty"],
)
def test_launch_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    with pytest.raises(error, match=match):
        _check(*_base(change))


@pytest.mark.parametrize("k", range(1, MAX_K + 1))
@pytest.mark.parametrize("c", [7168, 128, 4096, 1536, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launch_checks_take_the_zoos_widths_and_every_k(k, c, dtype):
    """zamba2-7b's x and B/C widths, zamba2-1.2b's and xlstm-125m's, and an
    odd width (the kernel's scalar path), at K 1 to 4, with and without a
    state and a bias."""
    x, w, state, bias = _inputs(k + c, 1, 3, c, k, dtype, True, True)
    _check(x, w, state, bias)
    _check(x, w, None, None)


@pytest.mark.parametrize("with_optional", [False, True], ids=["no_state_no_bias", "state_and_bias"])
def test_plain_backward_takes_operands_left_out(with_optional):
    """``grad.PlainBackward`` with the conv's optional operands as None (the
    card route of a training step) gives the plain version's gradients."""
    x, w, state, bias = _inputs(9, 2, 6, 16, 4, torch.float32, with_optional, with_optional)
    inputs = [t if t is None else t.requires_grad_(True) for t in (x, w, state, bias)]
    y = grad.PlainBackward.apply(causal_conv._plain_y, causal_conv._plain_y, {}, *inputs)
    gy = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(y.shape)).astype(np.float32))
    sources = [t for t in inputs if t is not None]
    got = torch.autograd.grad(y, sources, gy)
    want = torch.autograd.grad(causal_conv_silu_plain(*inputs)[0], sources, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _recording_bundle(calls):
    def recorded(x, w, state=None, bias=None):
        calls.append((tuple(x.shape), tuple(w.shape), None if state is None else tuple(state.shape), bias is not None))
        return causal_conv_silu_plain(x, w, state, bias)

    return dataclasses.replace(ops.PLAIN, causal_conv_silu=recorded)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "zamba2-7b"])
def test_mamba_block_calls_the_bundles_conv_in_prefill_and_decode(arch):
    """``mamba_apply`` and ``mamba_decode`` run x, B and C through the
    bundle's ``causal_conv_silu`` once each, prefill from no state and decode
    from the prefill's states, with a bias where the configuration has one;
    the kernels' bundle gives the same outputs on the CPU, bit for bit."""
    cfg = get_config(arch).reduced()
    params = materialize(ssm.mamba_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(1))
    calls = []
    bundle = _recording_bundle(calls)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 9, cfg.d_model)).astype(np.float32))
    out, st = ssm.mamba_apply(params, x[:, :8], cfg, True, bundle)
    step, _ = ssm.mamba_decode(params, x[:, 8:], cfg, st, bundle)
    d_in = cfg.ssm.expand * cfg.d_model
    n, k = cfg.ssm.n_groups * cfg.ssm.d_state, cfg.ssm.conv_kernel
    bias = bool(cfg.ssm.conv_bias)
    assert calls == [((2, s, c), (k, c), None if s > 1 else (2, k - 1, c), bias)
                     for s in (8, 1) for c in (d_in, n, n)]
    out_k, st_k = ssm.mamba_apply(params, x[:, :8], cfg, True, ops.KERNELS)
    assert _bits(out_k) == _bits(out)
    assert _bits(ssm.mamba_decode(params, x[:, 8:], cfg, st_k)[0]) == _bits(step)


def test_xlstm_blocks_call_the_bundles_conv_in_prefill_and_decode():
    """The mLSTM and sLSTM blocks run their conv4 front through the
    bundle's ``causal_conv_silu``, prefill and decode."""
    cfg = get_config("xlstm-125m").reduced()
    d_in = 2 * cfg.d_model
    mp = materialize(xlstm.mlstm_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(1))
    sp = materialize(xlstm.slstm_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 9, cfg.d_model)).astype(np.float32))
    calls = []
    bundle = _recording_bundle(calls)
    _, st = xlstm.mlstm_apply(mp, x[:, :8], cfg, True, bundle)
    xlstm.mlstm_decode(mp, x[:, 8:], cfg, st, bundle)
    _, st = xlstm.slstm_apply(sp, x[:, :8], cfg, True, kernels=bundle)
    xlstm.slstm_decode(sp, x[:, 8:], cfg, st, bundle)
    assert calls == [((2, 8, d_in), (4, d_in), None, False), ((2, 1, d_in), (4, d_in), (2, 3, d_in), False),
                     ((2, 8, cfg.d_model), (4, cfg.d_model), None, False),
                     ((2, 1, cfg.d_model), (4, cfg.d_model), (2, 3, cfg.d_model), False)]
