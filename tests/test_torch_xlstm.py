"""The port's chunkwise mLSTM and xLSTM blocks on the CPU against the JAX
package's: ``mlstm_chunk_plain`` (what the wrapper runs for CPU tensors)
against the Pallas kernel in interpret mode and the sequential oracle
``ref.mlstm_chunk_ref``, over ``tests/test_kernels.py``'s sweep; its final
(C, n, m) and ragged lengths against ``repro.models.xlstm._mlstm_cell_scan``;
and the mLSTM and sLSTM blocks (full sequence and decode) against the
reference's on weights carried over by ``params_from_numpy``.

Tolerances: 5e-4 absolute and relative for the cell
(``tests/test_kernels.py``'s: the chunkwise and recurrent forms sum in
different orders, and the denominator max(|q·n|, e^-m) amplifies that
where |q·n| is small); 1e-4 for the blocks in float32.  The CUDA kernel is
held to the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import types
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import _check, mlstm_chunk_plain  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import materialize  # noqa: E402

TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(rng, b, s, h, d):
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    li = rng.normal(size=(b, s, h)).astype(np.float32)
    lf = (rng.normal(size=(b, s, h)) - 1.0).astype(np.float32)
    return q, k, v, li, lf


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,chunk,d", [(64, 16, 32), (128, 64, 64)])
def test_mlstm_chunk_plain_matches_pallas_kernel_and_oracle(s, chunk, d):
    arrays = _inputs(np.random.default_rng(s + d), 2, s, 2, d)
    y, C, n, m = ops.mlstm_chunk(*_t(arrays), chunk=chunk)
    assert (tuple(C.shape), tuple(n.shape), tuple(m.shape)) == ((2, 2, d, d), (2, 2, d), (2, 2))
    assert_allclose(y.numpy(), np.asarray(jax_ops.mlstm_chunk(*_j(arrays), chunk=chunk)), **TOL)
    assert_allclose(y.numpy(), np.asarray(ref.mlstm_chunk_ref(*_j(arrays))), **TOL)


@pytest.mark.parametrize("s,chunk,d", [(64, 16, 32), (100, 32, 64), (77, 256, 32), (300, 256, 384), (1, 256, 64)])
def test_mlstm_chunk_plain_final_state_and_ragged_match_cell_scan(s, chunk, d):
    """The final (C, n, m) equals the recurrent scan's final carry; lengths
    no chunk divides (the Pallas kernel asserts against them) give the
    scan's outputs.  The scan starts m at -inf, the chunk form at -1e30."""
    arrays = _inputs(np.random.default_rng(s * 3 + d), 2, s, 2, d)
    y, C, n, m = mlstm_chunk_plain(*_t(arrays), chunk=chunk)
    want_y, (want_C, want_n, want_m) = ref_xl._mlstm_cell_scan(*_j(arrays))
    assert tuple(y.shape) == (2, s, 2, d)
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(C.numpy(), np.asarray(want_C), **TOL)
    assert_allclose(n.numpy(), np.asarray(want_n), **TOL)
    assert_allclose(m.numpy(), np.asarray(want_m), **TOL)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_mm(a, b_f32):
    """a @ b with b float32 carried as bf16 hi + lo (a is bf16-exact): two
    bf16 products into one float32 sum, as the CUDA kernels issue them."""
    hi = _bf16(b_f32)
    return a @ hi + a @ _bf16(b_f32 - hi)


def _split_mm_left(a_f32, b):
    hi = _bf16(a_f32)
    return hi @ b + _bf16(a_f32 - hi) @ b


def _mlstm_two_pass(q, k, v, li, lf, chunk):
    """The bf16 CUDA path of ``mlstm_chunk`` emulated in float32 PyTorch:
    pass 1 walks the chunks with the TPU kernel's carry and keeps the state
    before each chunk, pass 2 computes every chunk's outputs from that
    state.  Every product with a float32 operand runs as bf16 hi + lo."""
    b, s, h, d = q.shape
    scale = d**-0.5

    def heads(a):
        return a.permute(0, 2, 1, 3).reshape(b * h, s, -1).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    lih, lfh = heads(li[..., None])[..., 0], heads(lf[..., None])[..., 0]
    bounds = [(c0, min(c0 + chunk, s)) for c0 in range(0, s, chunk)]
    # pass 1: the states before each chunk, and the final one
    C = torch.zeros((b * h, d, d))
    n = torch.zeros((b * h, d))
    m = torch.full((b * h,), -1e30)
    prev = []
    for c0, c1 in bounds:
        prev.append((C, n, m))
        cf = torch.cumsum(lfh[:, c0:c1], dim=-1)
        last = cf[:, -1]
        x = last[:, None] - cf + lih[:, c0:c1]
        m_carry = torch.maximum(m + last, x.amax(dim=-1))
        kw = kh[:, c0:c1] * torch.exp(x - m_carry[:, None])[..., None]
        decay = torch.exp(m + last - m_carry)
        C = decay[:, None, None] * C + _split_mm_left(kw.transpose(1, 2), vh[:, c0:c1])
        n = decay[:, None] * n + kw.sum(dim=1)
        m = m_carry
    # pass 2: every chunk's outputs from the state before it
    ys = []
    for (c0, c1), (C_p, n_p, m_p) in zip(bounds, prev):
        qc, kc, vc = qh[:, c0:c1], kh[:, c0:c1], vh[:, c0:c1]
        cf = torch.cumsum(lfh[:, c0:c1], dim=-1)
        lc = c1 - c0
        keep = torch.ones((lc, lc), dtype=torch.bool).tril()
        w = (cf[:, :, None] - cf[:, None, :] + lih[:, None, c0:c1]).masked_fill(~keep, -1e30)
        b_row = cf + m_p[:, None]
        m_row = torch.maximum(w.amax(dim=-1), b_row)
        D = torch.exp(w - m_row[..., None])
        inter = torch.exp(b_row - m_row)
        sD = (qc @ kc.transpose(1, 2)) * D
        num = _split_mm_left(sD * scale, vc) + (inter * scale)[..., None] * _split_mm(qc, C_p)
        den = torch.maximum((sD.sum(dim=-1) + inter * (qc @ n_p[..., None])[..., 0]).abs() * scale, torch.exp(-m_row))
        ys.append(num / den[..., None])
    y = torch.cat(ys, dim=1).reshape(b, h, s, d).permute(0, 2, 1, 3)
    return y, C.reshape(b, h, d, d), n.reshape(b, h, d), m.reshape(b, h)


@pytest.mark.parametrize("s", [1024, 1000])
def test_mlstm_two_pass_bf16_split_numerics_match_reference(s):
    """The algebra and precision budget of the bf16 CUDA kernels, proven on
    the CPU before the card: states first, then every chunk's outputs from
    the state before it, with bf16 hi + lo operands, at xlstm-125m's d = 384
    and 256-row chunks (four, and a ragged last one), against the Pallas kernel (interpret mode; it takes only
    whole chunks) and the recurrent scan, within 5e-4.  q, k and v are
    bf16 values, as the model hands them."""
    rng = np.random.default_rng(s)
    q, k, v, li, lf = _inputs(rng, 1, s, 2, 384)
    q, k, v = (_bf16(torch.from_numpy(a)).numpy() for a in (q, k, v))
    y, C, n, m = _mlstm_two_pass(*_t((q, k, v, li, lf)), chunk=256)
    want_y, (want_C, want_n, want_m) = ref_xl._mlstm_cell_scan(*_j((q, k, v, li, lf)))
    if s % 256 == 0:
        assert_allclose(y.numpy(), np.asarray(jax_ops.mlstm_chunk(*_j((q, k, v, li, lf)), chunk=256)), **TOL)
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(C.numpy(), np.asarray(want_C), **TOL)
    assert_allclose(n.numpy(), np.asarray(want_n), **TOL)
    assert_allclose(m.numpy(), np.asarray(want_m), **TOL)


@pytest.mark.parametrize(
    "change,error,match",
    [
        (dict(d=48), ValueError, "head dims"),
        (dict(chunk=300), ValueError, "at most 256"),
        (dict(dtype=torch.float16), TypeError, "float32 or bfloat16"),
        (dict(li_dtype=torch.bfloat16), TypeError, "log_i must be torch.float32"),
        (dict(v_len=9), ValueError, "v has shape"),
    ],
)
def test_mlstm_chunk_launch_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """The CUDA wrapper's checks, which run before any pointer reaches C;
    checked here on CPU tensors."""
    d, dtype, s = change.get("d", 32), change.get("dtype", torch.float32), 300
    q = torch.zeros((1, s, 2, d), dtype=dtype)
    v = torch.zeros((1, change.get("v_len", s), 2, d), dtype=dtype)
    li = torch.zeros((1, s, 2), dtype=change.get("li_dtype", torch.float32))
    with pytest.raises(error, match=match):
        _check(q, q, v, li, torch.zeros((1, s, 2)), change.get("chunk", 256))


def test_mlstm_chunk_wrapper_refuses_other_devices_and_counts_no_cpu_call():
    before = ops.LAUNCHES["mlstm_chunk"].value
    arrays = _t(_inputs(np.random.default_rng(1), 1, 8, 2, 32))
    ops.mlstm_chunk(*arrays, chunk=4)
    assert ops.LAUNCHES["mlstm_chunk"].value == before
    meta = ops.mlstm_chunk(*(a.to("meta") for a in arrays), chunk=4)  # shapes alone: the plain version's
    assert [t.shape for t in meta] == [t.shape for t in ops.mlstm_chunk(*arrays, chunk=4)]
    assert ops.LAUNCHES["mlstm_chunk"].value == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.mlstm_chunk(other, *arrays[1:])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xl_pair():
    """(reference cfg, reference params, port cfg, port params) of reduced
    xlstm-125m (layers 0, 1 and 3 mLSTM, layer 2 sLSTM), converted weights."""
    rcfg, cfg = ref_config("xlstm-125m").reduced(), get_config("xlstm-125m").reduced()
    rparams, _ = ref_build(rcfg).init(jax.random.PRNGKey(3))
    return rcfg, rparams, cfg, params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(size=(2, s, cfg.d_model)).astype(np.float32)


def _close(got, want):
    """Each leaf of a port state (nested dicts of tensors) against the
    reference's, within 1e-4."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k])
        return
    assert tuple(got.shape) == want.shape
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,layer", [("mlstm", 0), ("slstm", 2)])
def test_blocks_match_reference_over_the_sequence_and_in_decode(xl_pair, kind, layer):
    """``*_apply`` over 37 positions (state included), then three decode
    steps from that state."""
    rcfg, rparams, cfg, params = xl_pair
    rp, p = rparams["layers"][layer][kind], params["layers"][layer][kind]
    rmod_apply, rmod_decode = getattr(ref_xl, f"{kind}_apply"), getattr(ref_xl, f"{kind}_decode")
    apply, decode = getattr(xlstm, f"{kind}_apply"), getattr(xlstm, f"{kind}_decode")
    x = _x(cfg, 40, seed=layer)
    want, want_st = rmod_apply(rp, jnp.asarray(x[:, :37]), rcfg, return_state=True)
    got, st = apply(p, torch.from_numpy(x[:, :37]), cfg, return_state=True)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _close(st, want_st)
    for i in range(37, 40):
        want, want_st = rmod_decode(rp, jnp.asarray(x[:, i : i + 1]), rcfg, want_st)
        got, st = decode(p, torch.from_numpy(x[:, i : i + 1]), cfg, st)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _close(st, want_st)


def test_mlstm_decode_from_the_empty_state_matches_reference(xl_pair):
    """Decode from ``xlstm_cache_spec``'s state (m = -1e30), as the
    reference's decode runs from its own."""
    rcfg, rparams, cfg, params = xl_pair
    rcache = ref_xl.make_xlstm_cache(rcfg, 2, jnp.float32)
    cache = materialize(xlstm.xlstm_cache_spec(cfg, 2, torch.float32), "cpu")
    _close(cache[2], rcache[2])
    want_st, st = rcache[0], cache[0]
    _close(st, want_st)
    x = _x(cfg, 3, seed=9)
    for i in range(3):
        want, want_st = ref_xl.mlstm_decode(rparams["layers"][0]["mlstm"], jnp.asarray(x[:, i : i + 1]), rcfg, want_st)
        got, st = xlstm.mlstm_decode(params["layers"][0]["mlstm"], torch.from_numpy(x[:, i : i + 1]), cfg, st)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _close(st, want_st)


def test_mlstm_decode_continues_the_full_sequence(xl_pair):
    """The port's own consistency: the kernel path's prefill of 30
    positions, then 6 one-step recurrences, gives the full sequence's
    outputs."""
    _, _, cfg, params = xl_pair
    p = params["layers"][1]["mlstm"]
    x = torch.from_numpy(_x(cfg, 36, seed=8))
    full = xlstm.mlstm_apply(p, x, cfg)
    _, st = xlstm.mlstm_apply(p, x[:, :30], cfg, return_state=True)
    for i in range(30, 36):
        y, st = xlstm.mlstm_decode(p, x[:, i : i + 1], cfg, st)
        assert_allclose(y.numpy(), full[:, i : i + 1].numpy(), rtol=1e-4, atol=1e-4)
