"""The port's SSD chunk scan and Mamba2 block on the CPU against the JAX
package's: ``ssd_scan_plain`` (what the wrapper runs for CPU tensors)
against the Pallas kernel in interpret mode and the sequential oracle
``ref.ssd_scan_ref``, over ``tests/test_kernels.py``'s sweep; its final
state and ragged lengths against ``repro.models.ssm._ssd_chunked``; and
``mamba_apply`` / ``mamba_decode`` against the reference's on weights
carried over by ``params_from_numpy``.

Tolerances: 2e-4 absolute and relative for the scan (``tests/test_kernels.py``'s:
the chunked form and the sequential recurrence sum in different orders);
1e-4 for the block in float32 (the same arithmetic, sums in another
order).  The CUDA kernel is held to the plain version on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).
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
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import _check, ssd_scan_plain  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import materialize  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, b, s, h, p, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (256, 64)])
@pytest.mark.parametrize("p,n", [(32, 16), (64, 64)])
def test_ssd_scan_plain_matches_pallas_kernel_and_oracle(s, chunk, p, n):
    arrays = _inputs(np.random.default_rng(s + p), 2, s, 3, p, n)
    y, S = ops.ssd_scan(*_t(arrays), chunk=chunk)
    assert y.dtype == S.dtype == torch.float32 and tuple(S.shape) == (2, 3, p, n)
    assert_allclose(y.numpy(), np.asarray(jax_ops.ssd_scan(*_j(arrays), chunk=chunk)), **TOL)
    want_y, want_S = ref.ssd_scan_ref(*_j(arrays))
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(S.numpy(), np.asarray(want_S), **TOL)


@pytest.mark.parametrize("s,chunk", [(100, 32), (77, 64), (1000, 256), (5, 256), (33, 32)])
def test_ssd_scan_plain_ragged_and_final_state_match_model_scan(s, chunk):
    """Lengths no chunk divides (the Pallas kernel asserts against them):
    the reference model pads the tail with dt = 0."""
    arrays = _inputs(np.random.default_rng(s), 2, s, 2, 32, 16)
    y, S = ssd_scan_plain(*_t(arrays), chunk=chunk)
    want_y, want_S = ref_ssm._ssd_chunked(*_j(arrays), chunk)
    assert tuple(y.shape) == (2, s, 2, 32)
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(S.numpy(), np.asarray(want_S), **TOL)


def test_ssd_scan_plain_takes_bfloat16_inputs():
    """x, B and C in bfloat16 (the serving type): the scan computes in
    float32 from the rounded values, as the reference model does."""
    x, dt, A, B, C = _inputs(np.random.default_rng(4), 1, 96, 2, 64, 32)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    y, S = ssd_scan_plain(xb, torch.from_numpy(dt), torch.from_numpy(A), Bb, Cb, chunk=32)
    want_y, want_S = ref.ssd_scan_ref(*_j((xb.float().numpy(), dt, A, Bb.float().numpy(), Cb.float().numpy())))
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(S.numpy(), np.asarray(want_S), **TOL)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _ssd_two_pass(x, dt, A, B, C, chunk, lo=True):
    """The bf16 CUDA path of ``ssd_scan`` emulated in float32 PyTorch: pass 1
    gives each chunk its own end state and total decay, all chunks alike;
    pass 2 carries the state chunk after chunk; pass 3 forms M = (C·Bᵀ) ⊙
    decay ⊙ dt with the kernel's factored decay below the diagonal's
    16 × 16 slices and y = M·x + exp(cs)·C·S_prevᵀ.  Every product with a
    float32 operand runs on bf16 parts: M as hi + lo, x·w and S_prev, whose
    errors the carry sums over every earlier chunk, as hi + mid + lo;
    ``lo=False`` keeps only the hi parts."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xh, dth = x.permute(0, 2, 1, 3).float(), dt.permute(0, 2, 1).float()  # (b, h, s, p), (b, h, s)
    Bf, Cf = B.float()[:, None], C.float()[:, None]  # (b, 1, s, n): one group for every head

    def split_mm(a_f32, b_exact, parts=2):
        out, rest = 0.0, a_f32
        for _ in range(parts if lo else 1):
            part = _bf16(rest)
            out, rest = out + part @ b_exact, rest - part
        return out

    bounds = [(c0, min(c0 + chunk, s)) for c0 in range(0, s, chunk)]
    css, locals_ = [], []
    for c0, c1 in bounds:  # pass 1
        cs = torch.cumsum(dth[..., c0:c1] * A[None, :, None], dim=-1)
        w = torch.exp(cs[..., -1:] - cs) * dth[..., c0:c1]
        css.append(cs)
        locals_.append(split_mm((xh[:, :, c0:c1] * w[..., None]).transpose(-1, -2), Bf[:, :, c0:c1], 3))
    S, prev = torch.zeros((b, h, p, n)), []
    for cs, local in zip(css, locals_):  # pass 2
        prev.append(S)
        S = torch.exp(cs[..., -1])[..., None, None] * S + local
    ys = []
    for ci, (c0, c1) in enumerate(bounds):  # pass 3
        lc = c1 - c0
        cs = css[ci]
        cs_pad = torch.cat([cs, cs[..., -1:].expand(b, h, 256 - lc)], dim=-1)  # dt = 0 past the chunk
        d = dth[..., c0:c1]
        i = torch.arange(lc)
        r0, r1 = i // 16 * 16, torch.clamp((i // 16 + 1) * 16, max=255)
        alpha = torch.exp(cs - cs_pad[..., r0])
        bj = torch.exp(cs_pad[..., r1] - cs) * d
        beta = torch.exp(cs_pad[..., r0][..., :, None] - cs_pad[..., r1][..., None, :])
        below = (i[None, :] // 16) < (i[:, None] // 16)
        diag = ((i[None, :] // 16) == (i[:, None] // 16)) & (i[None, :] <= i[:, None])
        G = Cf[:, :, c0:c1] @ Bf[:, :, c0:c1].transpose(-1, -2)
        M = torch.where(below, G * ((alpha[..., :, None] * beta) * bj[..., None, :]),
                        torch.where(diag, G * torch.exp(cs[..., :, None] - cs[..., None, :]) * d[..., None, :], 0.0))
        y = torch.exp(cs)[..., None] * split_mm(prev[ci], Cf[:, :, c0:c1].transpose(-1, -2), 3).transpose(-1, -2)
        ys.append(y + split_mm(M, xh[:, :, c0:c1]))
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


def _bf16_inputs(s):
    x, dt, A, B, C = _inputs(np.random.default_rng(s), 1, s, 2, 64, 64)
    return tuple(_bf16(torch.from_numpy(a)).numpy() for a in (x,)) + (dt, A) + tuple(
        _bf16(torch.from_numpy(a)).numpy() for a in (B, C))


@pytest.mark.parametrize("s", [512, 1000])
def test_ssd_two_pass_bf16_split_numerics_match_reference(s):
    """The algebra and precision budget of the bf16 CUDA kernels, proven on
    the CPU before the card: chunk states first, the carry over them, then
    every chunk's outputs, with bf16 hi + lo operands and the factored
    decay, at zamba2-1.2b's p = n = 64 and 256-row chunks (two,
    and a ragged last one), against the Pallas kernel (interpret mode; it
    takes only whole chunks) and the sequential oracle, within 2e-4.  x, B
    and C are bf16 values, as the model hands them."""
    arrays = _bf16_inputs(s)
    y, S = _ssd_two_pass(*_t(arrays), chunk=256)
    want_y, want_S = ref.ssd_scan_ref(*_j(arrays))
    if s % 256 == 0:
        assert_allclose(y.numpy(), np.asarray(jax_ops.ssd_scan(*_j(arrays), chunk=256)), **TOL)
    assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert_allclose(S.numpy(), np.asarray(want_S), **TOL)


def test_ssd_two_pass_without_the_lo_halves_misses_the_tolerance():
    """bf16 operands alone (2^-9 relative) are not enough for 2e-4: the lo
    parts of the split are what the tolerance needs."""
    arrays = _bf16_inputs(512)
    y, S = _ssd_two_pass(*_t(arrays), chunk=256, lo=False)
    want_y, want_S = ref.ssd_scan_ref(*_j(arrays))
    assert not np.allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert not np.allclose(S.numpy(), np.asarray(want_S), **TOL)


@pytest.mark.parametrize(
    "change,error,match",
    [
        (dict(p=48), ValueError, "takes p in"),
        (dict(n=256), ValueError, "n in"),
        (dict(chunk=512), ValueError, "at most 256"),
        (dict(dtype=torch.float16), TypeError, "float32 or bfloat16"),
        (dict(dt_dtype=torch.bfloat16), TypeError, "dt must be torch.float32"),
        (dict(c_len=7), ValueError, "C has shape"),
    ],
)
def test_ssd_scan_launch_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """The CUDA wrapper's checks, which run before any pointer reaches C;
    checked here on CPU tensors."""
    p, n, chunk = change.get("p", 32), change.get("n", 16), change.get("chunk", 64)
    dtype = change.get("dtype", torch.float32)
    s = 300  # longer than a chunk the kernel takes
    x = torch.zeros((1, s, 2, p), dtype=dtype)
    dt = torch.zeros((1, s, 2), dtype=change.get("dt_dtype", torch.float32))
    B = torch.zeros((1, s, n), dtype=dtype)
    C = torch.zeros((1, change.get("c_len", s), n), dtype=dtype)
    with pytest.raises(error, match=match):
        _check(x, dt, torch.zeros(2), B, C, chunk)


def test_ssd_scan_wrapper_refuses_other_devices_and_counts_no_cpu_call():
    before = ops.LAUNCHES["ssd_scan"].value
    arrays = _t(_inputs(np.random.default_rng(1), 1, 8, 2, 32, 16))
    ops.ssd_scan(*arrays, chunk=4)
    assert ops.LAUNCHES["ssd_scan"].value == before
    meta = ops.ssd_scan(*(a.to("meta") for a in arrays), chunk=4)  # shapes alone: the plain version's
    assert [t.shape for t in meta] == [t.shape for t in ops.ssd_scan(*arrays, chunk=4)]
    assert ops.LAUNCHES["ssd_scan"].value == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.ssd_scan(other, *arrays[1:])


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba_pair():
    """(reference cfg, reference layer params, port cfg, port layer params)
    of reduced zamba2-1.2b's first Mamba2 block, converted weights."""
    rcfg, cfg = ref_config("zamba2-1.2b").reduced(), get_config("zamba2-1.2b").reduced()
    rparams, _ = ref_build(rcfg).init(jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    return rcfg, rparams["layers"][0]["mamba"], cfg, params["layers"][0]["mamba"]


def _x(cfg, s, seed=5):
    return np.random.default_rng(seed).normal(size=(2, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [45, 64, 7])
def test_mamba_apply_matches_reference(mamba_pair, s):
    rcfg, rp, cfg, p = mamba_pair
    x = _x(cfg, s)
    want, want_st = ref_ssm.mamba_apply(rp, jnp.asarray(x), rcfg, return_state=True)
    got, st = ssm.mamba_apply(p, torch.from_numpy(x), cfg, return_state=True)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert sorted(st) == sorted(want_st)
    for name in st:
        assert tuple(st[name].shape) == want_st[name].shape
        assert_allclose(st[name].numpy(), np.asarray(want_st[name]), rtol=1e-4, atol=1e-4)
    assert_allclose(ssm.mamba_apply(p, torch.from_numpy(x), cfg).numpy(), got.numpy(), rtol=0, atol=0)


def test_mamba_decode_matches_reference(mamba_pair):
    """Four decode steps from a prefilled state, against the reference's
    O(1) update."""
    rcfg, rp, cfg, p = mamba_pair
    x = _x(cfg, 40, seed=6)
    _, want_st = ref_ssm.mamba_apply(rp, jnp.asarray(x[:, :36]), rcfg, return_state=True)
    _, st = ssm.mamba_apply(p, torch.from_numpy(x[:, :36]), cfg, return_state=True)
    for i in range(36, 40):
        want, want_st = ref_ssm.mamba_decode(rp, jnp.asarray(x[:, i : i + 1]), rcfg, want_st)
        got, st = ssm.mamba_decode(p, torch.from_numpy(x[:, i : i + 1]), cfg, st)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for name in st:
        assert_allclose(st[name].numpy(), np.asarray(want_st[name]), rtol=1e-4, atol=1e-4)


def test_mamba_decode_continues_the_full_sequence(mamba_pair):
    """The port's own consistency: prefill of 30 positions, then 6 decode
    steps, gives the full sequence's outputs."""
    _, _, cfg, p = mamba_pair
    x = torch.from_numpy(_x(cfg, 36, seed=7))
    full = ssm.mamba_apply(p, x, cfg)
    _, st = ssm.mamba_apply(p, x[:, :30], cfg, return_state=True)
    for i in range(30, 36):
        y, st = ssm.mamba_decode(p, x[:, i : i + 1], cfg, st)
        assert_allclose(y.numpy(), full[:, i : i + 1].numpy(), rtol=1e-4, atol=1e-4)


def test_make_ssm_cache_has_the_reference_layout():
    rcfg, cfg = ref_config("zamba2-1.2b").reduced(), get_config("zamba2-1.2b").reduced()
    want = ref_ssm.make_ssm_cache(rcfg, 3, 5, jnp.float32)
    got = materialize(ssm.ssm_cache_spec(cfg, 3, 5, torch.float32), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert got["ssm"].dtype == torch.float32
