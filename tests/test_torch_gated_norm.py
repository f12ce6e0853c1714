"""The Mamba2 mixer's output path (``kernels.gated_norm``) on the CPU:
``gated_rmsnorm_plain`` bit for bit against the expressions the model ran
inline before the kernel (prefill and decode forms, one group and two,
float32 and bfloat16); the wrapper's CPU route, its launch checks and the
model's use of the bundle; and the CUDA kernel's arithmetic emulated in
float32 (its rounding points, its factor for the mean, its order of the
sum of squares) within one unit in the last place of the plain version.
The kernel itself is held to the plain version on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.per_shard import on_shards  # noqa: E402
from repro_torch.kernels import gated_norm, ops  # noqa: E402
from repro_torch.kernels.gated_norm import ULPS, _check, gated_rmsnorm, gated_rmsnorm_plain, ulps  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import materialize, merge_heads, norm_apply  # noqa: E402

EPS = 1e-5


def _inputs(seed, b, s, h, p, dtype, scale_dtype=None):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    y = f(b, s, h, p)
    x = f(b, s, h, p).to(dtype)
    z = (2 * f(b, s, h * p)).to(dtype)
    D = f(h) + 1
    scale = (f(h * p) * 0.1 + 1).to(scale_dtype or dtype)
    return y, x, z, D, scale


def _old_gated_norm(scale, y, groups, eps):
    """``models.ssm._gated_norm`` as it stood before the kernel."""
    if groups == 1:
        return norm_apply({"scale": scale}, y, "rmsnorm", eps)
    yf = y.float().unflatten(-1, (groups, -1))
    yf = yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + eps)
    return (yf.flatten(-2) * scale.float()).to(y.dtype)


def _old_prefill(y, xh, z, D, scale, groups, eps):
    """``mamba_apply``'s skip, then ``_out`` up to the out-projection, as they stood."""
    y = y + D[None, None, :, None] * xh.float()
    b, s, h, p = y.shape
    y = merge_heads(y, y.shape[-2]).reshape((b, s, h * p)).to(z.dtype)
    y = y * F.silu(z)
    return _old_gated_norm(scale, y, groups, eps)


def _old_decode(y, xr, z, D, scale, groups, eps):
    """``mamba_decode``'s skip on (b, h, p), then ``_out``, as they stood."""
    b, h, p = y.shape
    xh = xr.reshape(b, h, p).float()
    y = y + D[None, :, None] * xh
    y = merge_heads(y, y.shape[-2]).reshape((b, 1, h * p)).to(z.dtype)
    y = y * F.silu(z)
    return _old_gated_norm(scale, y, groups, eps)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().tobytes()


@pytest.mark.parametrize("form", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_version_is_bit_identical_to_the_inline_expressions(groups, dtype, form):
    s = 37 if form == "prefill" else 1
    y, x, z, D, scale = _inputs(groups, 3, s, 8, 16, dtype)
    got = gated_rmsnorm_plain(y, x, z, D, scale, groups, EPS)
    if form == "prefill":
        want = _old_prefill(y, x, z, D, scale, groups, EPS)
    else:  # decode held y as (b, h, p) and x as the conv's (b, 1, h·p)
        want = _old_decode(y[:, 0], x.reshape(3, 1, 8 * 16), z, D, scale, groups, EPS)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (3, s, 128)
    assert _bits(got) == _bits(want)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    before = ops.LAUNCHES["gated_rmsnorm"].value
    args = _inputs(3, 2, 5, 8, 16, torch.bfloat16)
    assert _bits(gated_rmsnorm(*args, 2, EPS)) == _bits(gated_rmsnorm_plain(*args, 2, EPS))
    meta = gated_rmsnorm(*(a.to("meta") for a in args), 2, EPS)  # shapes alone: the plain version's
    assert meta.shape == (2, 5, 128) and meta.dtype == torch.bfloat16
    assert ops.LAUNCHES["gated_rmsnorm"].value == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        gated_rmsnorm(other, *args[1:], 2, EPS)


def test_the_bundles_carry_the_kernel_and_its_plain_version():
    assert ops.KERNELS.gated_rmsnorm is gated_rmsnorm
    assert ops.PLAIN.gated_rmsnorm is gated_rmsnorm_plain
    assert ops.LAUNCHES["gated_rmsnorm"] is gated_norm.launches
    args = _inputs(4, 2, 3, 8, 16, torch.float32)
    assert _bits(on_shards(ops.KERNELS).gated_rmsnorm(*args, 1, EPS)) == _bits(gated_rmsnorm_plain(*args, 1, EPS))


def _misaligned(t):
    """``t``'s values, contiguous, one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


def _base(change):
    dtype = change.get("dtype", torch.bfloat16)
    y, x, z, D, scale = _inputs(5, 2, 4, change.get("h", 8), change.get("p", 16), dtype)
    if "y_dtype" in change:
        y = y.to(change["y_dtype"])
    if "scale_dtype" in change:
        scale = scale.to(change["scale_dtype"])
    if change.get("misalign") == "x":
        x = _misaligned(x)
    if change.get("misalign") == "z":
        z = _misaligned(z)
    if "D_len" in change:
        D = D[: change["D_len"]]
    return y, x, z, D, scale, change.get("groups", 2)


@pytest.mark.parametrize(
    "change,error,match",
    [
        (dict(dtype=torch.float16), TypeError, "float32 or bfloat16 activations"),
        (dict(scale_dtype=torch.float64), TypeError, "float32 or bfloat16 scale"),
        (dict(y_dtype=torch.bfloat16), TypeError, "y must be torch.float32"),
        (dict(groups=3), ValueError, "3 groups over 128 channels"),
        (dict(groups=32), ValueError, "multiple of 8"),  # groups of 4 channels
        (dict(p=12, groups=1), ValueError, "head dim"),  # a vector of 8 would straddle two heads
        (dict(h=1025, p=8, groups=1), ValueError, "at most 8192"),  # more vectors than a block's threads
        (dict(D_len=7), ValueError, "D has shape"),
        (dict(misalign="x"), ValueError, "16-byte boundary"),
        (dict(misalign="z"), ValueError, "16-byte boundary"),
    ],
)
def test_launch_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """The CUDA wrapper's checks, which run before any pointer reaches C;
    checked here on CPU tensors."""
    with pytest.raises(error, match=match):
        _check(*_base(change))


def test_launch_checks_take_the_model_shapes():
    for b, s, h, p, groups, dtype, scale_dtype in (
        (3, 16, 112, 64, 2, torch.bfloat16, torch.bfloat16),  # zamba2-7b
        (2, 16, 64, 64, 1, torch.bfloat16, torch.float32),  # zamba2-1.2b, float32 parameters
        (4, 1, 8, 32, 2, torch.float32, torch.float32),  # reduced zamba2-7b, decode
    ):
        y, x, z, D, scale = _inputs(6, b, s, h, p, dtype, scale_dtype)
        _check(y, x, z, D, scale, groups)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "zamba2-7b"])
def test_mamba_block_calls_the_bundles_norm_in_prefill_and_decode(arch):
    """``mamba_apply`` and ``mamba_decode`` hand the scan's output to the
    bundle's ``gated_rmsnorm`` once each, (b, s, h, p) and (b, 1, h, p),
    with the configuration's groups and eps; the plain bundle gives the
    kernels' bundle's outputs on the CPU, bit for bit."""
    cfg = get_config(arch).reduced()
    params = materialize(ssm.mamba_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(1))
    calls = []

    def recorded(y, x, z, D, scale, groups, eps):
        calls.append((tuple(y.shape), tuple(x.shape), tuple(z.shape), groups, eps))
        return gated_rmsnorm_plain(y, x, z, D, scale, groups, eps)

    bundle = dataclasses.replace(ops.PLAIN, gated_rmsnorm=recorded)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 9, cfg.d_model)).astype(np.float32))
    out, st = ssm.mamba_apply(params, x[:, :8], cfg, True, bundle)
    step, _ = ssm.mamba_decode(params, x[:, 8:], cfg, st, bundle)
    d_in = cfg.ssm.expand * cfg.d_model
    nh = d_in // cfg.ssm.head_dim
    assert calls == [((2, 8, nh, cfg.ssm.head_dim), (2, 8, nh, cfg.ssm.head_dim), (2, 8, d_in), cfg.ssm.n_groups,
                      cfg.norm_eps),
                     ((2, 1, nh, cfg.ssm.head_dim), (2, 1, nh, cfg.ssm.head_dim), (2, 1, d_in), cfg.ssm.n_groups,
                      cfg.norm_eps)]
    out_k, st_k = ssm.mamba_apply(params, x[:, :8], cfg, True, ops.KERNELS)
    assert _bits(out_k) == _bits(out)
    assert _bits(ssm.mamba_decode(params, x[:, 8:], cfg, st_k)[0]) == _bits(step)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------
def _act(v, dtype):
    return v.to(dtype).float()


def _emulated(y, x, z, D, scale, groups, eps, threads):
    """``csrc/gated_norm.cu`` in float32 torch ops: the same rounding points,
    the sum of squares in the kernel's order (a thread's 8 channels in
    turn, the xor-shuffle tree over a warp's lanes, then the same tree over
    the warps' sums), the mean as the sum times float(outputs) / numel."""
    dtype = z.dtype
    b, s, h, p = y.shape
    rows, d = b * s, h * p
    w = d // groups
    u = _act(y + D[None, None, :, None] * x.float(), dtype).reshape(rows, groups, w)
    zf = z.float().reshape(rows, groups, w)
    gate = _act(F.silu(zf), dtype)  # the card computes silu as the kernel does; the CPU its own way
    g = _act(u * gate, dtype)
    sq = (g * g).reshape(rows, groups, w // 8, 8)
    per_thread = sq[..., 0]
    for i in range(1, 8):
        per_thread = per_thread + sq[..., i]
    pad = torch.zeros(rows, groups, threads - w // 8)
    lanes = torch.cat([per_thread, pad], -1).reshape(rows, groups, threads // 32, 32)

    def tree(v):  # lane 0 after the shuffles xor 16, 8, 4, 2, 1
        while v.shape[-1] > 1:
            half = v.shape[-1] // 2
            v = v[..., :half] + v[..., half:]
        return v[..., 0]

    warps = tree(lanes)
    total = tree(torch.cat([warps, torch.zeros(rows, groups, 32 - threads // 32)], -1))
    factor = np.float32(rows * groups) / np.float32(rows * d)
    r = torch.rsqrt(total * float(factor) + np.float32(eps))
    out = g * r[..., None] * scale.float().reshape(groups, w)
    return out.to(dtype).reshape(b, s, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,p,groups", [(112, 64, 2), (64, 64, 1), (8, 32, 2)], ids=["zamba2-7b", "zamba2-1.2b", "reduced"])
def test_kernel_arithmetic_emulated_is_within_ulps_of_the_plain_version(h, p, groups, dtype):
    """Only the order of the sum of squares (and the mean's factor) differs
    from the plain version: bfloat16 within one unit in the last place,
    float32 within ``ULPS``."""
    y, x, z, D, scale = _inputs(h + groups, 8, 24, h, p, dtype)
    nvec = h * p // groups // 8
    threads = (nvec + 31) // 32 * 32  # one vector a thread, as the kernel launches at these widths
    got = _emulated(y, x, z, D, scale, groups, EPS, threads)
    want = gated_rmsnorm_plain(y, x, z, D, scale, groups, EPS)
    assert got.dtype == want.dtype
    assert ulps(got, want) <= ULPS[dtype]  # up to 5 units of float32 read here


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ulps_counts_units_in_the_last_place_across_zero(dtype):
    """``ulps``: 0 on equal tensors, 1 between neighbours, and across zero
    the steps on both sides of it (+0 and -0 are one place)."""
    info = torch.finfo(dtype)
    one = torch.tensor([1.0], dtype=dtype)
    assert ulps(one, one) == 0
    assert ulps(one, torch.nextafter(one, torch.tensor([2.0], dtype=dtype))) == 1
    tiny = torch.tensor([info.smallest_normal], dtype=dtype)
    assert ulps(tiny, -tiny) == 2 * ulps(tiny, torch.zeros_like(tiny))
    assert ulps(torch.zeros_like(tiny), -torch.zeros_like(tiny)) == 0
