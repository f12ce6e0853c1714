"""The model's RMSNorm (``kernels.rms_norm``) on the CPU: ``rms_norm_plain``
bit for bit against the expressions ``models.layers.norm_apply`` ran before
the kernel (float32 and bfloat16, the zoo's widths); the wrapper's CPU
route, its launch checks and the bundles; the CUDA kernel's arithmetic
emulated in float32 (its order of the sum of squares for each launch shape,
its factor for the mean) within ``gated_norm.ULPS`` of the plain version;
and the models' use of the bundle's norm: 108 a zamba2-7b forward and 81 a
granite-4.0-h-small forward at their published widths (on meta tensors),
and the reduced models' forward, prefill and decode.  The kernel itself is
held to the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.per_shard import on_shards  # noqa: E402
from repro_torch.kernels import ops, rms_norm as rms_norm_mod  # noqa: E402
from repro_torch.kernels.gated_norm import ulps  # noqa: E402
from repro_torch.kernels.rms_norm import MAX_WIDTH, ULPS, _check, rms_norm, rms_norm_plain  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.layers import materialize, meta_of, norm_apply  # noqa: E402

EPS = 1e-5


def _old_norm_apply(params, x, kind, eps=1e-6):
    """``models.layers.norm_apply`` as it stood before the kernel."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def _inputs(seed, shape, dtype, scale_dtype=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)).to(scale_dtype or dtype)
    return x, scale


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().tobytes()


@pytest.mark.parametrize("width", [64, 3584, 4096, 7168])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_is_bit_identical_to_the_old_norm_apply(width, dtype):
    x, scale = _inputs(width, (3, 7, width), dtype)
    want = _old_norm_apply({"scale": scale}, x, "rmsnorm", EPS)
    for got in (rms_norm_plain(x, scale, EPS), norm_apply({"scale": scale}, x, "rmsnorm", EPS),
                norm_apply({"scale": scale}, x, "rmsnorm", EPS, kernels=ops.KERNELS)):
        assert got.dtype == want.dtype == dtype and got.shape == want.shape == (3, 7, width)
        assert _bits(got) == _bits(want)
    bias = torch.from_numpy(np.linspace(-1, 1, width, dtype=np.float32)).to(dtype)
    layer = {"scale": scale, "bias": bias}  # layer norm stays plain, with or without a bundle
    want = _old_norm_apply(layer, x, "layernorm", EPS)
    assert _bits(norm_apply(layer, x, "layernorm", EPS, kernels=ops.KERNELS)) == _bits(want)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    before = ops.LAUNCHES["rms_norm"].value
    x, scale = _inputs(3, (2, 5, 128), torch.bfloat16)
    assert _bits(rms_norm(x, scale, EPS)) == _bits(rms_norm_plain(x, scale, EPS))
    meta = rms_norm(x.to("meta"), scale.to("meta"), EPS)  # shapes alone: the plain version's
    assert meta.shape == (2, 5, 128) and meta.dtype == torch.bfloat16
    assert ops.LAUNCHES["rms_norm"].value == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        rms_norm(other, scale, EPS)


def test_the_bundles_carry_the_kernel_and_its_plain_version():
    assert ops.KERNELS.rms_norm is rms_norm
    assert ops.PLAIN.rms_norm is rms_norm_plain
    assert ops.LAUNCHES["rms_norm"] is rms_norm_mod.launches
    x, scale = _inputs(4, (2, 3, 256), torch.float32)
    assert _bits(on_shards(ops.KERNELS).rms_norm(x, scale, EPS)) == _bits(rms_norm_plain(x, scale, EPS))
    assert _bits(on_shards(ops.PLAIN).rms_norm(x, scale, EPS)) == _bits(rms_norm_plain(x, scale, EPS))


def _misaligned(t):
    """``t``'s values, contiguous, one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


def _base(change):
    dtype = change.get("dtype", torch.bfloat16)
    width = change.get("width", 256)
    x, scale = _inputs(5, (4, 6, width), dtype, change.get("scale_dtype"))
    if change.get("layout") == "transposed":  # the last dim 8 elements apart
        x = torch.zeros((4, width, 8), dtype=dtype).transpose(1, 2)
    if change.get("layout") == "misaligned":
        x = _misaligned(x)
    if change.get("layout") == "padded_rows":  # rows 260 bf16 apart: 520 bytes, off the 16-byte grid
        x = torch.zeros((4, 6, width + 4), dtype=dtype)[..., :width]
    if change.get("layout") == "uneven":  # the leading dims cannot merge into one stride
        x = torch.zeros((6, 4, width), dtype=dtype).transpose(0, 1)
    if change.get("layout") == "overlapping":
        x = x[0, 0].expand(8, width)
    if "scale_len" in change:
        scale = scale[: change["scale_len"]]
    return x, scale


@pytest.mark.parametrize(
    "change,error,match",
    [
        (dict(dtype=torch.float16), TypeError, "float32 or bfloat16 activations"),
        (dict(scale_dtype=torch.float64), TypeError, "float32 or bfloat16 scale"),
        (dict(width=MAX_WIDTH + 8), ValueError, "a width of 8200"),
        (dict(width=100), ValueError, "multiple of 8"),
        (dict(scale_len=128), ValueError, "scale has shape"),
        (dict(layout="transposed"), ValueError, "last dim must be contiguous"),
        (dict(layout="misaligned"), ValueError, "16-byte boundary"),
        (dict(layout="padded_rows"), ValueError, "16-byte boundary"),
        (dict(layout="uneven"), ValueError, "not one stride apart"),
        (dict(layout="overlapping"), ValueError, "overlap"),
    ],
)
def test_launch_checks_refuse_what_the_kernel_does_not_take(change, error, match):
    """The CUDA wrapper's checks, which run before any pointer reaches C;
    checked here on CPU tensors."""
    with pytest.raises(error, match=match):
        _check(*_base(change))


def test_launch_checks_take_the_model_shapes():
    for x, scale_dtype in (
        (torch.zeros((3, 2, 3584), dtype=torch.bfloat16), None),  # zamba2-7b's stream
        (torch.zeros((3, 2, 7168), dtype=torch.bfloat16), None),  # zamba2-7b's ln_a over cat(x, emb)
        (torch.zeros((4, 1, 4096), dtype=torch.bfloat16), torch.float32),  # a decode step, float32 parameters
        (torch.zeros((2, 5, 8, 128), dtype=torch.bfloat16), None),  # q/k norms over the head dim
        (torch.zeros((3, 64, 3584), dtype=torch.bfloat16)[:, -1:], None),  # prefill's final norm: the last position
        (torch.zeros((5, 8), dtype=torch.float32), None),  # the narrowest row
        (torch.zeros((2, MAX_WIDTH), dtype=torch.float32), None),
    ):
        _check(x, torch.ones(x.shape[-1], dtype=scale_dtype or x.dtype))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------
def _launch_shape(width: int) -> tuple:
    """(vectors a thread, threads a row) as ``dacp_rms_norm`` picks them."""
    nvec = width // 8
    vecs = 2 if nvec > 256 else 1
    per_thread = -(-nvec // vecs)
    if per_thread <= 32:
        return vecs, 1 << (per_thread - 1).bit_length()
    return vecs, -(-per_thread // 32) * 32


def _tree(v):
    """Lane 0 after the xor shuffles, offsets from half the lanes down to 1."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _emulated(x, scale, eps):
    """``csrc/rms_norm.cu`` in float32 torch ops: thread t sums the squares
    of its vectors t, t + lanes, ... channel by channel; a row of at most 32
    lanes sums them by one shuffle tree, a wider one by each warp's tree,
    then the same tree over the warps' sums; the mean as the sum times
    float(outputs) / numel."""
    width = x.shape[-1]
    rows = x.reshape(-1, width).float()
    n = rows.shape[0]
    v, lanes = _launch_shape(width)
    sq = (rows * rows).reshape(n, width // 8, 8)
    sq = torch.cat([sq, torch.zeros(n, v * lanes - width // 8, 8)], 1).reshape(n, v, lanes, 8)
    per_thread = torch.zeros(n, lanes)
    for k in range(v):
        for i in range(8):
            per_thread = per_thread + sq[:, k, :, i]
    if lanes <= 32:
        total = _tree(per_thread)
    else:
        warps = _tree(per_thread.reshape(n, lanes // 32, 32))
        total = _tree(torch.cat([warps, torch.zeros(n, 32 - lanes // 32)], -1))
    factor = np.float32(n) / np.float32(n * width)
    r = torch.rsqrt(total * float(factor) + np.float32(eps))
    out = rows * r[:, None] * scale.float()
    return out.to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [8, 64, 128, 256, 384, 512, 2048, 2056, 3584, 4096, 7168, 8192])
def test_kernel_arithmetic_emulated_is_within_ulps_of_the_plain_version(width, dtype):
    """Only the order of the sum of squares (and the mean's factor) differs
    from the plain version: bfloat16 within one unit in the last place,
    float32 within ``ULPS``, at each launch shape the widths pick."""
    x, scale = _inputs(width, (max(8, 65536 // width), width), dtype)
    got = _emulated(x, scale, EPS)
    want = rms_norm_plain(x, scale, EPS)
    assert got.dtype == want.dtype
    assert ulps(got, want) <= ULPS[dtype]


def test_launch_shapes_follow_the_width():
    """Runs of lanes up to 32 vectors a row (several rows a block), then a
    block a row, with two vectors a thread above 256 vectors."""
    assert [_launch_shape(w) for w in (8, 64, 128, 256)] == [(1, 1), (1, 8), (1, 16), (1, 32)]
    assert [_launch_shape(w) for w in (384, 512, 2048, 2056, 3584, 4096, 7168, 8192)] == [
        (1, 64), (1, 64), (1, 256), (2, 160), (2, 224), (2, 256), (2, 448), (2, 512)]


# ---------------------------------------------------------------------------
# the models' use of the bundle
# ---------------------------------------------------------------------------
def _counting(counts: list, bundle=ops.PLAIN):
    def counted(x, scale, eps):
        counts.append((tuple(x.shape), eps))
        return rms_norm_plain(x, scale, eps)

    return dataclasses.replace(bundle, rms_norm=counted)


@pytest.mark.parametrize("arch,norms", [("zamba2-7b", 81 + 2 * 13 + 1), ("granite-4.0-h-small", 2 * 40 + 1)])
def test_a_published_forward_calls_the_bundles_norm_before_every_block(arch, norms):
    """At the published widths, on meta tensors: zamba2-7b's 81 Mamba2
    layers, ln_a and ln_m in each of the 13 shared-block applications and
    the final norm; granite-4.0-h-small's ln1 and ln2 in each of 40 layers
    and the final norm; each with the configuration's eps."""
    cfg = get_config(arch)
    counts = []
    tokens = torch.zeros((1, 256), dtype=torch.int64, device="meta")
    lm.forward(meta_of(lm.spec(cfg)), tokens, cfg, _counting(counts))
    assert len(counts) == norms
    assert {eps for _, eps in counts} == {cfg.norm_eps}
    widths = sorted({shape[-1] for shape, _ in counts})
    assert widths == ([cfg.d_model, 2 * cfg.d_model] if cfg.hybrid_layer_ids else [cfg.d_model])


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-4.0-h-small", "granite-3-8b", "chameleon-34b", "xlstm-125m"])
def test_reduced_models_call_the_bundles_norm_in_forward_prefill_and_decode(arch):
    """A reduced model's forward, prefill and one decode step each call the
    bundle's norm as often as its layout has norms (the q/k norms and the
    xLSTM blocks' inner norms included), and the counting bundle gives the
    kernels' bundle's logits on the CPU, bit for bit."""
    cfg = get_config(arch).reduced()
    if cfg.block_pattern == "zamba2":
        norms = cfg.n_layers + 2 * len(cfg.hybrid_layer_ids) + 1
    elif cfg.block_pattern == "xlstm":  # one inner norm a block; the block and final norms are layer norms
        norms = cfg.n_layers
    else:
        norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    params = lm.init(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 259, (2, 9)).astype(np.int64))
    counts = []
    bundle = _counting(counts, ops.KERNELS)
    logits, _ = lm.forward(params, tokens, cfg, bundle)
    assert len(counts) == norms
    assert _bits(logits) == _bits(lm.forward(params, tokens, cfg)[0])
    counts.clear()
    last, cache = lm.prefill(params, tokens[:, :8], cfg, 16, bundle)
    assert len(counts) == norms
    counts.clear()
    step, _ = lm.decode_step(params, tokens[:, 8:], cache, cfg, bundle)
    assert len(counts) == norms
    assert all(shape[:2] == (2, 1) for shape, _ in counts)  # one position a row
    assert _bits(step) == _bits(lm.decode_step(params, tokens[:, 8:], lm.prefill(params, tokens[:, :8], cfg, 16)[1],
                                               cfg)[0])


def test_qk_norms_take_the_attention_blocks_bundle():
    """``attn_apply`` hands q and k (B, S, heads, hd) to the bundle's norm."""
    cfg = get_config("chameleon-34b").reduced()
    params = materialize(attention.attn_spec(cfg, torch.float32), "cpu", torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 7, cfg.d_model)).astype(np.float32))
    counts = []
    out = attention.attn_apply(params, x, cfg, kernels=_counting(counts))
    assert counts == [((2, 7, cfg.n_heads, cfg.head_dim_), 1e-6), ((2, 7, cfg.n_kv_heads, cfg.head_dim_), 1e-6)]
    assert _bits(out) == _bits(attention.attn_apply(params, x, cfg))
