"""The port's attention kernels on the CPU, where each wrapper runs its
plain PyTorch version, against the JAX package's Pallas kernels in
interpret mode and its jnp oracles.

The sweeps take ``tests/test_kernels.py``'s shapes and tolerances: float32
3e-5 (the two differ only in the order of the float32 sums) and bfloat16
2e-2 (p and the output round to 8 bits of mantissa at different places:
the Pallas kernel rounds p before normalising, the plain version after).
The ragged cases — S, T and ``length`` that no tile divides, which the
Pallas kernels assert against — are held to ``repro.kernels.ref``.  The
CUDA kernels themselves are checked on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import functools
import types
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import MAX_SPLITS, TILE, decode_attention_plain, split_plan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

R = np.random.default_rng(7)
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else dict(rtol=3e-5, atol=3e-5)


def _inputs(shapes, dtype, rng=R):
    """The same seeded values as a JAX array and a torch tensor of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    out = []
    for shape in shapes:
        a = rng.normal(size=shape).astype(np.float32)
        out.append((jnp.asarray(a, dtype), torch.from_numpy(a).to(_TORCH[dtype])))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("b,kv,g,s,hd", [(1, 1, 1, 128, 64), (2, 2, 2, 256, 64), (1, 4, 2, 512, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_kernel(b, kv, g, s, hd, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs([(b, kv, g, s, hd), (b, kv, s, hd), (b, kv, s, hd)], dtype)
    want = jax_ops.flash_attention(qj, kj, vj, causal=causal, block_q=64, block_k=128)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == (b, kv, g, s, hd)
    assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize(
    "b,kv,g,s,hd,block",
    [
        (2, 4, 1, 256, 64, 64),  # zamba2's shared block: G 1, hd 64
        (1, 2, 2, 129, 128, 43),  # S = T = 129: one row past the CUDA kernel's 128-row q tile
        (1, 1, 3, 129, 64, 129),
    ],
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_edge_shapes_match_pallas_kernel(b, kv, g, s, hd, block, dtype, causal):
    """The shapes the bf16 tensor-core kernel tiles at its edges, with the
    Pallas kernel's tiles chosen to divide S (it asserts S % tq == 0)."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs([(b, kv, g, s, hd), (b, kv, s, hd), (b, kv, s, hd)], dtype)
    want = jax_ops.flash_attention(qj, kj, vj, causal=causal, block_q=block, block_k=block)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == (b, kv, g, s, hd)
    assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("t,length,blk", [(256, 256, 128), (512, 300, 128), (1024, 17, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches_pallas_kernel(t, length, blk, dtype):
    b, kv, g, hd = 2, 2, 4, 64
    (qj, qt), (kj, kt), (vj, vt) = _inputs([(b, kv, g, hd), (b, kv, t, hd), (b, kv, t, hd)], dtype)
    want = jax_ops.decode_attention(qj, kj, vj, length, block_k=blk)
    got = ops.decode_attention(qt, kt, vt, length)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == (b, kv, g, hd)
    assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize(
    "b,kv,g,s,t,hd,causal",
    [
        (1, 1, 1, 1, 1, 32, True),
        (2, 2, 2, 7, 7, 64, True),
        (1, 3, 2, 100, 100, 128, True),
        (2, 1, 4, 200, 200, 256, True),
        (1, 2, 2, 5, 77, 64, False),
        (2, 2, 1, 130, 33, 32, False),
    ],
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_ragged_matches_reference(b, kv, g, s, t, hd, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs([(b, kv, g, s, hd), (b, kv, t, hd), (b, kv, t, hd)], dtype)
    f32 = jnp.float32
    want = ref.flash_attention_ref(qj.astype(f32), kj.astype(f32), vj.astype(f32), causal)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("t,length", [(1000, 1), (1000, 17), (1000, 999), (1000, 1000), (1056, 1025), (77, 64)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_ragged_matches_reference(t, length, dtype):
    b, kv, g, hd = 2, 2, 4, 32
    (qj, qt), (kj, kt), (vj, vt) = _inputs([(b, kv, g, hd), (b, kv, t, hd), (b, kv, t, hd)], dtype)
    f32 = jnp.float32
    want = ref.decode_attention_ref(qj.astype(f32), kj.astype(f32), vj.astype(f32), length)
    got = ops.decode_attention(qt, kt, vt, torch.tensor(length, dtype=torch.int32))
    assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_plain_versions_take_strided_views():
    """The model hands the kernels permuted views (q of (B, S, KV, G, hd)
    memory, k and v slices of the cache); the plain versions give the same
    values as on contiguous copies."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 9, 2, 3, 32)).astype(np.float32)).permute(0, 2, 3, 1, 4)
    cache = torch.from_numpy(rng.normal(size=(2, 2, 2, 16, 32)).astype(np.float32))
    k, v = cache[0, :, :, :9], cache[1, :, :, :9]
    got = flash_attention_plain(q, k, v, causal=True)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want)
    got = decode_attention_plain(q[:, :, :, 0], cache[0], cache[1], 5)
    want = decode_attention_plain(q[:, :, :, 0].contiguous(), cache[0, :, :, :5].contiguous(), cache[1, :, :, :5].contiguous(), 5)
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_decode_attention_with_nothing_to_attend_is_zero():
    """``length == 0``: the TPU kernel runs no step and writes 0 / 1e-30."""
    q = torch.ones((1, 1, 2, 32))
    k = torch.ones((1, 1, 8, 32))
    assert torch.count_nonzero(ops.decode_attention(q, k, k, 0)).item() == 0


@pytest.mark.parametrize(
    "bkv,length,sms",
    [(32, 1025, 132), (32, 1056, 132), (1, 1, 132), (4, 64, 132), (8, 100_000, 132), (512, 3000, 132), (3, 129, 8)],
)
def test_decode_split_plan_covers_length_with_whole_tiles(bkv, length, sms):
    splits, chunk = split_plan(bkv, length, sms)
    assert chunk % TILE == 0 and chunk > 0
    assert (splits - 1) * chunk < length <= splits * chunk  # no empty chunk, nothing left over
    assert splits * bkv <= max(bkv, 2 * sms)  # one wave of two blocks per SM, never fewer than one per (b, kv)
    assert splits <= MAX_SPLITS  # the bf16 kernel's cluster holds one block per chunk


def test_decode_split_plan_at_the_serving_shape():
    # granite-3-8b at batch 4: 32 (b, kv) pairs, first decode step on 132 SMs:
    # at most 264 blocks in one wave, so 8 chunks of three tiles -> 6 of 192 rows
    assert split_plan(32, 1025, 132) == (6, 192)


@pytest.mark.parametrize("fn", ["flash_attention", "decode_attention", "decode_attention_partials"])
def test_wrappers_refuse_devices_other_than_cuda_and_cpu(fn):
    """A device other than cuda or cpu raises; meta tensors hold shapes
    alone (the dry-run's), so they take the plain version's shapes."""
    q = torch.zeros((1, 1, 1, 4, 32), device="meta")
    k = torch.zeros((1, 1, 4, 32), device="meta")
    other = types.SimpleNamespace(device=torch.device("xpu"))
    if fn == "flash_attention":
        assert ops.flash_attention(q, k, k).shape == q.shape
        assert ops.flash_attention(q, k, k).device.type == "meta"
        call = functools.partial(ops.flash_attention, other, k, k)
    elif fn == "decode_attention":
        assert ops.decode_attention(q[:, :, :, 0], k, k, 2).shape == q[:, :, :, 0].shape
        call = functools.partial(ops.decode_attention, other, k, k, 2)
    else:
        m, l, acc = ops.KERNELS.decode_attention_partials(q[:, :, :, 0], k, k, 2)
        assert (m.shape, l.shape, acc.shape) == ((1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 1, 32))
        assert acc.device.type == "meta" and acc.dtype == torch.float32
        call = functools.partial(ops.KERNELS.decode_attention_partials, other, k, k, 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        call()


def test_launch_counters_are_registered_and_cpu_calls_do_not_count():
    for name in ("flash_attention", "decode_attention"):
        assert name in ops.LAUNCHES
    before = {n: c.value for n, c in ops.LAUNCHES.items()}
    q = torch.zeros((1, 1, 1, 4, 32))
    k = torch.zeros((1, 1, 4, 32))
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, :, :, 0], k, k, 2)
    assert {n: c.value for n, c in ops.LAUNCHES.items()} == before
