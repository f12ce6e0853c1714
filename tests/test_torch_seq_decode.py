"""The decode over a KV cache sharded by position (``cache_seq_long``, the
``long_500k`` cells): the decode kernel's partial (m, l, acc) against the
reference's ``partial_decode_attention``, and the flash-decoding merge of
``per_shard.on_shards`` over four gloo ranks on the CPU, alone and inside
reduced zamba2's ``decode_step`` against the reference's.

On the CPU ``decode_attention_partials`` runs its plain version
(``decode_attention_partials_plain``); on the card it launches the decode
kernel (``tests/test_torch_gpu.py``).  The ranks run in one subprocess
(``torch.multiprocessing``, spawn, one thread a rank) under a timeout.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed.collectives import partial_decode_attention as ref_partials  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partials,
    decode_attention_partials_plain,
    decode_attention_plain,
)

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RANKS = 4


def _merge(parts) -> np.ndarray:
    """The flash-decoding merge of ``collectives.seq_sharded_decode_attention``
    over a list of (m, l, acc), in float64."""
    m = np.max([np.asarray(p[0], np.float64) for p in parts], axis=0)
    l = sum(np.asarray(p[1], np.float64) * np.exp(np.asarray(p[0], np.float64) - m) for p in parts)
    acc = sum(np.asarray(p[2], np.float64) * np.exp(np.asarray(p[0], np.float64) - m) for p in parts)
    return acc / np.maximum(l, 1e-30)


def _inputs(seed: int, g: int, t: int, dtype: str):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((2, 2, g, 32), (2, 2, t, 32), (2, 2, t, 32))]
    ours = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    theirs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return ours, theirs


# ---------------------------------------------------------------------------
# the partials against the reference's partial_decode_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("length", [0, 13, 24], ids=["empty", "ragged", "full"])
def test_decode_attention_partials_match_the_reference(dtype, g, length):
    """(m, l, acc) within 2e-5 (float32) / 2e-2 (bfloat16) of the reference's
    at a valid length of 0, ragged and the whole slice; of an empty slice
    only m is the same (the reference's l and acc there are an artefact of
    every score being -1e30), and it merges with a full slice into the
    reference's merge of the same two."""
    tol = TOL[dtype]
    (q, k, v), (qj, kj, vj) = _inputs(g * 100 + length, g, 24, dtype)
    got = decode_attention_partials_plain(q, k, v, length)
    want = ref_partials(qj, kj, vj, length)
    assert [tuple(t.shape) for t in got] == [(2, 2, g, 1), (2, 2, g, 1), (2, 2, g, 32)]
    assert all(t.dtype == torch.float32 for t in got)
    if length == 0:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert not got[1].any() and not got[2].any()
        (q2, k2, v2), (qj2, kj2, vj2) = _inputs(7, g, 24, dtype)
        other, other_ref = decode_attention_partials_plain(q, k2, v2, 24), ref_partials(qj, kj2, vj2, 24)
        np.testing.assert_allclose(_merge([got, other]), _merge([want, other_ref]), rtol=tol, atol=tol)
        return
    for name, a, b in zip("mla", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=tol, atol=tol, err_msg=name)
    # merged alone, the partials are the decode itself
    np.testing.assert_allclose(_merge([got]), decode_attention_plain(q, k, v, length).float().numpy(),
                               rtol=tol, atol=tol)


def test_decode_attention_partials_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is its plain version and counts no launch;
    meta tensors (the dry-run's) give the partials' shapes."""
    from repro_torch.kernels import ops

    (q, k, v), _ = _inputs(3, 4, 40, "float32")
    before = ops.LAUNCHES["decode_attention"].value
    for length in (0, 17, 40):
        for a, b in zip(decode_attention_partials(q, k, v, length), decode_attention_partials_plain(q, k, v, length)):
            assert torch.equal(a, b)
    assert ops.LAUNCHES["decode_attention"].value == before
    meta = [t.to("meta") for t in (q, k, v)]
    assert [tuple(t.shape) for t in decode_attention_partials(*meta, 9)] == [(2, 2, 4, 1), (2, 2, 4, 1), (2, 2, 4, 32)]
    assert ops.KERNELS.decode_attention_partials is decode_attention_partials
    assert ops.PLAIN.decode_attention_partials is decode_attention_partials_plain


# ---------------------------------------------------------------------------
# four gloo ranks on the CPU: on_shards' merge, alone and in zamba2's decode
# ---------------------------------------------------------------------------
SEQ_T = 64  # 16 positions a rank
SEQ_LENGTHS = (1, 17, 40, 50, 64)  # rank 0 alone; ranks 1, 2, 3 ragged; all full
ZAMBA_T, ZAMBA_INDEX, ZAMBA_STEPS = 64, 50, 3  # rank 3 ragged (3, 4, 5 positions), the others full

RANKS_SCRIPT = textwrap.dedent(
    """
    import pickle, sys
    sys.path.insert(0, %r)
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, data, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs import get_config
        from repro_torch.distributed import collectives
        from repro_torch.distributed.per_shard import on_shards
        from repro_torch.distributed.sharding import distribute_tree, shard_tensor, tree_shardings, use_mesh
        from repro_torch.kernels import ops
        from repro_torch.kernels.decode_attention import decode_attention_partials_plain
        from repro_torch.models import build
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.tree import tree_map

        with open(data, "rb") as f:
            d = pickle.load(f)
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        res = {"seq": {}}
        q, k, v = (torch.from_numpy(d["seq"][n]) for n in ("q", "k", "v"))
        ks, vs = shard_tensor(k, mesh, (Shard(2),)), shard_tensor(v, mesh, (Shard(2),))
        with torch.no_grad():
            for length in d["lengths"]:
                for label, bundle in (("kernels", ops.KERNELS), ("plain", ops.PLAIN)):
                    res["seq"][label, length] = on_shards(bundle).decode_attention(q, ks, vs, length).to_local()
                # the card's partials contract (an empty slice is -1e30, 0, 0) through the same merge
                res["seq"]["port partials", length] = collectives.seq_sharded_decode_attention(
                    mesh, q, ks, vs, length - 1, partials=decode_attention_partials_plain)

        # reduced zamba2: parameters laid out by param_axes, the cache by decode_cache_axes(long_context=True)
        cfg = get_config("zamba2-1.2b").reduced()
        api = build(cfg)
        params = params_from_numpy(d["params"], cfg, "cpu")
        cache = {"ssm": {n: torch.from_numpy(a) for n, a in d["ssm"].items()},
                 "kv": {"k": torch.from_numpy(d["kv_k"]), "v": torch.from_numpy(d["kv_v"]), "index": d["index"]}}
        merges = []
        real = collectives.seq_sharded_decode_attention

        def counted(*args, **kwargs):
            merges.append(1)
            return real(*args, **kwargs)

        collectives.seq_sharded_decode_attention = counted
        for layout in ("param_axes", "replicated"):  # replicated: the weights as chip_smoke.py's 8e holds them
            merges.clear()
            with use_mesh(mesh), implicit_replication(), torch.no_grad():
                p = params
                if layout == "param_axes":
                    p = distribute_tree(params, tree_shardings(api.param_axes(), params, mesh), mesh)
                c = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, cache)  # decode writes in place
                c = distribute_tree(c, tree_shardings(api.decode_cache_axes(True), c, mesh), mesh)
                assert tuple(c["kv"]["k"].placements) == (Shard(3),), c["kv"]["k"].placements
                logits = []
                for i in range(d["tokens"].shape[1]):
                    step, c = api.decode_step(p, torch.from_numpy(d["tokens"][:, i : i + 1]), c)
                    logits.append(step.full_tensor())
                res["zamba2", layout] = {"logits": torch.stack(logits), "merges": len(merges),
                                         "kv_k": c["kv"]["k"].full_tensor(), "kv_v": c["kv"]["v"].full_tensor(),
                                         "index": c["kv"]["index"]}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3]), nprocs=4,
                           start_method="spawn")
        print("ranks OK")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs and what four gloo ranks gave for them: the merge of
    ``on_shards(KERNELS)`` and ``on_shards(PLAIN)`` at SEQ_LENGTHS, and
    reduced zamba2's decode steps over a cache sharded by position."""
    tmp = tmp_path_factory.mktemp("seq_decode")
    rng = np.random.default_rng(23)
    cfg = get_config("zamba2-1.2b").reduced()
    rparams, _ = ref_build(ref_config("zamba2-1.2b").reduced()).init(jax.random.PRNGKey(11))
    sites = cfg.n_layers // cfg.attn_every
    kv_shape = (sites, 2, cfg.n_kv_heads, ZAMBA_T, cfg.head_dim_)
    d_in = cfg.ssm.expand * cfg.d_model
    k1 = cfg.ssm.conv_kernel - 1
    data = {
        "seq": {
            "q": rng.normal(size=(2, 2, 4, 16)).astype(np.float32),
            "k": rng.normal(size=(2, 2, SEQ_T, 16)).astype(np.float32),
            "v": rng.normal(size=(2, 2, SEQ_T, 16)).astype(np.float32),
        },
        "lengths": SEQ_LENGTHS,
        "params": jax.tree.map(np.asarray, rparams),
        "ssm": {
            "ssm": (0.1 * rng.normal(size=(cfg.n_layers, 2, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim,
                                           cfg.ssm.d_state))).astype(np.float32),
            "conv_x": rng.normal(size=(cfg.n_layers, 2, k1, d_in)).astype(np.float32),
            "conv_B": rng.normal(size=(cfg.n_layers, 2, k1, cfg.ssm.d_state)).astype(np.float32),
            "conv_C": rng.normal(size=(cfg.n_layers, 2, k1, cfg.ssm.d_state)).astype(np.float32),
        },
        "kv_k": rng.normal(size=kv_shape).astype(np.float32),
        "kv_v": rng.normal(size=kv_shape).astype(np.float32),
        "index": ZAMBA_INDEX,
        "tokens": rng.integers(0, cfg.vocab_size, (2, ZAMBA_STEPS)).astype(np.int32),
    }
    path, out = tmp / "inputs.pkl", tmp / "ranks.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    script = tmp / "seq_ranks.py"
    script.write_text(RANKS_SCRIPT % str(SRC))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(script), str(_free_port()), str(path), str(out)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ranks OK" in res.stdout
    with open(out, "rb") as f:
        return data, rparams, pickle.load(f)


@pytest.mark.parametrize("bundle", ["kernels", "plain", "port partials"])
@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_on_shards_decode_over_a_cache_sharded_by_position_equals_the_whole_cache(ranks, bundle, length):
    """``on_shards(KERNELS)`` and ``on_shards(PLAIN)`` on k and v sharded over
    their positions, and the merge of the card's partials contract, equal one
    whole-cache ``decode_attention`` within 2e-5: with ranks past the
    length, a ragged rank, every rank full."""
    data, _, res = ranks
    want = decode_attention_plain(*(torch.from_numpy(data["seq"][n]) for n in ("q", "k", "v")), length)
    got = res["seq"][bundle, length]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", ["param_axes", "replicated"])
def test_zamba2_decode_over_a_cache_sharded_by_position_matches_the_reference(ranks, layout):
    """Reduced zamba2 in float32: ``decode_step`` over a ``long_context``
    cache sharded by position over four gloo ranks (rank 3 ragged), with the
    parameters laid out by ``param_axes`` or replicated, gives the
    reference's ``decode_step`` logits over the same cache, whole, within
    1e-4 relative, step for step; every shared-attention site went through
    the merge, and the tokens' k and v land at the reference's positions."""
    data, rparams, res = ranks
    rapi = ref_build(ref_config("zamba2-1.2b").reduced())
    to_ref = (0, 1, 3, 2, 4)  # the port's (layers, B, KV, T, hd) as the reference's (layers, B, T, KV, hd)
    cache = {
        "ssm": {n: jnp.asarray(a) for n, a in data["ssm"].items()},
        "kv": {"k": jnp.asarray(data["kv_k"].transpose(to_ref)), "v": jnp.asarray(data["kv_v"].transpose(to_ref)),
               "index": jnp.int32(data["index"])},
    }
    got = res["zamba2", layout]
    cfg = get_config("zamba2-1.2b").reduced()
    assert got["merges"] == ZAMBA_STEPS * (cfg.n_layers // cfg.attn_every)
    for i in range(ZAMBA_STEPS):
        want, cache = rapi.decode_step(rparams, jnp.asarray(data["tokens"][:, i : i + 1]), cache)
        want = np.asarray(want)
        err = np.abs(got["logits"][i].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (i, err)
    assert got["index"] == ZAMBA_INDEX + ZAMBA_STEPS
    for name in ("k", "v"):
        np.testing.assert_allclose(got[f"kv_{name}"].numpy().transpose(to_ref), np.asarray(cache["kv"][name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
