"""The port's distribution substrate (``repro_torch.distributed``) against the
reference's: the logical-axis rules and their partition tuples, the
models' logical-axes trees, the collectives over four gloo ranks on the
CPU, the elastic shard assignment, and ``TorchFeed`` over a mesh.

Spawned ranks run in subprocesses (``torch.multiprocessing`` with the
spawn method), each capped at one torch thread, each group under its own
timeout and checked by exit code; the reference's collectives run in a
subprocess of their own with four host devices, so this process keeps
its one-device JAX runtime and no process group.
"""

import json
import os
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
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.elastic import assign_shards, owner_of, plan_recovery  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES,
    Rules,
    is_axes_leaf,
    map_with_axes,
    placements_for,
    pspec_for,
    tree_pspecs,
)
from repro_torch.launch.dryrun import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.models import build  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESH = (("data", "model"), (16, 16))
MESH3 = (("pod", "data", "model"), (2, 16, 16))


class RefMesh:
    """The reference's view of a mesh: axis names and a devices array shape."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _ref_init(cfg):
    """(axes, shapes) of the reference's ``init`` via ``jax.eval_shape``:
    nothing is allocated."""
    cap = {}

    def f(k):
        p, a = ref_build(cfg).init(k)
        cap["a"] = a
        return p

    shapes = jax.eval_shape(f, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return cap["a"], shapes


def _plain(tree):
    """A reference axes tree with lists and dicts only (tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def _leaves(axes_tree, tree) -> list:
    out = []
    map_with_axes(lambda a, t: out.append((a, t)), axes_tree, tree)
    return out


# ---------------------------------------------------------------------------
# the rules: partition tuples leaf for leaf against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_pspec_for_matches_the_reference_on_every_parameter_at_full_width(arch):
    cfg = ref_config(arch)
    ref_axes, ref_shapes = _ref_init(cfg)
    port_axes = build(get_config(arch)).param_axes()
    assert port_axes == _plain(ref_axes)
    pairs = _leaves(port_axes, ref_shapes)
    assert len(pairs) == len(jax.tree.leaves(ref_shapes))
    for names, shape in (MESH, MESH3):
        ref_mesh = RefMesh(names, shape)
        for axes, leaf in pairs:
            want = tuple(ref_sharding.pspec_for(axes, leaf.shape, ref_mesh, ref_sharding.DEFAULT_RULES))
            assert pspec_for(axes, leaf.shape, (names, shape), DEFAULT_RULES) == want, (arch, names, axes, leaf.shape)


def test_the_port_shapes_are_the_reference_shapes_at_full_width():
    """The port's ``init`` (traced under ``FakeTensorMode``: nothing is
    allocated) gives the reference's shapes, so the axes trees line up."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for arch in ("granite-3-8b", "zamba2-1.2b", "xlstm-125m", "whisper-small", "moonshot-v1-16b-a3b"):
        _, ref_shapes = _ref_init(ref_config(arch))
        with FakeTensorMode():
            params = build(get_config(arch)).init(torch.Generator(), "cpu")
        axes = build(get_config(arch)).param_axes()
        got = [tuple(t.shape) for _, t in _leaves(axes, params)]
        assert got == [tuple(s.shape) for _, s in _leaves(axes, ref_shapes)], arch


def test_tree_pspecs_matches_the_reference():
    cfg = ref_config("granite-3-8b")
    ref_axes, ref_shapes = _ref_init(cfg)
    want = ref_sharding.tree_pspecs(ref_axes, ref_shapes, RefMesh(*MESH))
    got = tree_pspecs(build(get_config("granite-3-8b")).param_axes(), ref_shapes, MESH)
    axes = build(get_config("granite-3-8b")).param_axes()
    assert [s for _, s in _leaves(axes, got)] == [tuple(s) for _, s in _leaves(axes, want)]


def test_placements_follow_the_partition_tuple():
    from torch.distributed.tensor import Replicate, Shard

    assert placements_for(("data", "model"), MESH) == (Shard(0), Shard(1))
    assert placements_for((None, "data"), MESH) == (Shard(1), Replicate())
    assert placements_for((("pod", "data"), None, "model"), MESH3) == (Shard(0), Shard(0), Shard(2))
    assert placements_for((), MESH3) == (Replicate(), Replicate(), Replicate())


def test_rules_merge_and_constrain_outside_a_mesh_returns_its_input():
    from repro_torch.distributed.sharding import constrain, current_mesh

    r = Rules(DEFAULT_RULES).merged({"head_dim": ("model",)})
    assert r["head_dim"] == ("model",) and DEFAULT_RULES["head_dim"] == ()
    assert current_mesh() is None
    x = torch.ones(2, 3)
    assert constrain(x, ("act_batch", None)) is x


# mirrors tests/test_sharding_elastic.py on the port
def test_pspec_basic_tp_fsdp():
    assert pspec_for(("embed", "ffn"), (4096, 12800), MESH, DEFAULT_RULES) == ("data", "model")


def test_pspec_divisibility_fallback():
    # kv_heads=1 (gemma MQA) cannot shard over model=16 → replicated
    assert pspec_for(("embed", "kv_heads", "head_dim"), (2048, 1, 256), MESH, DEFAULT_RULES) == ("data",)
    # odd vocab is not divisible by 16 → dropped
    assert pspec_for(("vocab", "embed"), (49155, 4096), MESH, DEFAULT_RULES) == (None, "data")
    # padded vocab shards fine
    assert pspec_for(("vocab", "embed"), (49408, 4096), MESH, DEFAULT_RULES) == ("model", "data")


def test_pspec_multi_axis_batch():
    spec = pspec_for(("act_batch", None, None), (256, 4096, 1024), MESH3, DEFAULT_RULES)
    assert spec[0] == ("pod", "data")
    # batch=1 (long_500k): everything dropped
    assert pspec_for(("act_batch", None), (1, 128), MESH3, DEFAULT_RULES) == ()


def test_pspec_partial_axis_product():
    # batch 32 divides pod*data=32 on the 3d mesh
    assert pspec_for(("act_batch",), (32,), MESH3, DEFAULT_RULES) == (("pod", "data"),)
    # batch 2 only divides pod (single axis collapses from tuple to name)
    assert pspec_for(("act_batch",), (2,), MESH3, DEFAULT_RULES) == ("pod",)


def test_rendezvous_deterministic_and_balanced():
    files = [f"file_{i}" for i in range(2000)]
    hosts = [f"h{i}" for i in range(8)]
    a1 = assign_shards(files, hosts)
    a2 = assign_shards(files, hosts)
    assert a1 == a2
    sizes = [len(v) for v in a1.values()]
    assert min(sizes) > 150 and max(sizes) < 350  # roughly balanced


def test_rendezvous_minimal_churn():
    files = [f"file_{i}" for i in range(1000)]
    hosts = [f"h{i}" for i in range(10)]
    moved = plan_recovery(files, hosts, hosts[:-1])  # h9 dies
    # only h9's files move
    assert all(old == "h9" for old, _ in moved.values())
    lost = sum(1 for f in files if owner_of(f, hosts) == "h9")
    assert len(moved) == lost


def test_rendezvous_weights():
    files = [f"f{i}" for i in range(2000)]
    hosts = ["big", "small"]
    a = assign_shards(files, hosts, weights={"big": 3.0, "small": 1.0})
    ratio = len(a["big"]) / max(len(a["small"]), 1)
    assert 2.0 < ratio < 4.5


def test_elastic_assignment_equals_the_reference():
    from repro.distributed import elastic as ref_elastic

    files = [f"shard-{i:05d}.sdf" for i in range(500)]
    hosts = [f"faird-{i}:3101" for i in range(7)]
    weights = {hosts[0]: 2.0, hosts[3]: 0.5}
    assert assign_shards(files, hosts, weights) == ref_elastic.assign_shards(files, hosts, weights)
    assert plan_recovery(files, hosts, hosts[1:]) == ref_elastic.plan_recovery(files, hosts, hosts[1:])


# ---------------------------------------------------------------------------
# the models' logical axes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_equal_the_reference_init_axes(arch):
    ref_axes, _ = _ref_init(ref_config(arch).reduced())
    assert build(get_config(arch).reduced()).param_axes() == _plain(ref_axes)


def _swap_kv(axes):
    """A reference KV-cache axes leaf (layers, B, T, KV, hd) in the port's
    layout (layers, B, KV, T, hd)."""
    return axes[:2] + (axes[3], axes[2]) + axes[4:]


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("long", [False, True])
def test_decode_cache_axes_equal_the_reference_after_the_layout_swap(arch, long):
    cfg = get_config(arch).reduced()
    want = _plain(ref_build(ref_config(arch).reduced()).decode_cache_axes(long))
    kv_names = {"k", "v", "cross_k", "cross_v"}

    def swap(node):
        if isinstance(node, dict):
            return {k: (_swap_kv(v) if k in kv_names else swap(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [swap(v) for v in node]
        return node

    got = build(cfg).decode_cache_axes(long)
    assert got == swap(want)
    # and the tree lines up with the cache the port builds
    cache = build(cfg).make_decode_cache(2, 8, torch.float32, "cpu")
    for axes, t in _leaves(got, cache):
        assert is_axes_leaf(axes)
        if isinstance(t, torch.Tensor):
            assert len(axes) == t.dim(), (axes, t.shape)


def test_input_specs_and_axes_follow_the_reference():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.models import input_axes as ref_input_axes
    from repro.models import input_specs as ref_input_specs
    from repro_torch.configs import SHAPES
    from repro_torch.models import input_axes, input_specs

    for arch in ("granite-3-8b", "whisper-small", "zamba2-1.2b"):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            cfg, rcfg = get_config(arch), ref_config(arch)
            specs, ax = input_specs(cfg, SHAPES[name]), input_axes(cfg, SHAPES[name])
            rspecs, rax = ref_input_specs(rcfg, REF_SHAPES[name]), ref_input_axes(rcfg, REF_SHAPES[name])
            for key in ("tokens", "labels", "frames", "token"):
                if key in rspecs:
                    assert tuple(specs[key].shape) == rspecs[key].shape and specs[key].device.type == "meta"
                    assert ax[key] == rax[key]
            if "cache" in rspecs:
                for leaf in jax.tree.leaves(rspecs["cache"]):
                    assert leaf.size > 0
                got = sorted(t.numel() for _, t in _leaves(ax["cache"], specs["cache"]) if isinstance(t, torch.Tensor))
                want = sorted(int(np.prod(s.shape)) for s in jax.tree.leaves(rspecs["cache"]) if s.shape)
                assert got == want


# ---------------------------------------------------------------------------
# collectives over four gloo ranks on the CPU, against the reference's
# ---------------------------------------------------------------------------
B, KV, G, T, HD, INDEX = 2, 2, 2, 64, 16, 40

REF_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, %r)
    from repro.distributed.collectives import compressed_psum, seq_sharded_decode_attention

    d = np.load(%r)
    mesh = jax.make_mesh((4,), ("data",))
    with mesh:
        out = seq_sharded_decode_attention(mesh, jnp.asarray(d["q"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]),
                                           jnp.asarray(d["index"]), seq_axis="data")
        total = compressed_psum(mesh, jnp.asarray(d["x"]), axis="data")
    np.savez(%r, out=np.asarray(out), total=np.asarray(total))
    print("reference OK")
    """
)

PORT_SCRIPT = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, data, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.distributed.collectives import compressed_psum, seq_sharded_decode_attention
        from repro_torch.distributed.sharding import shard_tensor

        d = np.load(data)
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        q = torch.from_numpy(d["q"])
        # k and v as DTensors sharded over T, and as each rank's local slice
        k = shard_tensor(torch.from_numpy(d["k"]), mesh, (Shard(2),))
        v = shard_tensor(torch.from_numpy(d["v"]), mesh, (Shard(2),))
        got = seq_sharded_decode_attention(mesh, q, k, v, int(d["index"]), seq_axis="data")
        local = seq_sharded_decode_attention(mesh, q, k.to_local(), v.to_local(), torch.tensor(int(d["index"])))
        total = compressed_psum(mesh, torch.from_numpy(d["x"]), axis="data")
        assert torch.equal(got, local)
        outs = [torch.zeros_like(got) for _ in range(4)]
        dist.all_gather(outs, got)
        assert all(torch.equal(o, got) for o in outs), "ranks disagree"
        if rank == 0:
            np.savez(out, out=got.numpy(), total=total.numpy())
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3]), nprocs=4,
                           start_method="spawn")
        print("port OK")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(args, timeout: int, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(SRC))
    res = subprocess.run(args, capture_output=True, text=True, timeout=timeout, env=env, **kw)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    """(port, reference) results of the decode and the int8 psum on the
    same inputs: the port over four gloo ranks, the reference over four host
    devices, each in its own subprocess."""
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    data = tmp / "inputs.npz"
    np.savez(
        data,
        q=rng.normal(size=(B, KV, G, HD)).astype(np.float32),
        k=rng.normal(size=(B, KV, T, HD)).astype(np.float32),
        v=rng.normal(size=(B, KV, T, HD)).astype(np.float32),
        index=np.int32(INDEX),
        x=rng.normal(size=(16, 8)).astype(np.float32),
    )
    ref_out, port_out = tmp / "ref.npz", tmp / "port.npz"
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT % str(SRC))
    res = _run([sys.executable, "-c", REF_SCRIPT % (str(SRC), str(data), str(ref_out))], timeout=300)
    assert "reference OK" in res.stdout
    res = _run([sys.executable, str(script), str(_free_port()), str(data), str(port_out)], timeout=300)
    assert "port OK" in res.stdout
    return np.load(port_out), np.load(ref_out), np.load(data)


def test_seq_sharded_decode_matches_the_reference_over_four_ranks(collective_results):
    port, ref, _ = collective_results
    np.testing.assert_allclose(port["out"], ref["out"], rtol=2e-5, atol=2e-5)


def test_seq_sharded_decode_matches_the_whole_cache(collective_results):
    from repro_torch.kernels.decode_attention import decode_attention_plain

    port, _, d = collective_results
    want = decode_attention_plain(*(torch.from_numpy(d[n]) for n in ("q", "k", "v")), INDEX + 1)
    np.testing.assert_allclose(port["out"], want.numpy(), rtol=2e-5, atol=2e-5)


def test_compressed_psum_equals_the_reference_bit_for_bit(collective_results):
    port, ref, d = collective_results
    assert port["total"].dtype == ref["total"].dtype == np.float32
    np.testing.assert_array_equal(port["total"].view(np.uint32), ref["total"].view(np.uint32))
    # every rank holds the same x → psum = 4x within the int8 quantization
    scale = np.abs(d["x"]).max() / 127.0
    assert np.abs(port["total"] - 4 * d["x"]).max() <= 4 * scale + 1e-6


def test_partial_decode_attention_matches_the_reference():
    from repro.distributed.collectives import partial_decode_attention as ref_partial
    from repro_torch.distributed.collectives import partial_decode_attention

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((2, 2, 4, 32), (2, 2, 24, 32), (2, 2, 24, 32)))
    for valid in (0, 7, 24):
        got = partial_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid)
        want = ref_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# TorchFeed over a mesh of two CPU ranks
# ---------------------------------------------------------------------------
FEED_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, root, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard, Replicate
        import repro_torch.data  # registers tokenize_and_pack
        from repro_torch.client import LocalNetwork
        from repro_torch.client.torch_adapter import TorchFeed
        from repro_torch.core.executor import ExecutorConfig
        from repro_torch.data import training_dag
        from repro_torch.server import FairdServer

        srv = FairdServer("data:3101", executor=ExecutorConfig(device="cpu"))
        srv.catalog.register_path("corpus", root)
        net = LocalNetwork()
        net.register(srv)
        client = net.client_for("data:3101")
        dag = training_dag("dacp://data:3101/corpus/docs.jsonl", seq_len=16, batch_rows=4)
        whole = list(TorchFeed(lambda: client.cook(dag), "tokens", 17, 4, device="cpu"))
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        sharded = list(TorchFeed(lambda: client.cook(dag), "tokens", 17, 4, mesh=mesh))
        assert len(sharded) == len(whole) > 0
        for s, w in zip(sharded, whole):
            for name in ("tokens", "labels"):
                t = s[name]
                assert isinstance(t, DTensor) and tuple(t.placements) == (Shard(0), Replicate())
                assert tuple(t.shape) == tuple(w[name].shape)
                assert torch.equal(t.to_local(), w[name][rank * 2 : rank * 2 + 2])
                assert torch.equal(t.full_tensor(), w[name])
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"batches": len(sharded)}, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3]), nprocs=2,
                           start_method="spawn")
        print("feed OK")
    """
)


def test_torch_feed_over_a_mesh_of_two_cpu_ranks(tmp_path):
    from repro_torch.data import write_token_corpus

    root = tmp_path / "corpus"
    root.mkdir()
    write_token_corpus(str(root / "docs.jsonl"), docs=12, seed=5)
    script = tmp_path / "feed_ranks.py"
    script.write_text(FEED_SCRIPT % str(SRC))
    out = tmp_path / "feed.json"
    res = _run([sys.executable, str(script), str(_free_port()), str(root), str(out)], timeout=300)
    assert "feed OK" in res.stdout
    assert json.loads(out.read_text())["batches"] == 3


# ---------------------------------------------------------------------------
# the models on a mesh: sharded parameters give the unsharded logits
# ---------------------------------------------------------------------------
MODEL_SCRIPT = textwrap.dedent(
    """
    import dataclasses
    import sys
    sys.path.insert(0, %r)
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, archs):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import distribute_tree, tree_shardings, use_mesh
        from repro_torch.models import build

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for spec in archs.split(","):
            arch, _, zero3 = spec.partition("+")
            cfg = dataclasses.replace(get_config(arch).reduced(), zero3_gather=bool(zero3))
            api = build(cfg)
            params = api.init(torch.Generator().manual_seed(3), "cpu")
            tokens = torch.randint(0, cfg.vocab_size, (4, 24), generator=torch.Generator().manual_seed(4))
            want, _ = api.forward(params, {"tokens": tokens})
            axes = api.param_axes()
            sharded = distribute_tree(params, tree_shardings(axes, params, mesh), mesh)
            tok = distribute_tree({"t": tokens}, tree_shardings({"t": ("act_batch", None)}, {"t": tokens}, mesh), mesh)
            with use_mesh(mesh), implicit_replication(), torch.no_grad():
                got, _ = api.forward(sharded, {"tokens": tok["t"]})
                got = got.full_tensor()
            err = (got - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item(), (arch, err)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4, start_method="spawn")
        print("models OK")
    """
)


def test_models_on_a_mesh_of_four_cpu_ranks_give_the_unsharded_logits(tmp_path):
    """Reduced granite (GQA), zamba2 (Mamba2 + shared attention), xlstm and
    moonshot (MoE) forwards, granite also with ZeRO-3 unshard-at-use
    (``zero3_gather``), with their parameters laid out by ``param_axes`` on
    a (2, 2) mesh of gloo ranks (``constrain`` at the reference's sites, each kernel
    per rank on its shard) give the unsharded forward's logits."""
    script = tmp_path / "model_ranks.py"
    script.write_text(MODEL_SCRIPT % str(SRC))
    archs = "granite-3-8b,granite-3-8b+zero3,zamba2-1.2b,xlstm-125m,moonshot-v1-16b-a3b"
    res = _run([sys.executable, str(script), str(_free_port()), archs], timeout=600)
    assert "models OK" in res.stdout


# ---------------------------------------------------------------------------
# the model kernels on DTensors: per_shard.on_shards over four gloo ranks
# ---------------------------------------------------------------------------
ON_SHARDS_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, %r)
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.distributed.per_shard import on_shards
        from repro_torch.distributed.sharding import shard_tensor
        from repro_torch.kernels import ops

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        sharded = on_shards(ops.KERNELS)
        g = torch.Generator().manual_seed(5)
        r = lambda *s: torch.randn(s, generator=g)
        batch_heads = (Shard(0), Shard(1))

        def same(got, want, what):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want, strict=True):
                torch.testing.assert_close(a.full_tensor(), b, rtol=1e-5, atol=1e-5, msg=what)

        q, k, v = r(4, 2, 2, 16, 8), r(4, 2, 16, 8), r(4, 2, 16, 8)
        same(sharded.flash_attention(shard_tensor(q, mesh, batch_heads), k, v, causal=True),
             ops.flash_attention(q, k, v, causal=True), "flash_attention, batch and heads sharded")
        q, k, v = r(4, 2, 2, 8), r(4, 2, 32, 8), r(4, 2, 32, 8)
        want = ops.decode_attention(q, k, v, 21)
        same(sharded.decode_attention(q, shard_tensor(k, mesh, batch_heads), shard_tensor(v, mesh, batch_heads), 21),
             want, "decode_attention, batch and heads sharded")
        seq = (Shard(2), Shard(1))  # positions over data: the flash-decoding merge
        same(sharded.decode_attention(q, shard_tensor(k, mesh, seq), shard_tensor(v, mesh, seq), 21), want,
             "decode_attention, positions sharded")
        x, dt, A, B, C = r(4, 16, 4, 8), r(4, 16, 4).abs(), -r(4).abs(), r(4, 16, 8), r(4, 16, 8)
        same(sharded.ssd_scan(shard_tensor(x, mesh, (Shard(0), Shard(2))), dt, A, B, C, 8),
             ops.ssd_scan(x, dt, A, B, C, 8), "ssd_scan")
        q, k, v, li, lf = r(4, 16, 2, 8), r(4, 16, 2, 8), r(4, 16, 2, 8), r(4, 16, 2), -r(4, 16, 2).abs()
        same(sharded.mlstm_chunk(shard_tensor(q, mesh, (Shard(0), Shard(2))), k, v, li, lf, 8),
             ops.mlstm_chunk(q, k, v, li, lf, 8), "mlstm_chunk")
        # the gated norm's one group spans heads that the model axis splits: the heads are gathered
        y, xh, z, D, scale = r(4, 6, 4, 8), r(4, 6, 4, 8), r(4, 6, 32), r(4), r(32)
        lay = lambda t: shard_tensor(t, mesh, (Shard(0), Shard(2)))  # batch over data, heads (channels) over model
        whole = lambda t: shard_tensor(t, mesh, (Replicate(), Replicate()))
        out = sharded.gated_rmsnorm(lay(y), lay(xh), lay(z), shard_tensor(D, mesh, (Replicate(), Shard(0))), whole(scale), 1, 1e-5)
        assert tuple(out.placements) == (Shard(0), Replicate()), out.placements
        same(out, ops.gated_rmsnorm(y, xh, z, D, scale, 1, 1e-5), "gated_rmsnorm, heads sharded")
        out = sharded.gated_rmsnorm(*(whole(t) for t in (y, xh, z, D, scale)), 2, 1e-5)  # replicated: nothing moves
        assert tuple(out.placements) == (Replicate(), Replicate()), out.placements
        same(out, ops.gated_rmsnorm(y, xh, z, D, scale, 2, 1e-5), "gated_rmsnorm, replicated")
        # the RMSNorm: rows whole on a rank run per rank; a last dim the mesh splits is gathered
        x, scale = r(4, 6, 32), r(32)
        out = sharded.rms_norm(shard_tensor(x, mesh, (Shard(0), Shard(1))), whole(scale), 1e-5)
        assert tuple(out.placements) == (Shard(0), Shard(1)), out.placements
        same(out, ops.rms_norm(x, scale, 1e-5), "rms_norm, batch and positions sharded")
        out = sharded.rms_norm(lay(x), shard_tensor(scale, mesh, (Replicate(), Shard(0))), 1e-5)
        assert tuple(out.placements) == (Shard(0), Replicate()), out.placements
        same(out, ops.rms_norm(x, scale, 1e-5), "rms_norm, the last dim sharded")
        out = sharded.rms_norm(whole(x), whole(scale), 1e-5)  # replicated: nothing moves
        assert tuple(out.placements) == (Replicate(), Replicate()), out.placements
        same(out, ops.rms_norm(x, scale, 1e-5), "rms_norm, replicated")
        assert torch.equal(sharded.rms_norm(x, scale, 1e-5), ops.rms_norm(x, scale, 1e-5))
        # the depthwise conv: batch over data, channels over model, with and without a state and a bias
        x, w, st, bias = r(4, 6, 32), r(4, 32), r(4, 3, 32), r(32)
        out = sharded.causal_conv_silu(lay(x), shard_tensor(w, mesh, (Replicate(), Shard(1))), None, whole(bias))
        assert tuple(out[0].placements) == tuple(out[1].placements) == (Shard(0), Shard(2)), out[0].placements
        same(out, ops.causal_conv_silu(x, w, None, bias), "causal_conv_silu, batch and channels sharded")
        same(sharded.causal_conv_silu(lay(x[:, :1]), w, lay(st)), ops.causal_conv_silu(x[:, :1], w, st),
             "causal_conv_silu, a decode step from a state")
        # a plain stream over a DTensor state (a decode step before the stream meets a DTensor): the state leads
        same(sharded.causal_conv_silu(x[:, :1], w, lay(st)), ops.causal_conv_silu(x[:, :1], w, st),
             "causal_conv_silu, a plain stream over a DTensor state")
        from repro_torch.kernels.causal_conv import _check
        try:  # a DTensor's data_ptr() is 0: it never reaches a kernel
            _check(x[:, :1].contiguous(), w, lay(st), None)
            raise AssertionError("a DTensor passed the launch checks")
        except TypeError as e:
            assert "DTensor" in str(e), e
        q, k, v = r(2, 2, 2, 16, 8), r(2, 2, 16, 8), r(2, 2, 16, 8)  # plain tensors go straight to the wrapper
        assert torch.equal(sharded.flash_attention(q, k, v), ops.flash_attention(q, k, v))
        assert torch.equal(sharded.gated_rmsnorm(y, xh, z, D, scale, 2, 1e-5), ops.gated_rmsnorm(y, xh, z, D, scale, 2, 1e-5))
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(rank_main, args=(int(sys.argv[1]),), nprocs=4, start_method="spawn")
        print("on_shards OK")
    """
)


def test_on_shards_runs_each_model_kernel_per_rank_over_four_cpu_ranks(tmp_path):
    """``per_shard.on_shards`` (the bundle ``models.build`` hands the models)
    runs flash and decode attention, the SSD scan and the mLSTM per rank on
    DTensor shards over a (2, 2) gloo mesh, and a cache sharded over its
    positions through the flash-decoding merge, the gated RMSNorm with
    the heads a mesh splits gathered, the RMSNorm per rank on rows with
    a last dim the mesh splits gathered, and the depthwise causal conv with
    batch and channels sharded (a state or bias left out passes through as
    None; a plain stream over a DTensor state takes the state's layout):
    each equals the wrapper on the whole tensors.  The launch checks refuse
    a DTensor operand."""
    script = tmp_path / "on_shards_ranks.py"
    script.write_text(ON_SHARDS_SCRIPT % str(SRC))
    res = _run([sys.executable, str(script), str(_free_port())], timeout=300)
    assert "on_shards OK" in res.stdout
