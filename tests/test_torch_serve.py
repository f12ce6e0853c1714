"""The port's serving path on the CPU against the reference's, for reduced
granite-3-8b, zamba2-1.2b and xlstm-125m: prompts
written to a corpus, tokenized in place by a ``FairdServer`` running
``training_dag``, read back by the feed, prefilled and greedily decoded.

The port's side is a port ``FairdServer`` over TCP, ``TorchFeed(device=
"cpu")`` and the port's model; the reference's side is the reference
``FairdServer``, ``JaxFeed`` and ``repro.models``, with the same weights
carried over.  Token batches must be equal; greedy ids must be equal (both
compute in float32, where the two models' logits agree to about 5e-6,
far below the gap between the top two logits on these inputs).
"""

import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data  # noqa: F401  registers the reference's tokenize_and_pack
import repro_torch.data  # noqa: F401  registers the port's tokenize_and_pack
from repro.client import TcpNetwork as RefTcpNetwork  # noqa: E402
from repro.client.jax_adapter import JaxFeed  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.server import FairdServer as RefFairdServer  # noqa: E402
from repro_torch.client import TcpNetwork  # noqa: E402
from repro_torch.client.torch_adapter import TorchFeed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import ExecutorConfig  # noqa: E402
from repro_torch.data import training_dag, write_token_corpus  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.server import FairdServer  # noqa: E402

DOCS = 10
PROMPT = 24
NEW = 8


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prompts")
    write_token_corpus(str(root / "prompts.jsonl"), docs=DOCS, seed=11)
    return str(root)


@pytest.fixture(scope="module")
def servers(corpus):
    """(port server authority, reference server authority), both over TCP."""
    pa, ra = _port(), _port()
    port_srv = FairdServer(f"127.0.0.1:{pa}", executor=ExecutorConfig(device="cpu"))
    ref_srv = RefFairdServer(f"127.0.0.1:{ra}")
    for srv, p in ((port_srv, pa), (ref_srv, ra)):
        srv.catalog.register_path("prompts", corpus)
        srv.serve_tcp(port=p)
    yield f"127.0.0.1:{pa}", f"127.0.0.1:{ra}"
    port_srv.shutdown()
    ref_srv.shutdown()


def _uri(auth):
    return f"dacp://{auth}/prompts/prompts.jsonl"


@pytest.mark.parametrize("global_batch,drop", [(4, True), (3, False)])
def test_torch_feed_matches_jax_feed(servers, global_batch, drop):
    port_auth, ref_auth = servers
    pnet, rnet = TcpNetwork(), RefTcpNetwork()
    try:
        pc, rc = pnet.client_for(port_auth), rnet.client_for(ref_auth)
        pdag = training_dag(_uri(port_auth), seq_len=32, batch_rows=4)
        rdag = repro.data.training_dag(_uri(ref_auth), seq_len=32, batch_rows=4)
        got = list(TorchFeed(lambda: pc.cook(pdag), "tokens", 33, global_batch, drop_remainder=drop, device="cpu"))
        want = list(JaxFeed(lambda: rc.cook(rdag), "tokens", 33, global_batch, drop_remainder=drop))
    finally:
        pnet.close_all()
        rnet.close_all()
    assert len(got) == len(want) == (DOCS // global_batch if drop else -(-DOCS // global_batch))
    for g, w in zip(got, want):
        for name in ("tokens", "labels"):
            assert g[name].dtype == torch.int32 and g[name].device.type == "cpu"
            np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]))


def test_greedy_ids_match_reference_serving(servers):
    """Reduced granite-3-8b served end to end: the prompts each package's
    server tokenizes are equal, and port prefill + decode from the
    reference's converted weights give the reference serving path's ids."""
    port_auth, ref_auth = servers
    prompts = serve.dacp_prompts(_uri(port_auth), 4, PROMPT)
    rnet = RefTcpNetwork()
    try:
        from repro.client.jax_adapter import tokens_from_blob_column

        rdag = repro.data.training_dag(_uri(ref_auth), seq_len=PROMPT - 1, batch_rows=4)
        batches = list(rnet.client_for(ref_auth).cook(rdag).iter_batches())  # the whole stream, as dacp_prompts reads it
        ref_prompts = tokens_from_blob_column(batches[0], "tokens", PROMPT)
    finally:
        rnet.close_all()
    np.testing.assert_array_equal(prompts, ref_prompts)

    out = _port_greedy("granite-3-8b", prompts)
    np.testing.assert_array_equal(out["ids"], _reference_greedy("granite-3-8b", ref_prompts))
    assert out["cache"]["index"] == PROMPT + NEW


def _reference_greedy(arch, prompts):
    """The reference serving path's greedy ids (B, NEW + 1) for reduced
    ``arch`` with weights from PRNGKey(0)."""
    rapi = ref_build(ref_config(arch).reduced())
    rparams, _ = rapi.init(jax.random.PRNGKey(0))
    max_seq = PROMPT + NEW
    logits, cache = jax.jit(lambda p, b: rapi.prefill(p, b, max_seq))(rparams, {"tokens": jnp.asarray(prompts)})
    decode = jax.jit(rapi.decode_step)
    cur = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    want = [np.asarray(cur)]
    for _ in range(NEW):
        logits, cache = decode(rparams, cur, cache)
        cur = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(cur))
    return np.concatenate(want, axis=1)


def _port_greedy(arch, prompts):
    """The port's ``greedy_generate`` on the CPU from the same weights."""
    rparams, _ = ref_build(ref_config(arch).reduced()).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    out = serve.greedy_generate(build(cfg), params, torch.from_numpy(prompts), NEW)
    assert out["ids"].shape == (prompts.shape[0], NEW + 1)
    return out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_hybrid_greedy_ids_match_reference_serving(servers, arch):
    """Reduced zamba2 (Mamba2 + shared attention) and xlstm (mLSTM + sLSTM)
    served from the port server's DACP prompts: the port's greedy ids are
    the reference serving path's."""
    port_auth, _ = servers
    prompts = serve.dacp_prompts(_uri(port_auth), 4, PROMPT)
    out = _port_greedy(arch, prompts)
    np.testing.assert_array_equal(out["ids"], _reference_greedy(arch, prompts))


def test_serve_launcher_reads_prompts_from_a_faird(servers, capsys):
    port_auth, _ = servers
    out = serve.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "3", "--prompts", _uri(port_auth)])
    printed = capsys.readouterr().out
    assert "arch=qwen1.5-0.5b" in printed and "device=cpu" in printed and "ms/tok" in printed
    assert out["ids"].shape == (2, 4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_serve_launcher_serves_hybrids(servers, arch, capsys):
    port_auth, _ = servers
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "40", "--new-tokens", "3",
                      "--prompts", _uri(port_auth)])
    assert f"arch={arch}" in capsys.readouterr().out and out["ids"].shape == (2, 4)


def test_serve_launcher_random_prompts(capsys):
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--new-tokens", "2"])
    assert out["ids"].shape == (2, 3) and "prefill(8)" in capsys.readouterr().out


def test_torch_feed_refuses_a_mesh_and_defaults_to_the_card():
    """A mesh without the batch axes, or a mesh beside a device, is refused
    (the feed over a mesh is held in tests/test_torch_distributed.py)."""
    mesh = types.SimpleNamespace(device_type="cpu", mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="not axes of the mesh"):
        TorchFeed(lambda: None, "tokens", 8, 2, mesh=mesh)
    with pytest.raises(ValueError, match="pass no device"):
        TorchFeed(lambda: None, "tokens", 8, 2, mesh=mesh, device="cpu")
    if torch.cuda.is_available():
        assert TorchFeed(lambda: None, "tokens", 8, 2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        TorchFeed(lambda: None, "tokens", 8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--new-tokens", "1"])


def test_serve_decode_torch_example_runs_on_the_cpu():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_decode_torch.py"), "--device", "cpu", "--requests", "2",
         "--prompt-len", "16", "--new-tokens", "3"],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "request batch: (2, 16) on cpu" in res.stdout and "cache index: 19" in res.stdout


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_serve_decode_torch_example_serves_hybrids(arch):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_decode_torch.py"), "--device", "cpu", "--requests", "2",
         "--prompt-len", "40", "--new-tokens", "3", "--arch", arch],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "request batch: (2, 40) on cpu" in res.stdout and "cache index: 43" in res.stdout


def test_train_lm_torch_example_runs_on_the_cpu():
    """The port's counterpart of examples/train_lm.py trains from a DACP
    feed on the CPU when asked (the card is its default)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "train_lm_torch.py"), "--device", "cpu", "--steps", "2", "--seq", "32",
         "--batch", "4"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"),
    )
    assert res.returncode == 0, res.stderr
    assert "on cpu" in res.stdout and "step     1 loss=" in res.stdout and "done; checkpoints in" in res.stdout
