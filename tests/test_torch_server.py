"""End to end on the CPU: one seeded dataset served by the reference
``FairdServer`` (numpy and pallas backends) and by the port's server (torch
backend on ``device="cpu"``) answers GET and COOK with identical bytes —
-0.0, NaN payloads, int64 wraparound and 0/0 included — and the two
packages' clients and servers talk to each other over TCP."""

import numpy as np
import pytest

pytest.importorskip("torch")

pytest.importorskip("jax")

import repro.client as ref_client  # noqa: E402
import repro.core.executor as ref_executor  # noqa: E402
import repro.core.expr as ref_expr  # noqa: E402
import repro.server as ref_server  # noqa: E402
import repro_torch.client as port_client  # noqa: E402
import repro_torch.core.executor as port_executor  # noqa: E402
import repro_torch.core.expr as port_expr  # noqa: E402
import repro_torch.server as port_server  # noqa: E402
from repro.core.batch import RecordBatch  # noqa: E402
from repro.core.sdf import StreamingDataFrame  # noqa: E402

ROWS = 3000
MORSEL = 1024
T_CUT = 1_000_000_000_000 + 1000 * 1_000


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs") / "obs"
    rng = np.random.default_rng(7)
    temp = (rng.standard_normal(ROWS) * 10).astype(np.float32)
    temp[::53] = -0.0
    temp[::61] = np.nan
    temp[5::67] = np.array([0x7FA00001], np.uint32).view(np.float32)[0]
    temp[::71] = 0.0
    pressure = (rng.standard_normal(ROWS) * 9 + 1013).astype(np.float32)
    big = rng.integers(-(2**63), 2**63 - 1, ROWS, dtype=np.int64)
    big[::5] = 2**62  # group sums overflow and wrap
    arrays = {
        "station": rng.integers(0, 12, ROWS).astype(np.int32),
        "temp": temp,
        "pressure": pressure,
        "ts": 1_000_000_000_000 + np.arange(ROWS, dtype=np.int64) * 1_000,
        "big": big,
        "value": rng.standard_normal(ROWS),
        "qc": rng.integers(0, 4, ROWS).astype(np.uint8),
    }

    def gen():
        for s in range(0, ROWS, 1000):
            yield RecordBatch.from_pydict({k: v[s : s + 1000] for k, v in arrays.items()})

    probe = RecordBatch.from_pydict({k: v[:1] for k, v in arrays.items()})
    ref_server.write_sdf_dataset(str(root), StreamingDataFrame(probe.schema, gen))
    return str(root)


def _requests(uri, col):
    """(name, fn(client)) — the same requests spelled with either package's
    ``col``.  Filters sit on computed columns so they run in the executor
    (a filter right above the source sinks into the scan)."""
    return [
        ("get", lambda c: c.get(uri, columns=["station", "temp", "ts"], predicate=col("temp") > 0.0).collect()),
        (
            "cook_agg",
            lambda c: c.open(uri)
            .project(temp_k=col("temp") + 273.15, s3=col("station") * 3 + 1, age=col("ts") - T_CUT)
            .filter(col("age") >= 0)
            .group_by("station")
            .agg(n="count", q=("sum", "qc"), s=("sum", "big"), lo=("min", "pressure"), hi=("max", "ts"), m=("mean", "temp_k"))
            .collect(),
        ),
        (
            "cook_select",
            lambda c: c.open(uri)
            .project(s3=col("station") * 3 + 1)
            .filter(col("s3") != 22)
            .select("station", "value", "ts", "temp")
            .collect(),
        ),
        (
            "cook_arith",
            lambda c: c.open(uri)
            .project(
                keep=False,
                q=col("temp") / (col("temp") * 0.0),  # 0/0, x/0, NaN payloads
                w=col("station") * 2147483647 + 5,  # int32 wraparound
                d=col("pressure") - col("temp"),
            )
            .collect(),
        ),
    ]


def _bytes(batch):
    out = {}
    for f, c in zip(batch.schema, batch.columns):
        out[f.name] = (c.offsets.tobytes() + c.data.tobytes()) if f.dtype.is_varwidth else c.values.tobytes()
    return batch.schema.to_json(), batch.num_rows, out


def _serve(pkg_server, pkg_executor, dataset, tcp=False, **cfg):
    import socket

    port = 0
    if tcp:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    authority = f"127.0.0.1:{port}" if tcp else "h1:3101"
    srv = pkg_server.FairdServer(authority, executor=pkg_executor.ExecutorConfig(num_workers=2, morsel_rows=MORSEL, **cfg))
    srv.catalog.register_path("obs", dataset)
    if tcp:
        srv.serve_tcp(port=port)
    return srv, authority


def _answers_inproc(pkg_client, pkg_server, pkg_executor, col, dataset, **cfg):
    srv, auth = _serve(pkg_server, pkg_executor, dataset, **cfg)
    net = pkg_client.LocalNetwork()
    net.register(srv)
    c = net.client_for(auth)
    with np.errstate(all="ignore"):
        return {name: _bytes(fn(c)) for name, fn in _requests(f"dacp://{auth}/obs", col)}


@pytest.fixture(scope="module")
def reference_answers(dataset):
    return _answers_inproc(ref_client, ref_server, ref_executor, ref_expr.col, dataset, backend="numpy")


def test_port_server_matches_reference_numpy_server(dataset, reference_answers):
    from repro_torch.core.backend import get_backend

    bk = get_backend("torch", device="cpu")
    before = bk.kernel_calls
    got = _answers_inproc(port_client, port_server, port_executor, port_expr.col, dataset, backend="torch", device="cpu")
    assert bk.kernel_calls > before, "the port server never dispatched to its kernels"
    assert got.keys() == reference_answers.keys()
    for name in got:
        assert got[name] == reference_answers[name], f"{name}: port reply differs from the reference"
    assert reference_answers["cook_agg"][1] == 12


def test_reference_pallas_server_agrees(dataset, reference_answers):
    got = _answers_inproc(ref_client, ref_server, ref_executor, ref_expr.col, dataset, backend="pallas")
    for name in got:
        assert got[name] == reference_answers[name], f"{name}: pallas reply differs"


@pytest.mark.parametrize("direction", ["reference_client_to_port_server", "port_client_to_reference_server"])
def test_cross_wire_over_tcp(dataset, reference_answers, direction):
    if direction == "reference_client_to_port_server":
        srv, auth = _serve(port_server, port_executor, dataset, tcp=True, backend="torch", device="cpu")
        net, col = ref_client.TcpNetwork(), ref_expr.col
    else:
        srv, auth = _serve(ref_server, ref_executor, dataset, tcp=True, backend="numpy")
        net, col = port_client.TcpNetwork(), port_expr.col
    try:
        c = net.client_for(auth)
        assert c.ping()
        assert c.describe(f"dacp://{auth}/obs", scope="local")["schema"]
        with np.errstate(all="ignore"):
            got = {name: _bytes(fn(c)) for name, fn in _requests(f"dacp://{auth}/obs", col)}
        net.close_all()
    finally:
        srv.shutdown()
    for name in got:
        assert got[name] == reference_answers[name], f"{name}: reply over TCP differs"
