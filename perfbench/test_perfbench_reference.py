"""The plain reference against the port, on the CPU at a reduced size: the
COOK reference bit for bit against both backends' replies, on the cell's
query and on a query of the per-op path; the control it gives in float32
sums caught; the workload's fused plan as the port lays it out; the
table as the configuration states it.  The references import nothing of
the program."""

import ast
import socket
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.reference import cook as ref_cook  # noqa: E402
from perfbench.traffic import obs_table  # noqa: E402
from perfbench.traffic.cook import _reply_columns, compare, send, thresholds  # noqa: E402

REF_DIR = Path(__file__).resolve().parent / "reference"
WORKLOAD = harness.load_json(harness.BENCH / "workloads" / "obs16m.fused_agg.json")
FUSED_AGG = WORKLOAD["query"]
CONF = harness.load_json(harness.BENCH / "configs" / "obs16m.json")
# a second query on the per-op path: two keys, int64 min and max, a float mean and sum
PER_OP = {"project": {"st": ["col", "station"], "k": ["col", "temp_qc"], "ts": ["col", "ts"], "p": ["col", "slp"],
                      "dp": ["sub", ["mul", ["col", "slp"], 0.5], 506.5]},
          "filter": ["lt", ["col", "dp"], "$thr"], "group_by": ["st", "k"],
          "agg": {"n": ["count"], "lo": ["min", "ts"], "hi": ["max", "ts"], "m": ["mean", "dp"], "sp": ["sum", "p"]}}
SMALL = dict(stations=48, parts=8)


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro", "repro_torch")], names


def _server(root: str, backend: str):
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.server import FairdServer

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = FairdServer(f"127.0.0.1:{port}", executor=ExecutorConfig(backend=backend, device="cpu",
                                                                      morsel_rows=262144))
    server.catalog.register_path("obs", root)
    server.serve_tcp(port=port)
    return server, f"127.0.0.1:{port}"


@pytest.fixture(scope="module")
def obs_parts(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs") / "obs"
    conf = dict(CONF, **SMALL)
    parts = obs_table.columns(conf, 2**33 + 5)
    assert obs_table.write(str(root), parts) == 48 * 8760
    return str(root), parts


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("query, thrs", [(FUSED_AGG, thresholds(7, 10.0, 30.0, 40, 4, 0.01)[:3]),
                                         (PER_OP, [0.25, -3.5])], ids=["fused_agg", "per_op"])
def test_cook_reference_is_bit_identical_to_the_port(obs_parts, backend, query, thrs):
    from repro_torch.client import TcpNetwork

    root, parts = obs_parts
    server, auth = _server(root, backend)
    net = TcpNetwork()
    try:
        for thr in thrs:
            got = _reply_columns(send(net.client_for(auth), f"dacp://{auth}/obs", query, thr))
            want = ref_cook.run(query, parts, thr, 65536)
            assert list(got) == query["group_by"] + list(query["agg"])
            assert compare(got, want) == 0, thr
            assert len(want["st"]) >= 30
            floats = [v for v in want.values() if v.dtype.kind == "f"]
            assert floats and not any(np.isnan(v).any() for v in floats)  # no aggregate poisoned by NaN
    finally:
        net.close_all()
        server.shutdown()


def test_cook_control_in_float32_sums_is_caught_in_nearly_every_group(obs_parts):
    _, parts = obs_parts
    want = ref_cook.run(FUSED_AGG, parts, 20.03, 65536)
    low = ref_cook.run(FUSED_AGG, parts, 20.03, 65536, np.float32)
    groups = len(want["st"])  # only a group of a few warm hours can sum alike in float32
    assert compare({"t_mean": low["t_mean"]}, {"t_mean": want["t_mean"]}) >= 0.8 * groups
    assert compare({"dh": low["degree_hours"]}, {"dh": want["degree_hours"]}) >= 0.8 * groups
    assert compare(want, want) == 0


def test_the_workloads_fused_plan_is_the_ports_layout(obs_parts, monkeypatch):
    """Every launch of the cell's COOK takes the tables ``fused_plan`` names
    (a table the plan leaves unused rides as the kernel's width-1 dummy)."""
    from repro_torch.client import TcpNetwork
    from repro_torch.kernels import ops

    seen = []
    real = ops.fused_chain_tiles

    def spy(scalars, pred, gidx, pass_tbl, limb, mmf, mmi, af, ai, **static):
        seen.append(({"pred_cols": pred.shape[1], "pass_cols": pass_tbl.shape[1], "limb_sums": limb.shape[1],
                      "min_f32": mmf.shape[1], "max_i32": mmi.shape[1], "af_cols": af.shape[1],
                      "ai_cols": ai.shape[1]},
                     {"computed_f32": len(static["descrs_f"]), "computed_i32": len(static["descrs_i"]),
                      "csums": len(static["csums"]), "with_gidx": static["with_gidx"]}))
        return real(scalars, pred, gidx, pass_tbl, limb, mmf, mmi, af, ai, **static)

    monkeypatch.setattr(ops, "fused_chain_tiles", spy)
    root, parts = obs_parts
    server, auth = _server(root, "torch")
    net = TcpNetwork()
    try:
        send(net.client_for(auth), f"dacp://{auth}/obs", FUSED_AGG, 21.07)
    finally:
        net.close_all()
        server.shutdown()
    plan = WORKLOAD["fused_plan"]
    tables = {k: max(1, plan[k] * (8 if k == "limb_sums" else 1))
              for k in ("pred_cols", "pass_cols", "limb_sums", "min_f32", "max_i32", "af_cols", "ai_cols")}
    static = {k: plan[k] for k in ("computed_f32", "computed_i32", "csums", "with_gidx")}
    assert len(seen) == sum(-(-n // 65536) for n in obs_table.part_rows(dict(CONF, **SMALL)))
    assert all(s == (tables, static) for s in seen), seen[0]


def test_the_table_is_the_configurations():
    conf = dict(CONF, stations=32, parts=4, hours=240)
    parts = obs_table.columns(conf, 2**40 + 9)
    assert [len(p["station"]) for p in parts] == obs_table.part_rows(conf) == [8 * 240] * 4
    assert all(list(p) == list(CONF["schema"]) for p in parts)
    assert all(str(p[k].dtype) == t for p in parts for k, t in CONF["schema"].items())
    assert CONF["rows"] == CONF["stations"] * CONF["hours"]
    p = parts[1]
    assert np.array_equal(np.unique(p["station"]), np.arange(8, 16))
    assert np.all(np.diff(p["ts"][:240]) == obs_table.HOUR_NS)  # a station's hours in time order
    for name, qc in (("temp", "temp_qc"), ("slp", "slp_qc")):
        bad = np.isin(p[qc], np.frombuffer(b"379", np.uint8))
        assert np.array_equal(np.isnan(p[name]), bad)  # missing or erroneous, and only those, are NaN
    again = obs_table.columns(conf, 2**40 + 9)
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for a, b in zip(parts, again) for k in a)


def test_thresholds_are_distinct_and_every_seed_sends_the_same_set():
    t = thresholds(2**40 + 3, 10.0, 30.0, 604, 4, 0.01)
    assert len(t) == len(set(t)) == 604
    assert min(t) == 12.5 and max(t) < 30.0
    for r in range(0, 604, 4):  # each round holds one threshold of every stratum
        assert sorted(int((x - 10.0) // 5.0) for x in t[r : r + 4]) == [0, 1, 2, 3]
    other = thresholds(2**40 + 4, 10.0, 30.0, 604, 4, 0.01)
    assert other != t and sorted(other) == sorted(t)
