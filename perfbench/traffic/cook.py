"""Traffic kind ``cook``: a closed loop of client sessions sending one COOK
each after the last reply, to a port ``FairdServer`` over TCP on localhost.

Set-up makes the configuration's table from the seed (the generator its
file names, ``traffic/<table>.py``), writes it under the run's temporary
directory, starts the server on the card and sends one warm-up COOK from
every client over the whole table (the same plan and morsels as the
window's, at a threshold of its own), so that the allocator and the
pinned staging are grown before the window opens.  The window then runs
``--seconds``.  Each request's threshold comes from the seed, distinct
from every other of the run, so the plan cache answers none.  After the
window, a sample of the replies drawn from the seed is held to the numpy
reference bit for bit.

Without ``--trace`` the profiler records the card's activity alone, from
before the window opens until every COOK it started has ended:
``cook_kernel_ms`` is the summed time of every kernel over those COOKs.
The copies' times are printed beside it and not counted: under four
workers they overlap on the copy engines, and their sum follows the
host's pace.  With ``--trace`` it records the host's operations too, over
``trace_seconds``, for the per-layer readers.  Either way the rate of
source rows on the host clock, over the window, is ``facts["rows_per_s"]``.

Workload parameters: ``query`` (the COOK in ``reference.cook``'s JSON
form, its threshold ``"$thr"``), ``fused_plan`` (the tables of the fused
chain's launch, for ``counts.dataplane``), ``clients``, ``thr_lo`` /
``thr_hi`` / ``thr_levels`` / ``thr_step`` (the thresholds' range, its
strata, one a client, so the requests in flight together cover every
selectivity, and the step between rounds), ``max_requests``,
``check_replies`` (replies compared), ``trace_seconds`` (the profiled part
of a ``--trace 1`` window).
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import socket
import sys
import tempfile
import threading
import time

import numpy as np

from perfbench.counts.dataplane import TILE
from perfbench.harness import Check, Control, Run, Trace, rate
from perfbench.reference import cook as reference

# the reference with float32 sums for the configuration's float64 sums and means; 25 s finish and compare as many
# replies as a run does
CONTROL = Control("float32", "reply_values_differing", 25.0)


def tiny(cell):
    """The cell at a size a CPU test holds: a smaller table, fewer clients
    and replies compared."""
    return dataclasses.replace(cell, config=dict(cell.config, stations=32, parts=4),
                               params=dict(cell.params, clients=2, check_replies=2))


def _expr(e, thr: float):
    """A query's expression (``reference.cook``'s JSON form) as the port's ``Expr``."""
    from repro_torch.core.expr import Expr, col, lit

    if e == "$thr":
        return lit(thr)
    if isinstance(e, (int, float)):
        return lit(e)
    if e[0] == "col":
        return col(e[1])
    return Expr(e[0], (_expr(e[1], thr), _expr(e[2], thr)))


def send(client, uri: str, query: dict, thr: float):
    """The query as the port's client builds it, sent and collected."""
    frame = client.open(uri)
    if "project" in query:
        frame = frame.project(keep=False, **{k: _expr(e, thr) for k, e in query["project"].items()})
    if "filter" in query:
        frame = frame.filter(_expr(query["filter"], thr))
    aggs = {name: spec[0] if len(spec) == 1 else tuple(spec) for name, spec in query["agg"].items()}
    return frame.group_by(*query["group_by"]).agg(**aggs).collect()


def thresholds(seed: int, lo: float, hi: float, count: int, levels: int, step: float) -> list:
    """``count`` distinct thresholds in rounds of ``levels``: round r holds
    the midpoints of ``levels`` equal strata of [lo, hi), each raised by
    ``step`` x r, in an order drawn from the seed.  Every seed's run sends
    the same thresholds (the same selectivities, so the same work) in
    another order, and no two of a run share a plan."""
    rng = np.random.default_rng([seed, 1])
    base = lo + (np.arange(levels) + 0.5) * (hi - lo) / levels
    out: list = []
    for r in range(-(-count // levels)):
        out += [round(float(base[k]) + step * r, 6) for k in rng.permutation(levels)]
    return out[:count]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reply_columns(batch) -> dict:
    return {f.name: np.asarray(c.values) for f, c in zip(batch.schema, batch.columns)}


def compare(got: dict, want: dict) -> int:
    """Values of the reply that are not bit-identical to the reference's
    (a column of another type or length counts every value)."""
    bad = 0
    for name, w in want.items():
        g = got.get(name)
        if g is None or g.dtype != w.dtype or g.shape != w.shape:
            bad += max(len(w), 0 if g is None else len(g), 1)
            continue
        gb = g.view(np.uint8).reshape(len(g), -1)
        wb = w.view(np.uint8).reshape(len(w), -1)
        bad += int((gb != wb).any(axis=1).sum())
    return bad


def shapes(query: dict, parts: list, morsel_rows: int) -> dict:
    """A COOK's shapes as the executor cuts it: its rows, its morsels, their
    tiles, and the groups the morsels fold (each morsel's distinct keys,
    summed)."""
    cut = []
    for table in parts:
        rows = len(next(iter(table.values())))
        cut += [(table, a, min(morsel_rows, rows - a)) for a in range(0, rows, morsel_rows)]
    key = [query.get("project", {}).get(k, ["col", k]) for k in query["group_by"]]
    slots = 0
    for table, a, n in cut:
        m = {k: v[a : a + n] for k, v in table.items()}
        cols = [np.asarray(reference.evaluate(e, m, 0.0)) for e in key]
        slots += len(np.unique(cols[0] if len(cols) == 1 else np.rec.fromarrays(cols)))
    return {"rows_per_cook": sum(n for _t, _a, n in cut), "morsels_per_cook": len(cut),
            "tiles_per_cook": sum(-(-n // TILE) for _t, _a, n in cut), "group_slots_per_cook": slots}


def run(cell, t_start: float, control: str | None = None) -> Run:
    """Drive the cell.  ``control`` ("float32") also reads the reference
    with float32 sums in the program's place on the same sample (the
    control's reading, in ``facts``)."""
    import torch

    from repro_torch.client import TcpNetwork
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.kernels import ops
    from repro_torch.server import FairdServer

    conf, par = cell.config, cell.params
    query = par["query"]
    morsel = min(conf["morsel_rows"], conf["scan_batch_rows"])
    tmp = tempfile.mkdtemp(prefix="perfbench_cook_")
    server = None
    nets = []
    try:
        table = importlib.import_module(f"perfbench.traffic.{conf['table']}")
        parts = table.columns(conf, cell.seed)
        rows = table.write(os.path.join(tmp, "obs"), parts)
        port = _free_port()
        authority = f"127.0.0.1:{port}"
        server = FairdServer(authority, executor=ExecutorConfig(backend=conf["backend"], device=cell.device,
                                                                morsel_rows=conf["morsel_rows"]))
        server.catalog.register_path("obs", os.path.join(tmp, "obs"))
        server.serve_tcp(port=port)
        uri = f"dacp://{authority}/obs"
        nets = [TcpNetwork() for _ in range(par["clients"])]
        clients = [net.client_for(authority) for net in nets]
        thrs = thresholds(cell.seed, par["thr_lo"], par["thr_hi"], par["max_requests"] + par["clients"],
                          par["thr_levels"], par["thr_step"])
        warm, thrs = thrs[: par["clients"]], thrs[par["clients"]:]
        warmers = [threading.Thread(target=send, args=(c, uri, query, t)) for c, t in zip(clients, warm)]
        for w in warmers:
            w.start()
        for w in warmers:
            w.join()
        trace = Trace(cell.trace and cell.device == "cuda")
        card = Trace(not cell.trace and cell.device == "cuda", host_ops=False)  # the card's kernels, whole window
        trace.warm()
        card.start()  # its first start, which takes seconds, falls here in set-up
        if cell.device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        lock = threading.Lock()
        done: list = []  # (completion time, rows, thr, reply columns, seconds)
        errors: list = []
        nxt = [0]
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        launches0 = ops.LAUNCHES["fused_chain_tiles"].value

        def loop(client):
            while time.perf_counter() < t_end:
                with lock:
                    if nxt[0] >= len(thrs):
                        return
                    thr = thrs[nxt[0]]
                    nxt[0] += 1
                s = time.perf_counter()
                try:
                    reply = send(client, uri, query, thr)
                except Exception as e:  # noqa: BLE001 - a failed request is counted, and printed
                    errors.append(repr(e))
                    print(f"perfbench: request thr={thr} failed: {e!r}", file=sys.stderr)
                    continue
                e = time.perf_counter()
                with lock:
                    done.append((e, rows, thr, _reply_columns(reply), e - s))

        threads = [threading.Thread(target=loop, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        if trace.enabled:
            trace.start()
            time.sleep(min(par["trace_seconds"], cell.seconds))
            trace.stop()
        for t in threads:
            t.join()
        card.stop()
        launches = ops.LAUNCHES["fused_chain_tiles"].value - launches0
        rows_per_s, completed = rate([(d[0], d[1]) for d in done], t0, t_end)
        # every COOK the window started has ended inside the card's trace
        kernel_s = sum(v for k, v in card.kernels.items() if not k.startswith(("Memcpy", "Memset")))
        kernel_ms = kernel_s / len(done) * 1e3 if card.enabled and done and kernel_s > 0 else None
        peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0

        # correctness: a sample of the replies drawn from the seed, bit for bit
        rng = np.random.default_rng([cell.seed, 2])
        order = sorted(done, key=lambda d: d[2])
        pick = rng.choice(len(order), size=min(par["check_replies"], len(order)), replace=False) if order else []
        bad, control_bad = 0, 0
        for i in pick:
            want = reference.run(query, parts, order[i][2], morsel)
            bad += compare(order[i][3], want)
            if control == "float32":
                control_bad += compare(reference.run(query, parts, order[i][2], morsel, np.float32), want)
        checks = [Check("reply_values_differing", float(bad) if len(pick) else float("inf"), 0.0)]
        attempted = len(done) + len(errors)
        facts = dict(shapes(query, parts, morsel), setup_s=setup_s, rows_per_s=rows_per_s, cooks=attempted,
                     fused_launches=launches,
                     fused_plan=par["fused_plan"],
                     control={"reply_values_differing": control_bad} if control else None)
        count = next((n for n, spec in query["agg"].items() if spec[0] == "count"), None)
        if done and count:
            facts["survivors_per_cook"] = sum(int(d[3][count].sum()) for d in done) / len(done)
        return Run(attempted=attempted, failed=len(errors),
                   end_to_end={"cook_kernel_ms": kernel_ms}, checks=checks, memory_peak_bytes=int(peak),
                   trace=trace, facts=facts,
                   samples={"cooks completed in the window": completed, "replies compared": len(pick),
                            "rows/s on the host clock": rows_per_s,
                            "card seconds by operation": sorted(card.kernels.items(), key=lambda kv: -kv[1])[:8],
                            "card busy seconds (their union)": card.busy_s,
                            "cook (threshold, seconds) in order": [(d[2], round(d[4], 3)) for d in sorted(done)]})
    finally:
        for net in nets:
            net.close_all()
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
