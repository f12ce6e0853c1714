"""Traffic kind ``score_granite``: the ``score`` kind's closed loop of one
client scoring a hosted corpus in place (``traffic/score.py``: the corpus,
its parts and their order, the COOK, the comparison), run with a
GraniteMoeHybrid model (``perfbench/configs/granite-4.0-h-small.json``'s
keys) and held to its own plain float32 reference
(``reference.granitemoehybrid``).

What it adds to the ``score`` kind: the forwards' shapes take the SSD
chunk from ``mamba_chunk_size``; the MoE's counters
(``repro_torch.models.moe.STATS``) are read over the window and over the
traced part of it (``facts["moe_counts"]``, which ``moe_experts_roofline``
reads), and the check ``moe_slots_dropped`` (limit 0) holds the window's
MoE layers to dropping no (token, expert) assignment.  A program without
the configuration fails at once, before any corpus is written.

The control (``CONTROL``) is the reference with every matrix product's
operands rounded through float8_e4m3fn, on the same documents.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
import tempfile
import time

import numpy as np

from perfbench.harness import Check, Control, Run, Trace
from perfbench.reference import granitemoehybrid as reference
from perfbench.traffic.score import _blobs, _free_port, compare, corpus, lengths, part_order, send, write

# the reference in float8_e4m3fn products; 120 s finish the set-up and the comparison of a run's documents
CONTROL = Control("fp8", "logprob_mean_abs_diff", 120.0)
# the reduced configuration (``ArchConfig.reduced()``) under the published keys, for a CPU test
TINY_MODEL = {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2, "mamba_n_heads": 8,
              "mamba_d_head": 32, "mamba_d_state": 16, "mamba_chunk_size": 32, "num_local_experts": 8,
              "num_experts_per_tok": 3, "intermediate_size": 64, "shared_intermediate_size": 96,
              "layer_types": ["mamba", "mamba", "attention", "mamba"], "num_hidden_layers": 4, "vocab_size": 512,
              "dtype": "float32", "tiny": True}


def tiny(cell):
    """The cell at a size a CPU test holds: the reduced model in float32,
    four parts of six short documents, two compared."""
    return dataclasses.replace(cell, config=dict(cell.config, **TINY_MODEL),
                               params=dict(cell.params, parts=4, docs_per_part=6, length_median=40, length_min=8,
                                           length_max=96, max_tokens_per_forward=256, check_docs=2))


def shapes(conf: dict, par: dict) -> dict:
    """A COOK's forwards as ``score.plan_forwards`` cuts a part: [(batch,
    padded length)], and the documents' own lengths."""
    from repro_torch.models.score import plan_forwards

    lens = lengths(par)
    plan = plan_forwards(lens, conf["mamba_chunk_size"], par["max_tokens_per_forward"])
    return {"forwards": [(len(m), size) for size, m in plan], "doc_lengths": lens}


def _delta(now: dict, before: dict) -> dict:
    return {n: v - before[n] for n, v in now.items()}


def run(cell, t_start: float, control: str | None = None) -> Run:
    """Drive the cell.  ``control`` ("fp8") also scores the compared
    documents with the reference in float8 products (``facts["control"]``)."""
    from repro_torch.configs import get_config

    conf, par = cell.config, cell.params
    get_config(conf["arch"])  # a program without the configuration stops here
    import torch

    from repro_torch.client import TcpNetwork
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.kernels import ops
    from repro_torch.models import moe, score
    from repro_torch.server import FairdServer

    tmp = tempfile.mkdtemp(prefix="perfbench_score_granite_")
    server, net = None, None
    try:
        parts = corpus(conf, par, cell.seed)
        dirs = write(tmp, parts)
        _api, params = score.hold(conf["arch"], cell.seed, cell.device, reduced=bool(conf.get("tiny")))
        port = _free_port()
        authority = f"127.0.0.1:{port}"
        server = FairdServer(authority, executor=ExecutorConfig(backend="torch", device=cell.device))
        for i, d in enumerate(dirs):
            server.catalog.register_path(f"part{i:02d}", d)
        server.serve_tcp(port=port)
        net = TcpNetwork()
        client = net.client_for(authority)
        order = part_order(cell.seed, par["parts"])

        def cook(i):
            return send(client, f"dacp://{authority}/part{i:02d}", conf, cell.seed, par["max_tokens_per_forward"])

        cook(order[0])  # warm-up: every forward shape of a part
        trace = Trace(cell.trace and cell.device == "cuda")
        card = Trace(not cell.trace and cell.device == "cuda", host_ops=False)
        trace.warm()
        card.start()
        if cell.device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        done, errors = [], []  # done: (completion time, part, reply)
        counts0, moe0 = score.STATS.snapshot(), moe.STATS.snapshot()
        launches0 = {n: c.value for n, c in ops.LAUNCHES.items()}
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        traced = {"cooks": 0}

        def stop_trace():
            trace.stop()
            traced["counts"] = _delta(score.STATS.snapshot(), traced["counts"])
            traced["moe"] = _delta(moe.STATS.snapshot(), traced["moe"])

        k = 1
        while (time.perf_counter() < t_end or not done) and k < len(order):
            if trace.enabled and trace.prof is None and not traced["cooks"] and time.perf_counter() >= t0:
                trace.start()
                traced["counts"], traced["moe"] = score.STATS.snapshot(), moe.STATS.snapshot()
            i = order[k]
            k += 1
            try:
                reply = cook(i)
            except Exception as e:  # noqa: BLE001 - a failed request is counted, and printed
                errors.append(repr(e))
                print(f"perfbench: COOK of part {i} failed: {e!r}", file=sys.stderr)
                if not done:
                    break
                continue
            done.append((time.perf_counter(), i, reply))
            if trace.prof is not None:
                traced["cooks"] += 1
                if time.perf_counter() - trace._t0 >= min(par["trace_seconds"], cell.seconds):
                    stop_trace()
        if trace.prof is not None:
            stop_trace()
        card.stop()
        kernel_s = sum(v for n, v in card.kernels.items() if not n.startswith(("Memcpy", "Memset")))
        kernel_ms = kernel_s / len(done) * 1e3 if card.enabled and done and kernel_s > 0 else None
        peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
        counts = _delta(score.STATS.snapshot(), counts0)
        moe_counts = _delta(moe.STATS.snapshot(), moe0)
        launches = {n: c.value - launches0[n] for n, c in ops.LAUNCHES.items() if c.value > launches0[n]}

        # correctness: documents drawn from the seed among the window's replies, every token
        rng = np.random.default_rng([cell.seed, 5])
        pairs = [(d, j) for d in range(len(done)) for j in range(par["docs_per_part"])]
        pick = [pairs[p] for p in rng.choice(len(pairs), size=min(par["check_docs"], len(pairs)), replace=False)]
        worst, means, ctl_worst, ctl_means = [], [], [], []
        dev = params["embed"]["table"].device
        for d, j in pick:
            _t, i, reply = done[d]
            doc = int(reply["doc_id"].values[j])
            tokens = torch.from_numpy(parts[i][doc - i * par["docs_per_part"]])
            got = _blobs(reply["logprobs"])[j]
            want = reference.logprobs(params, tokens, conf, device=dev).cpu().numpy()
            mx, mean = compare(got, want) if len(want) == len(got) else (float("inf"), float("inf"))
            worst.append(mx)
            means.append(mean)
            if control == CONTROL.name:
                low = reference.logprobs(params, tokens, conf, fp8=True, device=dev)
                mx, mean = compare(low.cpu().numpy(), want)
                ctl_worst.append(mx)
                ctl_means.append(mean)
        lim = par["limits"]
        checks = [Check("logprob_max_abs_diff", max(worst) if pick else float("inf"), lim["logprob_max_abs_diff"]),
                  Check("logprob_mean_abs_diff", float(np.mean(means)) if pick else float("inf"),
                        lim["logprob_mean_abs_diff"]),
                  Check("moe_slots_dropped", moe_counts["dropped"] if moe_counts["forwards"] else float("inf"),
                        lim["moe_slots_dropped"])]
        facts = dict(shapes(conf, par), setup_s=setup_s, cooks=len(done) + len(errors), conf=conf,
                     traced_cooks=traced["cooks"], score_counts=traced.get("counts") if trace.enabled else counts,
                     moe_counts=traced.get("moe") if trace.enabled else moe_counts,
                     control={"logprob_max_abs_diff": max(ctl_worst), "logprob_mean_abs_diff": float(np.mean(ctl_means))}
                     if control and pick else None)
        return Run(attempted=len(done) + len(errors), failed=len(errors), end_to_end={"cook_kernel_ms": kernel_ms},
                   checks=checks, memory_peak_bytes=int(peak), trace=trace, facts=facts,
                   samples={"cooks completed": len(done), "documents compared": len(pick),
                            "per document (largest, mean) |difference|": [(round(a, 6), round(b, 7))
                                                                          for a, b in zip(worst, means)],
                            "scoring counters over the window": counts,
                            "MoE counters over the window": moe_counts,
                            "kernel launches over the window (program)": launches,
                            "card seconds by operation": sorted(card.kernels.items(), key=lambda kv: -kv[1])[:10],
                            "card busy seconds (their union)": card.busy_s,
                            "cook seconds in order": [round(b[0] - a[0], 3) for a, b in zip(done, done[1:])]})
    finally:
        if net is not None:
            net.close_all()
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
