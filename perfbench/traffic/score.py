"""Traffic kind ``score``: a closed loop of one client sending COOKs that
score a hosted corpus in place, to a port ``FairdServer`` over TCP on
localhost: source = one corpus part -> ``map score_tokens`` -> the reply
(``repro_torch.models.score``: each document's log-likelihood, its count
of scored tokens and its per-token log-probabilities).

Set-up writes the corpus from the seed (``parts`` columnar datasets of
``docs_per_part`` documents: ``doc_id`` int64, ``tokens`` Binary of int32;
every part the same multiset of lengths, the quantiles (i + 1/2)/n of a
log-normal of median ``length_median`` and sigma ``length_sigma``, clipped
to [``length_min``, ``length_max``], shuffled by the seed; ids Zipf of
exponent ``zipf_s`` over the vocabulary), builds the configuration's model
on the card in the server's process (``score.hold``, weights from the
seed), starts the server and sends one warm-up COOK, whose forwards have
the shapes of every later one.  The window then runs ``--seconds``: the
other parts, each once, in an order drawn from the seed (a part scored
again would be the plan cache's replay, with no work on the card; a window
that runs out of parts ends there).

Without ``--trace`` the profiler records the card's activity alone over
the window, and ``cook_kernel_ms`` is the summed time of every kernel
(copies and fills left out) over the COOKs completed, as the ``cook``
kind reads it.  With ``--trace`` the profiler records the host's
operations too over ``trace_seconds``, started and stopped between two
COOKs (one client), for the per-layer readers.

After the window, ``check_docs`` documents drawn from the seed among the
window's replies are scored again by the plain float32 reference
(``reference.zamba2``) on the card, on the program's own weights, and
every token's log-probability is compared: the largest and the mean
absolute difference, each beside its limit (``limits``).  The control
(``CONTROL``) is the same reference with every matrix product's operands
rounded through float8_e4m3fn, on the same documents.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import sys
import tempfile
import time
from statistics import NormalDist

import numpy as np

from perfbench.harness import Check, Control, Run, Trace
from perfbench.reference import zamba2 as reference

# the reference in float8_e4m3fn products; 60 s finish the set-up and the comparison of a run's documents
CONTROL = Control("fp8", "logprob_mean_abs_diff", 60.0)
# the reduced configuration (``ArchConfig.reduced()``) under the published keys, for a CPU test
TINY_MODEL = {"hidden_size": 128, "n_mamba_heads": 8, "mamba_headdim": 32, "mamba_d_state": 16, "chunk_size": 32,
              "num_attention_heads": 4, "num_key_value_heads": 4, "attention_head_dim": 64,
              "attention_hidden_size": 256, "hybrid_layer_ids": [1, 2, 4], "num_hidden_layers": 5,
              "adapter_rank": 8, "ffn_hidden_size": 256, "intermediate_size": 256, "vocab_size": 512,
              "dtype": "float32", "tiny": True}


def tiny(cell):
    """The cell at a size a CPU test holds: the reduced model in float32,
    four parts of six short documents, two compared."""
    return dataclasses.replace(cell, config=dict(cell.config, **TINY_MODEL),
                               params=dict(cell.params, parts=4, docs_per_part=6, length_median=40, length_min=8,
                                           length_max=96, max_tokens_per_forward=256, check_docs=2))


def lengths(par: dict) -> list:
    """A part's document lengths: the log-normal's quantiles, clipped."""
    n, med, sig = par["docs_per_part"], par["length_median"], par["length_sigma"]
    q = [med * np.exp(sig * NormalDist().inv_cdf((i + 0.5) / n)) for i in range(n)]
    return [int(min(par["length_max"], max(par["length_min"], round(v)))) for v in q]


def corpus(conf: dict, par: dict, seed: int) -> list:
    """[[tokens of each document] of each part], from the seed."""
    rng = np.random.default_rng([seed, 3])
    vocab = conf["vocab_size"]
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -par["zipf_s"]
    cdf = np.cumsum(p / p.sum())
    base = lengths(par)
    parts = []
    for _ in range(par["parts"]):
        parts.append([np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1).astype(np.int32)
                      for n in rng.permutation(base)])
    return parts


def write(root: str, parts: list) -> list:
    """Each part as a columnar dataset directory of its own (``_schema.json``
    and one npz file, the layout ``write_sdf_dataset`` writes); returns the
    directories."""
    dirs, doc = [], 0
    for i, docs in enumerate(parts):
        d = os.path.join(root, f"part{i:02d}")
        os.makedirs(d)
        with open(os.path.join(d, "_schema.json"), "w") as f:
            json.dump([{"name": "doc_id", "dtype": "int64", "nullable": False},
                       {"name": "tokens", "dtype": "binary", "nullable": False}], f)
        blobs = [t.tobytes() for t in docs]
        offsets = np.concatenate([[0], np.cumsum([len(b) for b in blobs])]).astype(np.int64)
        with open(os.path.join(d, "part-00000.npz"), "wb") as f:
            np.savez(f, doc_id=np.arange(doc, doc + len(docs), dtype=np.int64), tokens__offsets=offsets,
                     tokens__data=np.frombuffer(b"".join(blobs), np.uint8))
            f.flush()
            os.fsync(f.fileno())
        doc += len(docs)
        dirs.append(d)
    return dirs


def part_order(seed: int, parts: int) -> list:
    """The parts in an order drawn from the seed: the warm-up's first."""
    return [int(i) for i in np.random.default_rng([seed, 4]).permutation(parts)]


def shapes(conf: dict, par: dict) -> dict:
    """A COOK's forwards as ``score.plan_forwards`` cuts a part: [(batch,
    padded length)], and the documents' own lengths."""
    from repro_torch.models.score import plan_forwards

    lens = lengths(par)
    plan = plan_forwards(lens, conf["chunk_size"], par["max_tokens_per_forward"])
    return {"forwards": [(len(m), size) for size, m in plan], "doc_lengths": lens}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def send(client, uri: str, conf: dict, seed: int, max_tokens: int) -> dict:
    """One scoring COOK; the reply's columns by name."""
    reply = client.open(uri).map("score_tokens", column="tokens", arch=conf["arch"], seed=int(seed),
                                 max_tokens=int(max_tokens)).collect()
    return {f.name: c for f, c in zip(reply.schema, reply.columns)}


def _blobs(col) -> list:
    return [np.frombuffer(col.data[col.offsets[i] : col.offsets[i + 1]].tobytes(), np.float32)
            for i in range(len(col.offsets) - 1)]


def compare(got, want) -> tuple:
    """(largest, mean) absolute difference of two documents' log-probabilities."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(d.max()), float(d.mean())


def run(cell, t_start: float, control: str | None = None) -> Run:
    """Drive the cell.  ``control`` ("fp8") also scores the compared
    documents with the reference in float8 products (``facts["control"]``)."""
    import torch

    from repro_torch.client import TcpNetwork
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.kernels import ops
    from repro_torch.models import score
    from repro_torch.server import FairdServer

    conf, par = cell.config, cell.params
    tmp = tempfile.mkdtemp(prefix="perfbench_score_")
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
        counts0 = score.STATS.snapshot()
        scans0 = ops.LAUNCHES["ssd_scan"].value
        t0 = time.perf_counter()
        t_end = t0 + cell.seconds
        traced = {"cooks": 0}
        k = 1
        while (time.perf_counter() < t_end or not done) and k < len(order):
            if trace.enabled and trace.prof is None and not traced["cooks"] and time.perf_counter() >= t0:
                trace.start()
                traced["counts"] = score.STATS.snapshot()
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
                    trace.stop()
                    traced["counts"] = {n: v - traced["counts"][n] for n, v in score.STATS.snapshot().items()}
        if trace.prof is not None:
            trace.stop()
            traced["counts"] = {n: v - traced["counts"][n] for n, v in score.STATS.snapshot().items()}
        card.stop()
        kernel_s = sum(v for n, v in card.kernels.items() if not n.startswith(("Memcpy", "Memset")))
        kernel_ms = kernel_s / len(done) * 1e3 if card.enabled and done and kernel_s > 0 else None
        peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
        counts = {n: v - counts0[n] for n, v in score.STATS.snapshot().items()}
        scans = ops.LAUNCHES["ssd_scan"].value - scans0

        # correctness: documents drawn from the seed among the window's replies, every token
        rng = np.random.default_rng([cell.seed, 5])
        pairs = [(d, j) for d in range(len(done)) for j in range(par["docs_per_part"])]
        pick = [pairs[p] for p in rng.choice(len(pairs), size=min(par["check_docs"], len(pairs)), replace=False)]
        worst, means, ctl_worst, ctl_means = [], [], [], []
        for d, j in pick:
            _t, i, reply = done[d]
            doc = int(reply["doc_id"].values[j])
            tokens = torch.from_numpy(parts[i][doc - i * par["docs_per_part"]])
            got = _blobs(reply["logprobs"])[j]
            want = reference.logprobs(params, tokens, conf, device=params["embed"]["table"].device).cpu().numpy()
            mx, mean = compare(got, want) if len(want) == len(got) else (float("inf"), float("inf"))
            worst.append(mx)
            means.append(mean)
            if control == CONTROL.name:
                low = reference.logprobs(params, tokens, conf, fp8=True, device=params["embed"]["table"].device)
                mx, mean = compare(low.cpu().numpy(), want)
                ctl_worst.append(mx)
                ctl_means.append(mean)
        lim = par["limits"]
        checks = [Check("logprob_max_abs_diff", max(worst) if pick else float("inf"), lim["logprob_max_abs_diff"]),
                  Check("logprob_mean_abs_diff", float(np.mean(means)) if pick else float("inf"),
                        lim["logprob_mean_abs_diff"])]
        facts = dict(shapes(conf, par), setup_s=setup_s, cooks=len(done) + len(errors), conf=conf,
                     traced_cooks=traced["cooks"], score_counts=traced.get("counts") if trace.enabled else counts,
                     control={"logprob_max_abs_diff": max(ctl_worst), "logprob_mean_abs_diff": float(np.mean(ctl_means))}
                     if control and pick else None)
        return Run(attempted=len(done) + len(errors), failed=len(errors), end_to_end={"cook_kernel_ms": kernel_ms},
                   checks=checks, memory_peak_bytes=int(peak), trace=trace, facts=facts,
                   samples={"cooks completed": len(done), "documents compared": len(pick),
                            "per document (largest, mean) |difference|": [(round(a, 6), round(b, 7))
                                                                          for a, b in zip(worst, means)],
                            "scoring counters over the window": counts,
                            "card seconds by operation": sorted(card.kernels.items(), key=lambda kv: -kv[1])[:8],
                            "card busy seconds (their union)": card.busy_s,
                            # a profile that drops kernel records reads fewer out kernels than the program launched
                            "ssd_scan launches (program, card profile)": (scans, card.kernel_launches("ssd_scan_kernel_out")),
                            "cook seconds in order": [round(b[0] - a[0], 3) for a, b in zip(done, done[1:])]})
    finally:
        if net is not None:
            net.close_all()
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
