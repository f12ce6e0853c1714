"""In-situ scoring: a COOK ``map`` that runs a language model where the
documents live and returns a few numbers a document instead of the text
(the perplexity filter of CCNet, arXiv:1911.00359, as a DACP operator).

    map score_tokens(column="tokens", arch="zamba2-7b", seed=0)

reads a Binary column of int32 token ids, one document a row, and replaces
it by

- ``loglik`` (float64): the sum over t >= 1 of log p(token_t | tokens_<t);
- ``n_scored`` (int32): the number of those terms (the length less one);
- ``logprobs`` (Binary): the per-token float32 log-probabilities.

The model is ``model_zoo.build(cfg)`` on the normal path, held once per
process and keyed by (arch, seed): ``hold`` builds it (weights drawn from
a generator seeded with ``seed``, on the process's card unless asked for
the CPU) when the server starts.  The map scores only with a model held
so; a request for another (arch, seed) fails with a ``PlanError`` and
builds nothing, so that no client can pin more models on a shared card.

A morsel's documents go through ``forward`` in groups (``plan_forwards``):
longest first, each right-padded to a multiple of the SSD chunk, a group
padded to its first document's length and holding at most ``MAX_TOKENS``
padded tokens; a document starts a new group where its padded length is
below ``SHRINK`` of the group's, so that short documents are not padded to
long ones.  Right padding cannot change a causal model's earlier
positions.  The log-softmax of the real positions runs in slices of
``SLICE_ROWS`` rows, so no (tokens × vocab) float32 tensor is ever whole,
and the morsel's log-probabilities come back to the host in one copy.

Spans (``trace``): ``score`` (the map on one morsel), inside it a
``forward`` per group and a ``logprob`` per group; a MoE model's ``moe``
and ``route`` spans (``models.moe``) open inside ``forward``.  Counters: ``STATS``
(a ``ScoreStats``: documents, forwards, real and padded tokens).
Importing this module registers the map, as ``repro_torch.data`` registers
``tokenize_and_pack``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch
from repro_torch.core.errors import PlanError
from repro_torch.core.operators import register_map
from repro_torch.core.schema import Field, Schema

__all__ = ["MAX_TOKENS", "SCORE_FIELDS", "STATS", "ScoreStats", "hold", "held", "plan_forwards"]

MAX_TOKENS = 32768  # padded tokens a forward
SHRINK = 0.75  # a document whose padded length is below this share of its group's starts a new group
SLICE_ROWS = 4096  # rows of a log-softmax slice
SCORE_FIELDS = (Field("loglik", dtypes.resolve("float64")), Field("n_scored", dtypes.resolve("int32")),
                Field("logprobs", dtypes.BINARY))


@dataclasses.dataclass
class ScoreStats:
    """Counters of the scoring map over the process's life."""

    documents: int = 0
    forwards: int = 0
    real_tokens: int = 0  # the documents' own tokens
    padded_tokens: int = 0  # every token position a forward ran, padding included
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    def add(self, documents: int, forwards: int, real: int, padded: int) -> None:
        with self._lock:
            self.documents += documents
            self.forwards += forwards
            self.real_tokens += real
            self.padded_tokens += padded

    def snapshot(self) -> dict:
        with self._lock:
            return {"documents": self.documents, "forwards": self.forwards, "real_tokens": self.real_tokens,
                    "padded_tokens": self.padded_tokens}


STATS = ScoreStats()

_models: dict = {}  # (arch, seed) -> (ModelApi, params)
_models_lock = threading.Lock()


def hold(arch: str, seed: int, device=None, reduced: bool = False):
    """Build and keep the model scored under (arch, seed): ``get_config(arch)``
    (its ``reduced()`` form if asked), weights from a generator seeded with
    ``seed`` on ``device``.  Returns (api, params)."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    with _models_lock:
        key = (arch, int(seed))
        if key not in _models:
            cfg = get_config(arch)
            if reduced:
                cfg = cfg.reduced()
            dev = device_mod.resolve(device)
            api = model_zoo.build(cfg)
            _models[key] = (api, api.init(torch.Generator(device=dev).manual_seed(int(seed)), dev))
        return _models[key]


def held(arch: str, seed: int):
    """The model held under (arch, seed); a ``PlanError`` if none is."""
    with _models_lock:
        got = _models.get((arch, int(seed)))
    if got is None:
        raise PlanError(f"score_tokens: this server holds no model {arch!r} of seed {int(seed)}")
    return got


def plan_forwards(lengths, chunk: int, max_tokens: int = MAX_TOKENS) -> list:
    """[(padded length, [document index])]: the forwards of a morsel's
    documents, longest first (see the module's docstring)."""
    groups: list = []
    for i in sorted(range(len(lengths)), key=lambda i: (-lengths[i], i)):
        padded = -(-max(int(lengths[i]), 1) // chunk) * chunk
        if groups:
            size, members = groups[-1]
            if padded >= SHRINK * size and (len(members) + 1) * size <= max_tokens:
                members.append(i)
                continue
        groups.append((padded, [i]))
    return groups


def _score_schema(schema: Schema, column: str = "tokens", **params) -> Schema:
    return Schema([f for f in schema.fields if f.name != column] + list(SCORE_FIELDS))


def _logprobs(logits, tokens, lengths) -> torch.Tensor:
    """The real positions' log-probabilities of one forward, float32, each
    document's t = 1 .. n-1 in order: logits (B, L, V), tokens (B, L)."""
    b, seq, vocab = logits.shape
    rows = torch.cat([torch.arange(k * seq, k * seq + n - 1, device=logits.device) for k, n in enumerate(lengths)])
    targets = tokens.reshape(-1)[rows + 1]
    flat = logits.reshape(b * seq, vocab)
    out = torch.empty(rows.numel(), dtype=torch.float32, device=logits.device)
    for a in range(0, rows.numel(), SLICE_ROWS):
        lp = torch.log_softmax(flat[rows[a : a + SLICE_ROWS]].float(), dim=-1)
        out[a : a + SLICE_ROWS] = lp.gather(-1, targets[a : a + SLICE_ROWS, None].long())[:, 0]
    return out


def _score_tokens(batch: RecordBatch, column: str = "tokens", arch: str = "zamba2-7b", seed: int = 0,
                  max_tokens: int = MAX_TOKENS) -> RecordBatch:
    sp = trace.ON and trace.begin("score")
    api, params = held(arch, seed)
    dev = params["embed"]["table"].device
    col = batch.column(column)
    docs = [np.frombuffer(col.data[col.offsets[i] : col.offsets[i + 1]].tobytes(), np.int32)
            for i in range(batch.num_rows)]
    lengths = [len(d) for d in docs]
    groups = plan_forwards(lengths, api.cfg.ssm.chunk if api.cfg.ssm else 1, int(max_tokens))
    parts, padded = [], 0
    with torch.no_grad():
        for size, members in groups:
            sf = trace.ON and trace.begin("forward", leaf=True)
            host = np.zeros((len(members), size), np.int32)
            for k, i in enumerate(members):
                host[k, : lengths[i]] = docs[i]
            tokens = torch.from_numpy(host).to(dev, non_blocking=False)
            logits, _ = api.forward(params, {"tokens": tokens})
            padded += host.size
            if sf:
                trace.finish(sf)
            sl = trace.ON and trace.begin("logprob", leaf=True)
            parts.append((members, _logprobs(logits, tokens, [lengths[i] for i in members])))
            del logits
            if sl:
                trace.finish(sl)
        flat = torch.cat([lp for _, lp in parts]).cpu().numpy() if parts else np.zeros(0, np.float32)
    per_doc: list = [None] * len(docs)
    at = 0
    for members, lp in parts:
        for i in members:
            n = max(lengths[i] - 1, 0)
            per_doc[i] = flat[at : at + n]
            at += n
    STATS.add(len(docs), len(groups), sum(lengths), padded)
    keep = [(f, c) for f, c in zip(batch.schema, batch.columns) if f.name != column]
    f64, i32 = SCORE_FIELDS[0].dtype, SCORE_FIELDS[1].dtype
    new = [Column.from_values(f64, np.array([float(np.sum(p, dtype=np.float64)) for p in per_doc], np.float64)),
           Column.from_values(i32, np.array([len(p) for p in per_doc], np.int32)),
           Column.from_values(dtypes.BINARY, [p.astype(np.float32).tobytes() for p in per_doc])]
    out = RecordBatch(Schema([f for f, _ in keep] + list(SCORE_FIELDS)), [c for _, c in keep] + new)
    if sp:
        trace.finish(sp)
    return out


_score_tokens.schema_fn = _score_schema
register_map("score_tokens", reads=("*",), writes=tuple(f.name for f in SCORE_FIELDS))(_score_tokens)
