"""Memory-budgeted spill-to-disk for pipeline breakers (grace hash).

DACP's reverse supply makes a faird server run COOK computation over data
sized by *remote* domains, so the build-side state of the two pipeline
breakers — the aggregate fold's ``GroupState`` and the join build's hash
table — must not grow unbounded with input the operator never chose.  This
module supplies the pieces the executor uses to keep every breaker inside a
shared byte budget:

  * ``MemoryAccountant`` — one per executor run, shared by all concurrent
    pipelines; breakers account their state bytes against the configured
    ``memory_budget`` and switch to grace-hash mode when the *combined*
    usage crosses it.  It also carries the run's spill counters
    (partitions/batches/bytes written, recursion depth), exported through
    ``ExecutorStats`` → ``engine.executor_stats()`` → PING.
  * ``SpillFile`` / ``SpillSet`` — partitioned spill files that reuse the
    RecordBatch **wire framing** (SCHEMA frame, BATCH frames with the
    writev-style zero-copy buffer parts, END frame): a spilled batch
    round-trips through exactly the serialization the transport already
    exercises, and partition readers stream batches back morsel-sized.
  * value-consistent **key hashing** (``partition_ids``) — rows are
    partitioned by a salted hash of their key *values* under python
    equality semantics (int 5 == 5.0 == np.int32(5), ``-0.0 == 0.0``,
    masked keys are one null class), so two rows that would land in the
    same group / join match can never be split across partitions.  Hash
    collisions merely co-locate unrelated keys — never a correctness
    hazard.  Each recursion level re-salts the hash so an oversized
    partition actually splits.
  * ``GraceHashAggregate`` — the aggregate breaker's spill mode.  It spills
    **partial GroupStates** (one state batch per morsel, scattered by key
    hash) rather than raw rows: per-group accumulator merge order is then
    exactly the in-memory morsel order, so results — including float partial
    sums — are **byte-identical** to in-memory execution.  Every state row
    carries a monotone first-seen id; after per-partition re-aggregation the
    groups are re-sorted by the minimum id, reproducing the in-memory
    first-seen group order bit-for-bit.  A partition that still exceeds the
    budget is recursively re-partitioned with the next hash salt.
  * grace-hash join (``collect_build`` / ``spilled_join_stream``) — the
    build side scatters to partitions once its accounted bytes cross the
    budget; the probe side then scatters too (rows tagged with a global row
    id), partition pairs are joined one at a time (recursively re-split if
    a build partition is still too big), and the output is restored to the
    in-memory probe-order by a stable sort on the row ids — byte-identical
    collected results.

The Pallas ``segment_reduce`` path composes with spilling untouched: the
per-morsel folds that produce the partial states still dispatch to the
accelerator through the backend registry; only the (already vectorized,
bit-exactness-critical) state *merges* stay on numpy.
"""

from __future__ import annotations

import os
import tempfile
import threading
import zlib

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.batch import Column, RecordBatch, concat_batches
from repro_torch.core.errors import PlanError
from repro_torch.core.operators import (
    GroupState,
    build_join_table,
    join_probe_indices,
)
from repro_torch.core.schema import Field, Schema
from repro_torch.transport import framing
from repro_torch.transport.framing import FrameReader, FrameWriter

__all__ = [
    "MemoryAccountant",
    "SpillFile",
    "SpillSet",
    "GraceHashAggregate",
    "collect_build",
    "spilled_join_stream",
    "key_hashes",
    "partition_ids",
    "SPILL_MAX_DEPTH",
    "DEFAULT_SPILL_FANOUT",
    "FS_COL",
    "ROWID_COL",
]

SPILL_MAX_DEPTH = 8
DEFAULT_SPILL_FANOUT = 8
# reserved column names the spill paths append to batches in flight
FS_COL = "__dacp_fs"  # first-seen id riding on aggregate state batches
ROWID_COL = "__dacp_rowid"  # global probe row id riding on join probe batches

_I64MAX = np.iinfo(np.int64).max
# estimated python-side bytes per join hash-table row (dict slot + key tuple
# + index list entry) added on top of the raw build batch bytes
_TABLE_ROW_OVERHEAD = 96


# ---------------------------------------------------------------------------
# memory accounting (shared across the run's concurrent pipelines)
# ---------------------------------------------------------------------------
class MemoryAccountant:
    """Byte budget shared by every breaker of one executor run.

    ``budget <= 0`` disables spilling (unbounded, the default).  Breakers
    ``adjust()`` their accounted state bytes as they grow and check
    ``over()``; whichever breaker observes the combined total above budget
    spills *its own* state.  The trigger point may vary run-to-run under
    concurrency — results never do (spilled execution is byte-identical).

    Doubles as the run's spill observability: counters land in
    ``ExecutorStats.to_dict()["spill"]`` and the server PING response.
    """

    def __init__(self, budget: int = 0):
        self.budget = max(0, int(budget))
        self._lock = threading.Lock()
        self._used = 0
        self.spills = 0  # breakers that switched to grace-hash mode
        self.partitions_written = 0  # spill partition files created
        self.batches_spilled = 0
        self.bytes_spilled = 0  # framed bytes written to spill files
        self.max_depth = 0  # deepest recursive re-partition level

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def used(self) -> int:
        return self._used

    def adjust(self, delta: int) -> None:
        with self._lock:
            self._used = max(0, self._used + int(delta))

    def over(self) -> bool:
        return self.enabled and self._used > self.budget

    def note_spill(self) -> None:
        with self._lock:
            self.spills += 1

    def note_partition(self) -> None:
        with self._lock:
            self.partitions_written += 1

    def note_batch(self, nbytes: int) -> None:
        with self._lock:
            self.batches_spilled += 1
            self.bytes_spilled += int(nbytes)

    def note_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self.max_depth:
                self.max_depth = depth

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "memory_budget": self.budget,
                "used_bytes": self._used,
                "spills": self.spills,
                "partitions_written": self.partitions_written,
                "batches_spilled": self.batches_spilled,
                "bytes_spilled": self.bytes_spilled,
                "max_depth": self.max_depth,
            }


# ---------------------------------------------------------------------------
# value-consistent key hashing
# ---------------------------------------------------------------------------
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_NULL_BITS = np.uint64(0x6E756C6C6B657900)  # distinct class for masked keys
_NAN_BITS = np.uint64(0x7FF8000000000000)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, wrapping uint64 arithmetic)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _column_bits(col: Column, n: int) -> np.ndarray:
    """Per-row uint64 fingerprints under python value-equality semantics:
    equal key values (across integer widths, bool vs int, integral floats
    vs ints, str content) get equal bits; ``-0.0`` folds onto ``0.0`` and
    every NaN onto one class (NaN keys never *match* anything, so merging
    their partitions is harmless); masked (null) rows are one class."""
    if col.dtype.is_varwidth:
        bits = np.empty(n, np.uint64)
        data = memoryview(np.ascontiguousarray(col.data))
        off = col.offsets
        for i in range(n):
            bits[i] = zlib.crc32(data[off[i] : off[i + 1]])
    else:
        v = col.values
        k = v.dtype.kind
        if k == "f":
            f = v.astype(np.float64)  # exact for f16/f32
            with np.errstate(invalid="ignore"):
                # integral floats hash as their integer value (python
                # equality: 5.0 == 5) across the FULL integer-key range
                # [-2^63, 2^64) — an exactly-representable 2.0**63 must
                # land with the uint64 key 2**63, not with its float bits
                integral = np.isfinite(f) & (np.floor(f) == f) & (f >= -(2.0**63)) & (f < 2.0**64)
                neg = f < 0
                as_pos = np.where(integral & ~neg, f, 0.0).astype(np.uint64)
                as_neg = np.where(integral & neg, f, 0.0).astype(np.int64).view(np.uint64)
            as_int = np.where(neg, as_neg, as_pos)
            f = f + 0.0  # -0.0 -> +0.0
            fbits = f.view(np.uint64).copy()
            fbits[np.isnan(f)] = _NAN_BITS
            bits = np.where(integral, as_int, fbits)
        elif k == "u" and v.dtype.itemsize == 8:
            bits = v.astype(np.uint64)  # value mod 2^64, same as int64 view
        else:  # signed ints, narrow unsigned, bool — hash the python value
            bits = v.astype(np.int64).view(np.uint64)
    if col.validity is not None:
        bits = np.where(col.validity, bits, _NULL_BITS)
    return bits


def key_hashes(batch: RecordBatch, keys: list, level: int) -> np.ndarray:
    """Salted per-row key hash; a different ``level`` re-salts so recursive
    re-partitioning actually splits an oversized partition."""
    with np.errstate(over="ignore"):
        salt = _mix64(np.uint64(level + 1) * _GOLDEN)
        h = np.full(batch.num_rows, salt, np.uint64)
        for k in keys:
            h = _mix64(h ^ (_column_bits(batch.column(k), batch.num_rows) + _GOLDEN))
    return h


def partition_ids(batch: RecordBatch, keys: list, nparts: int, level: int) -> np.ndarray:
    return (key_hashes(batch, keys, level) % np.uint64(nparts)).astype(np.int64)


# ---------------------------------------------------------------------------
# wire-framed spill files
# ---------------------------------------------------------------------------
class SpillFile:
    """One spill partition: a temp file of wire frames (SCHEMA, BATCH*,
    END).  Batches round-trip through ``RecordBatch.to_buffers`` /
    ``from_buffers`` — the exact zero-copy framing the transport uses, no
    new serialization format.  ``read`` streams batches back (re-sliced to
    ``morsel_rows``) from a fresh read handle; ``close`` deletes the file."""

    def __init__(self, schema: Schema, spill_dir: str | None = None, tag: str = "spill"):
        fd, self.path = tempfile.mkstemp(prefix=f"dacp-{tag}-", suffix=".spill", dir=spill_dir)
        self._f = os.fdopen(fd, "w+b")
        self._writer = FrameWriter(self._f)
        self.schema = schema
        self._writer.write_frame(framing.SCHEMA, {"schema": schema.to_json()})
        self.batches = 0
        self.rows = 0
        self._sealed = False
        self._closed = False

    @property
    def bytes_written(self) -> int:
        return self._writer.bytes_written

    def write(self, batch: RecordBatch) -> None:
        if self._sealed or self._closed:
            raise PlanError("spill partition is sealed; cannot append")
        header, bufs = batch.to_buffers()
        self._writer.write_frame(framing.BATCH, header, RecordBatch.payload_parts(bufs))
        self.batches += 1
        self.rows += batch.num_rows

    def seal(self) -> None:
        if not self._sealed and not self._closed:
            self._writer.write_frame(framing.END, {"rows": self.rows})
            self._f.flush()
            self._sealed = True

    def read(self, morsel_rows: int | None = None):
        """Generator of the spilled batches, morsel-sized."""
        if self._closed:
            raise PlanError("spill partition already consumed/closed")
        self.seal()
        with open(self.path, "rb") as rf:
            fr = FrameReader(rf)
            ftype, header, _body = fr.read_frame()
            if ftype != framing.SCHEMA:  # pragma: no cover - writer invariant
                raise PlanError("spill file does not start with a SCHEMA frame")
            schema = Schema.from_json(header["schema"])
            while True:
                ftype, header, body = fr.read_frame()
                if ftype == framing.END:
                    return
                b = RecordBatch.from_buffers(schema, header, body)
                if morsel_rows and b.num_rows > morsel_rows:
                    for s in range(0, b.num_rows, morsel_rows):
                        yield b.slice(s, s + morsel_rows)
                else:
                    yield b

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._f.close()
        except OSError:  # pragma: no cover - best-effort cleanup
            pass
        try:
            os.unlink(self.path)
        except OSError:  # pragma: no cover - already removed
            pass


class SpillSet:
    """A fan of ``nparts`` partition spill files for one breaker level.
    ``scatter`` splits a batch by key hash and appends each slice to its
    partition (files are created lazily, so empty partitions cost nothing)."""

    def __init__(
        self,
        schema: Schema,
        keys: list,
        nparts: int,
        acct: MemoryAccountant,
        level: int = 0,
        spill_dir: str | None = None,
        tag: str = "spill",
    ):
        self.schema = schema
        self.keys = list(keys)
        self.nparts = int(nparts)
        self.acct = acct
        self.level = level
        self.spill_dir = spill_dir
        self.tag = tag
        self.files: list = [None] * self.nparts

    def scatter(self, batch: RecordBatch) -> None:
        n = batch.num_rows
        if n == 0:
            return
        pids = partition_ids(batch, self.keys, self.nparts, self.level)
        for p in np.unique(pids):
            idx = np.flatnonzero(pids == p)
            part = batch if len(idx) == n else batch.take(idx)
            f = self.files[p]
            if f is None:
                f = self.files[p] = SpillFile(self.schema, self.spill_dir, tag=f"{self.tag}-l{self.level}-p{p}")
                self.acct.note_partition()
            before = f.bytes_written
            f.write(part)
            self.acct.note_batch(f.bytes_written - before)

    def close(self) -> None:
        for f in self.files:
            if f is not None:
                f.close()


# ---------------------------------------------------------------------------
# grace-hash aggregation
# ---------------------------------------------------------------------------
class GraceHashAggregate:
    """Spill mode of the aggregate breaker (see the module docstring for the
    byte-identity argument).  Lifecycle: the executor's aggregate consumer
    creates one when the accounted ``GroupState`` bytes cross the budget,
    feeds it the prefix state and then every further per-morsel partial
    state (``spill_state``), and finally asks for the merged, first-seen
    ordered ``result()``.  ``close()`` removes every spill file."""

    def __init__(
        self,
        keys: list,
        aggs: dict,
        mode: str,
        in_schema: Schema,
        out_schema: Schema,
        acct: MemoryAccountant,
        backend=None,
        morsel_rows: int = 65536,
        fanout: int = DEFAULT_SPILL_FANOUT,
        spill_dir: str | None = None,
    ):
        self.keys = list(keys)
        self.aggs = dict(aggs)
        self.mode = mode
        self.in_schema = in_schema
        self.out_schema = out_schema
        self.acct = acct
        self.backend = backend
        self.morsel_rows = max(1, int(morsel_rows))
        self.fanout = max(2, int(fanout))
        self.spill_dir = spill_dir
        self._fs_next = 0
        self._state_fields = self._make_state_fields()
        self._state_schema = Schema(self._state_fields)
        self._sets: list = []
        self._set = self._new_set(0)
        acct.note_spill()

    # -- eligibility --------------------------------------------------------
    @staticmethod
    def supported(keys: list, aggs: dict, mode: str, in_schema: Schema) -> bool:
        """Spilling needs ≥1 key (a keyless aggregate is a single bounded
        group) and a collision-free state-batch schema."""
        if not keys:
            return False
        probe = GroupState(keys, aggs, mode, in_schema)
        state_names = set(probe._state_specs())
        names = set(keys) | state_names | {FS_COL}
        return len(names) == len(keys) + len(state_names) + 1

    def _make_state_fields(self) -> list:
        fields = [self.in_schema.field(k) for k in self.keys]
        probe = GroupState(self.keys, self.aggs, self.mode, self.in_schema)
        for name, (_init, dt) in probe._state_specs().items():
            fields.append(Field(name, dtypes.from_numpy(np.dtype(dt))))
        fields.append(Field(FS_COL, dtypes.resolve("int64")))
        return fields

    def _new_set(self, level: int) -> SpillSet:
        s = SpillSet(
            self._state_schema, self.keys, self.fanout, self.acct, level=level, spill_dir=self.spill_dir, tag="agg"
        )
        self._sets.append(s)
        return s

    # -- state <-> batch ----------------------------------------------------
    def _state_batch(self, st: GroupState, fs: np.ndarray) -> RecordBatch:
        ngroups = len(st.key_rows)
        cols = []
        for i, k in enumerate(self.keys):
            f = self.in_schema.field(k)
            cols.append(st._key_column(f, [row[i] for row in st.key_rows]))
        for name, (_init, dt) in st._state_specs().items():
            cols.append(Column(dtypes.from_numpy(np.dtype(dt)), values=np.ascontiguousarray(st.acc[name][:ngroups])))
        cols.append(Column.from_values(dtypes.resolve("int64"), np.ascontiguousarray(fs[:ngroups])))
        return RecordBatch(self._state_schema, cols)

    def _state_from_batch(self, batch: RecordBatch) -> GroupState:
        """Rehydrate a spilled state batch into a GroupState shell so the
        partition fold reuses the exact in-memory ``merge`` arithmetic."""
        st = GroupState(self.keys, self.aggs, self.mode, self.in_schema)
        key_cols = [batch.column(k) for k in self.keys]
        st.key_rows = list(zip(*[c.to_pylist() for c in key_cols]))
        st.gids = {kt: i for i, kt in enumerate(st.key_rows)}
        for name in st.acc:
            st.acc[name] = np.asarray(batch.column(name).values)
        return st

    # -- spill-side API -----------------------------------------------------
    def spill_state(self, st: GroupState) -> None:
        """Scatter one partial state (morsel fold or the in-memory prefix)
        to the level-0 partitions, assigning monotone first-seen ids."""
        ngroups = len(st.key_rows)
        if ngroups == 0:
            return
        fs = np.arange(self._fs_next, self._fs_next + ngroups, dtype=np.int64)
        self._fs_next += ngroups
        self._set.scatter(self._state_batch(st, fs))

    def result(self) -> RecordBatch:
        leaves: list = []
        for f in self._set.files:
            if f is not None:
                self._process(f, 0, leaves)
        if not leaves:
            return RecordBatch.empty(self.out_schema)
        cat = concat_batches([b for b, _fs in leaves])
        fs = np.concatenate([f for _b, f in leaves])
        return cat.take(np.argsort(fs, kind="stable"))

    def _absorb(self, total: GroupState, fs: np.ndarray, batch: RecordBatch) -> np.ndarray:
        other = self._state_from_batch(batch)
        bfs = np.asarray(batch.column(FS_COL).values)
        idx = total.merge_indexed(other)
        grow = len(total.gids) - len(fs)
        if grow > 0:
            fs = np.concatenate([fs, np.full(grow, _I64MAX, np.int64)])
        np.minimum.at(fs, idx, bfs)
        return fs

    def _process(self, f: SpillFile, level: int, leaves: list) -> None:
        """Fold one partition's state batches (in spill order — the morsel
        order) into a fresh GroupState; recursively re-partition when the
        partition itself exceeds the budget."""
        self.acct.note_depth(level)
        total = GroupState(self.keys, self.aggs, self.mode, self.in_schema, vectorized=True, backend=self.backend)
        fs = np.zeros(0, np.int64)
        reserved = 0
        try:
            reader = f.read(self.morsel_rows)
            for batch in reader:
                fs = self._absorb(total, fs, batch)
                nb = total.approx_nbytes()
                self.acct.adjust(nb - reserved)
                reserved = nb
                if self.acct.over() and level + 1 < SPILL_MAX_DEPTH and len(total.gids) > 1:
                    sub = self._new_set(level + 1)
                    sub.scatter(self._state_batch(total, fs))
                    total = None
                    self.acct.adjust(-reserved)
                    reserved = 0
                    for rest in reader:
                        sub.scatter(rest)
                    f.close()
                    for sf in sub.files:
                        if sf is not None:
                            self._process(sf, level + 1, leaves)
                    return
            leaves.append((total.result(self.out_schema), fs))
        finally:
            self.acct.adjust(-reserved)
            f.close()

    def close(self) -> None:
        for s in self._sets:
            s.close()


# ---------------------------------------------------------------------------
# grace-hash join
# ---------------------------------------------------------------------------
def collect_build(
    batches,
    schema: Schema,
    on: list,
    acct: MemoryAccountant,
    fanout: int = DEFAULT_SPILL_FANOUT,
    spill_dir: str | None = None,
):
    """Materialize a join build side under the accountant.

    Returns ``("mem", build_batch, table)`` when it fits (the table's bytes
    stay accounted for the rest of the run — it lives as long as the
    pipeline), or ``("spill", SpillSet)`` once the accounted bytes cross
    the budget: the already-collected batches and the rest of the stream
    are scattered to build partitions by join-key hash."""
    got: list = []
    reserved = 0
    sset = None
    try:
        for b in batches:
            if sset is not None:
                sset.scatter(b)
                continue
            got.append(b)
            delta = b.nbytes + _TABLE_ROW_OVERHEAD * b.num_rows
            reserved += delta
            acct.adjust(delta)
            if acct.over():
                acct.note_spill()
                sset = SpillSet(schema, on, fanout, acct, level=0, spill_dir=spill_dir, tag="join-build")
                for g in got:
                    sset.scatter(g)
                got = []
                acct.adjust(-reserved)
                reserved = 0
    except BaseException:
        # a failing build source (e.g. a dead exchange pull) must not strand
        # partition files on a long-lived server
        acct.adjust(-reserved)
        if sset is not None:
            sset.close()
        raise
    if sset is not None:
        return ("spill", sset)
    rb = concat_batches(got) if got else RecordBatch.empty(schema)
    return ("mem", rb, build_join_table(rb, on))


def spilled_join_stream(
    build_set: SpillSet,
    probe_batches,
    on: list,
    payload: list,
    out_schema: Schema,
    probe_schema: Schema,
    acct: MemoryAccountant,
    morsel_rows: int = 65536,
    fanout: int = DEFAULT_SPILL_FANOUT,
    spill_dir: str | None = None,
):
    """Drive a join whose build side spilled: scatter the probe stream by
    the same key hash (tagging rows with a global row id), join partition
    pairs one at a time, and emit the matches re-sorted to the exact
    in-memory probe order (stable sort on the row ids — within one probe
    row, build matches are already in build order)."""
    rowid_field = Field(ROWID_COL, dtypes.resolve("int64"))
    pset = SpillSet(
        probe_schema.append(rowid_field), on, build_set.nparts, acct, level=build_set.level, spill_dir=spill_dir, tag="join-probe"
    )
    try:
        next_rowid = 0
        for b in probe_batches:
            rid = Column.from_values(dtypes.resolve("int64"), np.arange(next_rowid, next_rowid + b.num_rows, dtype=np.int64))
            next_rowid += b.num_rows
            pset.scatter(b.with_column(rowid_field, rid))
        outs: list = []
        for bf, pf in zip(build_set.files, pset.files):
            _join_pair(bf, pf, build_set.level, outs, on, payload, out_schema, probe_schema, acct, morsel_rows, fanout, spill_dir)
        if not outs:
            return
        cat = concat_batches([b for b, _r in outs])
        rid = np.concatenate([r for _b, r in outs])
        out = cat.take(np.argsort(rid, kind="stable"))
        for s in range(0, out.num_rows, morsel_rows):
            yield out.slice(s, s + morsel_rows)
    finally:
        build_set.close()
        pset.close()


def _join_pair(
    bf: SpillFile | None,
    pf: SpillFile | None,
    level: int,
    outs: list,
    on: list,
    payload: list,
    out_schema: Schema,
    probe_schema: Schema,
    acct: MemoryAccountant,
    morsel_rows: int,
    fanout: int,
    spill_dir: str | None,
    force_mem: bool = False,
) -> None:
    """Join one (build partition, probe partition) pair, recursively
    re-splitting the pair while the build side still exceeds the budget.
    ``force_mem`` (set when the previous level's scatter failed to split —
    one dominant key class) builds in memory instead of rewriting the same
    bytes to every remaining level."""
    if bf is None or pf is None:
        # an equi-join emits nothing for a key class missing on either side
        if bf is not None:
            bf.close()
        if pf is not None:
            pf.close()
        return
    acct.note_depth(level)
    batches: list = []
    reserved = 0
    try:
        reader = bf.read(morsel_rows)
        for b in reader:
            batches.append(b)
            delta = b.nbytes + _TABLE_ROW_OVERHEAD * b.num_rows
            reserved += delta
            acct.adjust(delta)
            if acct.over() and level + 1 < SPILL_MAX_DEPTH and not force_mem:
                bsub = SpillSet(bf.schema, on, fanout, acct, level=level + 1, spill_dir=spill_dir, tag="join-build")
                psub = SpillSet(pf.schema, on, fanout, acct, level=level + 1, spill_dir=spill_dir, tag="join-probe")
                try:
                    for g in batches:
                        bsub.scatter(g)
                    for g in reader:
                        bsub.scatter(g)
                    batches = []
                    acct.adjust(-reserved)
                    reserved = 0
                    bf.close()
                    # progress guard: if everything re-hashed into a single
                    # sub-partition, splitting again cannot help
                    no_split = sum(1 for f in bsub.files if f is not None) <= 1
                    for g in pf.read(morsel_rows):
                        psub.scatter(g)
                    pf.close()
                    for sb, sp in zip(bsub.files, psub.files):
                        _join_pair(
                            sb, sp, level + 1, outs, on, payload, out_schema, probe_schema,
                            acct, morsel_rows, fanout, spill_dir, force_mem=no_split,
                        )
                finally:
                    bsub.close()
                    psub.close()
                return
        rb = concat_batches(batches) if batches else RecordBatch.empty(bf.schema)
        table = build_join_table(rb, on)
        for pb in pf.read(morsel_rows):
            rid = np.asarray(pb.column(ROWID_COL).values)
            core = pb.select(probe_schema.names)
            lidx, ridx = join_probe_indices(core, table, on)
            if len(lidx) == 0:
                continue
            lpart = core.take(lidx)
            rpart = rb.take(ridx)
            cols = list(lpart.columns) + [rpart.column(name) for name in payload]
            outs.append((RecordBatch(out_schema, cols), rid[lidx]))
    finally:
        acct.adjust(-reserved)
        bf.close()
        pf.close()
