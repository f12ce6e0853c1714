#!/usr/bin/env python3
"""Smoke run of the DACP PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. card and build — prints the card's name and power limit as
     ``nvidia-smi`` gives them, builds the data-plane kernels from
     ``src/repro_torch/kernels/csrc`` and times the build;
  2. kernels — calls each kernel's wrapper on card tensors at the shapes
     the main path hands it (one 65536-row morsel of the COOKs below) and at
     the backend's widest envelope (262144 rows, 256 groups), with seeded
     inputs holding NaN payloads, ±0, ±inf, denormals and int64 extremes;
     holds every result bit for bit against the plain PyTorch version run
     on the CPU (tolerance 0) and times kernel, plain version (on the card)
     and the one-call PyTorch yardstick with CUDA events.  The fused chain
     kernel is checked in four configurations (the fused aggregate COOK's
     morsel, the widest envelope, a streaming chain on an int64 predicate,
     special values) and timed beside the four per-op kernels doing the
     same morsel's work; times the pageable and the pinned H2D copy of one
     morsel and its D2H copy, and one fused morsel's encode, staging and
     fold on the host clock.  The two attention kernels are held to their
     plain versions within tests/test_kernels.py's tolerances (float32
     3e-5, bfloat16 2e-2) at the serving shapes of phases 4-6 (phase 6's:
     G = 1 at head dim 128, full attention at the ragged 1500 and at
     S != T, decode with length the whole cache, each also timed against
     SDPA's device time), at ragged
     shapes, in float32 and at head dims 32 and 256, and timed beside their
     plain versions and ``F.scaled_dot_product_attention``, SDPA by the
     profiler's device time of its own kernels as ours are (its CUDA-event
     time beside it); decode over a rotation of DECODE_SETS distinct caches,
     more than the L2 holds, as the model's 40 layers read them (the
     L2-resident time beside it).  ``ssd_scan`` and ``mlstm_chunk`` are held
     to their plain versions (y and the final state) within
     tests/test_kernels.py's tolerances (2e-4, 5e-4) at the serving shapes
     of phase 5, at a ragged length, at reduced widths and in float32, and
     timed beside them (no single PyTorch call computes either);
     ``ssd_scan`` also over 16 chunks (b 1, s 4096) and at p 32, n 16 with
     96-row chunks, with the worst ratio |got - want| / (atol + rtol |want|)
     per case.  All nine kernels print their design and the fraction of
     their bound they reach, and the multi-kernel wrappers (min/max, fused,
     SSD, mLSTM) each kernel's device time by name;
     ``decode_attention_partials`` (the decode kernel's partial m, l, acc)
     is held to its plain version at phase 8e's rank shape (B 1, KV 32,
     G 1, 131072 positions, hd 64, bf16; whole and rank 3's ragged 106781),
     in float32, at G 17 over 16 splits and at length 0, and timed at the
     rank shape beside its bound, its plain version and
     ``_scaled_dot_product_efficient_attention`` with its log-sum-exp;
     ``segment_minmax_tiles`` also its device events a call (at most two,
     or the run fails), and it, ``filter_select_planes`` and
     ``project_tiles`` their device time at the widest envelope beside its
     bound (the filter's and the projection's, at the main shape too, also
     over a rotation of inputs that holds COLD_BYTES, out of L2);
     ``project_tiles`` is also checked on a tree of STACK_MAX values and on
     tables 4 bytes past a 16-byte boundary, timed on the int32 morsel
     projection (``s3``), and fails if ``cuobjdump -sass`` finds a
     local-memory instruction (LDL / STL) in its kernel;
     ``segment_minmax_tiles``'s
     and ``segment_sum_tiles``'s yardsticks (``scatter_reduce_``,
     ``index_add_``) are timed by the profiler's device time of their own
     kernels, as ours are; ``cuobjdump -sass`` must find tensor-core
     instructions in the bf16 flash, decode, SSD and mLSTM kernels;
  3. end to end — writes a seeded 2^24-row station-observations table
     (16 columnar parts), serves it from two port ``FairdServer``s over TCP
     loopback (torch backend on cuda, numpy backend), runs PING, LIST,
     DESCRIBE, a GET, two per-op COOKs and two fused COOKs through the
     port's client on both, holds every reply byte for byte against the
     numpy server's, checks that each of the five kernels launched during
     the torch server's run, that the fused COOKs went through the fused
     kernel with staged (overlapped) uploads, and profiles one aggregate
     COOK of each path;
  4. serving — granite-3-8b at full width (40 layers, d_model 4096, GQA
     32/8, head_dim 128, bfloat16, random weights drawn on the card from a
     seeded ``torch.Generator``): a port ``FairdServer`` over TCP tokenizes
     a seeded prompt corpus in place (``training_dag``), the model prefills
     4 prompts of 1024 byte tokens through ``flash_attention`` and greedily
     decodes 32 tokens through ``decode_attention`` (exactly 40 and 40 × 32
     launches), then holds the kernel path's prefill logits and 4
     teacher-forced decode steps against the plain path's on the same
     weights and tokens, and profiles a prefill and a decode step (whose
     ``decode_attn`` kernels over 40 give the in-model time a launch);
  5. serving the other two block patterns the same way, at full width from
     DACP prompts: zamba2-1.2b (38 Mamba2 blocks, d_model 2048, ssm state
     64, head_dim 64, the shared attention block after every 6th; exactly
     38 ``ssd_scan`` and 6 ``flash_attention`` launches per prefill and
     6 × 32 ``decode_attention`` over the decode) and xlstm-125m (12 blocks,
     d_model 768, 4 heads, 11 mLSTM blocks through ``mlstm_chunk`` and one
     sLSTM block in PyTorch; exactly 11 launches per prefill);
  6. serving the rest of the model zoo the same way, at full width from
     DACP prompts: moonshot-v1-16b-a3b (48 MHA layers, d_model 2048, 16
     heads of head_dim 128, each FFN 64 experts top-6 of d_ff 1408; about
     2.8 × 10^10 parameters, 56 GB; exactly 48 ``flash_attention`` and
     48 × 32 ``decode_attention`` launches), held to the plain path within
     the larger of the rounding model and twice the plain path's spread
     against a plain bundle that sums attention over the keys in two halves
     (routing near a tie flips under both), printing the share of top-k
     routing decisions that agree between the paths and the slots each
     drops at capacity; and whisper-small (12 encoder + 12 decoder layers,
     d_model 768, 12 heads, seeded stub frames of 1500 × 768; exactly 36
     ``flash_attention`` — 12 encoder, 12 self, 12 cross — and 24 × 32
     ``decode_attention`` launches, the cross-attention's with length
     1500);
  7. training — (a) on card tensors that need a gradient,
     ``flash_attention`` (bfloat16 at zamba2's and granite's serving
     shapes, float32), ``ssd_scan`` (zamba2's training microbatch) and
     ``mlstm_chunk`` (xlstm's serving shape) return outputs with a
     ``grad_fn`` whose input gradients hold to the plain version's within
     the forward tolerances, and ``decode_attention`` raises; (b)
     zamba2-1.2b at full width (bfloat16, remat ``full``, random weights
     drawn on the card) trains 4 steps of 4 × 1024 tokens that a port
     ``FairdServer`` over TCP tokenizes in place (``training_dag`` →
     ``TorchFeed``) through ``Trainer`` (2 microbatches, int8 gradient
     compression, ``warmup_cosine``), printing each step's loss, grad norm,
     lr, CUDA-synchronised ms, tokens/s and launches (exactly 152
     ``ssd_scan`` and 12 ``flash_attention`` a step: remat runs each Mamba2
     block's forward twice), the peak memory and one profiled step (device
     against wall ms, top kernels, the plain backward's share); the losses
     and grad norms must be finite and the loss on step 1's batch after
     step 4 below step 1's; (c) one loss + backward through the kernels
     against one through the plain versions on the same weights and batch
     (loss within 1e-2 relative, gradient norm within 2%, every leaf
     above 1e-3 of the largest leaf norm at cosine 0.99 or more); (d)
     reduced zamba2 in bfloat16 trains 2 steps and saves a checkpoint, and a
     new ``Trainer`` resumes it bit for bit and takes a third step;
  8. distribution — (a) four gloo ranks in four processes on the one card,
     with CUDA tensors, run ``seq_sharded_decode_attention`` at zamba2-1.2b's
     long_500k shared-attention shape (B 1, KV 32, G 1, T 524288, 131072 a
     rank, hd 64, bf16, index 499999; K and V 4.3 GB) and at granite-3-8b's
     decode shape of phase 4 (B 4, KV 8, G 4, T 1056, hd 128, length 1025),
     each held to one ``decode_attention`` launch over the whole cache
     within the bf16 attention tolerance, printing each call's wall time and
     the bytes each rank all-reduces; (b) ``compressed_psum`` of a
     granite-3-8b padded_vocab × 4096 float32 leaf (809.5 MB a rank) on the
     card ranks, equal bit for bit to the same ranks' call on CPU tensors;
     (c) ``TorchFeed(mesh=make_smoke_mesh())`` on NCCL world 1 gives phase
     7's feed's batches as card DTensors; (d) the dry-run of granite-3-8b
     train_4k and zamba2-1.2b long_500k on the single production mesh (256
     fake ranks, meta tensors: host work) prints its roofline terms with the
     H100's rates; (e) the same four ranks decode zamba2-1.2b's long_500k at
     full width (38 Mamba2 blocks, 6 shared-attention sites, KV 32, hd 64,
     bf16, random weights drawn on the card from a seeded generator,
     replicated) over a cache of 524288 positions sharded by position
     (``decode_cache_axes(long_context=True)``, 131072 a rank, K and V 25.8
     GB whole, seeded slice by slice), 4 teacher-forced steps from index
     499996 through ``lm.decode_step`` with ``on_shards(KERNELS)``: exactly
     6 partials launches a step on each rank and no plain partials, each
     site's output within SEQ_ERR_UNITS half ulps of bf16 of one
     ``decode_attention`` launch over the whole cache on the same inputs (a
     planted fault, rank 0's partials replaced by an empty slice's, must
     fall outside), and each step's logits within phase 5's zamba2 limit of
     the same 4 steps over the whole cache in the parent (exactly 6
     ``decode_attention`` launches a step); prints the warm wall ms a step,
     each rank's partials device ms beside its bound, the bytes each rank
     all-reduces a site and the peak memory.

The second-to-last line is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

TILE = 256
MORSEL = 65536  # rows per morsel on the main path: the columnar scan's batch size
WIDE_N = 262144  # SUM_ROW_CAP, the largest morsel the backend hands a kernel
COLD_BYTES = 64 << 20  # inputs an out-of-L2 timing cycles through: above the H100's 50 MB L2
STATIONS = 200
E2E_ROWS = 1 << 24
E2E_PARTS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 tensor cores
WARMUP = 5
REPS = 50
SEED = 20261016


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------
def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    report = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln or "spill" in ln]
    print("\n".join(report), file=sys.stderr)
    return seconds


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def _bits32(rng, shape) -> np.ndarray:
    """Random int32 bit patterns with float specials planted."""
    a = rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
    flat = a.reshape(-1)
    specials = np.array([0x7FC00000, 0xFFC00000, 0x7FA00001, 0x80000000, 0, 0x7F800000, 0xFF800000, 1], np.uint32)
    idx = rng.choice(flat.size, size=min(flat.size, 64), replace=False)
    flat[idx] = specials[np.arange(idx.size) % specials.size].view(np.int32)
    return a


def _f32_specials(rng, n: int) -> np.ndarray:
    v = (rng.standard_normal(n) * 20.0).astype(np.float32)
    v[::97] = -0.0
    v[1::97] = 0.0
    v[2::101] = np.nan
    v[3::103] = np.inf
    v[4::107] = -np.inf
    v[5::109] = np.array([0x7FA00001], np.uint32).view(np.float32)[0]  # signalling NaN payload
    v[6::113] = np.float32(1e-45)  # denormal
    return v


def _signed32(v: int) -> int:
    return ((v + 2**31) % 2**32) - 2**31


def _i64_words(v: np.ndarray) -> np.ndarray:
    hi = (v >> 32).astype(np.int32)
    lo = (v & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return np.stack([hi, lo], axis=1)


def _same(a, b) -> tuple:
    """(bit-identical, max |a - b| over the values) for two tensors."""
    a = a.detach().cpu().contiguous()
    b = b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    an, bn = a.numpy(), b.numpy()
    exact = an.tobytes() == bn.tobytes()
    if exact:
        return True, 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        diff = np.abs(an.astype(np.float64) - bn.astype(np.float64))
    return False, float(np.nanmax(diff)) if np.isfinite(diff).any() else float("inf")


_OUR_KERNELS = ("filter_select_kernel", "project_kernel", "segment_sum_kernel", "minmax_", "fused_", "fsum_fold",
                "flash_attn", "decode_attn", "ssd_scan_kernel", "mlstm_chunk_kernel")


def _device_times(fn, host: dict | None = None, counts: dict | None = None) -> tuple:
    """Run ``fn`` once under ``torch.profiler``; returns ({event name:
    device microseconds}, wall seconds) over the CUDA-side events (kernels,
    memcpys, memsets) it traced.  With ``host``, also fills it with {event
    name: self host microseconds} of the host-side events (operators and
    CUDA runtime calls); with ``counts``, {event name: number of events}
    of the CUDA-side ones."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out: dict = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            if host is not None:
                host[e.key] = host.get(e.key, 0.0) + float(e.self_cpu_time_total)
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        out[e.key] = out.get(e.key, 0.0) + float(us)
        if counts is not None:
            counts[e.key] = counts.get(e.key, 0) + int(e.count)
    return out, wall


def _rep_device_times(fn) -> dict:
    """{event name: device microseconds of REPS calls} of ``fn`` under the
    profiler.  The profiler drops kernel records: it counted 49 of 50
    `decode_attn` launches in profile after profile, and once lost most of
    a profile's records, which read as times below the kernel's bound.  So
    each event
    reads as its mean duration times REPS times its launches per call
    (its count over REPS, rounded), and a profile that lost more than a
    tenth of an event's launches, or every record (a profile has come
    back empty), is taken again, five times at most."""
    short: dict = {}
    for _ in range(5):
        counts: dict = {}
        times, _wall = _device_times(lambda: [fn() for _ in range(REPS)], counts=counts)
        per_call = {k: max(1, round(n / REPS)) for k, n in counts.items()}
        short = {k: n for k, n in counts.items() if n < 0.9 * per_call[k] * REPS} if counts else {"every event": 0}
        if not short:
            return {k: us / counts[k] * per_call[k] * REPS for k, us in times.items()}
        short = {k[:80]: n for k, n in short.items()}
        print(f"the profile of {REPS} calls dropped device events, taking it again: {short}", file=sys.stderr)
    check(False, f"five profiles of {REPS} calls each lost over a tenth of an event's launches: {short}")
    return {}


def _events_per_call(fn) -> dict:
    """{device event name: events per call} of ``fn`` (REPS calls,
    profiled; each count over REPS, rounded, as the profiler drops
    records; an empty profile is taken again, five times at most):
    kernels, copies and fills alike."""
    counts: dict = {}
    for _ in range(5):
        _device_times(lambda: [fn() for _ in range(REPS)], counts=counts)
        if counts:
            break
    check(bool(counts), f"five profiles of {REPS} calls each held no device event")
    return {k[:60]: round(n / REPS) for k, n in counts.items() if round(n / REPS) > 0}


def _kernel_device_ms(fn) -> float | None:
    """Device time per call of our kernels in ``fn`` (REPS calls, profiled),
    or None when the profiler saw no device time."""
    times = _rep_device_times(fn)
    us = sum(v for k, v in times.items() if any(n in k for n in _OUR_KERNELS))
    if us <= 0:
        print(f"profiler saw no kernel time; device events: {times}", file=sys.stderr)
        return None
    return us / 1e3 / REPS


def _all_device_ms(fn, name: str = "") -> float:
    """Device time per call of every kernel, copy and fill ``fn`` runs
    (REPS calls, profiled), or of those whose name holds ``name``."""
    times = _rep_device_times(fn)
    return sum(v for k, v in times.items() if name in k) / 1e3 / REPS


@functools.lru_cache(maxsize=1)
def _sass() -> str:
    """``cuobjdump -sass`` of the built library, once per run."""
    from repro_torch.kernels import _build

    cands = (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"), shutil.which("cuobjdump"))
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    check(tool is not None, "cuobjdump not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    res = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr.strip()[-500:]}")
    return res.stdout


def sass_instructions(kernel: str, mnemonics: tuple) -> int:
    """Instructions whose mnemonic is one of ``mnemonics`` in the SASS of the
    built library's functions whose name holds ``kernel``, by ``cuobjdump
    -sass``."""
    pattern = re.compile(r"\b(" + "|".join(mnemonics) + r")\b")
    n, function = 0, ""
    for ln in _sass().splitlines():
        if "Function :" in ln:
            function = ln
        elif kernel in function and pattern.search(ln):
            n += 1
    return n


def tensor_core_instructions(kernel: str) -> int:
    """Tensor-core instructions (HMMA, HGMMA) of ``kernel``'s SASS."""
    return sass_instructions(kernel, ("HMMA", "HGMMA"))


def _time_ms(fn) -> float:
    """Mean milliseconds per call of ``fn`` on the card, CUDA events around
    REPS calls after WARMUP."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.exact = True  # bit-identical to the plain version in every check
        self.agrees = True  # within the tolerance in every check
        self.tolerance = "exact"
        self.max_abs_err = 0.0
        self.checks = 0
        self.ms = self.call_ms = self.plain_ms = self.bound_ms = self.library_ms = None
        self.ms_source = "cuda_events"
        self.bound_by = "bytes"
        self.shape = ""
        self.wide_ms = self.wide_bound_ms = None
        self.wide_shape = ""
        self.extra: dict = {}

    def wide(self, fn, nbytes: int, shape: str) -> None:
        """Device time and byte bound at the backend's widest envelope."""
        self.wide_ms = _kernel_device_ms(fn)
        self.wide_bound_ms = _bytes_bound_ms(nbytes)
        self.wide_shape = shape

    def compare(self, got, want, what: str) -> None:
        for g, w in zip(got, want):
            same, err = _same(g, w)
            self.checks += 1
            self.max_abs_err = max(self.max_abs_err, err)
            if not same:
                self.exact = self.agrees = False
                log(f"MISMATCH {self.name}: {what}")

    def compare_close(self, got, want, rtol: float, atol: float, what: str) -> None:
        """Hold ``got`` to ``want`` within |got - want| <= atol + rtol |want|
        (numpy's allclose), elementwise in float32."""
        g = got.detach().float().cpu().numpy()
        w = want.detach().float().cpu().numpy()
        self.checks += 1
        if g.shape != w.shape or not np.isfinite(g).all():
            self.exact = self.agrees = False
            log(f"MISMATCH {self.name}: {what}: shape {g.shape} vs {w.shape} or non-finite output")
            return
        err = np.abs(g - w)
        self.max_abs_err = max(self.max_abs_err, float(err.max()))
        self.exact = self.exact and g.tobytes() == w.tobytes()
        if not (err <= atol + rtol * np.abs(w)).all():
            self.agrees = False
            log(f"MISMATCH {self.name}: {what}: max |err| {float(err.max())} beyond atol {atol} + rtol {rtol}")

    def as_json(self, launches: int) -> dict:
        return {
            "name": self.name,
            "route": "cuda",
            "source": self.source,
            "replaces": self.replaces,
            "launches": launches,
            "exact": self.exact,
            "agrees": self.agrees,
            "tolerance": self.tolerance,
            "checks": self.checks,
            "max_abs_err": self.max_abs_err,
            "ms": self.ms,
            "ms_source": self.ms_source,
            "call_ms": self.call_ms,
            "plain_ms": self.plain_ms,
            "bound_ms": self.bound_ms,
            "bound_by": self.bound_by,
            "library_ms": self.library_ms,
            "shape": self.shape,
            "wide_ms": self.wide_ms,
            "wide_bound_ms": self.wide_bound_ms,
            "wide_shape": self.wide_shape,
            **self.extra,
        }


def _time_kernel(rec: KernelRecord, fn) -> None:
    """``call_ms``: CUDA events around REPS wrapper calls (host launch cost
    included); ``ms``: the kernels' own device time from the profiler, or
    the event time when the profiler saw none."""
    import torch

    rec.call_ms = _time_ms(fn)
    dev_ms = _kernel_device_ms(fn)
    rec.ms, rec.ms_source = (dev_ms, "profiler") if dev_ms is not None else (rec.call_ms, "cuda_events")


def _bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_filter_select(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels import filter_select as fs

    rec = KernelRecord("filter_select_planes", "src/repro_torch/kernels/csrc/filter_select.cu",
                       "src/repro/kernels/filter_select.py:104")
    # shapes: (rows, table planes) — the COOK's unfused filter on the int64
    # `age` column carries 11 planes; its filter+select carries 5; the wide
    # envelope 8 at SUM_ROW_CAP rows
    for n, d in ((MORSEL, 11), (MORSEL, 5), (WIDE_N, 8)):
        f32 = _f32_specials(rng, n)
        i32 = rng.integers(-1000, 1000, n).astype(np.int32)
        i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        i64[:8] = [-(2**63), 2**63 - 1, 0, -1, 1, 2**32, -(2**32), 7]
        table = _bits32(rng, (n, d))
        preds = {
            "f32": (f32.view(np.int32).reshape(n, 1), int(np.array([0.5], np.float32).view(np.int32)[0]), 0),
            "i32": (i32.reshape(n, 1), 17, 0),
            "i64": (_i64_words(i64), int(i64[5] >> 32), _signed32((int(i64[5]) & 0xFFFFFFFF) ^ 0x80000000)),
        }
        t_cpu = torch.from_numpy(table)
        t_dev = t_cpu.to(dev)
        for kind, (planes, t_hi, t_lo) in preds.items():
            p_cpu = torch.from_numpy(np.ascontiguousarray(planes))
            p_dev = p_cpu.to(dev)
            scalars = np.array([n - 37, t_hi, t_lo], np.int32)  # ragged tail tile
            for op in fs.OPS:
                got = fs.filter_select_planes(p_dev, t_dev, scalars, op, kind, TILE)
                want = fs.filter_select_planes_plain(p_cpu, t_cpu, scalars, op, kind, TILE)
                rec.compare(got, want, f"n={n} d={d} {kind} {op}")
        if n == MORSEL and d == 11:
            p_dev = torch.from_numpy(np.ascontiguousarray(preds["i64"][0])).to(dev)
            scalars = np.array([n, preds["i64"][1], preds["i64"][2]], np.int32)
            _time_kernel(rec, lambda: fs.filter_select_planes(p_dev, t_dev, scalars, "ge", "i64", TILE))
            rec.plain_ms = _time_ms(lambda: fs.filter_select_planes_plain(p_dev, t_dev, scalars, "ge", "i64", TILE))
            rec.bound_ms = _bytes_bound_ms(4 * n * (2 + 2 * d) + 4 * (n // TILE))
            rec.shape = f"N={n} P=2 D={d} tile={TILE}"
            rec.extra["design"] = ("a block per tile: the tile's planes in flight to shared memory by 16-byte cp.async "
                                   "while the predicate loads, survivors' rows recorded at their slots, the output "
                                   "tile written as 16-byte stores")
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
            # the main shape's 6.3 MB stay in the 50 MB L2 between calls, so
            # the fraction above is of L2-resident inputs; this reads them
            # from HBM
            sets = _cold_sets(p_dev, t_dev)
            rec.extra["cold_sets"] = len(sets)
            rec.extra["cold_ms"] = _kernel_device_ms(
                _rotation(lambda p, t: fs.filter_select_planes(p, t, scalars, "ge", "i64", TILE), sets))
        elif n == WIDE_N:
            p_dev = torch.from_numpy(np.ascontiguousarray(preds["i64"][0])).to(dev)
            scalars = np.array([n, preds["i64"][1], preds["i64"][2]], np.int32)
            rec.wide(lambda: fs.filter_select_planes(p_dev, t_dev, scalars, "ge", "i64", TILE),
                     4 * n * (2 + 2 * d) + 4 * (n // TILE), f"N={n} P=2 D={d}")
            # the wide envelope's 18.9 MB sit in the 50 MB L2 between calls;
            # over a rotation of COLD_BYTES of inputs they come from HBM
            sets = _cold_sets(p_dev, t_dev)
            rec.extra["wide_cold_sets"] = len(sets)
            rec.extra["wide_cold_ms"] = _kernel_device_ms(
                _rotation(lambda p, t: fs.filter_select_planes(p, t, scalars, "ge", "i64", TILE), sets))
    return rec


def check_project(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels import project_arith as pa

    rec = KernelRecord("project_tiles", "src/repro_torch/kernels/csrc/project_arith.cu",
                       "src/repro/kernels/project_arith.py:75")
    # the COOK's projection: temp_k = temp + 273.15 and dp = pressure * 0.5 -
    # 1013.0 over (temp, pressure); s3 = station * 3 + 1 over (station,)
    main_f = (("add", ("col", 0), ("lit", 273.15)), ("sub", ("mul", ("col", 1), ("lit", 0.5)), ("lit", 1013.0)))
    main_i = (("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1)),)
    # hazards: 0/0, inf-inf, NaN operands (one and both), division, denormals
    hazard_f = (
        ("div", ("col", 0), ("col", 1)),
        ("sub", ("col", 0), ("col", 1)),
        ("add", ("col", 1), ("col", 0)),
        ("mul", ("col", 0), ("col", 1)),
        ("div", ("sub", ("col", 0), ("lit", 1.5)), ("add", ("col", 1), ("lit", -2.0))),
        ("mul", ("add", ("col", 0), ("mul", ("lit", 2.0), ("lit", 3.0))), ("col", 1)),
    )
    hazard_i = (("mul", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("lit", 2**31 - 1)), ("add", ("col", 1), ("col", 0)))
    # a tree that holds STACK_MAX values at once, in both dtypes
    deep_f, deep_i = ("col", 1), ("col", 1)
    for i in range(pa.STACK_MAX - 1):
        deep_f = (("add", "sub", "mul", "div")[i % 4], ("col", i % 2), deep_f)
        deep_i = (("add", "sub", "mul")[i % 3], ("col", i % 2), deep_i)
    for n in (MORSEL, WIDE_N):
        f = np.stack([_f32_specials(rng, n), _f32_specials(rng, n)], axis=1)
        f[::5, 1] = 0.0
        ii = rng.integers(-(2**31), 2**31, size=(n, 2), dtype=np.int64).astype(np.int32)
        cases = ((f, main_f), (f, hazard_f + (deep_f,)), (ii[:, :1].copy(), main_i), (ii, hazard_i + (deep_i,)))
        for table, descrs in cases:
            t_cpu = torch.from_numpy(np.ascontiguousarray(table))
            got = pa.project_tiles(t_cpu.to(dev), descrs, TILE)
            want = pa.project_tiles_plain(t_cpu, descrs, TILE)
            rec.compare((got,), (want,), f"n={n} {descrs}")
            # the same table 4 bytes past a 16-byte boundary
            flat = torch.zeros(t_cpu.numel() + 1, dtype=t_cpu.dtype, device=dev)
            flat[1:] = t_cpu.reshape(-1).to(dev)
            got = pa.project_tiles(flat[1:].view(t_cpu.shape), descrs, TILE)
            rec.compare((got,), (want,), f"n={n} view 4 bytes in {descrs}")
        t_dev = torch.from_numpy(np.ascontiguousarray(f)).to(dev)
        # the inputs of one call stay in the 50 MB L2 between calls; over a
        # rotation of COLD_BYTES of inputs they come from HBM
        sets = _cold_sets(t_dev)
        cold_ms = _kernel_device_ms(_rotation(lambda t: pa.project_tiles(t, main_f, TILE), sets))
        if n == MORSEL:
            _time_kernel(rec, lambda: pa.project_tiles(t_dev, main_f, TILE))
            rec.plain_ms = _time_ms(lambda: pa.project_tiles_plain(t_dev, main_f, TILE))
            by_bytes = _bytes_bound_ms(4 * n * 2 + 4 * n * len(main_f))
            by_ops = n * 3 / F32_FLOPS * 1e3  # one op for temp_k, two for dp
            rec.bound_ms = max(by_bytes, by_ops)
            rec.bound_by = "bytes" if by_bytes >= by_ops else "operations"
            rec.shape = f"N={n} D=2 K=2 float32"
            rec.extra["cold_sets"] = len(sets)
            rec.extra["cold_ms"] = cold_ms
            i_dev = torch.from_numpy(ii[:, :1].copy()).to(dev)
            rec.extra["i32_ms"] = _kernel_device_ms(lambda: pa.project_tiles(i_dev, main_i, TILE))
            rec.extra["i32_bound_ms"] = _bytes_bound_ms(4 * n * 2)
            rec.extra["i32_shape"] = f"N={n} D=1 K=1 int32"
            rec.extra["design"] = ("a postfix program with annotated stack slots and literal ops fused, the top of the "
                                   "stack in a register and the slots below in shared memory; one row a thread at a "
                                   "morsel, four rows where the card is full; decoded by uniform tests, add / sub / "
                                   "mul selected without a branch, NaN bits fixed only in a warp that holds a NaN")
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        else:
            rec.wide(lambda: pa.project_tiles(t_dev, main_f, TILE), 4 * n * 2 + 4 * n * len(main_f), f"N={n} D=2 K=2")
            rec.extra["wide_cold_sets"] = len(sets)
            rec.extra["wide_cold_ms"] = cold_ms
    # the interpreter's stack must not live in local memory
    rec.extra["local_memory_instructions"] = sass_instructions("project_kernel", ("LDL", "STL"))
    return rec


def _skewed_groups(rng, n: int, g: int) -> np.ndarray:
    w = 1.0 / (np.arange(g) + 1.0) ** 1.1
    return rng.choice(g, size=n, p=w / w.sum()).astype(np.int32)


def _limbs(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    cols = [((v >> (8 * k)) & 0xFF).astype(np.int32) for k in range(7)] + [(v >> 56).astype(np.int32)]
    return np.stack(cols, axis=1)


def check_segment_sum(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels import segment_reduce as sr

    rec = KernelRecord("segment_sum_tiles", "src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce.py:70")
    # the COOK folds counts and sum(qc): 8 limb columns over 200 stations; the
    # wide envelope two int64 columns (16 limbs) over 256 groups
    for n, g, cols in ((MORSEL, STATIONS, 1), (WIDE_N, 256, 2)):
        gidx = _skewed_groups(rng, n, g)
        vals = [rng.integers(0, 4, n).astype(np.uint8)] if cols == 1 else [
            rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64) for _ in range(cols)
        ]
        limbs = np.concatenate([_limbs(v) for v in vals], axis=1)
        g_cpu, l_cpu = torch.from_numpy(gidx), torch.from_numpy(np.ascontiguousarray(limbs))
        g_dev, l_dev = g_cpu.to(dev), l_cpu.to(dev)
        n_rows = n - 29
        got = sr.segment_sum_tiles(g_dev, l_dev, n_rows, g, TILE)
        want = sr.segment_sum_tiles_plain(g_cpu, l_cpu, n_rows, g, TILE)
        rec.compare(got, want, f"n={n} g={g} s={limbs.shape[1]}")
        if n == MORSEL:
            s = limbs.shape[1]
            _time_kernel(rec, lambda: sr.segment_sum_tiles(g_dev, l_dev, n, g, TILE))
            rec.plain_ms = _time_ms(lambda: sr.segment_sum_tiles_plain(g_dev, l_dev, n, g, TILE))
            idx = g_dev.to(torch.int64)

            def library():
                return torch.zeros((g, s), dtype=torch.int32, device=dev).index_add_(0, idx, l_dev)

            rec.library_ms = _time_ms(library)
            rec.bound_ms = _bytes_bound_ms(4 * n + 4 * n * s + 4 * g * s + 4 * g)
            rec.shape = f"N={n} S={s} G={g}"
            # device time beside device time: the kernel against index_add_'s
            # kernel, and the wrapper (two zero fills and the kernel) against
            # the library call (one fill and index_add_)
            rec.extra["library_device_ms"] = _all_device_ms(library, "index")
            rec.extra["library_call_device_ms"] = _all_device_ms(library)
            rec.extra["call_device_ms"] = _all_device_ms(lambda: sr.segment_sum_tiles(g_dev, l_dev, n, g, TILE))
            rec.extra["design"] = "warp-aggregated (match_any + shuffle tree), grid-stride over 2 blocks per SM"
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        else:
            s = limbs.shape[1]
            rec.wide(lambda: sr.segment_sum_tiles(g_dev, l_dev, n, g, TILE), 4 * n + 4 * n * s + 4 * g * s + 4 * g,
                     f"N={n} S={s} G={g}")
    return rec


def check_segment_minmax(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels import segment_reduce as sr

    rec = KernelRecord("segment_minmax_tiles", "src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce.py:121")
    # the COOK folds min(pressure) (float32, one column) and max(ts) (two
    # int32 word passes); the wide envelope four columns over 256 groups
    for n, g, m in ((MORSEL, STATIONS, 1), (WIDE_N, 256, 4)):
        gidx = _skewed_groups(rng, n, g)
        fns = ("min", "max", "min", "max")[:m]
        vf = np.stack([_f32_specials(rng, n) for _ in range(m)], axis=1)
        vi = rng.integers(-(2**31), 2**31, size=(n, m), dtype=np.int64).astype(np.int32)
        g_cpu = torch.from_numpy(gidx)
        g_dev = g_cpu.to(dev)
        for vals in (vf, vi):
            for fn_set in (fns, tuple("max" if f == "min" else "min" for f in fns)):
                v_cpu = torch.from_numpy(np.ascontiguousarray(vals))
                got = sr.segment_minmax_tiles(g_dev, v_cpu.to(dev), n - 11, g, fn_set, TILE)
                want = sr.segment_minmax_tiles_plain(g_cpu, v_cpu, n - 11, g, fn_set, TILE)
                rec.compare((got,), (want,), f"n={n} g={g} {vals.dtype} {fn_set}")
        if n == MORSEL:
            v_dev = torch.from_numpy(np.ascontiguousarray(vf)).to(dev)
            _time_kernel(rec, lambda: sr.segment_minmax_tiles(g_dev, v_dev, n, g, fns, TILE))
            rec.plain_ms = _time_ms(lambda: sr.segment_minmax_tiles_plain(g_dev, v_dev, n, g, fns, TILE))
            idx = g_dev.to(torch.int64).unsqueeze(1).expand(n, m)

            def library():
                return torch.full((g, m), float("inf"), device=dev).scatter_reduce_(0, idx, v_dev, "amin")

            rec.library_ms = _time_ms(library)
            rec.bound_ms = _bytes_bound_ms(4 * n + 4 * n * m + 4 * g * m)
            rec.shape = f"N={n} M={m} G={g} float32"
            # device time beside device time, as for segment_sum_tiles: the
            # kernel against scatter_reduce_'s own kernel, the wrapper
            # (init, fold, decode) against the library call (fill and scatter)
            times = _rep_device_times(library)
            rec.extra["library_device_ms"] = sum(v for k, v in times.items() if "scatter" in k) / 1e3 / REPS
            rec.extra["library_call_device_ms"] = sum(times.values()) / 1e3 / REPS
            rec.extra["library_kernels"] = sorted(k[:60] for k in times)
            call = functools.partial(sr.segment_minmax_tiles, g_dev, v_dev, n, g, fns, TILE)
            rec.extra["call_device_ms"] = _all_device_ms(call)
            rec.extra["kernels_ms"] = _kernels_by_name(call, r"minmax_\w*kernel")
            rec.extra["device_events_per_call"] = _events_per_call(call)
            per_call = sum(rec.extra["device_events_per_call"].values())
            check(per_call <= 2, f"segment_minmax_tiles ran {per_call} device kernels a call, more than 2")
            rec.extra["design"] = ("grid-stride over 1024-thread blocks, one per SM, the next row's loads in flight; "
                                   "each row one shared atomicMin of key or ~key (no warp aggregation); changed bins "
                                   "folded into the output as values by int / unsigned atomics, no decode pass")
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        else:
            v_dev = torch.from_numpy(np.ascontiguousarray(vf)).to(dev)
            rec.wide(lambda: sr.segment_minmax_tiles(g_dev, v_dev, n, g, fns, TILE), 4 * n + 4 * n * m + 4 * g * m,
                     f"N={n} M={m} G={g} float32")
    return rec


# the fused aggregate COOK's plan: filter p > 1013.0 on pressure, keys st,
# n=count, sq=sum qc (limbs), s3s=sum station*3+1 (in-kernel csum),
# lo=min pressure (f32), hi=max qc (i32), m=mean temp+273.15 (compacted + gidx)
_TK = ("add", ("col", 0), ("lit", 273.15))
_S3 = ("add", ("mul", ("col", 0), ("lit", 3)), ("lit", 1))
_HAZARD_F = (
    ("div", ("col", 0), ("col", 1)),
    ("sub", ("col", 0), ("col", 1)),
    ("add", ("col", 1), ("col", 0)),
    ("mul", ("col", 0), ("col", 1)),
    ("mul", ("add", ("col", 0), ("lit", 1.5)), ("col", 1)),
)
_HAZARD_I = (("mul", ("col", 0), ("col", 1)), ("sub", ("col", 0), ("lit", 2**31 - 1)), ("add", ("col", 1), ("col", 0)))


def _cell_morsel(rng, n: int = MORSEL, base: float = 12.5):
    """(numpy inputs, static args) of one morsel of the benchmark's
    degree-hours COOK: station-years one after another (8760 hourly rows a
    station, so 8-9 stations a morsel), temperatures at ISD's tenth about
    climates from -5 to 27 C, 1% missing (NaN), filtered ``temp > base``,
    and the float sums of ``t`` (passthrough) and ``temp - base``."""
    hours = 8760
    st = (int(rng.integers(0, hours)) + np.arange(n)) // hours
    gidx = (st - st[0]).astype(np.int32)
    h = (int(rng.integers(0, hours)) + np.arange(n)) % hours
    mean = rng.uniform(-5.0, 27.0, gidx[-1] + 1)[gidx]
    temp = mean + 10.0 * np.sin(2 * np.pi * h / hours) + 3.0 * np.sin(2 * np.pi * h / 24) + rng.normal(0, 2.5, n)
    temp = (np.round(temp * 10.0) / 10.0).astype(np.float32)
    temp[rng.random(n) < 0.01] = np.nan
    thr = int(np.array([base], np.float32).view(np.int32)[0])
    z, bits = np.zeros((n, 1), np.int32), temp.view(np.int32).reshape(n, 1)
    arrays = (np.array([n, thr, 0, 0], np.int32), bits, gidx, bits.copy(), z, np.zeros((n, 1), np.float32), z,
              temp.reshape(n, 1), z)
    g = int(gidx[-1]) + 1
    static = dict(op="gt", kind="f32", descrs_f=(("sub", ("col", 0), ("lit", base)),), descrs_i=(), csums=(),
                  fns_f=("min",), fns_i=("min",), with_gidx=True, segmented=True, ngroups=-(-g // 8) * 8,
                  fsums=((0, "f32"), (1, "f32")))
    return arrays, static


def _fused_cases(rng) -> list:
    """(label, numpy inputs, static args) of the five configurations."""
    f32_bits = lambda v: v.view(np.int32).reshape(-1, 1)  # noqa: E731
    thr_1013 = int(np.array([1013.0], np.float32).view(np.int32)[0])
    cases = []

    # 1. the fused aggregate COOK's morsel (the shape the main path hands it)
    n = MORSEL
    station = _skewed_groups(rng, n, STATIONS)
    pressure = (rng.standard_normal(n) * 9.0 + 1013.0).astype(np.float32)
    qc = rng.integers(0, 4, n).astype(np.uint8)
    temp = (rng.standard_normal(n) * 12.0 + 8.0).astype(np.float32)
    temp[rng.random(n) < 0.001] = np.nan
    temp[rng.random(n) < 0.001] = -0.0
    z = np.zeros((n, 1), np.int32)
    arrays = (np.array([n, thr_1013, 0, 0], np.int32), f32_bits(pressure), station, z, _limbs(qc),
              pressure.reshape(n, 1), qc.astype(np.int32).reshape(n, 1), temp.reshape(n, 1), station.reshape(n, 1))
    static = dict(op="gt", kind="f32", descrs_f=(_TK,), descrs_i=(_S3,), csums=(0,), fns_f=("min",), fns_i=("max",),
                  with_gidx=True, segmented=True, ngroups=STATIONS)
    cases.append(("main", arrays, static))

    # 2. the widest envelope: SUM_ROW_CAP rows, 256 groups, every table wide
    n = WIDE_N
    gidx = _skewed_groups(rng, n, 256)
    i32 = rng.integers(-50, 50, n).astype(np.int32)
    wide_limbs = np.concatenate([_limbs(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)) for _ in range(2)], axis=1)
    arrays = (np.array([n - 37, 3, 0, 0], np.int32), i32.reshape(n, 1), gidx, _bits32(rng, (n, 6)), wide_limbs,
              (rng.standard_normal((n, 4)) * 40).astype(np.float32),
              rng.integers(-(2**31), 2**31, size=(n, 4), dtype=np.int64).astype(np.int32),
              (rng.standard_normal((n, 2)) * 3).astype(np.float32),
              rng.integers(-(2**31), 2**31, size=(n, 2), dtype=np.int64).astype(np.int32))
    static = dict(op="ge", kind="i32", descrs_f=_HAZARD_F[:3], descrs_i=_HAZARD_I[:2], csums=(0, 1),
                  fns_f=("min", "max", "max", "min"), fns_i=("max", "min", "min", "max"), with_gidx=True,
                  segmented=True, ngroups=256)
    cases.append(("wide", arrays, static))

    # 3. a streaming chain (no fold) on an int64 predicate: the fused select
    #    COOK's layout [station | temp | ts hi, lo | value hi, lo] + temp_k
    n = MORSEL
    ts = T0 + np.arange(n, dtype=np.int64) * 1_000_000 + rng.integers(0, 999_999, n)
    ts[:4] = [-(2**63), 2**63 - 1, 0, -1]
    cut = int(ts[n // 3])
    temp = _f32_specials(rng, n)
    value = rng.standard_normal(n) * 1e3
    pass_tbl = np.concatenate([station.reshape(n, 1), f32_bits(temp), _i64_words(ts),
                               _i64_words(value.view(np.int64))], axis=1)
    t_lo = _signed32((cut & 0xFFFFFFFF) ^ 0x80000000)
    z = np.zeros((n, 1), np.int32)
    arrays = (np.array([n - 5, cut >> 32, t_lo, 0], np.int32), _i64_words(ts), np.zeros(n, np.int32),
              np.ascontiguousarray(pass_tbl), z, np.zeros((n, 1), np.float32), z, temp.reshape(n, 1), z)
    static = dict(op="ge", kind="i64", descrs_f=(_TK,), descrs_i=(), csums=(), fns_f=("min",), fns_i=("min",),
                  with_gidx=False, segmented=False, ngroups=8)
    cases.append(("stream-i64", arrays, static))

    # 4. special values everywhere: NaN payloads (one and both operands),
    #    ±0, ±inf, denormals and int64 extremes, in every table
    n = MORSEL
    pred = _f32_specials(rng, n)
    pass_tbl = np.concatenate([_bits32(rng, (n, 3)), _i64_words(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))],
                              axis=1)
    pass_tbl[:4, 3:5] = _i64_words(np.array([-(2**63), 2**63 - 1, 0, -1], np.int64))
    af = np.stack([_f32_specials(rng, n), _f32_specials(rng, n)], axis=1)
    af[::5, 1] = 0.0
    ai = rng.integers(-(2**31), 2**31, size=(n, 2), dtype=np.int64).astype(np.int32)
    arrays = (np.array([n - 11, int(np.array([0.5], np.float32).view(np.int32)[0]), 0, 0], np.int32),
              f32_bits(pred), _skewed_groups(rng, n, 64), np.ascontiguousarray(pass_tbl),
              _limbs(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)),
              np.stack([_f32_specials(rng, n), _f32_specials(rng, n)], axis=1), ai[:, :1].copy(), af, ai)
    static = dict(op="le", kind="f32", descrs_f=_HAZARD_F, descrs_i=_HAZARD_I, csums=(2, 0), fns_f=("min", "max"),
                  fns_i=("max",), with_gidx=True, segmented=True, ngroups=64)
    cases.append(("specials", arrays, static))

    # 5. the benchmark cell's morsel, whose two float sums fold on the card
    arrays, static = _cell_morsel(rng)
    cases.append(("cell", arrays, static))
    return cases


def _fold_bytes(arrays, static) -> int:
    """Bytes the float sums' fold must move: the tile counts, each
    survivor's gidx and float-sum planes read once, fsum written once."""
    pred, thr = arrays[1], arrays[0]
    n = arrays[3].shape[0]
    survivors = int((pred[: thr[0], 0].view(np.float32) > np.array([thr[1]], np.int32).view(np.float32)[0]).sum())
    planes = sum(2 if k in ("f64", "i64", "u64") else 1 for _o, k in static["fsums"])
    return 4 * (n // TILE) + 4 * survivors * (1 + planes) + 8 * static["ngroups"] * len(static["fsums"])


def _fused_bytes(arrays, static) -> int:
    """Bytes the function must move: every input table read once, ctab,
    the counts and the group outputs written once."""
    _sc, pred, gidx, pass_tbl, limb, mmf, mmi, af, ai = arrays
    n = pass_tbl.shape[0]
    read = sum(a.nbytes for a in (pred, gidx, pass_tbl, limb, mmf, mmi, af, ai))
    dc = pass_tbl.shape[1] + len(static["descrs_f"]) + len(static["descrs_i"]) + int(static["with_gidx"])
    ls = limb.shape[1] + 4 * len(static["csums"])
    g = static["ngroups"]
    return read + 4 * n * dc + 4 * (n // TILE) + 4 * g * (ls + 2 + mmf.shape[1] + mmi.shape[1])


def _per_op_morsel(dev, arrays):
    """The per-op kernels doing the main case's morsel: project temp_k and
    s3, filter+select the five columns the fold reads, then the segment sum
    (count, qc and s3 limbs) and the f32 / i32 min/max over the survivors.
    Returns a function that launches them on device-resident inputs."""
    import torch

    from repro_torch.kernels import ops

    scalars, pred, gidx, _z, limb_qc, mmf, mmi, af, ai = arrays
    n = pred.shape[0]
    tk = (af[:, 0] + np.float32(273.15)).astype(np.float32)
    s3 = (ai[:, 0].astype(np.int64) * 3 + 1).astype(np.int32)
    table = np.stack([ai[:, 0], mmf[:, 0].view(np.int32), mmi[:, 0], tk.view(np.int32), s3], axis=1)
    keep = mmf[:, 0] > np.float32(1013.0)
    n_sel = int(keep.sum())
    g_sel = np.zeros(n, np.int32)
    g_sel[:n_sel] = gidx[keep]
    limbs = np.zeros((n, 16), np.int32)
    limbs[:n_sel] = np.concatenate([limb_qc[keep], _limbs(s3[keep])], axis=1)
    vf = np.zeros((n, 1), np.float32)
    vf[:n_sel] = mmf[keep]
    vi = np.zeros((n, 1), np.int32)
    vi[:n_sel] = mmi[keep]
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in dict(
        af=af, ai=ai, pred=pred, table=table, g=g_sel, limbs=limbs, vf=vf, vi=vi).items()}

    def run():
        ops.project_tiles(t["af"], (_TK,), TILE)
        ops.project_tiles(t["ai"], (_S3,), TILE)
        ops.filter_select_planes(t["pred"], t["table"], scalars[:3], "gt", "f32", TILE)
        ops.segment_sum_tiles(t["g"], t["limbs"], n_sel, STATIONS, TILE)
        ops.segment_minmax_tiles(t["g"], t["vf"], n_sel, STATIONS, ("min",), TILE)
        ops.segment_minmax_tiles(t["g"], t["vi"], n_sel, STATIONS, ("max",), TILE)

    return run


def check_fused(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels import fused_pipeline as fp

    rec = KernelRecord("fused_chain_tiles", "src/repro_torch/kernels/csrc/fused_chain.cu",
                       "src/repro/kernels/fused_pipeline.py:182")
    for label, arrays, static in _fused_cases(rng):
        t_cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays[1:]]
        t_dev = [t.to(dev) for t in t_cpu]
        got = fp.fused_chain_tiles(arrays[0], *t_dev, **static, tile=TILE)
        torch.cuda.synchronize()
        want = fp.fused_chain_tiles_plain(arrays[0], *t_cpu, **static, tile=TILE)
        rec.compare(got, want, f"{label}: {static['kind']} segmented={static['segmented']}")
        n = arrays[3].shape[0]
        shape = (f"N={n} P={arrays[1].shape[1]} Dp={arrays[3].shape[1]} L={arrays[4].shape[1]} "
                 f"Mf={arrays[5].shape[1]} Mi={arrays[6].shape[1]} nf={len(static['descrs_f'])} "
                 f"ni={len(static['descrs_i'])} csums={len(static['csums'])} G={static['ngroups']}")
        if label == "main":
            call = lambda t_dev=t_dev, arrays=arrays, static=static: fp.fused_chain_tiles(  # noqa: E731
                arrays[0], *t_dev, **static, tile=TILE)
            _time_kernel(rec, call)
            rec.plain_ms = _time_ms(lambda: fp.fused_chain_tiles_plain(arrays[0], *t_dev, **static, tile=TILE))
            rec.bound_ms = _bytes_bound_ms(_fused_bytes(arrays, static))
            rec.shape = shape
            per_op = _per_op_morsel(dev, arrays)
            rec.extra["per_op_ms"] = _kernel_device_ms(per_op)
            rec.extra["per_op_call_ms"] = _time_ms(per_op)
            rec.extra["kernels_ms"] = _kernels_by_name(call, r"fused_\w+_kernel")  # the wrapper's launches
            rec.extra["call_device_ms"] = _all_device_ms(call)
            rec.extra["blocks"] = _launched_grid(call, "fused_chain_kernel")
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        elif label == "wide":
            call = lambda t_dev=t_dev, arrays=arrays, static=static: fp.fused_chain_tiles(  # noqa: E731
                arrays[0], *t_dev, **static, tile=TILE)
            rec.wide(call, _fused_bytes(arrays, static), shape)
            rec.extra["wide_blocks"] = _launched_grid(call, "fused_chain_kernel")
        elif label == "cell":  # the float sums' fold, in the parallel pass and (a few far larger values) in order
            call = lambda t_dev=t_dev, arrays=arrays, static=static: fp.fused_chain_tiles(  # noqa: E731
                arrays[0], *t_dev, **static, tile=TILE)
            rec.extra["cell_shape"] = shape + f" fsums={len(static['fsums'])}"
            rec.extra["cell_kernels_ms"] = _kernels_by_name(call, r"(fused_\w+_kernel|fsum_fold_kernel)")
            rec.extra["cell_fold_bound_ms"] = _bytes_bound_ms(_fold_bytes(arrays, static))
            rec.extra["cell_plain_ms"] = _time_ms(lambda: fp.fused_chain_tiles_plain(arrays[0], *t_dev, **static,
                                                                                     tile=TILE))
            far = [np.array(a) for a in arrays]
            temp = far[7][:, 0]
            temp[::97] = np.float32(3.0e7)  # 3.0e7 beside tenths of a degree: the sums round, so order counts
            far[1], far[3] = temp.view(np.int32).reshape(-1, 1).copy(), temp.view(np.int32).reshape(-1, 1).copy()
            o_cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in far[1:]]
            o_dev = [t.to(dev) for t in o_cpu]
            got = fp.fused_chain_tiles(far[0], *o_dev, **static, tile=TILE)
            rec.compare(got, fp.fused_chain_tiles_plain(far[0], *o_cpu, **static, tile=TILE), "cell, sums in order")
            rec.extra["cell_ordered_kernels_ms"] = _kernels_by_name(
                lambda: fp.fused_chain_tiles(far[0], *o_dev, **static, tile=TILE), r"fsum_fold_kernel")
    rec.extra["design"] = ("grid-stride over at most 2 blocks per SM, warp-aggregated fold (match_any + shuffle trees: "
                           "sums, min/max, first row), tile rows staged in shared memory and stored as 16-byte vectors, "
                           "f32 keys decoded by the last block")
    return rec


def _kernels_by_name(fn, pattern: str) -> dict:
    """{kernel name: device ms per call} of the kernels ``fn`` launches
    whose name matches ``pattern`` (REPS calls, profiled)."""
    times = _rep_device_times(fn)
    out: dict = {}
    for name, us in times.items():
        hit = re.search(pattern, name)
        if hit:
            out[hit.group(0)] = out.get(hit.group(0), 0.0) + us / 1e3 / REPS
    return out


def _launched_grid(fn, pattern: str) -> int:
    """Blocks in the grid of the kernel matching ``pattern`` that one call of
    ``fn`` launched, as the profiler's trace records the launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    grids = [math.prod(e["args"]["grid"]) for e in events
             if e.get("cat") == "kernel" and re.search(pattern, e.get("name", "")) and "grid" in e.get("args", {})]
    check(len(grids) == 1, f"the trace holds {len(grids)} launches of {pattern} with a grid, not 1")
    return grids[0]


# the serving shapes of phase 4: granite-3-8b at batch 4, 1024-token prompts
# (one layer's prefill attention) and the first of 32 decode steps
SERVE_BATCH = 4
SERVE_PROMPT = 1024
SERVE_NEW = 32
ATTN_TOL = {"bfloat16": 2e-2, "float32": 3e-5}  # tests/test_kernels.py:14-15, as rtol and atol
DECODE_SETS = 12  # distinct caches the decode timing cycles through: 12 × 17.3 MB against a 50 MB L2
ENC_SEQ = 1500  # whisper-small's encoder frames (phase 6)


def _attn_inputs(rng, dev, dtype, *shapes):
    import torch

    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev, dtype) for sh in shapes]


def _sdpa_call(q, k, v, causal: bool):
    """One ``F.scaled_dot_product_attention`` call on the same inputs: q
    (B, H, S, hd), k/v (B, KV, T, hd), grouped heads."""
    import torch
    import torch.nn.functional as F

    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    g = q.shape[1] // k.shape[1]  # older PyTorch: expand the kv heads outside the timed call
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)


_COPY_EVENTS = ("Memcpy", "Memset", "copy", "elementwise", "fill")


def _sdpa_times(fn) -> dict:
    """SDPA measured as our kernels are: the profiler's device time of its
    attention kernels (every traced kernel but copies and fills), beside the
    device time of the whole call and the CUDA-event time of REPS calls."""
    times = _rep_device_times(fn)
    attn = {k: v for k, v in times.items() if not any(c in k for c in _COPY_EVENTS)}
    return {
        "library_ms": _time_ms(fn),
        "library_device_ms": sum(attn.values()) / 1e3 / REPS,
        "library_call_device_ms": sum(times.values()) / 1e3 / REPS,
        "library_kernels": sorted(k[:60] for k in times),
    }


def _cold_sets(*tensors) -> list:
    """Rolled copies of ``tensors``, as many sets as hold COLD_BYTES, so
    that a rotation over them reads its inputs from device memory."""
    per_set = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.roll(k, 0).contiguous() for t in tensors) for k in range(-(-COLD_BYTES // per_set))]


def _rotation(fn, sets: list):
    """A callable that runs ``fn`` on the next of ``sets`` each call, so
    that consecutive calls read different memory."""
    state = {"i": 0}

    def call():
        args = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*args)

    return call


def check_flash(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rec = KernelRecord("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:74")
    rec.tolerance = "rtol=atol=2e-2 bfloat16, 3e-5 float32 (tests/test_kernels.py)"
    b, kv, g, hd = SERVE_BATCH, 8, 4, 128
    cases = [  # (label, B, KV, G, S, T, hd, dtype, causal)
        ("serving", b, kv, g, SERVE_PROMPT, SERVE_PROMPT, hd, torch.bfloat16, True),
        ("ragged", b, kv, g, 1000, 1000, hd, torch.bfloat16, True),
        ("f32", 1, 2, 2, 200, 200, 64, torch.float32, True),
        ("f32-full", 2, 1, 3, 77, 130, 64, torch.float32, False),
        ("hd32", 2, 2, 1, 65, 65, 32, torch.float32, True),
        ("hd256", 1, 1, 8, 300, 300, 256, torch.bfloat16, True),
        ("zamba2", b, 32, 1, SERVE_PROMPT, SERVE_PROMPT, 64, torch.bfloat16, True),
        # phase 6's shapes: moonshot's MHA (G 1 at hd 128); whisper's encoder (full,
        # ragged 1500), cross-attention at prefill (full, S != T) and self-attention
        ("moonshot", b, 16, 1, SERVE_PROMPT, SERVE_PROMPT, 128, torch.bfloat16, True),
        ("whisper-encoder", b, 12, 1, ENC_SEQ, ENC_SEQ, 64, torch.bfloat16, False),
        ("whisper-cross", b, 12, 1, SERVE_PROMPT, ENC_SEQ, 64, torch.bfloat16, False),
        ("whisper-self", b, 12, 1, SERVE_PROMPT, SERVE_PROMPT, 64, torch.bfloat16, True),
    ]
    rec.extra["serving_shapes"] = {}
    for label, bb, nk, gg, s, t, d, dtype, causal in cases:
        q, k, v = _attn_inputs(rng, dev, dtype, (bb, nk, gg, s, d), (bb, nk, t, d), (bb, nk, t, d))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        rec.compare_close(got, flash_attention_plain(q, k, v, causal=causal), tol, tol, label)
        if label == "serving":
            _time_kernel(rec, lambda: flash_attention(q, k, v, causal=True))
            rec.plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, causal=True))
            sdpa = _sdpa_times(_sdpa_call(q.reshape(bb, nk * gg, s, d), k, v, causal=True))
            rec.library_ms = sdpa.pop("library_ms")
            rec.extra.update(sdpa)
            nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v read once, o written once
            flops = 4 * bb * nk * gg * s * t * d / 2  # QK^T and PV, half of them below the diagonal
            by_bytes, by_ops = _bytes_bound_ms(nbytes), flops / BF16_FLOPS * 1e3
            rec.bound_ms, rec.bound_by = max(by_bytes, by_ops), "operations" if by_ops >= by_bytes else "bytes"
            rec.shape = f"B={bb} KV={nk} G={gg} S=T={s} hd={d} bfloat16 causal"
            rec.extra["tflops"] = flops / (rec.ms * 1e-3) / 1e12
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        elif label == "zamba2":  # the shared attention block's prefill, timed beside the serving shape
            zamba2 = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
            rec.extra["zamba2_ms"] = _kernel_device_ms(zamba2) or _time_ms(zamba2)
            sdpa = _sdpa_times(_sdpa_call(q.reshape(bb, nk * gg, s, d), k, v, causal=True))
            rec.extra["zamba2_library_ms"] = sdpa["library_ms"]
            rec.extra["zamba2_library_device_ms"] = sdpa["library_device_ms"]
        elif label.startswith(("moonshot", "whisper")):
            fn = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
            sdpa = _sdpa_times(_sdpa_call(q.reshape(bb, nk * gg, s, d), k, v, causal=causal))
            flops = 4 * bb * nk * gg * s * t * d / (2 if causal else 1)
            nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
            rec.extra["serving_shapes"][label] = {
                "shape": f"B={bb} KV={nk} G={gg} S={s} T={t} hd={d} bfloat16 {'causal' if causal else 'full'}",
                "ms": _kernel_device_ms(fn) or _time_ms(fn),
                "library_device_ms": sdpa["library_device_ms"],
                "library_ms": sdpa["library_ms"],
                "bound_ms": max(_bytes_bound_ms(nbytes), flops / BF16_FLOPS * 1e3),
            }
    # bfloat16 runs on the tensor cores (wgmma); float32 on the CUDA cores
    rec.extra["design"] = "wgmma"
    rec.extra["tensor_core_instructions"] = tensor_core_instructions("flash_attn_bf16")
    check(rec.extra["tensor_core_instructions"] > 0, "the bf16 flash kernel's SASS holds no HMMA / HGMMA")
    return rec


def check_decode(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain, split_plan

    rec = KernelRecord("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                       "src/repro/kernels/decode_attention.py:64")
    rec.tolerance = "rtol=atol=2e-2 bfloat16, 3e-5 float32 (tests/test_kernels.py)"
    t_max = SERVE_PROMPT + SERVE_NEW
    cases = [  # (label, B, KV, G, T, length, hd, dtype)
        ("serving", SERVE_BATCH, 8, 4, t_max, SERVE_PROMPT + 1, 128, torch.bfloat16),
        ("serving-last", SERVE_BATCH, 8, 4, t_max, t_max, 128, torch.bfloat16),
        ("ragged", SERVE_BATCH, 8, 4, 1000, 17, 128, torch.bfloat16),
        ("f32", 2, 2, 4, 1000, 999, 64, torch.float32),
        ("hd32-g1", 3, 2, 1, 70, 1, 32, torch.float32),
        ("hd256-g32", 1, 2, 32, 300, 129, 256, torch.bfloat16),
        # phase 6's shapes: moonshot's MHA at hd 128; whisper's self-attention,
        # and its cross-attention over the whole 1500-row memory (length = T)
        ("moonshot", SERVE_BATCH, 16, 1, t_max, SERVE_PROMPT + 1, 128, torch.bfloat16),
        ("whisper-self", SERVE_BATCH, 12, 1, t_max, SERVE_PROMPT + 1, 64, torch.bfloat16),
        ("whisper-cross", SERVE_BATCH, 12, 1, ENC_SEQ, ENC_SEQ, 64, torch.bfloat16),
    ]
    rec.extra["serving_shapes"] = {}
    for label, bb, nk, gg, t, length, d, dtype in cases:
        q, k, v = _attn_inputs(rng, dev, dtype, (bb, nk, gg, d), (bb, nk, t, d), (bb, nk, t, d))
        got = decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        rec.compare_close(got, decode_attention_plain(q, k, v, length), tol, tol, label)
        if label == "serving":
            # the model reads 40 layer caches a step, none of them from L2:
            # time over a rotation of DECODE_SETS distinct (q, k, v), more
            # bytes than the 50 MB L2 holds, for the kernel and SDPA alike
            sets = [(q, k, v)] + [
                tuple(_attn_inputs(rng, dev, dtype, (bb, nk, gg, d), (bb, nk, t, d), (bb, nk, t, d)))
                for _ in range(DECODE_SETS - 1)
            ]
            cold = _rotation(lambda q, k, v: decode_attention(q, k, v, length), sets)
            _time_kernel(rec, cold)
            rec.extra["call_device_ms"] = _all_device_ms(cold)
            rec.extra["hot_ms"] = _kernel_device_ms(lambda: decode_attention(q, k, v, length))
            rec.plain_ms = _time_ms(lambda: decode_attention_plain(q, k, v, length))
            sdpa = _sdpa_times(_rotation(
                lambda q, k, v: _sdpa_call(q.reshape(bb, nk * gg, 1, d), k[:, :, :length], v[:, :, :length], False)(),
                sets))
            rec.library_ms = sdpa.pop("library_ms")
            rec.extra.update(sdpa)
            rec.extra["hot_library_device_ms"] = _sdpa_times(
                _sdpa_call(q.reshape(bb, nk * gg, 1, d), k[:, :, :length], v[:, :, :length], False))["library_device_ms"]
            rec.extra["rotation"] = f"{DECODE_SETS} sets of {sum(a.numel() * a.element_size() for a in sets[0]) / 1e6:.1f} MB"
            nbytes = 2 * (2 * bb * nk * length * d + 2 * q.numel())  # k, v below length; q; o
            flops = 4 * bb * nk * gg * length * d
            by_bytes, by_ops = _bytes_bound_ms(nbytes), flops / BF16_FLOPS * 1e3
            rec.bound_ms, rec.bound_by = max(by_bytes, by_ops), "operations" if by_ops >= by_bytes else "bytes"
            rec.shape = f"B={bb} KV={nk} G={gg} T={t} length={length} hd={d} bfloat16"
            rec.extra["splits"] = split_plan(bb * nk, length, torch.cuda.get_device_properties(dev).multi_processor_count)
            rec.extra["GBps"] = nbytes / (rec.ms * 1e-3) / 1e9
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
        elif label.startswith(("moonshot", "whisper")):
            # over a rotation of DECODE_SETS distinct caches, as the serving shape
            sets = [(q, k, v)] + [
                tuple(_attn_inputs(rng, dev, dtype, (bb, nk, gg, d), (bb, nk, t, d), (bb, nk, t, d)))
                for _ in range(DECODE_SETS - 1)
            ]
            cold = _rotation(lambda q, k, v: decode_attention(q, k, v, length), sets)
            sdpa = _sdpa_times(_rotation(
                lambda q, k, v: _sdpa_call(q.reshape(bb, nk * gg, 1, d), k[:, :, :length], v[:, :, :length], False)(),
                sets))
            nbytes = 2 * (2 * bb * nk * length * d + 2 * q.numel())
            rec.extra["serving_shapes"][label] = {
                "shape": f"B={bb} KV={nk} G={gg} T={t} length={length} hd={d} bfloat16",
                "ms": _kernel_device_ms(cold) or _time_ms(cold),
                "library_device_ms": sdpa["library_device_ms"],
                "library_ms": sdpa["library_ms"],
                "bound_ms": max(_bytes_bound_ms(nbytes), 4 * bb * nk * gg * length * d / BF16_FLOPS * 1e3),
            }
    rec.extra["partials"] = check_decode_partials(rec, dev, rng)
    rec.extra["design"] = ("mma.sync m16n8k16 bf16 on transposed products (S^T = K Q^T, out^T = V^T P^T), 16-byte "
                           "cp.async ring, split-K merged within a thread block cluster; the partials mode ends the "
                           "merge before the division by l")
    rec.extra["tensor_core_instructions"] = tensor_core_instructions("decode_attn_tc")
    check(rec.extra["tensor_core_instructions"] > 0, "the bf16 decode kernel's SASS holds no HMMA / HGMMA")
    return rec


def check_decode_partials(rec: KernelRecord, dev, rng) -> dict:
    """``decode_attention_partials`` (the decode kernel whose merge hands out
    the partial m, l, acc) against its plain version: m within the attention
    tolerance, l relatively, acc within it at its peak and acc / l as the
    output, at phase 8e's rank shape (zamba2-1.2b's shared attention, B 1,
    KV 32, G 1, hd 64, 131072 positions, whole and at rank 3's ragged
    106781), in float32, at G 17 over 16 splits, and at length 0 (no launch:
    -1e30, 0, 0).  A disagreement fails ``rec``.  Times the rank shape's
    launch against its bound, its plain version and the library's attention
    that also hands out a softmax statistic,
    ``_scaled_dot_product_efficient_attention`` with its log-sum-exp (G 1:
    no kv heads to expand).  Returns the readings (max |err| of each
    component over the cases, times at the rank shape)."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_partials, decode_attention_partials_plain
    from repro_torch.kernels.decode_attention import launches

    t_rank = LONG_T // DIST_RANKS
    ragged = LONG_INDEX + 1 - (DIST_RANKS - 1) * t_rank
    cases = [  # (label, B, KV, G, T, length, hd, dtype)
        ("rank", 1, 32, 1, t_rank, t_rank, 64, torch.bfloat16),
        ("rank-ragged", 1, 32, 1, t_rank, ragged, 64, torch.bfloat16),
        ("f32", 2, 2, 4, 1000, 999, 64, torch.float32),
        ("g17-16splits", 1, 2, 17, 4096, 4000, 128, torch.bfloat16),
        ("zero", 1, 32, 1, 256, 0, 64, torch.bfloat16),
    ]
    out: dict = {"max_abs_err": {"m": 0.0, "l": 0.0, "acc": 0.0, "acc/l": 0.0}, "checks": 0}

    def close(name, got, want, rtol, atol, label):
        err = (got - want).abs()
        out["max_abs_err"][name] = max(out["max_abs_err"][name], float(err.max()))
        out["checks"] += 1
        if not bool(torch.isfinite(got).all()) or not bool((err <= atol + rtol * want.abs()).all()):
            rec.agrees = False
            log(f"MISMATCH decode_attention_partials {label}: {name} max |err| {float(err.max())} beyond atol "
                f"{atol} + rtol {rtol}")

    for label, bb, nk, gg, t, length, d, dtype in cases:
        q, k, v = _attn_inputs(rng, dev, dtype, (bb, nk, gg, d), (bb, nk, t, d), (bb, nk, t, d))
        before = launches.value
        got = decode_attention_partials(q, k, v, length)
        torch.cuda.synchronize()
        launched = launches.value - before
        check(launched == (length > 0), f"decode_attention_partials {label}: {launched} launches")
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        if length == 0:
            out["checks"] += 1
            check(bool((got[0] == -1e30).all()) and not got[1].any() and not got[2].any(),
                  "decode_attention_partials at length 0 is not (-1e30, 0, 0)")
            continue
        m, l, acc = got
        wm, wl, wacc = decode_attention_partials_plain(q, k, v, length)
        close("m", m, wm, tol, tol, label)
        close("l", l, wl, tol, 0.0, label)
        close("acc", acc, wacc, tol, tol * float(wacc.abs().max()), label)
        close("acc/l", acc / l, wacc / wl, tol, tol, label)
        if label == "rank":
            nbytes = 2 * 2 * bb * nk * length * d + 2 * q.numel() + 4 * (m.numel() + l.numel() + acc.numel())
            flops = 4 * bb * nk * gg * length * d
            by_bytes, by_ops = _bytes_bound_ms(nbytes), flops / BF16_FLOPS * 1e3
            fn = lambda: decode_attention_partials(q, k, v, length)  # noqa: E731
            q_heads = q.reshape(bb, nk * gg, 1, d)
            lse = _sdpa_times(lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q_heads, k, v, None, True))
            out.update(shape=f"B={bb} KV={nk} G={gg} T={t} length={length} hd={d} bfloat16",
                       ms=_kernel_device_ms(fn) or _time_ms(fn), call_ms=_time_ms(fn),
                       plain_ms=_time_ms(lambda: decode_attention_partials_plain(q, k, v, length)),
                       bound_ms=max(by_bytes, by_ops), bound_by="operations" if by_ops >= by_bytes else "bytes",
                       bound_bytes=nbytes, library="aten._scaled_dot_product_efficient_attention, log-sum-exp",
                       library_ms=lse["library_ms"], library_device_ms=lse["library_device_ms"],
                       library_kernels=lse["library_kernels"])
        del q, k, v, got
    torch.cuda.empty_cache()
    return out


SSD_TOL = 2e-4  # tests/test_kernels.py:53, as rtol and atol
MLSTM_TOL = 5e-4  # tests/test_kernels.py:66


def _ops_bound(rec: KernelRecord, nbytes: int, flops: float) -> None:
    """The larger of the bytes at 3.35 TB/s and the operations at the bf16
    tensor-core rate, and which of the two it is."""
    by_bytes, by_ops = _bytes_bound_ms(nbytes), flops / BF16_FLOPS * 1e3
    rec.bound_ms, rec.bound_by = max(by_bytes, by_ops), "operations" if by_ops >= by_bytes else "bytes"
    rec.extra["bound_bytes"] = nbytes
    rec.extra["bound_flops"] = flops


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def _chunk_lengths(s: int, chunk: int) -> list:
    return [min(chunk, s - c0) for c0 in range(0, s, chunk)]


def check_ssd(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    rec = KernelRecord("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:65")
    rec.tolerance = f"rtol=atol={SSD_TOL} on y and the final state (tests/test_kernels.py)"
    cases = [  # (label, b, s, h, p, n, chunk, dtype): serving is zamba2-1.2b's prefill, one layer
        ("serving", SERVE_BATCH, SERVE_PROMPT, 64, 64, 64, 256, torch.bfloat16),
        ("ragged", SERVE_BATCH, 1000, 64, 64, 64, 256, torch.bfloat16),
        ("long", 1, 4096, 64, 64, 64, 256, torch.bfloat16),  # 16 chunks: the carry over many
        ("narrow", 2, 300, 8, 32, 16, 96, torch.bfloat16),
        ("reduced", 2, 100, 8, 32, 16, 32, torch.float32),
        ("f32", 2, 512, 8, 64, 64, 256, torch.float32),
    ]
    rec.extra["worst_ratio"] = {}  # max |got - want| / (atol + rtol |want|) per case: 1 is the tolerance
    for label, b, s, h, p, n, chunk, dtype in cases:
        x, B, C = _attn_inputs(rng, dev, dtype, (b, s, h, p), (b, s, n), (b, s, n))
        dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)).to(dev)
        A = torch.from_numpy(-np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)).to(dev)
        got = ssd_scan(x, dt, A, B, C, chunk)
        torch.cuda.synchronize()
        want = ssd_scan_plain(x, dt, A, B, C, chunk)
        ratio = 0.0
        for what, g, w in zip(("y", "S_final"), got, want):
            rec.compare_close(g, w, SSD_TOL, SSD_TOL, f"{label} {what}")
            ratio = max(ratio, float(((g - w).abs() / (SSD_TOL + SSD_TOL * w.abs())).max()))
        rec.extra["worst_ratio"][label] = ratio
        if label == "serving":
            _time_kernel(rec, lambda: ssd_scan(x, dt, A, B, C, chunk))
            rec.plain_ms = _time_ms(lambda: ssd_scan_plain(x, dt, A, B, C, chunk))
            e = x.element_size()
            nbytes = x.numel() * e + dt.numel() * 4 + A.numel() * 4 + 2 * B.numel() * e + x.numel() * 4 + b * h * p * n * 4
            # below the diagonal: C·B scores and M·x per chunk, C·S_prev and the state update per row
            flops = b * h * sum(2 * _tri(lc) * (n + p) + 4 * lc * p * n for lc in _chunk_lengths(s, chunk))
            _ops_bound(rec, nbytes, flops)
            rec.shape = f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} bfloat16"
            call = lambda: ssd_scan(x, dt, A, B, C, chunk)  # noqa: E731
            rec.extra["call_device_ms"] = _all_device_ms(call)
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
            rec.extra["tflops"] = flops / (rec.ms * 1e-3) / 1e12
            rec.extra["kernels_ms"] = _kernels_by_name(call, r"ssd_scan_kernel\w*")  # the wrapper's launch is three kernels
        elif label == "long":
            rec.extra["long_ms"] = _kernel_device_ms(lambda: ssd_scan(x, dt, A, B, C, chunk))
    rec.extra["design"] = ("three kernels, products on mma.sync m16n8k16 bf16 (f32 operands as bf16 hi + lo, x*w and the "
                           "carried state as hi + mid + lo): every chunk's own state, the carry over chunks, every chunk's "
                           "outputs; B and C loaded once for 4 heads")
    rec.extra["tensor_core_instructions"] = tensor_core_instructions("ssd_scan_kernel")
    check(rec.extra["tensor_core_instructions"] > 0, "the bf16 ssd kernels' SASS holds no HMMA / HGMMA")
    return rec


def check_mlstm(dev, rng) -> KernelRecord:
    import torch

    from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain

    rec = KernelRecord("mlstm_chunk", "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                       "src/repro/kernels/mlstm_chunk.py:80")
    rec.tolerance = f"rtol=atol={MLSTM_TOL} on y, C, n and m (tests/test_kernels.py)"
    cases = [  # (label, b, s, h, d, chunk, dtype): serving is xlstm-125m's prefill, one layer
        ("serving", SERVE_BATCH, SERVE_PROMPT, 4, 384, 256, torch.bfloat16),
        ("ragged", SERVE_BATCH, 1000, 4, 384, 256, torch.bfloat16),
        ("reduced", 2, 100, 4, 64, 32, torch.float32),
        ("f32", 2, 512, 2, 384, 256, torch.float32),
    ]
    for label, b, s, h, d, chunk, dtype in cases:
        q, k, v = _attn_inputs(rng, dev, dtype, (b, s, h, d), (b, s, h, d), (b, s, h, d))
        li = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)).to(dev)
        lf = torch.from_numpy((rng.standard_normal((b, s, h)) - 1.0).astype(np.float32)).to(dev)
        got = mlstm_chunk(q, k, v, li, lf, chunk)
        torch.cuda.synchronize()
        want = mlstm_chunk_plain(q, k, v, li, lf, chunk)
        for what, g, w in zip(("y", "C", "n", "m"), got, want):
            rec.compare_close(g, w, MLSTM_TOL, MLSTM_TOL, f"{label} {what}")
        if label == "serving":
            _time_kernel(rec, lambda: mlstm_chunk(q, k, v, li, lf, chunk))
            rec.plain_ms = _time_ms(lambda: mlstm_chunk_plain(q, k, v, li, lf, chunk))
            e = q.element_size()
            nbytes = 3 * q.numel() * e + 2 * li.numel() * 4 + q.numel() * 4 + b * h * (d * d + d + 1) * 4
            # below the diagonal: q·k and (s·D)·v per chunk; q·C_prev and the carry per row
            flops = b * h * sum(2 * _tri(lc) * 2 * d + 4 * lc * d * d for lc in _chunk_lengths(s, chunk))
            _ops_bound(rec, nbytes, flops)
            rec.shape = f"b={b} s={s} h={h} d={d} chunk={chunk} bfloat16"
            rec.extra["call_device_ms"] = _all_device_ms(lambda: mlstm_chunk(q, k, v, li, lf, chunk))
            rec.extra["bound_fraction"] = rec.bound_ms / rec.ms
            times = _rep_device_times(lambda: mlstm_chunk(q, k, v, li, lf, chunk))
            rec.extra["kernels_ms"] = {  # the wrapper's launch is two kernels
                re.search(r"mlstm_chunk_kernel\w*", name).group(0): us / 1e3 / REPS
                for name, us in times.items() if "mlstm_chunk_kernel" in name
            }
    rec.extra["design"] = ("two kernels on mma.sync m16n8k16 bf16 (f32 operands as bf16 hi + lo): the carry over chunks "
                           "per tile of C, then every chunk's outputs in parallel")
    rec.extra["tensor_core_instructions"] = tensor_core_instructions("mlstm_chunk_kernel")
    check(rec.extra["tensor_core_instructions"] > 0, "the bf16 mlstm kernels' SASS holds no HMMA / HGMMA")
    return rec


def time_morsel_copies(dev) -> dict:
    """Host clock around one main-path morsel (the filter's 11 int32
    planes) crossing PCIe: a synchronised pageable H2D copy and D2H copy, as
    the per-op path does, and a pinned ``non_blocking`` H2D copy followed by
    a synchronise, as the fused path stages."""
    import torch

    host = np.zeros((MORSEL, 11), np.int32)
    pinned = torch.from_numpy(host).pin_memory()
    nbytes = host.nbytes
    t_dev = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    h2d, d2h, h2d_pinned = [], [], []
    for _ in range(20):
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        t_dev.cpu()
        d2h.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        h2d_pinned.append(time.perf_counter() - t0)
    out = {"bytes": nbytes}
    for name, samples in (("h2d", h2d), ("d2h", d2h), ("h2d_pinned", h2d_pinned)):
        ms = float(np.median(samples) * 1e3)
        out[f"{name}_ms"] = ms
        out[f"{name}_GBps"] = nbytes / ms / 1e6
    return out


# ---------------------------------------------------------------------------
# phase 3: end to end through two servers
# ---------------------------------------------------------------------------
T0 = 1_700_000_000_000_000_000  # ts origin (ns); row i is stamped near T0 + i ms


def t_cut(rows: int) -> int:
    """The COOK keeps ts >= t_cut: about the last two thirds of the rows."""
    return T0 + (rows // 3) * 1_000_000


def write_observations(root: str, rows: int, parts: int, seed: int) -> int:
    """Seeded station-observations table as a columnar dataset."""
    from repro_torch.core.batch import RecordBatch
    from repro_torch.core.sdf import StreamingDataFrame
    from repro_torch.server import write_sdf_dataset

    per = rows // parts
    w = 1.0 / (np.arange(STATIONS) + 1.0) ** 1.1
    p = w / w.sum()
    probe = RecordBatch.from_pydict(
        {
            "station": np.zeros(1, np.int32),
            "temp": np.zeros(1, np.float32),
            "pressure": np.zeros(1, np.float32),
            "ts": np.zeros(1, np.int64),
            "value": np.zeros(1, np.float64),
            "qc": np.zeros(1, np.uint8),
        }
    )

    def gen():
        for part in range(parts):
            rng = np.random.default_rng([seed, part])
            temp = (rng.standard_normal(per) * 12.0 + 8.0).astype(np.float32)
            temp[rng.random(per) < 0.001] = np.nan
            temp[rng.random(per) < 0.001] = -0.0
            base = part * per
            yield RecordBatch.from_pydict(
                {
                    "station": rng.choice(STATIONS, size=per, p=p).astype(np.int32),
                    "temp": temp,
                    "pressure": (rng.standard_normal(per) * 9.0 + 1013.0).astype(np.float32),
                    "ts": T0 + (np.arange(base, base + per, dtype=np.int64) * 1_000_000) + rng.integers(0, 999_999, per),
                    "value": rng.standard_normal(per) * 1e3,
                    "qc": rng.integers(0, 4, per).astype(np.uint8),
                }
            )

    return write_sdf_dataset(root, StreamingDataFrame(probe.schema, gen))


def _column_bytes(batch) -> dict:
    out = {}
    for f, c in zip(batch.schema, batch.columns):
        if f.dtype.is_varwidth:
            out[f.name] = c.offsets.tobytes() + c.data.tobytes()
        else:
            out[f.name] = np.ascontiguousarray(c.values).tobytes()
        if c.validity is not None:
            out[f.name] += np.asarray(c.validity).tobytes()
    return out


def requests(uri: str, cut: int, thr: float = 1013.0):
    """(name, callable(client) -> reply) for each request of the run.  The
    two per-op COOKs stay on the per-op path (an int64 projection, a wide
    max and a filter on a computed column); the two fused COOKs rename
    source columns with a ``keep=False`` project, so their filter reads a
    renamed source column that is neither sunk into the scan nor swapped
    below the project, and the planner fuses the whole chain."""
    from repro_torch.core.expr import col

    def cook_agg(c):
        return (
            c.open(uri)
            .project(
                temp_k=col("temp") + 273.15,
                dp=col("pressure") * 0.5 - 1013.0,
                s3=col("station") * 3 + 1,
                age=col("ts") - cut,
            )
            .filter(col("age") >= 0)  # ts >= cut, on a column the scan cannot see
            .group_by("station")
            .agg(n="count", q=("sum", "qc"), lo=("min", "pressure"), hi=("max", "ts"), m=("mean", "temp_k"))
            .collect()
        )

    def cook_select(c):
        return (
            c.open(uri)
            .project(s3=col("station") * 3 + 1)
            .filter(col("s3") != 22)  # station != 7
            .select("station", "value", "ts")
            .collect()
        )

    def cook_fused_select(c):
        return (
            c.open(uri)
            .project(keep=False, st=col("station"), t=col("temp"), tk=col("temp") + 273.15, ts=col("ts"),
                     v=col("value"))
            .filter(col("t") > 0.0)
            .collect()
        )

    def cook_fused_agg(c):
        return (
            c.open(uri)
            .project(keep=False, st=col("station"), p=col("pressure"), q=col("qc"), tk=col("temp") + 273.15,
                     s3=col("station") * 3 + 1)
            .filter(col("p") > thr)
            .group_by("st")
            .agg(n="count", sq=("sum", "q"), s3s=("sum", "s3"), lo=("min", "p"), hi=("max", "q"), m=("mean", "tk"))
            .collect()
        )

    return [
        ("GET temp>0 [station,temp,ts]", lambda c: c.get(uri, columns=["station", "temp", "ts"], predicate=col("temp") > 0.0).collect()),
        ("COOK project>filter>group_by.agg", cook_agg),
        ("COOK project>filter>select", cook_select),
        ("COOK fused project>filter>select", cook_fused_select),
        ("COOK fused project>filter>group_by.agg", cook_fused_agg),
    ]


def run_requests(client, uri: str, cut: int, counters=None, server=None) -> list:
    """Drive every request; returns [(name, reply, seconds, path)].  With
    ``counters`` (the kernel launch counters) they are zeroed right before
    the first request and left as they stand after the last; ``path`` then
    holds each request's fused-kernel launches and, with ``server``, its
    COOK's executor counters (fused launches, staged transfers)."""
    meta = {
        "ping": client.ping(),
        "list": client.list(scope="local"),
        "describe": client.describe(uri, scope="local"),
    }
    out = [("PING/LIST/DESCRIBE", meta, 0.0, {})]
    if counters is not None:
        for c in counters.values():
            c.reset()
    for name, fn in requests(uri, cut):
        before = counters["fused_chain_tiles"].value if counters is not None else 0
        t0 = time.perf_counter()
        reply = fn(client)
        secs = time.perf_counter() - t0
        path = {}
        if counters is not None:
            path["fused_kernel_launches"] = counters["fused_chain_tiles"].value - before
        if server is not None and name.startswith("COOK"):
            st = server.engine.executor_stats()
            path["fused_launches"] = st.get("fused_launches", 0)
            path["transfers_overlapped"] = st.get("transfers_overlapped", 0)
        out.append((name, reply, secs, path))
    return out


def start_server(root: str, backend: str, device: str):
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.server import FairdServer

    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = FairdServer(f"127.0.0.1:{port}", executor=ExecutorConfig(backend=backend, device=device, morsel_rows=262144))
    server.catalog.register_path("obs", root)
    server.serve_tcp(port=port)
    return server, f"127.0.0.1:{port}"


def profile_cook(client, server, uri: str, name: str, cut: int, thr: float) -> dict:
    """Where the torch server's time goes in one aggregate COOK: one more
    run under ``torch.profiler`` (a cut or threshold the main run did not
    use, so the plan cache cannot answer it), device time split into our
    kernels, copies and the rest, against the request's wall time."""
    fn = dict(requests(uri, cut, thr))[name]
    times, wall = _device_times(lambda: fn(client))
    st = server.engine.executor_stats()
    ours = sum(v for k, v in times.items() if any(n in k for n in _OUR_KERNELS)) / 1e3
    copies = sum(v for k, v in times.items() if "Memcpy" in k) / 1e3
    other = sum(times.values()) / 1e3 - ours - copies
    return {
        "request": f"{name} (profiled)",
        "wall_ms": wall * 1e3,
        "kernels_ms": ours,
        "memcpy_ms": copies,
        "other_device_ms": other,
        "device_busy_share": (ours + copies + other) / (wall * 1e3),
        "fused_launches": st.get("fused_launches", 0),
        "transfers_overlapped": st.get("transfers_overlapped", 0),
        "top": sorted(((round(v / 1e3, 3), k[:60]) for k, v in times.items()), reverse=True)[:8],
    }


def end_to_end(device: str, rows: int, parts: int) -> tuple:
    """Returns (per-request report, launch counts of the torch run, device
    time breakdowns of the profiled aggregate COOKs, per-op and fused)."""
    from repro_torch.client import TcpNetwork
    from repro_torch.kernels import ops

    tmp = tempfile.mkdtemp(prefix="dacp_smoke_")
    servers = []
    try:
        root = os.path.join(tmp, "obs")
        t0 = time.perf_counter()
        written = write_observations(root, rows, parts, SEED)
        check(written == rows, f"wrote {written} rows, expected {rows}")
        log(f"e2e: wrote {rows} rows in {parts} parts in {time.perf_counter() - t0:.3f} s")
        torch_srv, torch_auth = start_server(root, "torch", device)
        numpy_srv, numpy_auth = start_server(root, "numpy", "cpu")
        servers = [torch_srv, numpy_srv]
        net = TcpNetwork()
        cut = t_cut(rows)
        torch_uri = f"dacp://{torch_auth}/obs"
        got = run_requests(net.client_for(torch_auth), torch_uri, cut, counters=ops.LAUNCHES, server=torch_srv)
        launches = {name: c.value for name, c in ops.LAUNCHES.items()}
        want = run_requests(net.client_for(numpy_auth), f"dacp://{numpy_auth}/obs", cut)
        tc = net.client_for(torch_auth)
        breakdowns = [
            profile_cook(tc, torch_srv, torch_uri, "COOK project>filter>group_by.agg", cut + 1, 1013.0),
            profile_cook(tc, torch_srv, torch_uri, "COOK fused project>filter>group_by.agg", cut, 1013.5),
        ]
        net.close_all()
        report = []
        meta_g, meta_w = got[0][1], want[0][1]
        check(meta_g["describe"].get("schema") == meta_w["describe"].get("schema"), "DESCRIBE schemas differ")
        check(
            [e.get("name") for e in meta_g["list"].get("entries", [])] == [e.get("name") for e in meta_w["list"].get("entries", [])],
            "LIST entries differ",
        )
        check(bool(meta_g["ping"]), "PING returned nothing")
        for (name, g, secs, path), (_n2, w, secs_np, _p2) in zip(got[1:], want[1:]):
            check(g.schema.to_json() == w.schema.to_json(), f"{name}: schemas differ")
            check(g.num_rows == w.num_rows and g.num_rows > 0, f"{name}: {g.num_rows} rows vs {w.num_rows}")
            gb, wb = _column_bytes(g), _column_bytes(w)
            for col in gb:
                check(gb[col] == wb[col], f"{name}: column {col} is not byte-identical to the numpy server's")
            if "fused" in name:
                check(path["fused_kernel_launches"] > 0 and path["fused_launches"] > 0,
                      f"{name}: the planner did not fuse it ({path})")
                check(path["transfers_overlapped"] > 0, f"{name}: no morsel was staged ({path})")
            else:
                check(path["fused_kernel_launches"] == 0, f"{name}: left the per-op path ({path})")
            report.append(
                {
                    "request": name,
                    "rows_out": g.num_rows,
                    "torch_s": secs,
                    "numpy_s": secs_np,
                    "torch_rows_per_s": rows / secs,
                    "numpy_rows_per_s": rows / secs_np,
                    **path,
                }
            )
        for i in (2, 5):
            check(got[i][1].num_rows == STATIONS, f"{got[i][0]} has {got[i][1].num_rows} groups, expected {STATIONS}")
        check(breakdowns[1]["fused_launches"] > 0 and breakdowns[1]["transfers_overlapped"] > 0,
              f"the profiled fused COOK did not stage through the fused kernel: {breakdowns[1]}")
        return report, launches, breakdowns
    finally:
        for s in servers:
            s.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4: serve granite-3-8b at full width from DACP prompts
# ---------------------------------------------------------------------------
SERVE_ARCH = "granite-3-8b"
# kernel path against plain path, max |Δ logits| over max |logits|: each of
# the 40 layers rounds its attention output (and p) to bfloat16 (8 bits of
# mantissa, 3.9e-3) at other places on the two paths; taken as independent,
# about sqrt(2 · 40) of those roundings add up, 3.5e-2
SERVE_LOGIT_TOL = 5e-2


def _rel_err(a, b, vocab: int) -> float:
    """max |a - b| over max |b|, on the real vocabulary (the padded tail
    holds the -1e9 mask on both paths)."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    return float((a - b).abs().max() / b.abs().max())


def dacp_serving_prompts(seed: int = SEED) -> tuple:
    """(SERVE_BATCH × SERVE_PROMPT int32 prompts, seconds): a port
    ``FairdServer`` over TCP tokenizes a seeded corpus in place
    (``training_dag``) and the client reads the token blobs."""
    import repro_torch.data  # noqa: F401  registers tokenize_and_pack for the server in this process
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.data import write_token_corpus
    from repro_torch.launch.serve import dacp_prompts
    from repro_torch.server import FairdServer

    import socket

    tmp = tempfile.mkdtemp(prefix="dacp_serve_")
    server = None
    try:
        write_token_corpus(os.path.join(tmp, "prompts.jsonl"), docs=SERVE_BATCH, seed=seed)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        server = FairdServer(f"127.0.0.1:{port}", executor=ExecutorConfig(device="cuda"))
        server.catalog.register_path("prompts", tmp)
        server.serve_tcp(port=port)
        t0 = time.perf_counter()
        prompts = dacp_prompts(f"dacp://127.0.0.1:{port}/prompts/prompts.jsonl", SERVE_BATCH, SERVE_PROMPT)
        cook_s = time.perf_counter() - t0
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    check(prompts.shape == (SERVE_BATCH, SERVE_PROMPT), f"prompt COOK gave {prompts.shape}")
    check(int(prompts.min()) >= 0 and int(prompts.max()) <= 258, "prompt ids outside the byte tokenizer's 0-258")
    return prompts, cook_s


def _cache_index(cache) -> int:
    return int((cache["kv"] if "kv" in cache else cache)["index"])


def serve_model(dev, counters, arch: str, width: tuple, width_of, expected: dict, logit_tol: float,
                reordered=None, diagnose=None) -> tuple:
    """Serve ``arch`` at full width from DACP prompts (an encoder-decoder
    also takes seeded stub frames): check ``width_of(cfg)
    == width``, prefill SERVE_BATCH × SERVE_PROMPT tokens and greedily decode
    SERVE_NEW, with ``counters`` (the kernel launch counters) zeroed right
    before the served prefill + decode and read right after it; each kernel
    in ``expected`` must have launched exactly that often and every other
    kernel never.  Then hold the kernel path's prefill logits and 4
    teacher-forced decode steps to the plain path's (same weights, same
    tokens) within ``logit_tol`` of max |logit|, and profile a prefill and
    a decode step.  With ``reordered`` — a kernel bundle that computes the
    plain path's function with its float32 sums in another order — the
    limit is at least twice the plain path's own difference from that
    bundle's: a model that amplifies rounding (bfloat16 activations, random
    weights) moves its logits that far under a mere reordering.  With
    ``diagnose(kernel api, plain api, params, batch)``, its dict of numbers
    joins the report, printed and not gated on.  Returns (report, the
    served run's launch counts)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import build

    prompts, cook_s = dacp_serving_prompts()
    cfg = get_config(arch)
    check(width_of(cfg) == width, f"{arch} is not at full width: {width_of(cfg)} != {width}")
    kern, plain = build(cfg), build(cfg, ops.PLAIN)
    t0 = time.perf_counter()
    params = kern.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.from_numpy(prompts).to(dev)
    frames = None
    if cfg.is_encdec:  # the stub frontend's frame embeddings, as the launcher draws them
        frames_np = np.random.default_rng(SEED).normal(size=(SERVE_BATCH, cfg.enc_seq, cfg.d_model))
        frames = torch.from_numpy(frames_np.astype(np.float32)).to(dev)
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    greedy_generate(kern, params, tokens[:, :64], 2, frames)  # warm-up: cuBLAS handles, allocator pools
    max_seq = SERVE_PROMPT + SERVE_NEW

    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    out = greedy_generate(kern, params, tokens, SERVE_NEW, frames)
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {name: expected.get(name, 0) for name in launches}
    check(launches == want, f"{arch}: the served run made launches {launches}, expected {want}")
    check(out["ids"].shape == (SERVE_BATCH, SERVE_NEW + 1), f"ids {out['ids'].shape}")
    check(bool(torch.isfinite(out["prefill_logits"].float()).all()), f"{arch}: non-finite prefill logits")
    check(_cache_index(out["cache"]) == max_seq, f"{arch}: cache index {_cache_index(out['cache'])}")
    del out["cache"]

    # the kernel path against the plain path: same weights, same tokens
    ids = torch.from_numpy(out["ids"]).to(dev, torch.int32)
    errs, agree = _compare_paths(kern, plain, params, batch, ids, cfg.vocab_size)
    spread = None
    if reordered is not None:
        spread, _ = _compare_paths(build(cfg, reordered), plain, params, batch, ids, cfg.vocab_size)
        logit_tol = max(logit_tol, 2 * max(spread))
    diagnosis = {} if diagnose is None else diagnose(kern, plain, params, batch)
    log(f"{arch}: kernel path against plain path {errs} of max |logit| (limit {logit_tol}), reordered plain "
        f"path {spread}; " + json.dumps(diagnosis))
    check(max(errs) <= logit_tol,
          f"{arch}: kernel-path logits differ from the plain path's by {max(errs)} of max |logit| (limit {logit_tol})")

    # where the time goes: one prefill and one decode step under the profiler
    host_p, host_d = {}, {}
    prof_prefill, wall_p = _device_times(lambda: kern.prefill(params, batch, max_seq), host_p)
    cache = kern.prefill(params, batch, max_seq)[1]
    prof_decode, wall_d = _device_times(lambda: kern.decode_step(params, ids[:, :1], cache), host_d)
    del cache, params, batch, frames
    torch.cuda.empty_cache()

    def split(times, wall, host):
        total = sum(times.values()) / 1e3
        ours = sum(v for k, v in times.items() if any(n in k for n in _OUR_KERNELS)) / 1e3
        by_kernel = {n: sum(v for k, v in times.items() if n in k) / 1e3 for n in _OUR_KERNELS}
        return {"wall_ms": wall * 1e3, "device_ms": total, "port_kernels_ms": ours,
                "port_kernels_by_name_ms": {n: v for n, v in by_kernel.items() if v},
                "device_busy_share": total / (wall * 1e3),
                "top": sorted(((round(v / 1e3, 3), k[:70]) for k, v in times.items()), reverse=True)[:6],
                "host_self_ms": sum(host.values()) / 1e3,
                "host_top": sorted(((round(v / 1e3, 3), k[:50]) for k, v in host.items()), reverse=True)[:10]}

    new_tok = SERVE_BATCH * SERVE_NEW
    return {
        "arch": arch,
        "params": n_params,
        "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT,
        "new_tokens": SERVE_NEW,
        "prompt_cook_s": cook_s,
        "init_s": init_s,
        "prefill_ms": out["prefill_s"] * 1e3,
        "decode_ms_per_token": out["decode_s"] / SERVE_NEW * 1e3,
        "decode_tokens_per_s": new_tok / out["decode_s"],
        "output_tokens_per_s": new_tok / (out["prefill_s"] + out["decode_s"]),
        "peak_memory_gb": peak / 1e9,
        "launches": {k: v for k, v in launches.items() if v},
        "logit_rel_err": errs,
        "logit_rel_tol": logit_tol,
        "plain_reordered_rel_err": spread,
        "argmax_agreement": agree,
        **diagnosis,
        "first_ids": out["ids"][:, :8].tolist(),
        "profile_prefill": split(prof_prefill, wall_p, host_p),
        "profile_decode_step": split(prof_decode, wall_d, host_d),
    }, launches


def _compare_paths(api_a, api_b, params, batch, ids, vocab: int) -> tuple:
    """([max |Δ logits| / max |logits| of the prefill and of 4
    teacher-forced decode steps], [argmax agreement of each]) of two builds
    of one model on the same weights and inputs."""
    max_seq = SERVE_PROMPT + SERVE_NEW
    a_logits, a_cache = api_a.prefill(params, batch, max_seq)
    b_logits, b_cache = api_b.prefill(params, batch, max_seq)
    errs = [_rel_err(a_logits, b_logits, vocab)]
    agree = [(a_logits.argmax(-1) == b_logits.argmax(-1)).float().mean().item()]
    for i in range(4):  # teacher-forced: both paths take the served greedy ids
        a_logits, a_cache = api_a.decode_step(params, ids[:, i : i + 1], a_cache)
        b_logits, b_cache = api_b.decode_step(params, ids[:, i : i + 1], b_cache)
        errs.append(_rel_err(a_logits, b_logits, vocab))
        agree.append((a_logits.argmax(-1) == b_logits.argmax(-1)).float().mean().item())
    return errs, agree


def serve_lm(dev, counters) -> tuple:
    """Phase 4: granite-3-8b at full width through ``flash_attention`` (one
    launch a layer per prefill) and ``decode_attention`` (one a layer per
    token)."""
    n = 40
    return serve_model(
        dev, counters, SERVE_ARCH, (n, 4096, 32, 8, 128, "bfloat16"),
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim_, c.dtype),
        {"flash_attention": n, "decode_attention": n * SERVE_NEW}, SERVE_LOGIT_TOL,
    )


# ---------------------------------------------------------------------------
# phase 5: serve zamba2-1.2b and xlstm-125m at full width from DACP prompts
# ---------------------------------------------------------------------------
def _logit_tol(sites: int) -> float:
    """Kernel path against plain path, max |Δ logits| over max |logits|, for
    a model with ``sites`` layers whose kernel output is rounded to bfloat16
    (8 bits of mantissa, 2^-8) at other places on the two paths: taken as
    independent, about sqrt(2 · sites) of those roundings add up; the limit
    keeps phase 4's margin of 1.4 over that (granite: 40 sites, 4.9e-2)."""
    return 1.4 * (2 * sites) ** 0.5 * 2.0**-8


def serve_hybrids(dev, counters):
    """Phase 5: yields (report, launch counts) for zamba2-1.2b (38 Mamba2 blocks
    through ``ssd_scan``, the shared attention block after every 6th through
    ``flash_attention`` / ``decode_attention``) and xlstm-125m (11 mLSTM
    blocks through ``mlstm_chunk``, one sLSTM block in PyTorch)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_plain

    n_z, every = 38, 6
    n_attn = n_z // every
    yield serve_model(
        dev, counters, "zamba2-1.2b", (n_z, 2048, 64, 64, 2, every, 32, 32, "bfloat16"),
        lambda c: (c.n_layers, c.d_model, c.ssm.d_state, c.ssm.head_dim, c.ssm.expand, c.attn_every, c.n_heads,
                   c.n_kv_heads, c.dtype),
        {"ssd_scan": n_z, "flash_attention": n_attn, "decode_attention": n_attn * SERVE_NEW},
        _logit_tol(n_z + n_attn),
    )
    n_x, s_every = 12, 8
    n_m = n_x - n_x // s_every
    # the plain mLSTM with 128-row chunks: the same function, its sums in another order
    reordered = dataclasses.replace(
        ops.PLAIN, mlstm_chunk=lambda q, k, v, li, lf, chunk: mlstm_chunk_plain(q, k, v, li, lf, chunk // 2)
    )
    yield serve_model(
        dev, counters, "xlstm-125m", (n_x, 768, 4, s_every, "bfloat16"),
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.slstm_every, c.dtype),
        {"mlstm_chunk": n_m}, _logit_tol(n_m), reordered,
    )


# ---------------------------------------------------------------------------
# phase 6: serve moonshot-v1-16b-a3b (MoE) and whisper-small (encoder-decoder)
# ---------------------------------------------------------------------------
def _halves_attention(q, k, v, causal: bool, length: int):
    """softmax(q k^T hd^-1/2) v over keys ``< length`` (and, if ``causal``,
    at or before the query's position), q (B, KV, G, S, hd), with the keys
    in two halves: the maximum of both, each half's unnormalised p rounded
    to v's type before its PV product, the denominator and the output
    summed over the halves, then divided.  The plain versions' function
    with their float32 sums in another order and p rounded at another
    place, as an online softmax over tiles does."""
    import torch

    from repro_torch.kernels.flash_attention import NEG_INF

    s, t, hd = q.shape[3], k.shape[2], q.shape[-1]
    halves = ((0, t // 2), (t // 2, t))
    scores = []
    for lo, hi in halves:
        sc = torch.einsum("bngsh,bnth->bngst", q.float(), k[:, :, lo:hi].float()) * hd**-0.5
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        drop = kpos >= length
        if causal:
            drop = drop | (torch.arange(s, device=q.device)[:, None] < kpos)
        scores.append(sc.masked_fill(drop, NEG_INF))
    m = torch.maximum(*(sc.amax(-1, keepdim=True) for sc in scores))
    denom, acc = 0.0, 0.0
    for sc, (lo, hi) in zip(scores, halves):
        p = torch.exp(sc - m)
        denom = denom + p.sum(-1, keepdim=True)
        acc = acc + torch.einsum("bngst,bnth->bngsh", p.to(v.dtype).float(), v[:, :, lo:hi].float())
    return (acc / denom).to(q.dtype)


def _halves_flash(q, k, v, causal: bool = True):
    """``flash_attention_plain``'s function, keys in two halves."""
    return _halves_attention(q, k, v, causal, k.shape[2])


def _halves_decode(q, k, v, length):
    """``decode_attention_plain``'s function, keys in two halves."""
    return _halves_attention(q[:, :, :, None], k, v, False, int(length))[:, :, :, 0]


def moe_routing(kern, plain, params, batch) -> dict:
    """The MoE layers' routing on each path's prefill: the share of (layer,
    token, slot) top-k decisions that agree between the paths, the slots
    dropped at capacity on each, and each layer's dropped share on the
    kernel path."""
    from repro_torch.models import moe

    real = moe.moe_apply

    def routed(api):
        seen = []

        def recording(p, x, cfg, act):
            _, _, gate_i = moe.route(p, x, cfg)
            _, _, keep = moe.slot_positions(gate_i, cfg.moe.n_experts, moe.scatter_capacity(x.shape[1], cfg))
            seen.append((gate_i, int((~keep).sum())))
            return real(p, x, cfg, act)

        moe.moe_apply = recording
        try:
            api.prefill(params, batch, SERVE_PROMPT + SERVE_NEW)
        finally:
            moe.moe_apply = real
        return seen

    a, b = routed(kern), routed(plain)
    same = sum(int((ga == gb).sum()) for (ga, _), (gb, _) in zip(a, b))
    slots = sum(ga.numel() for ga, _ in a)
    return {"routing_agreement": same / slots, "routed_slots": slots,
            "dropped_slots_kernel": sum(n for _, n in a), "dropped_slots_plain": sum(n for _, n in b),
            "dropped_share_by_layer": [round(n / ga.numel(), 4) for ga, n in a]}


def serve_zoo(dev, counters):
    """Phase 6: yields (report, launch counts) for moonshot-v1-16b-a3b (48
    MHA layers through ``flash_attention`` / ``decode_attention``, each with
    a 64-expert top-6 MoE FFN) and whisper-small (12 encoder layers through
    ``flash_attention(causal=False)``, 12 decoder layers with causal
    self-attention and cross-attention over the 1500-frame memory: flash
    at prefill, ``decode_attention`` with length 1500 a decode step)."""
    import dataclasses

    from repro_torch.kernels import ops

    # the plain path with its attention sums in another order: routing near a
    # tie flips under it as under the kernels, so it measures what flips cost
    reordered = dataclasses.replace(ops.PLAIN, flash_attention=_halves_flash, decode_attention=_halves_decode)
    n = 48
    yield serve_model(
        dev, counters, "moonshot-v1-16b-a3b", (n, 2048, 16, 16, 128, 64, 6, 1408, "bfloat16"),
        lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim_, c.moe.n_experts, c.moe.top_k,
                   c.moe.d_ff_expert, c.dtype),
        {"flash_attention": n, "decode_attention": n * SERVE_NEW}, _logit_tol(n), reordered, moe_routing,
    )
    n_enc, n_dec = 12, 12
    yield serve_model(
        dev, counters, "whisper-small", (n_enc, n_dec, 768, 12, 12, 64, ENC_SEQ, "bfloat16"),
        lambda c: (c.encoder_layers, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim_, c.enc_seq, c.dtype),
        {"flash_attention": n_enc + 2 * n_dec, "decode_attention": 2 * n_dec * SERVE_NEW},
        _logit_tol(n_enc + 2 * n_dec),
    )


# ---------------------------------------------------------------------------
# phase 7: train zamba2-1.2b at full width from a DACP feed
# ---------------------------------------------------------------------------
TRAIN_ARCH = "zamba2-1.2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 1024, 2, 4
TRAIN_LR = 3e-4  # warmup_cosine peak: 2 warm-up steps of 4
GRAD_TOL = {"flash_attention/bfloat16": 2e-2, "flash_attention/float32": 3e-5, "ssd_scan": SSD_TOL,
            "mlstm_chunk": MLSTM_TOL}  # the forward tolerances, on max |Δ grad| over max |grad|
PATHS_LOSS_TOL, PATHS_NORM_TOL, PATHS_COS_MIN = 1e-2, 2e-2, 0.99  # kernel path against plain path


def _grad_case(fn, plain, inputs, rng, used=None) -> float:
    """max |Δ| / max |want| over the input gradients of ``fn`` (a kernel
    wrapper on card tensors that need a gradient) against ``plain``'s, for
    the same seeded output gradients (on the outputs ``used`` picks, all
    by default); fails unless ``fn``'s outputs carry a ``grad_fn``."""
    import torch

    args = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    check(all(o.grad_fn is not None for o in outs), f"{fn}: an output on the card has no grad_fn")
    used = used or range(len(outs))
    gouts = [torch.from_numpy(rng.standard_normal(tuple(outs[i].shape)).astype(np.float32)).to(outs[i].device,
                                                                                             outs[i].dtype)
             for i in used]
    got = torch.autograd.grad([outs[i] for i in used], args, gouts, allow_unused=True)
    pouts = plain(*args)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    want = torch.autograd.grad([pouts[i] for i in used], args, gouts, allow_unused=True)
    worst = 0.0
    for g, w in zip(got, want):
        if w is None:
            check(g is None, "a kernel gradient where the plain version has none")
            continue
        check(bool(torch.isfinite(g.float()).all()), "a non-finite kernel gradient")
        worst = max(worst, float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30)))
    return worst


def check_kernel_grads(dev, rng) -> dict:
    """Phase 7a: ``flash_attention`` (bfloat16 at zamba2's and granite's
    serving shapes, float32), ``ssd_scan`` and ``mlstm_chunk`` (their
    serving shapes, bfloat16) on card tensors that need a gradient return
    outputs with a ``grad_fn`` whose input gradients hold to the plain
    version's within the forward tolerances; ``ssd_scan`` also with y alone
    used; ``decode_attention`` raises."""
    import torch

    from repro_torch.kernels import ops

    worst: dict = {}

    def case(key, fn, plain, inputs, used=None):
        err = _grad_case(fn, plain, inputs, rng, used)
        worst[key] = max(worst.get(key, 0.0), err)

    for label, b, kv, g, s, hd, dtype in (("zamba2", SERVE_BATCH, 32, 1, SERVE_PROMPT, 64, torch.bfloat16),
                                         ("granite", SERVE_BATCH, 8, 4, SERVE_PROMPT, 128, torch.bfloat16),
                                         ("f32", 2, 2, 2, 200, 64, torch.float32)):
        q, k, v = _attn_inputs(rng, dev, dtype, (b, kv, g, s, hd), (b, kv, s, hd), (b, kv, s, hd))
        case(f"flash_attention/{str(dtype)[6:]}", ops.flash_attention, ops.flash_attention_plain, (q, k, v))
    b, s, h, p, n = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ, 64, 64, 64  # zamba2's training microbatch, one layer
    x, B, C = _attn_inputs(rng, dev, torch.bfloat16, (b, s, h, p), (b, s, n), (b, s, n))
    dt = torch.from_numpy((np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)).to(dev)
    A = torch.from_numpy(-np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)).to(dev)
    for used in (None, (0,)):
        case("ssd_scan", ops.ssd_scan, ops.ssd_scan_plain, (x, dt, A, B, C), used)
    b, s, h, d = SERVE_BATCH, SERVE_PROMPT, 4, 384
    q, k, v = _attn_inputs(rng, dev, torch.bfloat16, (b, s, h, d), (b, s, h, d), (b, s, h, d))
    li = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32)).to(dev)
    lf = torch.from_numpy((rng.standard_normal((b, s, h)) - 1.0).astype(np.float32)).to(dev)
    case("mlstm_chunk", ops.mlstm_chunk, ops.mlstm_chunk_plain, (q, k, v, li, lf))
    q, k, v = _attn_inputs(rng, dev, torch.bfloat16, (2, 2, 2, 64), (2, 2, 64, 64), (2, 2, 64, 64))
    try:
        ops.decode_attention(q.requires_grad_(True), k, v, 64)
        fail("decode_attention took an input that needs a gradient")
    except RuntimeError as e:
        check("decode_attention" in str(e), f"decode_attention's refusal does not name it: {e}")
    for key, err in worst.items():
        check(err <= GRAD_TOL[key], f"{key}: input gradients differ from the plain version's by {err} of max |grad| "
                                    f"(limit {GRAD_TOL[key]})")
    return {"max_rel_grad_err": worst, "limits": GRAD_TOL, "decode_attention_under_grad": "raises"}


def _train_server(corpus_dir: str):
    """A port ``FairdServer`` on the card over TCP serving ``corpus_dir``;
    returns (server, its authority)."""
    import socket

    import repro_torch.data  # noqa: F401  registers tokenize_and_pack for the server in this process
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.server import FairdServer

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    server = FairdServer(f"127.0.0.1:{port}", executor=ExecutorConfig(device="cuda"))
    server.catalog.register_path("corpus", corpus_dir)
    server.serve_tcp(port=port)
    return server, f"127.0.0.1:{port}"


def _endless_feed(client, authority: str, seq: int, batch: int, dev):
    """{tokens, labels} batches of ``batch`` × ``seq`` on ``dev``: a
    ``training_dag`` COOK tokenizes the corpus in place and ``TorchFeed``
    splits its (seq + 1)-token rows; the stream is opened again at its end."""
    from repro_torch.client.torch_adapter import TorchFeed
    from repro_torch.data import training_dag

    dag = training_dag(f"dacp://{authority}/corpus/docs.jsonl", seq_len=seq, batch_rows=batch)
    feed = TorchFeed(lambda: client.cook(dag), token_column="tokens", seq_len=seq + 1, global_batch=batch, device=dev)
    while True:
        yield from feed


def _profile_step(fn) -> dict:
    """One call of ``fn`` (a training step) under the profiler: wall and
    device ms, the device busy share, the top device kernels, the port's
    kernels by name, and the device time under the plain backwards
    (``PlainBackwardBackward`` nodes: the plain versions' forward and
    backward run in the kernels' backward)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device: dict = {}
    plain_bwd = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            device[e.key] = device.get(e.key, 0.0) + float(us if us is not None else e.self_cuda_time_total)
        elif "PlainBackwardBackward" in e.key:  # the node and its engine frame hold the same kernels: take one
            us = getattr(e, "device_time_total", None)
            plain_bwd = max(plain_bwd, float(us if us is not None else e.cuda_time_total))
    total = sum(device.values()) / 1e3
    return {
        "wall_ms": wall * 1e3,
        "device_ms": total,
        "device_busy_share": total / (wall * 1e3),
        "plain_backward_device_ms": plain_bwd / 1e3,
        "plain_backward_share": plain_bwd / 1e3 / total if total else None,
        "port_kernels_by_name_ms": {n: sum(v for k, v in device.items() if n in k) / 1e3 for n in _OUR_KERNELS
                                    if any(n in k for k in device)},
        "top": sorted(((round(v / 1e3, 3), k[:70]) for k, v in device.items()), reverse=True)[:10],
    }


def _bits(t) -> bytes:
    from repro_torch.checkpoint.manager import to_host

    return to_host(t).tobytes()


def train_full_width(dev, counters, card: str) -> dict:
    """Phase 7b-d: zamba2-1.2b at full width (bfloat16, remat ``full``)
    trains TRAIN_STEPS steps of TRAIN_BATCH × TRAIN_SEQ tokens from a DACP
    feed (``Trainer``: TRAIN_MICRO microbatches, int8 gradient compression,
    ``warmup_cosine``), with ``counters`` zeroed right before each step and
    read right after it: under remat each Mamba2 block's forward runs twice,
    so a step launches exactly TRAIN_MICRO × 2 × 38 ``ssd_scan`` and
    TRAIN_MICRO × 6 ``flash_attention`` (the shared block is not
    recomputed; the backward launches none); the losses and grad norms must
    be finite and the loss on step 1's batch after the last step below step
    1's.  Then one profiled step; one loss + backward through the kernels
    against one through the plain versions on the same weights and batch;
    and a bfloat16 checkpoint round trip of reduced zamba2 (2 steps,
    ``save_async`` + ``wait``, a new ``Trainer`` resumes bit for bit and
    takes a third step)."""
    import dataclasses

    import torch

    from repro_torch.client import TcpNetwork
    from repro_torch.configs import get_config
    from repro_torch.data import write_token_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.optim.accumulate import value_and_grad
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    width = (cfg.n_layers, cfg.d_model, cfg.ssm.d_state, cfg.ssm.head_dim, cfg.attn_every, cfg.n_heads, cfg.dtype,
             cfg.param_dtype, cfg.remat, cfg.remat_policy)
    check(width == (38, 2048, 64, 64, 6, 32, "bfloat16", "bfloat16", True, "full"),
          f"{TRAIN_ARCH} is not at full width with bf16 and full remat: {width}")
    n_mamba, n_attn = cfg.n_layers, cfg.n_layers // cfg.attn_every
    expected = {"ssd_scan": TRAIN_MICRO * 2 * n_mamba, "flash_attention": TRAIN_MICRO * n_attn}
    tmp = tempfile.mkdtemp(prefix="dacp_train_")
    server, net = None, TcpNetwork()
    try:
        write_token_corpus(os.path.join(tmp, "docs.jsonl"), docs=TRAIN_STEPS * TRAIN_BATCH, seed=SEED)
        server, authority = _train_server(tmp)
        client = net.client_for(authority)
        stream = _endless_feed(client, authority, TRAIN_SEQ, TRAIN_BATCH, dev)
        first: list = []

        def batches():
            for b in stream:
                if not first:
                    first.append(b)
                yield b

        it = batches()
        optim_cfg = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 2, TRAIN_STEPS))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, lambda: it, optim_cfg, n_micro=TRAIN_MICRO, compress_grads=True, seed=SEED,
                          log_every=1, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(trainer.state["params"]))
        torch.cuda.reset_peak_memory_stats(dev)
        steps = []
        for _ in range(TRAIN_STEPS):
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run(1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {name: c.value for name, c in counters.items()}
            m = trainer.metrics_log[-1]
            row = {"step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"], "lr": m["lr"], "step_ms": ms,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
                   "launches": {k: v for k, v in launches.items() if v}}
            log(f"train {TRAIN_ARCH} step {row['step']}: " + json.dumps(row) + f" on {card}")
            steps.append(row)
            want = {name: expected.get(name, 0) for name in launches}
            check(launches == want, f"train step {row['step']} made launches {launches}, expected {want}")
            check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                  f"train step {row['step']}: loss {m['loss']}, grad norm {m['grad_norm']}")
        peak = torch.cuda.max_memory_allocated(dev)
        kern, plain = build(cfg), build(cfg, ops.PLAIN)
        params = trainer.state["params"]
        with torch.no_grad():
            after = float(kern.loss_fn(params, first[0])[0])
        check(after < steps[0]["loss"], f"the loss on step 1's batch after {TRAIN_STEPS} steps is {after}, step 1's "
                                        f"{steps[0]['loss']}")
        profile = _profile_step(lambda: trainer.run(1))
        # the profiler's own host work stretches the profiled step: the busy
        # share of an unprofiled step reads its device time over the mean
        # step time after the first
        steady_ms = sum(r["step_ms"] for r in steps[1:]) / (len(steps) - 1)
        profile["unprofiled_step_ms"] = steady_ms
        profile["device_busy_share_unprofiled"] = profile["device_ms"] / steady_ms

        # 7c: one loss + backward through the kernels and through the plain versions
        batch = first[0]
        lk, _, gk = value_and_grad(kern.loss_fn, params, batch)
        lp, _, gp = value_and_grad(plain.loss_fn, params, batch)
        gk, gp = tree_leaves(gk), tree_leaves(gp)
        del trainer, params
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        norm_k = torch.sqrt(sum((g.float() ** 2).sum() for g in gk))
        norm_p = torch.sqrt(sum((g.float() ** 2).sum() for g in gp))
        norm_rel = float((norm_k - norm_p).abs() / norm_p)
        leaf_norms = [float(g.float().norm()) for g in gp]
        big = max(leaf_norms)
        cos = [float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0))
               for a, b, nrm in zip(gk, gp, leaf_norms) if nrm > 1e-3 * big]
        del gk, gp
        paths = {"loss_kernel": float(lk), "loss_plain": float(lp), "loss_rel_err": loss_rel,
                 "grad_norm_kernel": float(norm_k), "grad_norm_plain": float(norm_p), "grad_norm_rel_err": norm_rel,
                 "leaves_compared": len(cos), "min_leaf_cosine": min(cos),
                 "limits": {"loss": PATHS_LOSS_TOL, "grad_norm": PATHS_NORM_TOL, "cosine": PATHS_COS_MIN}}
        log("train kernel path against plain path: " + json.dumps(paths) + f" on {card}")
        check(loss_rel <= PATHS_LOSS_TOL and norm_rel <= PATHS_NORM_TOL and min(cos) >= PATHS_COS_MIN,
              f"kernel-path loss and gradients differ from the plain path's: {paths}")
        torch.cuda.empty_cache()

        # 7d: a bfloat16 checkpoint of reduced zamba2 resumes bit for bit
        small = dataclasses.replace(cfg.reduced(), param_dtype="bfloat16", dtype="bfloat16")
        small_it = _endless_feed(client, authority, 64, TRAIN_BATCH, dev)
        ckdir = os.path.join(tmp, "ckpt")

        def small_trainer():
            return Trainer(small, lambda: small_it, optim_cfg, ckpt_dir=ckdir, ckpt_every=2, n_micro=TRAIN_MICRO,
                           compress_grads=True, seed=SEED, log_every=1, device=dev)

        first_run = small_trainer()
        first_run.run(2)  # save_async at step 2, then the final save (already durable) and wait
        saved = {k: [_bits(t) for t in tree_leaves(v)] for k, v in first_run.state.items()}
        resumed = small_trainer()
        check(resumed.step == 2, f"the resumed trainer starts at step {resumed.step}, not 2")
        same = {k: saved[k] == [_bits(t) for t in tree_leaves(v)] for k, v in resumed.state.items()}
        check(set(same) == {"params", "opt", "err"} and all(same.values()),
              f"the resumed state differs from the saved one: {same}")
        m3 = resumed.run(1)
        check(resumed.step == 3 and math.isfinite(m3["loss"]), f"the resumed step: {m3}")
        ckpt = {"arch": f"{TRAIN_ARCH} reduced, bfloat16", "resumed_at": 2, "bitwise_equal": same,
                "step3_loss": m3["loss"], "leaves": sum(len(v) for v in saved.values())}
        log("train checkpoint round trip: " + json.dumps(ckpt) + f" on {card}")
    finally:
        net.close_all()
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "arch": TRAIN_ARCH,
        "params": n_params,
        "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ,
        "n_micro": TRAIN_MICRO,
        "compress_grads": True,
        "remat": cfg.remat_policy,
        "init_s": init_s,
        "steps": steps,
        "loss_on_step1_batch_after": after,
        "peak_memory_gb": peak / 1e9,
        "expected_launches_per_step": expected,
        "profile_step": profile,
        "kernel_vs_plain": paths,
        "checkpoint": ckpt,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 8: the distributed paths (four gloo ranks on the card, NCCL world 1,
# the dry-run on a fake 256-rank mesh)
# ---------------------------------------------------------------------------
DIST_RANKS = 4
# (label, B, KV, G, T, hd, index): zamba2-1.2b's long_500k shared attention
# (T 524288, 131072 a rank; K and V 4.3 GB) and granite-3-8b's decode at
# phase 4's shape (T 1056, 264 a rank, length 1025)
SEQ_CASES = (("zamba2 long_500k", 1, 32, 1, 524288, 64, 499_999), ("granite decode", 4, 8, 4, 1056, 128, 1024))
# the sequence-sharded decode's limit: max |err| <= SEQ_ERR_UNITS · 2^-8 · max |want| (bf16's half ulp
# at the output's peak, times a count set from the sound runs; PERF.md §6 has their readings and the
# planted faults': rank 0's shard dropped, an all-zero output)
SEQ_ERR_UNITS = 4
PSUM_ARCH = "granite-3-8b"  # compressed_psum over its padded_vocab × d_model embedding, float32
DRYRUN_CELLS = (("granite-3-8b", "train_4k"), ("zamba2-1.2b", "long_500k"))
# 8e: zamba2-1.2b's long_500k decode (ShapeSpec long_500k: 524288 positions, batch 1) at full width over a
# cache sharded by position, 131072 positions a rank; at index 499996 rank 3 holds 106781 valid positions
LONG_ARCH = "zamba2-1.2b"
LONG_T = 524288
LONG_INDEX = 499_996
LONG_STEPS = 4


def _seq_shard(case: int, rank: int, shape: tuple, dev):
    """Rank ``rank``'s k and v slice of SEQ_CASES[case] (bfloat16 from a
    seeded generator on the card; the whole cache is the ranks' slices in
    order), and the query every rank holds."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 100 * case + rank)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return k, v


def _seq_query(case: int, shape: tuple, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 100 * case + 99)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)


def _long_kv(site: int, rank: int, shape: tuple, dev):
    """Rank ``rank``'s slice of shared-attention site ``site``'s k and v in
    8e's cache (bfloat16 from a seeded generator on the card; the whole
    cache is the ranks' slices in order)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + 10 * site + rank)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return k, v


def _long_tokens(cfg):
    """8e's teacher-forced tokens: (1, LONG_STEPS) int32, seeded."""
    return np.random.default_rng(SEED + 5).integers(0, cfg.vocab_size, (1, LONG_STEPS)).astype(np.int32)


def _recording(kernels, partials_plain: list | None = None):
    """``kernels`` whose ``decode_attention`` keeps each call's query and
    output (as float32 on the host), in ``seen``; with ``partials_plain``,
    the bundle's ``decode_attention_partials`` first, which records whether
    each call ran the plain version (``runs_plain``) there."""
    import dataclasses

    from repro_torch.distributed.per_shard import is_dtensor, on_shards
    from repro_torch.kernels import _build

    if partials_plain is not None:
        inner = kernels.decode_attention_partials

        def partials(q, k, v, length):
            partials_plain.append(_build.runs_plain(q))
            return inner(q, k, v, length)

        kernels = on_shards(dataclasses.replace(kernels, decode_attention_partials=partials))
    seen: list = []
    decode = kernels.decode_attention

    def recorded(q, k, v, length):
        out = decode(q, k, v, length)
        local = (lambda t: t.to_local() if is_dtensor(t) else t)
        seen.append((local(q).detach(), local(out).float().cpu()))
        return out

    return dataclasses.replace(kernels, decode_attention=recorded), seen


def _long_decode_rank(rank: int, mesh, dev) -> dict:
    """8e on one rank: zamba2-1.2b at full width (random bfloat16 weights
    from a seeded generator, the same on every rank, replicated) decodes
    LONG_STEPS teacher-forced tokens through ``lm.decode_step`` with
    ``on_shards(KERNELS)`` over its cache laid out by
    ``decode_cache_axes(long_context=True)``: this rank's slice of the
    positions of the six sites' k and v, drawn by ``_long_kv``.  The launch
    counters are zeroed right before the steps and read right after."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import shard_tree, sharding_for, use_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import build, lm
    from repro_torch.models.ssm import make_ssm_cache

    cfg = get_config(LONG_ARCH)
    sites = cfg.n_layers // cfg.attn_every
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    t_local = LONG_T // DIST_RANKS
    torch.cuda.reset_peak_memory_stats(dev)
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    axes = api.decode_cache_axes(True)
    whole = (sites, 1, kv, LONG_T, hd)
    with use_mesh(mesh), implicit_replication(), torch.no_grad():
        placements = sharding_for(axes["kv"]["k"], whole)
        check(placements == (Shard(3),), f"8e: the long cache is laid out {placements}, not by position")
        cache_kv = {}
        for j, name in enumerate(("k", "v")):
            local = torch.empty((sites, 1, kv, t_local, hd), dtype=torch.bfloat16, device=dev)
            for site in range(sites):
                local[site].copy_(_long_kv(site, rank, (1, kv, t_local, hd), dev)[j])
            stride = torch.empty(whole, device="meta").stride()
            cache_kv[name] = DTensor.from_local(local, mesh, placements, run_check=False, shape=whole, stride=stride)
        ssm = shard_tree(make_ssm_cache(cfg, 1, cfg.n_layers, torch.bfloat16, dev), axes["ssm"])
        cache = {"ssm": ssm, "kv": dict(cache_kv, index=LONG_INDEX)}
        torch.cuda.synchronize()
        plain_calls: list = []
        kernels, seen = _recording(ops.KERNELS, plain_calls)
        tokens = torch.from_numpy(_long_tokens(cfg)).to(dev)
        for c in ops.LAUNCHES.values():
            c.reset()
        logits, walls = [], []
        for i in range(LONG_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            step, cache = lm.decode_step(params, tokens[:, i : i + 1], cache, cfg, kernels)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            logits.append((step.to_local() if isinstance(step, DTensor) else step).float().cpu())
        launches = {name: c.value for name, c in ops.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        # the rows the steps wrote that this rank holds, for the reference's cache as the ranks saw it
        start = rank * t_local
        rows = {p: tuple(cache["kv"][n].to_local()[:, :, :, p - start].cpu() for n in ("k", "v"))
                for p in range(LONG_INDEX, LONG_INDEX + LONG_STEPS) if start <= p < start + t_local}
        # a planted fault for the limit: site 0 of step 0 with rank 0's partials replaced by an empty slice's
        q0 = seen[0][0]
        k0, v0 = cache["kv"]["k"].to_local()[0], cache["kv"]["v"].to_local()[0]

        def dropped(q, k, v, n):
            return ops.decode_attention_partials(q, k, v, 0 if rank == 0 else n)

        fault = collectives.seq_sharded_decode_attention(mesh, q0, k0, v0, LONG_INDEX, seq_axis="data",
                                                         partials=dropped).float().cpu()
        # each rank's partials launch at its slice, one rank on the card at a time
        valid = min(max(LONG_INDEX + 1 - rank * t_local, 0), t_local)
        partial_ms = None
        for r in range(DIST_RANKS):
            dist.barrier()
            if r == rank:
                partial_ms = _kernel_device_ms(lambda: ops.decode_attention_partials(q0, k0, v0, valid))
    nbytes = 2 * 2 * kv * valid * hd + 2 * q0.numel() + 4 * kv * (2 + hd)  # k, v below valid; q; m, l, acc
    return {"logits": torch.stack(logits), "sites": [out for _, out in seen], "queries": [q.cpu() for q, _ in seen],
            "rows": rows, "fault": fault, "wall_ms": walls,
            "launches": {k: v for k, v in launches.items() if v}, "partials_ran_plain": sum(plain_calls),
            "partials_calls": len(plain_calls), "peak_memory_gb": peak / 1e9, "valid": valid,
            "partials_ms": partial_ms, "partials_bound_ms": _bytes_bound_ms(nbytes),
            "all_reduce_bytes_per_site": 4 * 1 * kv * (cfg.n_heads // kv) * (2 + hd)}


def _long_decode_reference(dev, queries: list, rows: dict) -> dict:
    """8e's reference: the same weights, tokens and cache, whole, on one
    process; LONG_STEPS steps through ``lm.decode_step`` with ``KERNELS``
    (one ``decode_attention`` launch a site a step), the counters zeroed
    right before the steps and read right after, for the logits.  Then, for
    each site of each step, one ``decode_attention`` launch over the whole
    cache on the ranks' inputs: ``queries`` (the ranks' query of each call)
    over the cache with ``rows`` ({position: (k, v)} the ranks' steps
    wrote)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build, lm

    cfg = get_config(LONG_ARCH)
    sites = cfg.n_layers // cfg.attn_every
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    t_local = LONG_T // DIST_RANKS
    torch.cuda.reset_peak_memory_stats(dev)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    cache = lm.make_decode_cache(cfg, 1, LONG_T, torch.bfloat16, dev)
    for site in range(sites):
        for r in range(DIST_RANKS):
            k, v = _long_kv(site, r, (1, kv, t_local, hd), dev)
            cache["kv"]["k"][site, :, :, r * t_local : (r + 1) * t_local].copy_(k)
            cache["kv"]["v"][site, :, :, r * t_local : (r + 1) * t_local].copy_(v)
    cache["kv"]["index"] = LONG_INDEX
    tokens = torch.from_numpy(_long_tokens(cfg)).to(dev)
    logits = []
    with torch.no_grad():
        torch.cuda.synchronize()
        for c in ops.LAUNCHES.values():
            c.reset()
        walls = []
        for i in range(LONG_STEPS):
            t0 = time.perf_counter()
            step, cache = lm.decode_step(params, tokens[:, i : i + 1], cache, cfg, ops.KERNELS)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            logits.append(step.float().cpu())
        launches = {name: c.value for name, c in ops.LAUNCHES.items() if c.value}
        # each site of each step on the ranks' own inputs: their query, and the cache as they saw it (the
        # rows their steps wrote; later positions are past the length)
        for p, (k_row, v_row) in rows.items():
            cache["kv"]["k"][:, :, :, p].copy_(k_row)
            cache["kv"]["v"][:, :, :, p].copy_(v_row)
        same_input = [
            ops.decode_attention(q.to(dev), cache["kv"]["k"][j % sites], cache["kv"]["v"][j % sites],
                                 LONG_INDEX + j // sites + 1).float().cpu()
            for j, q in enumerate(queries)
        ]
    peak = torch.cuda.max_memory_allocated(dev)
    del cache, params
    torch.cuda.empty_cache()
    return {"logits": torch.stack(logits), "sites": same_input, "launches": launches, "wall_ms": walls,
            "peak_memory_gb": peak / 1e9, "vocab": cfg.vocab_size, "sites_per_step": sites,
            "logit_tol": _logit_tol(cfg.n_layers + sites)}


def _dist_rank(rank: int, port: int, out_dir: str) -> None:
    """One of DIST_RANKS gloo ranks on the one card: 8a each SEQ_CASES decode
    sharded over the ranks, 8b ``compressed_psum`` of a full-width embedding
    on the card and on the CPU; rank 0 writes the results to ``out_dir``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import compressed_psum, seq_sharded_decode_attention

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=DIST_RANKS)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        mesh = init_device_mesh("cuda", (DIST_RANKS,), mesh_dim_names=("data",))
        out: dict = {"seq": []}
        for case, (label, b, kv, g, t, hd, index) in enumerate(SEQ_CASES):
            k, v = _seq_shard(case, rank, (b, kv, t // DIST_RANKS, hd), dev)
            q = _seq_query(case, (b, kv, g, hd), dev)
            walls = []
            for _ in range(3):  # the first call warms up; the last one's output is kept
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                got = seq_sharded_decode_attention(mesh, q, k, v, index, seq_axis="data")
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            reduced = 4 * b * kv * g * (2 + hd)  # m and l (B, KV, G, 1) and acc (B, KV, G, hd), float32
            # a planted fault for the limit: rank 0 attends to no position, so its shard drops out
            dropped = seq_sharded_decode_attention(mesh, q, k, v, -1 if rank == 0 else index, seq_axis="data")
            out["seq"].append({"label": label, "wall_ms": walls, "all_reduce_bytes_per_rank": reduced,
                               "out": got.float().cpu(), "dropped": dropped.float().cpu()})
            del k, v
        cfg = get_config(PSUM_ARCH)
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + rank)
        x = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        on_card = compressed_psum(mesh, x, axis="data")
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        x_cpu = x.cpu()
        dist.barrier()
        t0 = time.perf_counter()
        on_cpu = compressed_psum(mesh, x_cpu, axis="data")  # the same gloo ranks, CPU tensors
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(on_card.cpu().view(torch.int32), on_cpu.view(torch.int32))
        flags = torch.tensor([int(same)], dtype=torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        out["psum"] = {"shape": list(x.shape), "bytes_per_rank": x.numel() * 4, "card_ms": card_ms,
                       "cpu_ms": cpu_ms, "bit_exact_on_every_rank": bool(flags.item()),
                       "max_abs": float(on_cpu.abs().max())}
        del x, x_cpu, on_card, on_cpu
        torch.cuda.empty_cache()
        long = _long_decode_rank(rank, mesh, dev)  # 8e
        gathered = [None] * DIST_RANKS
        dist.all_gather_object(gathered, {k: v for k, v in long.items()
                                          if k not in ("sites", "queries", "logits", "fault")})
        out["long"] = dict(long, ranks=gathered)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "ranks.pt"))
    finally:
        dist.destroy_process_group()


def distributed_paths(dev, card: str) -> dict:
    """Phase 8.  (8d) starts the dry-run of DRYRUN_CELLS on the single
    production mesh (256 fake ranks, meta tensors: host work) in
    subprocesses; (8a, 8b) DIST_RANKS gloo ranks on the card run
    ``seq_sharded_decode_attention`` at SEQ_CASES, each held to one
    ``decode_attention`` launch over the whole cache within SEQ_ERR_UNITS
    half ulps of bf16 at the output's peak (and the limit held to refuse
    two planted faults), and ``compressed_psum`` of PSUM_ARCH's embedding,
    bit for bit against the same call on CPU tensors; (8c)
    ``TorchFeed(mesh=make_smoke_mesh())`` (NCCL, world 1) gives phase 7's
    feed's batches; then the dry-run's records are read."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import ops

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    dry_dir = tempfile.mkdtemp(prefix="dacp_dryrun_")  # a directory of its own: a user's records stay as they are
    dry = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                             "--mesh", "single", "--out", dry_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True) for arch, shape in DRYRUN_CELLS]
    report: dict = {"card": card}
    tmp = tempfile.mkdtemp(prefix="dacp_dist_")
    try:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        t0 = time.perf_counter()
        mp.start_processes(_dist_rank, args=(port, tmp), nprocs=DIST_RANKS, start_method="spawn")
        report["ranks_s"] = time.perf_counter() - t0
        ranks = torch.load(os.path.join(tmp, "ranks.pt"))
        seq = []
        for case, (label, b, kv, g, t, hd, index) in enumerate(SEQ_CASES):
            shards = [_seq_shard(case, r, (b, kv, t // DIST_RANKS, hd), dev) for r in range(DIST_RANKS)]
            k = torch.cat([s[0] for s in shards], dim=2)
            v = torch.cat([s[1] for s in shards], dim=2)
            del shards
            q = _seq_query(case, (b, kv, g, hd), dev)
            before = ops.LAUNCHES["decode_attention"].value
            with torch.no_grad():
                want = ops.decode_attention(q, k, v, index + 1).float().cpu()
            launched = ops.LAUNCHES["decode_attention"].value - before
            check(launched == 1, f"{label}: the whole-cache reference launched decode_attention {launched} times")
            got = ranks["seq"][case]["out"]
            peak = float(want.abs().max())
            unit = 2.0**-8 * peak  # half an ulp of bf16 at the output's peak
            err = float((got - want).abs().max())
            dropped = float((ranks["seq"][case]["dropped"] - want).abs().max())
            ok = peak > 0 and err <= SEQ_ERR_UNITS * unit
            seq.append({"case": label, "shape": f"B={b} KV={kv} G={g} T={t} ({t // DIST_RANKS} a rank) hd={hd} "
                        f"index={index}", "kv_bytes": 2 * k.numel() * k.element_size(),
                        "wall_ms": ranks["seq"][case]["wall_ms"],
                        "all_reduce_bytes_per_rank": ranks["seq"][case]["all_reduce_bytes_per_rank"],
                        "max_abs_err": err, "max_abs_want": peak, "limit": SEQ_ERR_UNITS * unit,
                        "units": {"sound": err / unit if unit else None, "rank 0 dropped": dropped / unit if unit
                                  else None, "zeroed": 2.0**8, "limit": SEQ_ERR_UNITS}, "agrees": ok})
            log(f"  8a {label}: max |want| {peak:.6g}, max |err| {err:.6g}; in half ulps of bf16 at the peak: "
                f"sound {err / unit if unit else float('nan'):.3f}, rank 0's shard dropped "
                f"{dropped / unit if unit else float('nan'):.3f}, zeroed 256, limit {SEQ_ERR_UNITS}")
            check(peak > 0, f"seq_sharded_decode_attention at {label}: the whole-cache output is all zero")
            check(ok, f"seq_sharded_decode_attention at {label} disagrees with decode_attention: max |err| {err}"
                  f" > {SEQ_ERR_UNITS} · 2^-8 · {peak}")
            check(dropped > SEQ_ERR_UNITS * unit, f"{label}: the limit passes a merge with rank 0's shard dropped")
            del k, v
            torch.cuda.empty_cache()
        report["seq_sharded_decode"] = seq
        report["compressed_psum"] = ranks["psum"]
        check(ranks["psum"]["bit_exact_on_every_rank"], "compressed_psum on the card differs from the CPU ranks'")
        report["long_500k_decode"] = _check_long_decode(dev, ranks["long"], card)
        report["torch_feed_mesh"] = _feed_over_mesh(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dryrun_out = [p.communicate(timeout=600) for p in dry]
    cells = []
    try:
        for (arch, shape), p, (out, err) in zip(DRYRUN_CELLS, dry, dryrun_out):
            check(p.returncode == 0, f"dry-run of {arch} {shape} failed: {err[-2000:]} {out[-2000:]}")
            with open(os.path.join(dry_dir, f"{arch}__{shape}__single.json")) as f:
                rec = json.load(f)
            check(rec["status"] == "ok", f"dry-run of {arch} {shape}: {rec.get('error')}")
            cells.append({k: rec[k] for k in ("arch", "shape", "mesh", "n_chips", "trace_s", "flops_per_device",
                                              "bytes_per_device", "collective_bytes_per_device", "collective_counts",
                                              "by_site", "roofline", "useful_flops_ratio", "memory_analysis")})
    finally:
        shutil.rmtree(dry_dir, ignore_errors=True)
    report["dryrun"] = cells
    return report


def _check_long_decode(dev, got: dict, card: str) -> dict:
    """8e's checks, after the ranks exit: the whole-cache reference
    (``_long_decode_reference``) against rank 0's run.  Every rank launched
    exactly one partials kernel a site a step and ran no plain version; the
    reference one ``decode_attention`` a site a step; each site's output of
    each step within SEQ_ERR_UNITS half ulps of bf16 at the peak of one
    ``decode_attention`` launch over the whole cache on the same inputs (a
    planted fault, rank 0's partials replaced by an empty slice's, must fall
    outside); each step's logits within phase 5's zamba2 limit of the
    whole-cache run's."""
    import torch

    torch.cuda.empty_cache()
    rows = {p: kv for rank in got["ranks"] for p, kv in rank["rows"].items()}
    check(sorted(rows) == list(range(LONG_INDEX, LONG_INDEX + LONG_STEPS)), f"8e: the ranks wrote rows {sorted(rows)}")
    want = _long_decode_reference(dev, got["queries"], rows)
    sites = want["sites_per_step"]
    check(want["launches"] == {"decode_attention": sites * LONG_STEPS},
          f"8e: the whole-cache reference made launches {want['launches']}")
    for r, rank in enumerate(got["ranks"]):
        check(rank["launches"] == {"decode_attention": sites * LONG_STEPS},
              f"8e: rank {r} made launches {rank['launches']}, expected {sites * LONG_STEPS} partials launches")
        check(rank["partials_calls"] == sites * LONG_STEPS and rank["partials_ran_plain"] == 0,
              f"8e: rank {r} made {rank['partials_calls']} partials calls, {rank['partials_ran_plain']} of them plain")
    check(len(got["sites"]) == len(want["sites"]) == sites * LONG_STEPS, "8e: site outputs missing")
    units, worst = [], 0.0
    for i, (g, w) in enumerate(zip(got["sites"], want["sites"])):
        unit = 2.0**-8 * float(w.abs().max())  # half an ulp of bf16 at the site output's peak
        check(unit > 0 and bool(torch.isfinite(g).all()), f"8e: site {i % sites} of step {i // sites} is zero or "
              "non-finite")
        units.append(float((g - w).abs().max()) / unit)
    worst = max(units)
    unit0 = 2.0**-8 * float(want["sites"][0].abs().max())
    fault = float((got["fault"] - want["sites"][0]).abs().max()) / unit0
    log(f"  8e zamba2-1.2b long_500k: site outputs in half ulps of bf16 at the peak: worst {worst:.3f} over "
        f"{len(units)}, limit {SEQ_ERR_UNITS}; rank 0's partials dropped at site 0 {fault:.3f}")
    check(worst <= SEQ_ERR_UNITS, f"8e: a site's output differs from the whole-cache launch by {worst} half ulps")
    check(fault > SEQ_ERR_UNITS, f"8e: the limit passes a merge with rank 0's partials dropped ({fault} half ulps)")
    errs = [_rel_err(g, w, want["vocab"]) for g, w in zip(got["logits"], want["logits"])]
    check(all(np.isfinite(errs)) and max(errs) <= want["logit_tol"],
          f"8e: logits differ from the whole-cache run's by {errs} of max |logit| (limit {want['logit_tol']})")
    ranks = got["ranks"]
    report = {
        "arch": LONG_ARCH, "card": card, "positions": LONG_T, "per_rank": LONG_T // DIST_RANKS,
        "index": LONG_INDEX, "steps": LONG_STEPS, "valid_per_rank": [r["valid"] for r in ranks],
        "launches_per_rank": [r["launches"] for r in ranks], "reference_launches": want["launches"],
        "site_err_half_ulps": units, "site_err_limit": SEQ_ERR_UNITS, "fault_half_ulps": fault,
        "logit_rel_err": errs, "logit_rel_tol": want["logit_tol"],
        "wall_ms_per_step": ranks[0]["wall_ms"], "warm_wall_ms_per_step": float(np.mean(ranks[0]["wall_ms"][1:])),
        "reference_wall_ms_per_step": want["wall_ms"],
        "reference_warm_wall_ms_per_step": float(np.mean(want["wall_ms"][1:])),
        "partials_ms_per_rank": [r["partials_ms"] for r in ranks],
        "partials_bound_ms_per_rank": [r["partials_bound_ms"] for r in ranks],
        "all_reduce_bytes_per_rank_per_site": ranks[0]["all_reduce_bytes_per_site"],
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
        "reference_peak_memory_gb": want["peak_memory_gb"],
    }
    log(f"  8e on {card}: warm wall {report['warm_wall_ms_per_step']:.3f} ms a step (whole-cache reference "
        f"{report['reference_warm_wall_ms_per_step']:.3f}); partials device ms per rank "
        f"{report['partials_ms_per_rank']} against bounds {report['partials_bound_ms_per_rank']}; "
        f"{report['all_reduce_bytes_per_rank_per_site']} bytes all-reduced a rank a site; peak GB per rank "
        f"{report['peak_memory_gb_per_rank']}, reference {report['reference_peak_memory_gb']:.3f}; "
        f"logits {errs} of max |logit| (limit {want['logit_tol']:.4f})")
    return report


def _feed_over_mesh(dev) -> dict:
    """8c: TorchFeed over ``make_smoke_mesh()`` (NCCL, world 1, on the card)
    against the unsharded feed of phase 7's corpus, batch for batch."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.client import TcpNetwork
    from repro_torch.client.torch_adapter import TorchFeed
    from repro_torch.data import training_dag, write_token_corpus
    from repro_torch.launch.mesh import make_smoke_mesh

    tmp = tempfile.mkdtemp(prefix="dacp_feed_")
    server, net = None, TcpNetwork()
    try:
        write_token_corpus(os.path.join(tmp, "docs.jsonl"), docs=TRAIN_STEPS * TRAIN_BATCH, seed=SEED)
        server, authority = _train_server(tmp)
        client = net.client_for(authority)
        dag = training_dag(f"dacp://{authority}/corpus/docs.jsonl", seq_len=TRAIN_SEQ, batch_rows=TRAIN_BATCH)
        whole = list(TorchFeed(lambda: client.cook(dag), "tokens", TRAIN_SEQ + 1, TRAIN_BATCH, device=dev))
        mesh = make_smoke_mesh()
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "the smoke mesh is not NCCL world 1")
        sharded = list(TorchFeed(lambda: client.cook(dag), "tokens", TRAIN_SEQ + 1, TRAIN_BATCH, mesh=mesh))
        check(len(sharded) == len(whole) == TRAIN_STEPS, f"feeds gave {len(sharded)} and {len(whole)} batches")
        for s, w in zip(sharded, whole):
            for name in ("tokens", "labels"):
                t = s[name]
                check(isinstance(t, DTensor) and t.to_local().device.type == "cuda", "the mesh feed gave no card DTensor")
                check(torch.equal(t.to_local(), w[name]), f"the mesh feed's {name} differ from the unsharded feed's")
        return {"batches": len(sharded), "shape": list(sharded[0]["tokens"].shape),
                "placements": [str(p) for p in sharded[0]["tokens"].placements], "equal": True}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        net.close_all()
        if server is not None:
            server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch is not beside chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_s = build_kernels()
    log(f"build: {build_s:.3f} s")
    phase_s = {"build": build_s}
    t_phase = time.perf_counter()

    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    records = [
        check_filter_select(dev, rng),
        check_project(dev, rng),
        check_segment_sum(dev, rng),
        check_segment_minmax(dev, rng),
        check_fused(dev, rng),
        check_flash(dev, rng),
        check_decode(dev, rng),
        check_ssd(dev, rng),
        check_mlstm(dev, rng),
    ]
    for r in records:
        log(f"kernel {r.name}: exact={r.exact} agrees={r.agrees} ({r.tolerance}) over {r.checks} checks, "
            f"max |err| {r.max_abs_err}, {r.shape}: {r.ms:.6f} ms (plain {r.plain_ms:.6f} ms, "
            f"library {r.library_ms} ms, bound {r.bound_ms:.6f} ms by {r.bound_by})")
    for r in records:
        log(f"redesigned {r.name}: design {r.extra['design']}, {r.extra['bound_fraction']:.4f} of its bound "
            f"({r.bound_ms:.6f} ms by {r.bound_by} against {r.ms:.6f} ms), "
            f"{r.extra.get('tensor_core_instructions', 0)} tensor-core instructions")
    smm = records[3]
    log(f"segment_minmax_tiles device ms: kernels {smm.ms:.6f} {smm.extra['kernels_ms']} against scatter_reduce_ "
        f"{smm.extra['library_device_ms']:.6f} (events {smm.library_ms:.6f}); wrapper "
        f"{smm.extra['call_device_ms']:.6f} against the library call {smm.extra['library_call_device_ms']:.6f}; "
        f"device events a call {smm.extra['device_events_per_call']}; library kernels {smm.extra['library_kernels']}")
    fsp, cold = records[0], records[0].extra["cold_ms"]
    log(f"filter_select_planes {fsp.shape}: {fsp.ms:.6f} ms device with its inputs in L2 "
        f"({fsp.bound_ms / fsp.ms:.4f} of its bound {fsp.bound_ms:.6f} ms); out of L2 over "
        f"{fsp.extra['cold_sets']} sets " + (f"{cold:.6f} ms ({fsp.bound_ms / cold:.4f})" if cold else "not measured"))
    pt = records[1]
    log(f"project_tiles device ms, each beside its bound's share: {pt.shape} {pt.ms:.6f} in L2 "
        f"({pt.bound_ms / pt.ms:.4f} of {pt.bound_ms:.6f}), out of L2 over {pt.extra['cold_sets']} sets "
        f"{pt.extra['cold_ms']:.6f} ({pt.bound_ms / pt.extra['cold_ms']:.4f}); {pt.extra['i32_shape']} "
        f"{pt.extra['i32_ms']:.6f} in L2 ({pt.extra['i32_bound_ms'] / pt.extra['i32_ms']:.4f} of "
        f"{pt.extra['i32_bound_ms']:.6f}); local-memory instructions (LDL / STL) in its SASS: "
        f"{pt.extra['local_memory_instructions']}")
    for r in (records[0], records[1], records[3]):
        cold = r.extra.get("wide_cold_ms")
        log(f"{r.name} wide envelope {r.wide_shape}: {r.wide_ms:.6f} ms device against its bound "
            f"{r.wide_bound_ms:.6f} ms ({r.wide_bound_ms / r.wide_ms:.4f} of it)"
            + (f"; inputs out of L2 over {r.extra['wide_cold_sets']} sets {cold:.6f} ms "
               f"({r.wide_bound_ms / cold:.4f})" if cold else ""))
    seg = records[2]
    log(f"segment_sum_tiles device ms: kernel {seg.ms:.6f} against index_add_ {seg.extra['library_device_ms']:.6f}; "
        f"wrapper {seg.extra['call_device_ms']:.6f} against the library call {seg.extra['library_call_device_ms']:.6f}")
    flash = records[5]
    log(f"flash_attention device ms: kernel {flash.ms:.6f} against SDPA {flash.extra['library_device_ms']:.6f} "
        f"(SDPA call {flash.extra['library_call_device_ms']:.6f}, events {flash.library_ms:.6f}); zamba2 shape "
        f"{flash.extra['zamba2_ms']:.6f} against SDPA {flash.extra['zamba2_library_device_ms']:.6f} "
        f"(events {flash.extra['zamba2_library_ms']:.6f})")
    for r in (flash, records[6]):
        for label, row in r.extra["serving_shapes"].items():
            log(f"{r.name} at phase 6's {label} shape {row['shape']}: {row['ms']:.6f} ms device against SDPA "
                f"{row['library_device_ms']:.6f} (events {row['library_ms']:.6f}), bound {row['bound_ms']:.6f}")
    dec = records[6]
    log(f"decode_attention device ms over {dec.extra['rotation']}: kernel {dec.ms:.6f} (wrapper call "
        f"{dec.extra['call_device_ms']:.6f}) against SDPA {dec.extra['library_device_ms']:.6f} (SDPA call "
        f"{dec.extra['library_call_device_ms']:.6f}, events {dec.library_ms:.6f}); one set, L2-resident: kernel "
        f"{dec.extra['hot_ms']:.6f}, SDPA {dec.extra['hot_library_device_ms']:.6f}; SDPA kernels "
        f"{dec.extra['library_kernels']}")
    part = dec.extra["partials"]
    log(f"decode_attention_partials {part['shape']}: {part['ms']:.6f} ms device (call {part['call_ms']:.6f}) against "
        f"its bound {part['bound_ms']:.6f} ms by {part['bound_by']}, its plain version {part['plain_ms']:.6f} ms and "
        f"{part['library']} {part['library_device_ms']:.6f} ms device (events {part['library_ms']:.6f}) on {card}; "
        f"max |err| against the plain partials {part['max_abs_err']} over {part['checks']} checks")
    mls = records[8]
    log(f"mlstm_chunk device ms: kernels {mls.ms:.6f} {mls.extra['kernels_ms']} (wrapper call "
        f"{mls.extra['call_device_ms']:.6f}) against its plain version {mls.plain_ms:.6f} (events)")
    ssd = records[7]
    log(f"ssd_scan device ms: kernels {ssd.ms:.6f} {ssd.extra['kernels_ms']} (wrapper call "
        f"{ssd.extra['call_device_ms']:.6f}) against its plain version {ssd.plain_ms:.6f} (events); 16 chunks "
        f"(b=1 s=4096) {ssd.extra['long_ms']:.6f}; worst |err| / (atol + rtol |want|) per case {ssd.extra['worst_ratio']}")
    fused = records[4]
    log(f"fused vs per-op on one morsel: fused {fused.ms:.6f} ms device, per-op kernels "
        f"{fused.extra['per_op_ms']:.6f} ms device ({fused.call_ms:.6f} / {fused.extra['per_op_call_ms']:.6f} ms call); "
        f"fused kernels {fused.extra['kernels_ms']} (wrapper call {fused.extra['call_device_ms']:.6f}); "
        f"launched grid {fused.extra['blocks']} blocks at {MORSEL} rows, {fused.extra['wide_blocks']} at {WIDE_N} "
        f"(profiler trace)")
    log(f"fused chain with float sums, the benchmark cell's morsel {fused.extra['cell_shape']}: kernels "
        f"{fused.extra['cell_kernels_ms']} ms device, the fold's bound {fused.extra['cell_fold_bound_ms']:.6f} ms; "
        f"the fold in row order (3.0e7 in every 97th row) {fused.extra['cell_ordered_kernels_ms']} ms; "
        f"plain version {fused.extra['cell_plain_ms']:.6f} ms (events)")
    check(pt.extra["local_memory_instructions"] == 0,
          f"project_kernel's SASS holds {pt.extra['local_memory_instructions']} LDL / STL: its stack is in local memory")
    copies = time_morsel_copies(dev)
    log("morsel copies: " + json.dumps(copies))
    phase_s["kernels"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    report, launches, breakdowns = end_to_end("cuda", E2E_ROWS, E2E_PARTS)
    for row in report:
        log("e2e: " + json.dumps(row) + f" on {kind}")
    log("e2e launches: " + json.dumps(launches))
    for b in breakdowns:
        log("e2e breakdown: " + json.dumps(b))
    dataplane = ("filter_select_planes", "project_tiles", "segment_sum_tiles", "segment_minmax_tiles",
                 "fused_chain_tiles")
    idle = [name for name in dataplane if launches[name] == 0]
    check(not idle, f"kernels never launched on the data-plane path: {idle}")
    phase_s["end_to_end"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    serving, serve_launches = serve_lm(dev, ops.LAUNCHES)
    log("serve: " + json.dumps(serving) + f" on {kind}")
    in_model = serving["profile_decode_step"]["port_kernels_by_name_ms"].get("decode_attn", 0.0) / 40
    dec.extra["in_model_ms"] = in_model
    log(f"decode_attention in granite's profiled decode step: {in_model:.6f} ms a launch (40 launches)")
    for name in ("flash_attention", "decode_attention"):
        launches[name] = serve_launches[name]
    phase_s["serve_granite"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    for serving, serve_launches in serve_hybrids(dev, ops.LAUNCHES):
        log("serve: " + json.dumps(serving) + f" on {kind}")
        for name in ("ssd_scan", "mlstm_chunk"):
            launches[name] = launches.get(name, 0) + serve_launches[name]

    phase_s["serve_hybrids"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    for serving, _ in serve_zoo(dev, ops.LAUNCHES):
        log("serve: " + json.dumps(serving) + f" on {kind}")
    phase_s["serve_zoo"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    log("kernel gradients: " + json.dumps(check_kernel_grads(dev, rng)) + f" on {kind}")
    training = train_full_width(dev, ops.LAUNCHES, f"{kind} ({card})")
    log("train: " + json.dumps(training) + f" on {kind}")
    phase_s["train"], t_phase = time.perf_counter() - t_phase, time.perf_counter()

    distributed = distributed_paths(dev, card)
    log("distributed: " + json.dumps(distributed) + f" on {kind}")
    long = distributed["long_500k_decode"]
    dec.extra["partials"].update(launches_per_rank_8e=[r["decode_attention"] for r in long["launches_per_rank"]],
                                 rank_ms_8e=long["partials_ms_per_rank"],
                                 rank_bound_ms_8e=long["partials_bound_ms_per_rank"])
    phase_s["distributed"] = time.perf_counter() - t_phase

    bad = [r.name for r in records if not r.agrees]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    idle = [name for name, n in launches.items() if n == 0]
    check(not idle, f"kernels never launched on the main path: {idle}")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phase_s.items()}))
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(card)
    log(json.dumps({"kernels": [r.as_json(launches[r.name]) for r in records]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
