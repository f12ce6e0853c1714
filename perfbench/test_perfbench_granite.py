"""The ``score_granite`` kind's pieces on the CPU: the corpus over the
model's vocabulary, the counts of the published model from its JSON
configuration, the four readers of ``granite-4.0-h-small.score_docs``
on a synthetic trace of known numbers, a dropped expert slot turning
``correct`` false, and the control (the reference in float8 products)
failing the cell's check where the program passes it."""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import harness, spans  # noqa: E402
from perfbench.counts import granitemoehybrid as counts  # noqa: E402
from perfbench.reference import granitemoehybrid as reference  # noqa: E402
from perfbench.traffic import score as score_traffic  # noqa: E402
from perfbench.traffic import score_granite  # noqa: E402
from repro_torch import trace as recorder  # noqa: E402

CELL = "granite-4.0-h-small.score_docs"
CONF = harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small.json")
PAR = harness.load_json(harness.BENCH / "workloads" / f"{CELL}.json")
MS = 1_000_000


def test_the_corpus_and_the_forwards_are_the_score_mix_over_this_vocabulary():
    parts = score_traffic.corpus(CONF, dict(PAR, parts=3), 2**35 + 3)
    ids = np.concatenate([d for p in parts for d in p])
    assert ids.min() >= 0 and ids.max() < 100352 and sum(len(d) for d in parts[0]) == 42675
    plan = score_granite.shapes(CONF, PAR)
    assert plan["forwards"] == [(3, 4096), (3, 2816), (6, 2048), (8, 1280), (6, 768), (5, 512), (1, 256)]
    assert sum(b * s for b, s in plan["forwards"]) == 50688


def test_the_counts_of_granite_4_0_h_small_from_its_configuration():
    """The published model from its JSON configuration: 32,207,337,984
    parameters and 8,800,960,512 multiply-adds a token (routed experts
    42.9%, Mamba2 projections 41.8%, shared MLP 8.6%, head 4.7%, attention
    projections 1.9%, routers 0.1%)."""
    conf = harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small.json")
    assert counts.parameters(conf) == 32_207_337_984
    macs = counts.matmul_macs_per_token(conf)
    assert macs == 8_800_960_512
    experts = 40 * 10 * 3 * 4096 * 768
    mamba = 36 * (4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096)
    assert macs == experts + mamba + 40 * 3 * 4096 * 1536 + 4096 * 100352 + 4 * (2 * 4096 * 4096 + 2 * 4096 * 1024) \
        + 40 * 4096 * 72
    assert experts / macs == pytest.approx(0.429, abs=5e-4) and mamba / macs == pytest.approx(0.418, abs=5e-4)
    assert counts.expert_flops_per_assignment(conf) == 2 * 3 * 4096 * 768
    assert counts.attention_flops(conf, 4, 2) == 4 * 2 * 4 * 32 * 128 * 10
    # x bf16, dt f32, B and C bf16 read; y f32 and the final state written, at d_state 128 in one group
    assert counts.ssd_bytes(conf, 2, 256) == (2 * 512 * 128 * 64 + 4 * 512 * 128 + 4 * 512 * 128
                                              + 4 * 512 * 128 * 64 + 4 * 2 * 128 * 64 * 128)


class _Trace:
    kernels = {"void cutlass::device_kernel<cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::GroupProblemShape<>>":
               0.40, "void at::cuda::detail::prepare_grouped_gemm_data<>": 0.01,
               "ssd_scan_kernel_state<64, 128>": 0.010, "ssd_scan_kernel_carry<64, 128>": 0.002,
               "ssd_scan_kernel_out<64, 128>": 0.008, "nvjet_tst_192x192": 1.5,
               "Memcpy HtoD (Pageable -> Device)": 0.3, "Memset (Device)": 0.1}
    launches = {k: 72 for k in kernels}
    window_s, busy_s, intervals = 4.0, 1.6, [[0, 1]]
    kernel_seconds = harness.Trace.kernel_seconds
    kernel_launches = harness.Trace.kernel_launches


class _Run:
    trace = _Trace()
    facts = {"traced_cooks": 2, "conf": CONF, "doc_lengths": [100, 300], "forwards": [(1, 512), (1, 256)],
             "moe_counts": {"forwards": 80, "tokens": 1536, "assignments": 15360, "busiest": 900, "dropped": 0}}


def test_the_readers_on_known_numbers():
    run = _Run()
    kernel_s = 0.40 + 0.01 + 0.020 + 1.5  # copies and fills left out
    want = 100.0 * 2 * counts.model_flops(CONF, [100, 300]) / 989e12 / kernel_s
    assert harness.metric_reader("score_mfu.granite").read(run) == pytest.approx(want)
    assert harness.metric_reader("moe_experts_roofline").read(run) == pytest.approx(
        100.0 * 15360 * 6 * 4096 * 768 / 989e12 / 0.41)
    per_launch = (counts.ssd_bytes(CONF, 1, 512) + counts.ssd_bytes(CONF, 1, 256)) / 2
    assert harness.metric_reader("ssd_scan_roofline.granite").read(run) == pytest.approx(
        100.0 * 72 * per_launch / 3.35e12 / 0.020)


def test_the_zamba2_readers_read_nothing_in_this_cell():
    """``score_mfu`` and ``ssd_scan_roofline`` count zamba2's layout and list
    only its cell; on this cell's numbers they find no kernels of theirs or
    no keys of theirs, and this cell's readers none in zamba2's."""
    run = _Run()
    assert harness.metric_reader("flash_attention_roofline").read(run) is None
    zrun = type("Z", (), {"trace": _Trace(), "facts": dict(_Run.facts, conf=harness.load_json(
        harness.BENCH / "configs" / "zamba2-7b.json"), moe_counts=None)})()
    for name in ("score_mfu.granite", "moe_experts_roofline", "ssd_scan_roofline.granite"):
        assert harness.metric_reader(name).read(zrun) is None, name


def _span(name, start_ms, end_ms, request, span_id, parent=None):
    return recorder.Span(name, start_ms * MS, end_ms * MS, 0, 1, 1, span_id, parent, request)


def test_idle_share_moe_reads_the_idle_card_inside_moe_spans():
    """MoE spans 100-300 and 600-700 ms inside a forward; the card busy
    150-250 and 600-680 ms: idle inside them 100-150, 250-300 and 680-700,
    over the 1000 ms recorded."""
    off = 1_700_000_000 * 1_000_000_000
    t = harness.Trace(False)
    t._t0, t.window_s = 0.0, 1.0
    t.intervals = [[off + 150 * MS, off + 250 * MS], [off + 600 * MS, off + 680 * MS]]
    rec = recorder.Recording([_span("forward", 50, 800, 1, 1), _span("moe", 100, 300, 1, 2, 1),
                              _span("route", 100, 120, 1, 3, 2), _span("moe", 600, 700, 1, 4, 1)],
                             [(0, off, 0), (1000 * MS, off + 1000 * MS, 1000 * MS)], 0)
    t.spans = spans.window(t, rec)

    class R:
        trace = t

    assert harness.metric_reader("idle_share.moe").read(R()) == pytest.approx(100.0 * 120 / 1000)


def _tiny(seconds=1.0):
    cell = harness.find_cell(CELL, 2**33 + 5, seconds, False)
    cell.device = "cpu"
    return score_granite.tiny(cell)


def test_a_dropped_expert_slot_is_not_correct(monkeypatch):
    """A MoE layer that drops one (token, expert) slot a call, the rest
    unchanged: the run's ``moe_slots_dropped`` counts them and the line is
    not correct."""
    from repro_torch.models import moe

    real = moe.moe_apply_dropless

    def dropping(params, x, cfg, act, kernels=moe.ops.KERNELS):
        out = real(params, x, cfg, act, kernels)
        moe.STATS.add(0, 0, dropped=torch.ones((), dtype=torch.int64))
        return out

    monkeypatch.setattr(moe, "moe_apply_dropless", dropping)
    cell = _tiny()
    run = harness.driver(cell).run(cell, time.perf_counter())
    line = json.loads(json.dumps(harness.result_line(cell, run, run.facts["setup_s"])))
    assert line["correct"] is False and line["checks"]["moe_slots_dropped"]["value"] > 0
    assert line["checks"]["logprob_max_abs_diff"]["value"] <= line["checks"]["logprob_max_abs_diff"]["limit"]


def test_a_program_without_the_configuration_fails_at_once(monkeypatch):
    """A program that has no such configuration (a checkout from before it
    was added): ``get_config`` raises before any corpus is written or model
    built."""
    from repro_torch.configs import base

    base.list_archs()  # every configuration registered, then this one taken out
    monkeypatch.delitem(base._REGISTRY, "granite-4.0-h-small")
    cell = _tiny()
    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="unknown arch"):
        harness.driver(cell).run(cell, t0)
    assert time.perf_counter() - t0 < 5


def test_the_control_moves_the_log_probabilities_where_the_program_does_not():
    """At the reduced size on the CPU: the reference in float8 products
    against the float32 reference on three documents moves the mean
    log-probability difference over a hundred times as far as the
    program's float32 path does.  (The reduced model's logits, divided by
    16 as published, stay within ±1, so its log-probabilities hardly move
    under either; the cell's limits are set on the card at full width,
    where the control fails them.)"""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    cfg = get_config("granite-4.0-h-small").reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(4), "cpu")
    conf = dict(CONF, **score_granite.TINY_MODEL)
    rng = np.random.default_rng(6)
    for n in (40, 77, 96):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        want = reference.logprobs(params, toks, conf).numpy()
        logits, _ = api.forward(params, {"tokens": toks[None]})
        got = torch.log_softmax(logits[0, :-1], -1).gather(-1, toks[1:, None])[:, 0].numpy()
        low = reference.logprobs(params, toks, conf, fp8=True).numpy()
        assert score_traffic.compare(low, want)[1] > 100 * score_traffic.compare(got, want)[1]
