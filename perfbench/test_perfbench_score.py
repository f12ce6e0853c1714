"""The ``score`` kind's pieces on the CPU: the corpus as the workload states
it, the counts of operations and bytes, the five readers of
``zamba2-7b.score_docs`` on a synthetic trace of known numbers, and the
control (the reference in float8 products) failing the cell's check where
the program passes it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import harness, spans  # noqa: E402
from perfbench.counts import zamba2 as counts  # noqa: E402
from perfbench.reference import zamba2 as reference  # noqa: E402
from perfbench.traffic import score as score_traffic  # noqa: E402
from repro_torch import trace as recorder  # noqa: E402

CELL = "zamba2-7b.score_docs"
CONF = harness.load_json(harness.BENCH / "configs" / "zamba2-7b.json")
PAR = harness.load_json(harness.BENCH / "workloads" / f"{CELL}.json")
MS = 1_000_000


def test_the_corpus_is_the_workloads():
    par = dict(PAR, parts=5)
    parts = score_traffic.corpus(CONF, par, 2**35 + 1)
    lens = score_traffic.lengths(PAR)
    assert len(lens) == PAR["docs_per_part"] == 32 and sum(lens) == 42675
    assert all(sorted(len(d) for d in p) == sorted(lens) for p in parts)
    assert [len(d) for d in parts[0]] != [len(d) for d in parts[1]]  # shuffled by the seed
    ids = np.concatenate([d for p in parts for d in p])
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < CONF["vocab_size"]
    share = np.bincount(ids, minlength=4)[:4] / len(ids)
    z = np.arange(1, CONF["vocab_size"] + 1, dtype=np.float64) ** -PAR["zipf_s"]
    np.testing.assert_allclose(share, (z / z.sum())[:4], rtol=0.05)  # the most frequent ids at Zipf's shares
    again = score_traffic.corpus(CONF, par, 2**35 + 1)
    assert all(np.array_equal(a, b) for p, q in zip(parts, again) for a, b in zip(p, q))
    order = score_traffic.part_order(2**35 + 1, 64)
    assert sorted(order) == list(range(64)) and order != score_traffic.part_order(2**35 + 2, 64)


def test_the_counts_of_the_published_model():
    # 81 Mamba layers 78.4 M, 13 applications at concat width 334.2 M, LoRAs, linears and the head 0.335 G
    macs = counts.matmul_macs_per_token(CONF)
    mamba = 3584 * (2 * 7168 + 2 * 128 + 112) + 7168 * 3584
    shared = 3 * 7168 * 7168 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584
    assert macs == 81 * mamba + 13 * (shared + 128 * (3584 + 28672) + 3584 * 3584) + 3584 * 32000
    assert macs == pytest.approx(11.03e9, rel=1e-3)
    assert counts.attention_flops(CONF, 4, 2) == 13 * 2 * 4 * 32 * 224 * 10
    lens = score_traffic.lengths(PAR)
    flops = counts.model_flops(CONF, lens)
    assert flops == 2 * macs * 42675 + sum(counts.attention_flops(CONF, n) for n in lens)
    assert flops == pytest.approx(0.958e15, rel=0.01)  # 0.94 PFLOP of products and 17 TFLOP of attention a COOK
    # x bf16, dt f32, B and C bf16 read; y f32 and the final state written
    assert counts.ssd_bytes(CONF, 2, 256) == (2 * 512 * 112 * 64 + 4 * 512 * 112 + 4 * 512 * 128
                                              + 4 * 512 * 112 * 64 + 4 * 2 * 112 * 64 * 64)


class _Trace:
    kernels = {"flash_attn_bf16_kernel<256>": 0.020, "ssd_scan_kernel_state<64, 64>": 0.010,
               "ssd_scan_kernel_carry<64, 64>": 0.002, "ssd_scan_kernel_out<64, 64>": 0.008,
               "sm90_xmma_gemm_bf16bf16": 1.5, "Memcpy HtoD (Pageable -> Device)": 0.3, "Memset (Device)": 0.1}
    launches = {"flash_attn_bf16_kernel<256>": 26, "ssd_scan_kernel_state<64, 64>": 162,
                "ssd_scan_kernel_carry<64, 64>": 162, "ssd_scan_kernel_out<64, 64>": 162,
                "sm90_xmma_gemm_bf16bf16": 9000, "Memcpy HtoD (Pageable -> Device)": 40, "Memset (Device)": 4}
    window_s, busy_s, intervals = 4.0, 1.6, [[0, 1]]
    kernel_seconds = harness.Trace.kernel_seconds
    kernel_launches = harness.Trace.kernel_launches


class _Run:
    trace = _Trace()
    facts = {"traced_cooks": 2, "conf": CONF, "doc_lengths": [100, 300], "forwards": [(1, 512), (1, 256)],
             "score_counts": {"documents": 4, "forwards": 4, "real_tokens": 800, "padded_tokens": 1536}}


def test_the_readers_on_known_numbers():
    run = _Run()
    kernel_s = 0.020 + 0.010 + 0.002 + 0.008 + 1.5  # copies and fills left out
    want = 100.0 * 2 * counts.model_flops(CONF, [100, 300]) / 989e12 / kernel_s
    assert harness.metric_reader("score_mfu").read(run) == pytest.approx(want)
    per_launch = (counts.attention_flops(CONF, 512) + counts.attention_flops(CONF, 256)) / (13 * 2)
    assert harness.metric_reader("flash_attention_roofline").read(run) == pytest.approx(
        100.0 * 26 * per_launch / 989e12 / 0.020)
    per_launch = (counts.ssd_bytes(CONF, 1, 512) + counts.ssd_bytes(CONF, 1, 256)) / 2
    assert harness.metric_reader("ssd_scan_roofline").read(run) == pytest.approx(
        100.0 * 162 * per_launch / 3.35e12 / 0.020)
    assert harness.metric_reader("score_pad_share").read(run) == pytest.approx(100.0 * 736 / 1536)


def _span(name, start_ms, end_ms, request, span_id, parent=None):
    return recorder.Span(name, start_ms * MS, end_ms * MS, 0, 1, 1, span_id, parent, request)


def test_idle_share_score_reads_the_idle_card_inside_score_spans():
    """Score spans 100-400 and 500-900 ms; the card busy 150-350 and 600-850 ms:
    idle inside them 100-150, 350-400, 500-600 and 850-900, over the 1000 ms
    recorded."""
    off = 1_700_000_000 * 1_000_000_000
    t = harness.Trace(False)
    t._t0, t.window_s = 0.0, 1.0
    t.intervals = [[off + 150 * MS, off + 350 * MS], [off + 600 * MS, off + 850 * MS]]
    rec = recorder.Recording([_span("score", 100, 400, 1, 1), _span("forward", 110, 300, 1, 2, 1),
                              _span("score", 500, 900, 2, 3)], [(0, off, 0), (1000 * MS, off + 1000 * MS, 1000 * MS)], 0)
    t.spans = spans.window(t, rec)

    class R:
        trace = t

    assert harness.metric_reader("idle_share.score").read(R()) == pytest.approx(100.0 * 250 / 1000)


def test_the_control_fails_the_cells_check_where_the_program_passes():
    """At the reduced size on the CPU: the reference in float8 products
    against the float32 reference on three documents reads above the cell's
    limit on the mean difference, which the program's float32 path meets
    with room (its bfloat16 path on the card is held to the same limit)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    cfg = get_config("zamba2-7b").reduced()
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(4), "cpu")
    conf = dict(CONF, **score_traffic.TINY_MODEL)
    rng = np.random.default_rng(6)
    lim = PAR["limits"]
    for n in (40, 77, 96):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        want = reference.logprobs(params, toks, conf).numpy()
        logits, _ = api.forward(params, {"tokens": toks[None]})
        got = torch.log_softmax(logits[0, :-1], -1).gather(-1, toks[1:, None])[:, 0].numpy()
        assert score_traffic.compare(got, want)[1] < 0.01 * lim["logprob_mean_abs_diff"]
        low = reference.logprobs(params, toks, conf, fp8=True).numpy()
        assert score_traffic.compare(low, want)[1] > lim[score_traffic.CONTROL.check]
