"""granite-4.0-h-small, the published GraniteMoeHybrid layout, on the CPU
at the reduced size (every layer kind: three Mamba2 layers and one
attention layer, each with a dropless MoE of 8 experts, top 3, beside a
shared MLP): the port against the plain float32 reference
(``perfbench/reference/granitemoehybrid.py``) on seeded random weights
(forward; prefill then decode steps through the cache; the in-situ scoring
map on a ragged batch), the reference against transformers'
``GraniteMoeHybridForCausalLM``, the SSD scan's plain version at d_state
128 against the recurrence, and the MoE's spans and counters."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import harness  # noqa: E402
from perfbench.reference import granitemoehybrid as reference  # noqa: E402
from perfbench.traffic import score as score_traffic  # noqa: E402
from perfbench.traffic import score_granite  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = get_config("granite-4.0-h-small").reduced()
PUBLISHED = harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small.json")
CONF = dict(PUBLISHED, **score_granite.TINY_MODEL)  # the reduced configuration under the published keys


@pytest.fixture(scope="module")
def model():
    api = build(CFG)
    return api, api.init(torch.Generator().manual_seed(33), "cpu")


def _tokens(n, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG.vocab_size, n))


def test_the_configuration_is_the_published_one():
    cfg = get_config("granite-4.0-h-small")
    s, m = cfg.ssm, cfg.moe
    got = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps,
           "layer_types": list(cfg.layer_types), "attention_multiplier": cfg.attn_scale,
           "embedding_multiplier": cfg.embedding_multiplier, "residual_multiplier": cfg.residual_multiplier,
           "logits_scaling": cfg.logits_scaling, "mamba_n_heads": s.expand * cfg.d_model // s.head_dim,
           "mamba_d_head": s.head_dim, "mamba_d_state": s.d_state, "mamba_n_groups": s.n_groups,
           "mamba_d_conv": s.conv_kernel, "mamba_expand": s.expand, "mamba_chunk_size": s.chunk,
           "mamba_conv_bias": s.conv_bias, "num_local_experts": m.n_experts, "num_experts_per_tok": m.top_k,
           "intermediate_size": m.d_ff_expert, "shared_intermediate_size": m.d_ff_shared,
           "tie_word_embeddings": cfg.tie_embeddings, "max_position_embeddings": cfg.max_seq}
    assert got == {k: PUBLISHED[k] for k in got}
    assert PUBLISHED["position_embedding_type"] == "nope" and cfg.pos_emb == "none"
    assert cfg.head_dim_ == 128 and cfg.act == "silu" and cfg.moe_dispatch == "dropless" and m.fused_gate_up
    assert cfg.n_params() == 32_207_337_984
    assert PUBLISHED["reduced"] == [] and set(score_granite.TINY_MODEL) - {"dtype", "tiny"} <= set(PUBLISHED)


def test_the_parameter_count_is_the_built_trees(model):
    _api, params = model
    assert sum(t.numel() for t in tree_leaves(params)) == CFG.n_params()
    kinds = ["mamba" if "mamba" in lp else "attn" for lp in params["layers"]]
    assert kinds == ["mamba", "mamba", "attn", "mamba"]
    m = params["layers"][0]["moe"]
    assert m["input_linear"]["w"].shape == (8, 2 * 64, CFG.d_model) and m["output_linear"]["w"].shape == (8, 128, 64)
    assert m["shared"]["up"]["w"].shape == (CFG.d_model, 96) and m["router"]["w"].shape == (CFG.d_model, 8)


def test_forward_matches_the_reference(model):
    """Both in float32 on the same weights; they sum in other orders (the
    port's SSD scan, flash attention and grouped expert products against the
    reference's chunked scan, materialised softmax and dense expert loop)
    over four layers: under 1e-6 of the largest logit measured, held to
    1e-4."""
    api, params = model
    toks = _tokens(75)  # three SSD chunks of 32, the last one ragged
    got, _ = api.forward(params, {"tokens": toks[None]})
    want = reference.forward(params, toks, CONF)
    assert got.shape == (1, 75, CFG.padded_vocab)
    assert float((got[0] - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_prefill_then_decode_steps_match_the_references_forward(model):
    """Prefill 40 tokens, then 8 teacher-forced decode steps through the
    cache (one KV layer, three Mamba2 states and conv states): each step's
    logits against the reference's whole-sequence forward, as above."""
    api, params = model
    toks = _tokens(48, seed=4)
    want = reference.forward(params, toks, CONF)
    last, cache = api.prefill(params, {"tokens": toks[None, :40]}, 48)
    assert cache["k"].shape == (1, 1, CFG.n_kv_heads, 48, CFG.head_dim_)
    assert cache["ssm"]["ssm"].shape == (3, 1, 8, 32, 16) and cache["ssm"]["conv_x"].shape == (3, 1, 3, 256)
    got = [last[0, -1]]
    for i in range(8):
        logits, cache = api.decode_step(params, toks[None, 40 + i : 41 + i], cache)
        got.append(logits[0, -1])
    err = (torch.stack(got) - want[39:48]).abs().max()
    assert float(err) <= 1e-4 * float(want.abs().max())
    assert cache["index"] == 48


def test_score_tokens_matches_the_references_sums_on_a_ragged_batch(model):
    """Seven documents of 1 to 90 tokens through the map, in forwards of at
    most 128 padded tokens: each document's log-probabilities against the
    reference's (float32 both; 1e-4), whatever documents share its forward
    (the dispatch drops nothing); the MoE's counters count every token's k
    assignments and no dropped slot."""
    from repro_torch.core import dtypes
    from repro_torch.core.batch import Column, RecordBatch
    from repro_torch.core.operators import get_map
    from repro_torch.core.schema import Field, Schema
    from repro_torch.models import score

    api, params = model
    score._models[("granite-4.0-h-small-test", 5)] = (api, params)
    rng = np.random.default_rng(8)
    docs = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (90, 1, 33, 7, 64, 32, 65)]
    schema = Schema([Field("doc_id", dtypes.resolve("int64")), Field("tokens", dtypes.BINARY)])
    batch = RecordBatch(schema, [Column.from_values(dtypes.resolve("int64"), np.arange(7, dtype=np.int64)),
                                 Column.from_values(dtypes.BINARY, [d.tobytes() for d in docs])])
    before = moe.STATS.snapshot()
    out = get_map("score_tokens").fn(batch, column="tokens", arch="granite-4.0-h-small-test", seed=5, max_tokens=128)
    lp = score_traffic._blobs(out.column("logprobs"))
    for i, d in enumerate(docs):
        want = reference.logprobs(params, torch.from_numpy(d), CONF).numpy()
        assert len(lp[i]) == len(d) - 1 == out.column("n_scored").values[i]
        if len(d) > 1:
            assert np.abs(lp[i] - want).max() <= 1e-4
    after = moe.STATS.snapshot()
    plan = score.plan_forwards([len(d) for d in docs], CFG.ssm.chunk, 128)
    padded = sum(size * len(m) for size, m in plan)
    assert after["forwards"] - before["forwards"] == len(plan) * CFG.n_layers
    assert after["tokens"] - before["tokens"] == padded * CFG.n_layers
    assert after["assignments"] - before["assignments"] == padded * CFG.n_layers * CFG.moe.top_k
    assert after["dropped"] == before["dropped"]
    busiest = after["busiest"] - before["busiest"]
    assert padded * CFG.n_layers * CFG.moe.top_k / CFG.moe.n_experts <= busiest <= padded * CFG.n_layers


def test_the_moe_layers_record_a_span_each_with_a_route_inside(model):
    """With the recorder on, a forward records one ``moe`` span a layer and a
    ``route`` span inside each, on the forward's thread."""
    from repro_torch import trace

    api, params = model
    trace.enable()
    try:
        api.forward(params, {"tokens": _tokens(20)[None]})
    finally:
        rec = trace.disable()
    spans = {s.span_id: s for s in rec.spans}
    moes = [s for s in rec.spans if s.name == "moe"]
    routes = [s for s in rec.spans if s.name == "route"]
    assert len(moes) == len(routes) == CFG.n_layers
    assert all(spans[r.parent].name == "moe" and spans[r.parent].start_ns <= r.start_ns <= r.end_ns
               <= spans[r.parent].end_ns for r in routes)


# ---------------------------------------------------------------------------
# the reference against transformers' GraniteMoeHybrid, and the scan at d_state 128
# ---------------------------------------------------------------------------
def _hf_tree(m, hc) -> dict:
    """A transformers GraniteMoeHybrid model's weights in the port's tree."""
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    d, nh, kv = hc.hidden_size, hc.num_attention_heads, hc.num_key_value_heads
    hd = d // nh
    d_in, gn = hc.mamba_expand * d, hc.mamba_n_groups * hc.mamba_d_state
    fs = hc.shared_intermediate_size

    def t(w):
        return {"w": w.t().contiguous()}

    tree = {"embed": {"table": sd["model.embed_tokens.weight"]}, "final_norm": {"scale": sd["model.norm.weight"]},
            "layers": []}
    for li, kind in enumerate(hc.layer_types):
        pre = f"model.layers.{li}."
        lp = {"ln1": {"scale": sd[pre + "input_layernorm.weight"]}}
        if kind == "mamba":
            z, x, B, C, dt = torch.split(sd[pre + "mamba.in_proj.weight"], [d_in, d_in, gn, gn, hc.mamba_n_heads])
            cw, cb = sd[pre + "mamba.conv1d.weight"][:, 0, :].t(), sd[pre + "mamba.conv1d.bias"]
            lp["mamba"] = {"wz": t(z), "wx": t(x), "wB": t(B), "wC": t(C), "wdt": t(dt), "conv_x": cw[:, :d_in],
                           "conv_B": cw[:, d_in : d_in + gn], "conv_C": cw[:, d_in + gn :], "conv_x_b": cb[:d_in],
                           "conv_B_b": cb[d_in : d_in + gn], "conv_C_b": cb[d_in + gn :],
                           "A_log": sd[pre + "mamba.A_log"], "D": sd[pre + "mamba.D"],
                           "dt_bias": sd[pre + "mamba.dt_bias"], "norm": {"scale": sd[pre + "mamba.norm.weight"]},
                           "out": t(sd[pre + "mamba.out_proj.weight"])}
        else:
            a = pre + "self_attn."
            lp["attn"] = {"wq": {"w": sd[a + "q_proj.weight"].t().reshape(d, nh, hd)},
                          "wk": {"w": sd[a + "k_proj.weight"].t().reshape(d, kv, hd)},
                          "wv": {"w": sd[a + "v_proj.weight"].t().reshape(d, kv, hd)},
                          "wo": {"w": sd[a + "o_proj.weight"].t().reshape(nh, hd, d)}}
        gate, up = sd[pre + "shared_mlp.input_linear.weight"].split([fs, fs])
        lp["ln2"] = {"scale": sd[pre + "post_attention_layernorm.weight"]}
        lp["moe"] = {"router": t(sd[pre + "block_sparse_moe.router.layer.weight"]),
                     "input_linear": {"w": sd[pre + "block_sparse_moe.input_linear.weight"]},
                     "output_linear": {"w": sd[pre + "block_sparse_moe.output_linear.weight"]},
                     "shared": {"up": t(up), "gate": t(gate), "down": t(sd[pre + "shared_mlp.output_linear.weight"])}}
        tree["layers"].append(lp)
    return tree


def test_the_reference_is_transformers_granitemoehybrid():
    """transformers' GraniteMoeHybridForCausalLM at a toy size with the
    published layout (Mamba2 and NoPE attention layers, conv bias, a MoE of
    8 experts, top 3, and a shared MLP in every layer, the four µP
    multipliers), its weights drawn afresh and carried into the port's tree:
    float32 logits within 1e-4 relative.  Within one chunk (chunk 32, 27
    tokens): transformers' plain Mamba path mis-sums the state across
    chunks, as its Zamba2 path does (see the reference's docstring)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hc = transformers.GraniteMoeHybridConfig(
        vocab_size=512, hidden_size=64, intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2, hidden_act="silu", rms_norm_eps=1e-5, tie_word_embeddings=True,
        embedding_multiplier=12.0, logits_scaling=16.0, residual_multiplier=0.22, attention_multiplier=0.0625,
        num_local_experts=8, num_experts_per_tok=3, shared_intermediate_size=48, position_embedding_type="nope",
        layer_types=["mamba", "attention", "mamba", "mamba"], mamba_n_heads=8, mamba_n_groups=1, mamba_d_state=16,
        mamba_d_head=16, mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=32, mamba_conv_bias=True,
        mamba_proj_bias=False, attention_bias=False, pad_token_id=0)
    m = transformers.GraniteMoeHybridForCausalLM(hc).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(("dt_bias", "A_log", ".D")):
                continue
            if p.dim() < 2:  # norms and conv biases
                p.add_(torch.randn_like(p) * 0.1)
            else:
                p.copy_(torch.randn_like(p) * p.shape[-1] ** -0.5)
    conf = {k: getattr(hc, k) for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                        "num_key_value_heads", "rms_norm_eps", "embedding_multiplier",
                                        "logits_scaling", "residual_multiplier", "attention_multiplier",
                                        "num_local_experts", "num_experts_per_tok", "shared_intermediate_size",
                                        "layer_types", "mamba_n_heads", "mamba_n_groups", "mamba_d_state",
                                        "mamba_d_head", "mamba_expand", "mamba_chunk_size", "mamba_conv_bias",
                                        "vocab_size")}
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 512, 27))
    with torch.no_grad():
        want = m(toks[None]).logits[0]
    got = reference.forward(_hf_tree(m, hc), toks, conf)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_ssd_scan_plain_at_d_state_128_is_the_recurrence():
    """One B/C group of n = 128 over 4 heads, three chunks of 32 (the last
    ragged): the plain scan's y and final state against the sequential
    recurrence in float64 (float32 sums over 70 steps in two orders: 1e-4)."""
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 70, 4, 8, 128
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy((rng.random((b, s, h)) * 0.3).astype(np.float32))
    A = torch.from_numpy(-rng.random(h).astype(np.float32) * 2)
    B = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    y, S = ssd_scan_plain(x, dt, A, B, C, 32)
    state, want = torch.zeros((b, h, p, n), dtype=torch.float64), []
    for t in range(s):
        decay = torch.exp(dt[:, t].double() * A.double())[..., None, None]
        state = state * decay + dt[:, t, :, None, None].double() * x[:, t, :, :, None].double() * B[:, t, None, None, :]
        want.append(torch.einsum("bhpn,bn->bhp", state, C[:, t].double()))
    torch.testing.assert_close(y.double(), torch.stack(want, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(S.double(), state, rtol=1e-4, atol=1e-4)


def test_the_cells_configuration_file_holds_the_catalogs_numbers():
    """The benchmark's configuration keeps every published key as the
    model's config.json gives it, and states what it assumed."""
    assert PUBLISHED["model_type"] == "granitemoehybrid" and PUBLISHED["source"].startswith("https://huggingface.co/")
    assert len(PUBLISHED["layer_types"]) == PUBLISHED["num_hidden_layers"] == 40
    assert [i for i, t in enumerate(PUBLISHED["layer_types"]) if t == "attention"] == [5, 15, 25, 35]
    assert json.loads(json.dumps(PUBLISHED["assumed"])) and PUBLISHED["dtype"] == "bfloat16"
