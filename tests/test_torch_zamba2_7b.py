"""zamba2-7b, the published Zamba2 layout, on the CPU at the reduced size:
the port against the plain float32 reference (``perfbench/reference/
zamba2.py``) on seeded random weights (forward; prefill then decode steps
through the cache; the in-situ scoring map on a ragged batch), the
reference against transformers' ``Zamba2ForCausalLM``, and the kernels'
plain versions at what the model asks of them (B/C groups in the SSD scan;
head dim 224 and the caller's scale in attention)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.reference import zamba2 as reference  # noqa: E402
from perfbench.traffic import score as score_traffic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CFG = get_config("zamba2-7b").reduced()
PUBLISHED = {
    "hidden_size": 3584, "mamba_expand": 2, "n_mamba_heads": 112, "mamba_headdim": 64, "mamba_d_state": 64,
    "mamba_ngroups": 2, "mamba_d_conv": 4, "use_conv_bias": True, "chunk_size": 256, "num_attention_heads": 32,
    "num_key_value_heads": 32, "attention_head_dim": 224, "attention_hidden_size": 7168, "num_mem_blocks": 2,
    "adapter_rank": 128, "ffn_hidden_size": 14336, "num_hidden_layers": 81, "vocab_size": 32000,
    "rms_norm_eps": 1e-5, "rope_theta": 10000, "max_position_embeddings": 4096,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
}


def _conf(cfg=CFG) -> dict:
    """The reduced configuration under the published keys (what the
    reference reads)."""
    s = cfg.ssm
    return {"hidden_size": cfg.d_model, "mamba_expand": s.expand, "n_mamba_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_headdim": s.head_dim, "mamba_d_state": s.d_state, "mamba_ngroups": s.n_groups,
            "use_conv_bias": s.conv_bias, "chunk_size": s.chunk, "num_attention_heads": cfg.n_heads,
            "attention_head_dim": cfg.head_dim, "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
            "num_mem_blocks": cfg.n_mem_blocks, "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "vocab_size": cfg.vocab_size, "use_mem_rope": True, "adapter_rank": cfg.adapter_rank,
            "ffn_hidden_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers}


@pytest.fixture(scope="module")
def model():
    api = build(CFG)
    return api, api.init(torch.Generator().manual_seed(29), "cpu")


def _tokens(n, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, CFG.vocab_size, n))


def test_the_configuration_is_the_published_one():
    cfg = get_config("zamba2-7b")
    s = cfg.ssm
    got = {"hidden_size": cfg.d_model, "mamba_expand": s.expand, "n_mamba_heads": s.expand * cfg.d_model // s.head_dim,
           "mamba_headdim": s.head_dim, "mamba_d_state": s.d_state, "mamba_ngroups": s.n_groups,
           "mamba_d_conv": s.conv_kernel, "use_conv_bias": s.conv_bias, "chunk_size": s.chunk,
           "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads, "attention_head_dim": cfg.head_dim,
           "attention_hidden_size": cfg.attn_in_dim, "num_mem_blocks": cfg.n_mem_blocks,
           "adapter_rank": cfg.adapter_rank, "ffn_hidden_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
           "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
           "max_position_embeddings": cfg.max_seq, "hybrid_layer_ids": list(cfg.hybrid_layer_ids)}
    assert got == PUBLISHED
    assert s.expand * cfg.d_model // s.n_groups == 3584 and cfg.act == "gelu_exact" and cfg.tie_embeddings
    assert cfg.attn_scale == pytest.approx(112**-0.5)
    assert 7.35e9 < cfg.n_params() < 7.37e9  # 7.357 B, the published model's 7.35 B with the tied head counted once


def test_the_parameter_count_is_the_built_trees(model):
    _api, params = model
    assert sum(t.numel() for t in tree_leaves(params)) == CFG.n_params()
    assert len(params["mem_blocks"]) == 2 and len(params["hybrid"]) == 3 and "shared_attn" not in params
    assert params["mem_blocks"][0]["attn"]["wq"]["w"].shape == (2 * CFG.d_model, CFG.n_heads, CFG.head_dim)
    assert params["layers"][0]["mamba"]["wB"]["w"].shape == (CFG.d_model, 2 * CFG.ssm.d_state)


def test_forward_matches_the_reference(model):
    """Both in float32 on the same weights; they sum in other orders (the
    port's SSD scan and flash attention against the reference's chunked
    scan and materialised softmax) over five layers: 2e-5 of the largest
    logit measured, held to 1e-4."""
    api, params = model
    toks = _tokens(75)  # three SSD chunks of 32, the last one ragged
    got, _ = api.forward(params, {"tokens": toks[None]})
    want = reference.forward(params, toks, _conf())
    assert got.shape == (1, 75, CFG.padded_vocab)
    assert float((got[0] - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_prefill_then_decode_steps_match_the_references_forward(model):
    """Prefill 40 tokens, then 8 decode steps through the cache (13 KV
    layers in the full model, here 3; 2-group SSM states): each step's
    logits against the reference's whole-sequence forward, as above."""
    api, params = model
    toks = _tokens(48, seed=4)
    want = reference.forward(params, toks, _conf())
    last, cache = api.prefill(params, {"tokens": toks[None, :40]}, 48)
    assert cache["kv"]["k"].shape == (3, 1, CFG.n_kv_heads, 48, CFG.head_dim)
    assert cache["ssm"]["ssm"].shape == (5, 1, 8, 32, 16) and cache["ssm"]["conv_B"].shape == (5, 1, 3, 32)
    got = [last[0, -1]]
    for i in range(8):
        logits, cache = api.decode_step(params, toks[None, 40 + i : 41 + i], cache)
        got.append(logits[0, -1])
    err = (torch.stack(got) - want[39:48]).abs().max()
    assert float(err) <= 1e-4 * float(want.abs().max())
    assert cache["kv"]["index"] == 48


def test_score_tokens_matches_the_references_sums_on_a_ragged_batch(model):
    """Seven documents of 1 to 90 tokens through the map, in forwards of at
    most 128 padded tokens: each document's log-probabilities against the
    reference's (float32 both; 1e-4, as the logits), the log-likelihood their
    float64 sum, the count its length less one."""
    from repro_torch.core import dtypes
    from repro_torch.core.batch import Column, RecordBatch
    from repro_torch.core.operators import get_map
    from repro_torch.core.schema import Field, Schema
    from repro_torch.models import score

    api, params = model
    score._models[("zamba2-7b-test", 5)] = (api, params)
    rng = np.random.default_rng(8)
    docs = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (90, 1, 33, 7, 64, 32, 65)]
    schema = Schema([Field("doc_id", dtypes.resolve("int64")), Field("tokens", dtypes.BINARY)])
    batch = RecordBatch(schema, [Column.from_values(dtypes.resolve("int64"), np.arange(7, dtype=np.int64)),
                                 Column.from_values(dtypes.BINARY, [d.tobytes() for d in docs])])
    before = score.STATS.snapshot()
    out = get_map("score_tokens").fn(batch, column="tokens", arch="zamba2-7b-test", seed=5, max_tokens=128)
    assert [f.name for f in out.schema] == ["doc_id", "loglik", "n_scored", "logprobs"]
    lp = score_traffic._blobs(out.column("logprobs"))
    for i, d in enumerate(docs):
        want = reference.logprobs(params, torch.from_numpy(d), _conf()).numpy()
        assert len(lp[i]) == len(d) - 1 == out.column("n_scored").values[i]
        if len(d) > 1:
            assert np.abs(lp[i] - want).max() <= 1e-4
        assert out.column("loglik").values[i] == np.sum(lp[i], dtype=np.float64)
    after = score.STATS.snapshot()
    plan = score.plan_forwards([len(d) for d in docs], CFG.ssm.chunk, 128)
    assert after["forwards"] - before["forwards"] == len(plan)
    assert after["real_tokens"] - before["real_tokens"] == sum(len(d) for d in docs)
    assert after["padded_tokens"] - before["padded_tokens"] == sum(size * len(m) for size, m in plan)


def test_score_tokens_refuses_a_model_the_server_does_not_hold():
    """A request names (arch, seed); the map builds no model inside it, so a
    seed nobody holds is a ``PlanError`` and leaves the held models as they were."""
    from repro_torch.core import dtypes
    from repro_torch.core.batch import Column, RecordBatch
    from repro_torch.core.errors import PlanError
    from repro_torch.core.operators import get_map
    from repro_torch.core.schema import Field, Schema
    from repro_torch.models import score

    schema = Schema([Field("tokens", dtypes.BINARY)])
    batch = RecordBatch(schema, [Column.from_values(dtypes.BINARY, [np.arange(5, dtype=np.int32).tobytes()])])
    before = dict(score._models)
    with pytest.raises(PlanError, match="holds no model"):
        get_map("score_tokens").fn(batch, column="tokens", arch="zamba2-7b", seed=987654321)
    assert score._models == before


def test_forwards_group_longest_first_and_keep_to_their_size():
    """The cell's part: 32 lengths of 183 to 4096 tokens, 42,675 in all, in
    seven forwards of at most 32,768 padded tokens, 15.8% of them padding."""
    from repro_torch.models.score import plan_forwards

    par = {"docs_per_part": 32, "length_median": 1024, "length_sigma": 0.8, "length_min": 128, "length_max": 4096}
    lens = score_traffic.lengths(par)
    assert sum(lens) == 42675 and min(lens) == 183 and max(lens) == 4096
    plan = plan_forwards(lens, 256, 32768)
    assert sorted(i for _s, m in plan for i in m) == list(range(32))
    assert [(size, len(m)) for size, m in plan] == [(4096, 3), (2816, 3), (2048, 6), (1280, 8), (768, 6), (512, 5),
                                                    (256, 1)]
    for size, members in plan:
        assert size * len(members) <= 32768 and all(-(-lens[i] // 256) * 256 <= size for i in members)
    padded = sum(size * len(m) for size, m in plan)
    assert 1 - sum(lens) / padded == pytest.approx(0.158, abs=1e-3)


# ---------------------------------------------------------------------------
# the reference against transformers' Zamba2, and its scan against the recurrence
# ---------------------------------------------------------------------------
def _hf_tree(m, hc) -> dict:
    """A transformers Zamba2 model's weights in the port's tree."""
    sd = {k: v.detach().float() for k, v in m.state_dict().items()}
    d, nh, hd = hc.hidden_size, hc.num_attention_heads, hc.attention_head_dim
    d_in, gn = hc.mamba_expand * d, hc.mamba_ngroups * hc.mamba_d_state

    def t(w):
        return {"w": w.t().contiguous()}

    tree = {"embed": {"table": sd["model.embed_tokens.weight"]}, "final_norm": {"scale": sd["model.final_layernorm.weight"]},
            "layers": [], "mem_blocks": [], "hybrid": []}
    for li, kind in enumerate(hc.layers_block_type):
        pre = f"model.layers.{li}." + ("mamba_decoder." if kind == "hybrid" else "") + "mamba."
        z, x, B, C, dt = torch.split(sd[pre + "in_proj.weight"], [d_in, d_in, gn, gn, hc.n_mamba_heads])
        cw, cb = sd[pre + "conv1d.weight"][:, 0, :].t(), sd[pre + "conv1d.bias"]
        mp = {"wz": t(z), "wx": t(x), "wB": t(B), "wC": t(C), "wdt": t(dt), "conv_x": cw[:, :d_in],
              "conv_B": cw[:, d_in : d_in + gn], "conv_C": cw[:, d_in + gn :], "conv_x_b": cb[:d_in],
              "conv_B_b": cb[d_in : d_in + gn], "conv_C_b": cb[d_in + gn :], "A_log": sd[pre + "A_log"],
              "D": sd[pre + "D"], "dt_bias": sd[pre + "dt_bias"], "norm": {"scale": sd[pre + "norm.weight"]},
              "out": t(sd[pre + "out_proj.weight"])}
        ln = sd[pre.replace("mamba.", "") + "input_layernorm.weight"]
        tree["layers"].append({"ln": {"scale": ln}, "mamba": mp})
    for j, li in enumerate(hc.hybrid_layer_ids):
        st = f"model.layers.{li}.shared_transformer."
        if j < hc.num_mem_blocks:
            attn = {f"w{n}": {"w": sd[st + f"self_attn.{n}_proj.weight"].t().reshape(2 * d, nh, hd)} for n in "qkv"}
            attn["wo"] = {"w": sd[st + "self_attn.o_proj.weight"].t().reshape(nh, hd, d)}
            tree["mem_blocks"].append({"ln_a": {"scale": sd[st + "input_layernorm.weight"]}, "attn": attn,
                                       "ln_m": {"scale": sd[st + "pre_ff_layernorm.weight"]},
                                       "mlp": {"gate_up": t(sd[st + "feed_forward.gate_up_proj.weight"]),
                                               "down": t(sd[st + "feed_forward.down_proj.weight"])}})
        ad = st + f"feed_forward.gate_up_proj_adapter_list.{j}."
        tree["hybrid"].append({"lora_a": t(sd[ad + "0.weight"]), "lora_b": t(sd[ad + "1.weight"]),
                               "linear": t(sd[f"model.layers.{li}.linear.weight"])})
    return tree


def test_the_reference_is_transformers_zamba2():
    """transformers' Zamba2ForCausalLM at a toy size with the published
    layout (2 groups, 2 memory blocks, MLP adapters, mem-RoPE, conv bias),
    its weights perturbed and carried into the port's tree: float32 logits
    within 1e-4 relative.  Within one chunk (chunk_size 32, 21 tokens):
    transformers' plain Mamba path mis-sums the state across chunks (see the
    reference's docstring), which the next test covers.  dt_bias 0.5 keeps
    dt above ``time_step_min``, where that path clamps and the CUDA path the
    reference follows does not."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hc = transformers.Zamba2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=4,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_ngroups=2, n_mamba_heads=4, chunk_size=32,
        num_mem_blocks=2, use_shared_mlp_adapter=True, use_shared_attention_adapter=False, adapter_rank=8,
        use_mem_rope=True, layers_block_type=["mamba", "hybrid", "hybrid", "mamba", "hybrid"], intermediate_size=128,
        hidden_act="gelu", rms_norm_eps=1e-5, use_conv_bias=True, pad_token_id=0)
    m = transformers.Zamba2ForCausalLM(hc).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.add_(torch.randn_like(p) * 0.05)
            if name.endswith("dt_bias"):
                p.fill_(0.5)
    conf = {k: getattr(hc, k) for k in ("hidden_size", "mamba_expand", "n_mamba_heads", "mamba_headdim",
                                        "mamba_d_state", "mamba_ngroups", "use_conv_bias", "chunk_size",
                                        "num_attention_heads", "attention_head_dim", "hybrid_layer_ids",
                                        "num_mem_blocks", "rms_norm_eps", "rope_theta", "vocab_size", "use_mem_rope")}
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 512, 21))
    with torch.no_grad():
        want = m(toks[None]).logits[0]
    got = reference.forward(_hf_tree(m, hc), toks, conf)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_the_references_chunked_scan_is_the_recurrence():
    """The reference's SSD over three chunks (one ragged) against the
    sequential recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ,
    y_t = h_t C_t, in float64."""
    rng = np.random.default_rng(5)
    s, h, p, n = 21, 4, 8, 6
    x, B, C = (torch.from_numpy(rng.standard_normal(sh)) for sh in ((s, h, p), (s, h, n), (s, h, n)))
    dt = torch.from_numpy(rng.random((s, h)))
    A = -torch.from_numpy(rng.random(h))
    state, want = torch.zeros((h, p, n), dtype=torch.float64), []
    for t in range(s):
        state = state * torch.exp(dt[t] * A)[:, None, None] + dt[t][:, None, None] * x[t][:, :, None] * B[t][:, None]
        want.append(torch.einsum("hpn,hn->hp", state, C[t]))
    assert float((reference.ssd(x, dt, A, B, C, 8) - torch.stack(want)).abs().max()) < 1e-12


# ---------------------------------------------------------------------------
# the kernels' plain versions at what the model asks of them
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, b, s, h, p, n, g):
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy((rng.random((b, s, h)) * 0.3).astype(np.float32))
    A = torch.from_numpy(-rng.random(h).astype(np.float32) * 2)
    B = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32))
    return x, dt, A, B, C


def test_ssd_scan_plain_in_groups_is_each_heads_group_recurrence():
    """g = 2 over 8 heads: head h reads group h // 4.  Against the
    sequential recurrence with each head's own B and C (float32, 1e-4: sums
    over 70 steps in two orders)."""
    rng = np.random.default_rng(6)
    b, s, h, p, n, g = 2, 70, 8, 4, 5, 2
    x, dt, A, B, C = _ssd_inputs(rng, b, s, h, p, n, g)
    y, S = ssd_scan_plain(x, dt, A, B, C, 32)
    Bh, Ch = B.repeat_interleave(h // g, dim=2), C.repeat_interleave(h // g, dim=2)
    state, want = torch.zeros((b, h, p, n)), []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        state = state * decay + (dt[:, t, :, None, None] * x[:, t, :, :, None] * Bh[:, t, :, None, :])
        want.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    torch.testing.assert_close(y, torch.stack(want, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(S, state, rtol=1e-4, atol=1e-4)


def test_ssd_scan_plain_with_one_group_is_todays_bit_for_bit():
    rng = np.random.default_rng(7)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 70, 4, 4, 5, 1)
    for got, want in zip(ssd_scan_plain(x, dt, A, B, C, 32), ssd_scan_plain(x, dt, A, B[:, :, 0], C[:, :, 0], 32)):
        assert torch.equal(got, want)


def _attention(q, k, v, scale, keep):
    """Independent of the plain versions: one (query, position) score at a
    time through softmax, float64."""
    s = torch.einsum("...qd,...kd->...qk", q.double(), k.double()) * scale
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("scale", [None, 112**-0.5])
def test_flash_and_decode_plain_at_head_dim_224_with_a_scale(scale):
    rng = np.random.default_rng(9)
    b, kv, g, s, hd = 2, 2, 1, 37, 224
    q = torch.from_numpy(rng.standard_normal((b, kv, g, s, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, kv, s, hd)).astype(np.float32)) for _ in range(2))
    sc = hd**-0.5 if scale is None else scale
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    want = _attention(q, k[:, :, None], v[:, :, None], sc, causal)
    torch.testing.assert_close(flash_attention_plain(q, k, v, True, scale).double(), want, rtol=1e-5, atol=1e-5)
    length = 20
    keep = torch.arange(s) < length
    want = _attention(q[:, :, :, :1], k[:, :, None], v[:, :, None], sc, keep)[:, :, :, 0]
    torch.testing.assert_close(decode_attention_plain(q[:, :, :, 0], k, v, length, scale).double(), want, rtol=1e-5,
                               atol=1e-5)


def test_attention_wrappers_take_head_dim_224_and_a_scale_on_the_cpu():
    from repro_torch.kernels import ops

    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((1, 2, 1, 9, 224)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 9, 224)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, k, k, causal=True, scale=0.1), flash_attention_plain(q, k, k, True, 0.1))
    assert torch.equal(ops.decode_attention(q[:, :, :, 0], k, k, 5, scale=0.1),
                       decode_attention_plain(q[:, :, :, 0], k, k, 5, 0.1))
