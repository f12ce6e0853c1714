"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeSpec``s.  ``reduced()`` derives the CPU smoke-test
version of any config (same family/topology, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["MoECfg", "SSMCfg", "ArchConfig", "ShapeSpec", "SHAPES", "register_arch", "get_config", "list_archs"]


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_every: int = 1  # every Nth block is MoE (1 = all)
    group_size: int = 512  # einsum-dispatch token group (GShard G×g regroup)
    d_ff_shared: int = 0  # the shared MLP's own width (0: d_ff_expert × n_shared_experts)
    fused_gate_up: bool = False  # experts as published: input_linear (E, 2·d_ff, d) [SiLU half, up half], output_linear (E, d, d_ff)


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 256  # SSD chunk length
    n_groups: int = 1  # B/C groups: head h reads group h // (heads / n_groups)
    conv_bias: bool = False  # the depthwise convs carry a bias


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    act: str = "silu"  # silu | gelu
    glu: bool = True  # gated (SwiGLU/GeGLU) vs plain MLP
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim that rotates
    pos_emb: str = "rope"  # rope | learned | none
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 256
    # MoE
    moe: MoECfg | None = None
    # hybrid / ssm topology
    block_pattern: str = "attn"  # attn | zamba2 | xlstm | hybrid_moe
    ssm: SSMCfg | None = None
    attn_every: int = 6  # zamba2: shared attn after every Nth mamba block
    # zamba2's published layout, chosen by a non-empty ``hybrid_layer_ids``:
    # ``n_mem_blocks`` shared blocks applied in turn before the Mamba layers
    # listed, each application with its own MLP LoRA of ``adapter_rank`` and
    # its own d_model² linear into the next layer's input; the blocks attend
    # over concat(stream, embedding)
    hybrid_layer_ids: tuple = ()
    n_mem_blocks: int = 1
    adapter_rank: int = 0
    norm_eps: float = 1e-6  # the model's RMSNorms, the Mamba gated norm's too
    # hybrid_moe (granitemoehybrid): each layer's mixer ("mamba" or "attention"),
    # then a MoE FFN beside a shared MLP; the µP multipliers of the embedding,
    # of every residual branch and (as a divisor) of the logits; the scores'
    # scale where the config gives one (0: the head dim's)
    layer_types: tuple = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0
    slstm_every: int = 8  # xlstm: one sLSTM per N blocks
    # encoder-decoder
    is_encdec: bool = False
    encoder_layers: int = 0
    enc_seq: int = 1500  # whisper: frames after the conv stem (stubbed)
    # modality frontend stub
    frontend: str = "none"  # none | audio_stub | vq_stub
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full | dots (checkpoint_dots: save matmul outs)
    loss_impl: str = "logp"  # logp (materialize log_softmax) | lse (logsumexp-gather)
    moe_dispatch: str = "scatter"  # scatter | einsum (one-hot matmul dispatch)
    attn_impl: str = "auto"  # auto | naive | chunked
    zero3_gather: bool = False  # explicit ZeRO-3: all-gather FSDP weights at
    # use (with_sharding_constraint → replicated) instead of letting GSPMD
    # partial-sum activations and all-reduce them (§Perf hillclimb)
    max_seq: int = 532480
    source: str = ""  # provenance tag from the assignment

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attn_in_dim(self) -> int:
        """The attention's input width: 2·d_model over concat(stream, embedding)."""
        return 2 * self.d_model if self.hybrid_layer_ids else self.d_model

    @property
    def attn_scale(self) -> float:
        """The scores' scale: the config's ``attention_multiplier`` where it
        gives one, else hd^-0.5, or (hd/2)^-0.5 over the concatenated input,
        as published (its heads are twice the stream's width)."""
        if self.attention_multiplier:
            return self.attention_multiplier
        return (self.head_dim_ / 2 if self.hybrid_layer_ids else self.head_dim_) ** -0.5

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.glu:
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        per_layer = 0
        n_attn_layers = self.n_layers if self.block_pattern == "attn" else 0
        if self.block_pattern == "attn":
            if self.moe is not None:
                moe_mlp = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                moe_mlp += self.moe.n_shared_experts * 3 * d * self.moe.d_ff_expert
                moe_mlp += d * self.moe.n_experts  # router
                n_moe = self.n_layers // self.moe.moe_every
                n_dense = self.n_layers - n_moe
                per_layer_total = n_moe * (attn + moe_mlp) + n_dense * (attn + mlp_dense)
            else:
                per_layer_total = self.n_layers * (attn + mlp_dense)
        elif self.block_pattern == "zamba2":
            # mamba blocks have NO per-layer MLP; one shared attn+MLP block
            s = self.ssm or SSMCfg()
            d_in = s.expand * d
            nh = d_in // s.head_dim
            mamba = (
                d * (2 * d_in + 2 * s.d_state + nh)  # z,x,B,C,dt projections
                + d_in * d  # out proj
                + s.conv_kernel * (d_in + 2 * s.d_state)  # depthwise convs
                + d_in  # gate norm
            )
            if self.hybrid_layer_ids:
                mamba += s.n_groups * 2 * s.d_state * (d + s.conv_kernel) - 2 * s.d_state * (d + s.conv_kernel)
                mamba += (d_in + 2 * s.n_groups * s.d_state) * s.conv_bias + d + 3 * nh  # conv biases, norm, A, D, dt bias
                d_a = self.attn_in_dim
                shared = d_a * 3 * self.n_heads * hd + self.n_heads * hd * d + 3 * d * self.d_ff + d_a + d
                per_app = self.adapter_rank * (d + 2 * self.d_ff) + d * d
                per_layer_total = (self.n_layers * mamba + self.n_mem_blocks * shared
                                   + len(self.hybrid_layer_ids) * per_app + d)
            else:
                per_layer_total = self.n_layers * mamba + (attn + mlp_dense)
        elif self.block_pattern == "hybrid_moe":
            s, m = self.ssm, self.moe
            d_in = s.expand * d
            nh, gn = d_in // s.head_dim, s.n_groups * s.d_state
            mamba = (d * (2 * d_in + 2 * gn + nh) + d_in * d + (s.conv_kernel + s.conv_bias) * (d_in + 2 * gn)
                     + d_in + 3 * nh)  # projections, convs and their biases, gated norm, A, D, dt bias
            shared = 3 * d * (m.d_ff_shared or m.d_ff_expert * m.n_shared_experts)
            ffn = d * m.n_experts + m.n_experts * 3 * d * m.d_ff_expert + shared + 2 * d  # router, experts, norms
            n_attn = sum(t == "attention" for t in self.layer_types)
            per_layer_total = self.n_layers * ffn + n_attn * attn + (self.n_layers - n_attn) * mamba + d
        elif self.block_pattern == "xlstm":
            pf = 2
            d_in = pf * d
            # mLSTM block: up+gate (2·d·d_in), q/k/v (3·d_in²), i/f gates,
            # down (d_in·d); one sLSTM block per slstm_every with block-diag
            # recurrence + a 4/3-GLU FFN
            mlstm = 2 * d * d_in + 3 * d_in * d_in + d_in * 2 * self.n_heads + d_in * d
            hd = d // self.n_heads
            d_ff_s = int(d * 4 / 3)
            slstm = 4 * d * d + 3 * self.n_heads * hd * hd + 3 * d * d_ff_s
            n_s = self.n_layers // self.slstm_every
            per_layer_total = (self.n_layers - n_s) * mlstm + n_s * slstm
        else:
            per_layer_total = self.n_layers * (attn + mlp_dense)
        emb = self.padded_vocab * d
        if not self.tie_embeddings:
            emb *= 2
        if self.is_encdec:
            enc = self.encoder_layers * (attn + mlp_dense)
            dec_cross = self.n_layers * attn  # cross-attention blocks
            per_layer_total += enc + dec_cross
        _ = n_attn_layers
        return int(per_layer_total + emb)

    def active_params(self) -> int:
        """MoE: parameters touched per token (top-k + shared experts)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense_like = dataclasses.replace(self, moe=None)
        base = dense_like.n_params() - self.n_layers * 3 * d * self.d_ff
        n_moe = self.n_layers // self.moe.moe_every
        n_dense = self.n_layers - n_moe
        active_moe = n_moe * (self.moe.top_k + self.moe.n_shared_experts) * 3 * d * self.moe.d_ff_expert
        return int(base + n_dense * 3 * d * self.d_ff + active_moe)

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 4 if self.block_pattern == "attn" else 5),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            vocab_pad_multiple=64,
            dtype="float32",
            param_dtype="float32",
            remat=False,
            max_seq=4096,
        )
        if self.moe is not None:
            # capacity_factor=4 ⇒ no token drops at smoke scale, so
            # decode-vs-forward agreement is exact (production keeps 1.25)
            changes["moe"] = MoECfg(
                n_experts=4,
                top_k=min(2, self.moe.top_k),
                d_ff_expert=64,
                n_shared_experts=self.moe.n_shared_experts,
                capacity_factor=4.0,
                moe_every=self.moe.moe_every,
            )
        if self.ssm is not None:
            changes["ssm"] = SSMCfg(d_state=16, expand=2, head_dim=32, conv_kernel=4, chunk=32)
        if self.is_encdec:
            changes["encoder_layers"] = 2
            changes["enc_seq"] = 16
        if self.block_pattern == "zamba2":
            changes["attn_every"] = 2
            changes["n_layers"] = 5
        if self.hybrid_layer_ids:  # the published layout: 3 applications of 2 blocks, 2 B/C groups
            changes.update(hybrid_layer_ids=(1, 2, 4), n_kv_heads=4, head_dim=64, adapter_rank=8)
            changes["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.block_pattern == "xlstm":
            changes["slstm_every"] = 3
            changes["n_layers"] = 4
        if self.block_pattern == "hybrid_moe":  # every layer kind: three Mamba2 layers, one attention layer
            changes.update(layer_types=("mamba", "mamba", "attention", "mamba"), n_layers=4, n_kv_heads=2)
            changes["moe"] = dataclasses.replace(self.moe, n_experts=8, top_k=3, d_ff_expert=64, d_ff_shared=96)
            changes["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    import importlib

    for mod in (
        "chameleon_34b",
        "moonshot_v1_16b_a3b",
        "llama4_scout_17b_a16e",
        "whisper_small",
        "gemma_2b",
        "stablelm_1_6b",
        "granite_3_8b",
        "qwen1_5_0_5b",
        "zamba2_1_2b",
        "zamba2_7b",
        "granite_4_0_h_small",
        "xlstm_125m",
        "paper_lm",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
