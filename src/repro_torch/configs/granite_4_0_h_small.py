"""granite-4.0-h-small — Granite 4.0-H Small (32B-A9B) at its published widths
[https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json].

40 layers of d_model 4096: layers 5, 15, 25 and 35 attend (GQA, 32 query
and 8 KV heads of 128, no position embedding, scale
``attention_multiplier`` 1/128, no bias), the other 36 are Mamba2 (128
heads of 64, d_inner 8192, d_state 128, one B/C group, conv 4 with bias,
chunk 256, the gated RMSNorm over all 8192 channels, dt unclamped).  Every
layer then runs a MoE of 72 SwiGLU experts of 768 (top-10 of float32
router logits, softmax over those 10, dropless) beside a shared SwiGLU MLP
of 1536.  The embedding is multiplied by 12, every residual branch by
0.22, and the logits divided by 16.  Vocabulary 100,352, tied; RMSNorm eps
1e-5.  32,207,337,984 parameters.
"""

from repro_torch.configs.base import ArchConfig, MoECfg, SSMCfg, register_arch

LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))

CONFIG = register_arch(
    ArchConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=768,
        vocab_size=100352,
        act="silu",
        glu=True,
        norm="rmsnorm",
        norm_eps=1e-5,
        pos_emb="none",
        tie_embeddings=True,
        moe=MoECfg(n_experts=72, top_k=10, d_ff_expert=768, n_shared_experts=1, d_ff_shared=1536,
                   fused_gate_up=True),
        moe_dispatch="dropless",
        block_pattern="hybrid_moe",
        ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_kernel=4, chunk=256, n_groups=1, conv_bias=True),
        layer_types=LAYER_TYPES,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        attention_multiplier=0.0078125,
        max_seq=131072,
        source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
    )
)
