"""zamba2-7b — Zamba2-7B-Instruct at its published widths
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json].

81 Mamba2 layers of d_model 3584 (d_inner 7168: 112 heads of 64, d_state
64, 2 B/C groups, conv 4 with bias, chunk 256), the gated RMSNorm per group
of 3584 channels (eps 1e-5).  Two shared blocks (``num_mem_blocks``)
applied in turn before the Mamba layers of ``hybrid_layer_ids``, 13
applications: RMSNorm over concat(stream, embedding) (7168), MHA of 32
heads of 224 with RoPE over the whole head and scale (224/2)^-0.5, o_proj
to 3584, RMSNorm, a GeGLU MLP 3584 → 2 × 14336 → 3584 (exact GELU) whose
gate_up gains a rank-128 LoRA of the application's own; the block's output
goes through a 3584² linear of the application's own into the next Mamba
layer's input.  Vocabulary 32000, tied.  7.36 B parameters.
"""

from repro_torch.configs.base import ArchConfig, SSMCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=224,
        d_ff=14336,
        vocab_size=32000,
        act="gelu_exact",
        glu=True,
        norm="rmsnorm",
        norm_eps=1e-5,
        rope_theta=10000.0,
        block_pattern="zamba2",
        ssm=SSMCfg(d_state=64, expand=2, head_dim=64, conv_kernel=4, chunk=256, n_groups=2,
                   conv_bias=True),
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        n_mem_blocks=2,
        adapter_rank=128,
        tie_embeddings=True,
        max_seq=4096,
        source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json",
    )
)
