"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242; hf].

38L d_model=2048 (Mamba2 blocks, ssm_state=64) with a **shared** attention
block (32H kv=32) applied after every 6th Mamba block — weights shared
across applications, distinct KV caches (arXiv:2411.15242).  Sub-quadratic
backbone → runs ``long_500k``.
"""

from repro_torch.configs.base import ArchConfig, SSMCfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        act="gelu",
        glu=True,
        norm="rmsnorm",
        block_pattern="zamba2",
        ssm=SSMCfg(d_state=64, expand=2, head_dim=64, conv_kernel=4, chunk=256),
        attn_every=6,
        tie_embeddings=True,
        source="arXiv:2411.15242; hf",
    )
)
