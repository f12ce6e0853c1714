"""moonshot-v1-16b-a3b (Moonlight) — MoE [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408(per expert) vocab=163840,
MoE 64 experts top-6.  Assignment-literal: 64e/top-6, no shared expert.
Full attention → ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, MoECfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        act="silu",
        glu=True,
        norm="rmsnorm",
        tie_embeddings=False,
        moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=0),
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
    )
)
