"""llama4-scout-17b-a16e — MoE, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1.
Assignment-literal top-1 routing (HF adds a shared expert; noted in
DESIGN.md §4).  Full attention → ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, MoECfg, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        act="silu",
        glu=True,
        norm="rmsnorm",
        tie_embeddings=False,
        moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=0),
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    )
)
