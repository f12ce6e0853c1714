"""stablelm-1.6b — dense [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.  LayerNorm + partial
rotary (25% of head_dim) per the StableLM-2 config.  Full attention →
``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        act="silu",
        glu=True,
        norm="layernorm",
        partial_rotary=0.25,
        tie_embeddings=False,
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
    )
)
