"""qwen1.5-0.5b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.  Full attention →
``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        act="silu",
        glu=True,
        norm="rmsnorm",
        qkv_bias=True,
        tie_embeddings=True,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
)
