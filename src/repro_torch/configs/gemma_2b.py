"""gemma-2b — dense, GeGLU, MQA [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, head_dim=256,
GeGLU activation.  Full attention → ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        act="gelu",
        glu=True,
        norm="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2403.08295; hf",
    )
)
