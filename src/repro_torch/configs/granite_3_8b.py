"""granite-3-8b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.  The odd vocab
(49155) is padded to the next multiple of 256 for TP divisibility
(logits masked; DESIGN.md §5).  Full attention → ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        act="silu",
        glu=True,
        norm="rmsnorm",
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
    )
)
