"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early fusion: VQ
image tokens live inside the 65536 vocab, so the backbone is a decoder-only
LM; the VQ-GAN frontend is a stub (``frontend="vq_stub"`` — input_specs
provides token ids).  QK-norm per the Chameleon paper's training-stability
fix.  Full attention → ``long_500k`` is skipped (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        act="silu",
        glu=True,
        norm="rmsnorm",
        qk_norm=True,
        rope_theta=10000.0,
        tie_embeddings=False,
        frontend="vq_stub",
        source="arXiv:2405.09818; unverified",
    )
)
