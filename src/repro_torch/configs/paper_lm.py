"""paper-lm-100m — the end-to-end training example's own model.

A ~100M decoder-only LM fed by the DACP data plane (examples/train_lm.py):
byte-level vocab, 12L × 768.  This is the paper's "AI4Science joint
training" consumer in minimal runnable form.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="paper-lm-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=512,  # byte tokenizer (259) padded
        vocab_pad_multiple=64,
        act="silu",
        glu=True,
        norm="rmsnorm",
        tie_embeddings=True,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        source="in-repo",
    )
)
