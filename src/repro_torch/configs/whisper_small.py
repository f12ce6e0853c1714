"""whisper-small — enc-dec audio [arXiv:2212.04356; unverified].

12L (enc) + 12L (dec), d_model=768 12H d_ff=3072 vocab=51865.  The conv
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
(enc_seq=1500 × 768).  Learned positions, LayerNorm, GELU, no GLU —
faithful to Whisper.  Decoder positions are parameterized so the assigned
32k decode shapes lower (noted as a shape exercise in DESIGN.md §4).
Full attention → ``long_500k`` skipped.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        act="gelu",
        glu=False,
        norm="layernorm",
        qkv_bias=True,
        mlp_bias=True,
        pos_emb="learned",
        tie_embeddings=True,
        is_encdec=True,
        encoder_layers=12,
        enc_seq=1500,
        frontend="audio_stub",
        source="arXiv:2212.04356; unverified",
    )
)
