"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304.  ``d_ff=0`` → no separate FFN: the
up/down projections live inside the xLSTM blocks (mLSTM pf=2, sLSTM with
GLU ffn pf=4/3 per the paper).  One sLSTM per 8 blocks (7:1 ratio).
Recurrent state → runs ``long_500k``.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        act="gelu",
        glu=False,
        norm="layernorm",
        block_pattern="xlstm",
        slstm_every=8,
        tie_embeddings=True,
        source="arXiv:2405.04517; unverified",
    )
)
