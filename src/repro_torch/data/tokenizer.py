"""Byte-level tokenizer (no external vocab files; deterministic).

ids 0..255 = raw bytes; 256 = BOS, 257 = EOS, 258 = PAD.  Models with larger
vocabs simply leave the upper ids to real tokenizers in deployment; for the
synthetic corpora used here the byte vocabulary is exact and reversible.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
        raw = list(text.encode("utf-8"))
        ids = ([self.BOS] if add_bos else []) + raw + ([self.EOS] if add_eos else [])
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        raw = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return raw.decode("utf-8", errors="replace")

    def pack(self, ids: np.ndarray, length: int) -> np.ndarray:
        """Pad/truncate to exactly ``length`` tokens."""
        out = np.full(length, self.PAD, dtype=np.int32)
        n = min(len(ids), length)
        out[:n] = ids[:n]
        return out
