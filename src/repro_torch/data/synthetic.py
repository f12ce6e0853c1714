"""Synthetic corpora mirroring the paper's evaluation datasets (§V-B).

  * ``write_reviews_jsonl``  — Yelp-Open-Dataset-like: uniform-schema rows of
    five key/value pairs (review_id, stars, useful, text, date).
  * ``write_mixed_tree``     — ImageNet-like mixed blob workload: 1 large +
    N medium + M small files with random bytes (sizes configurable so CI can
    run a scaled-down version of the paper's 1GB/100MB/10KB mix).
  * ``write_token_corpus``   — LM training shards: text documents stored as
    jsonl for the DACP tokenize pipeline.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["write_reviews_jsonl", "write_mixed_tree", "write_token_corpus"]

_WORDS = (
    "the quick brown fox jumps over lazy dog scientific data access protocol "
    "streaming frame columnar batch lazy pull operator collaboration network "
    "astronomy physics genome telescope detector simulation tensor gradient"
).split()


def _text(rng: np.random.Generator, lo: int = 8, hi: int = 64) -> str:
    n = int(rng.integers(lo, hi))
    return " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), n))


def write_reviews_jsonl(path: str, rows: int, seed: int = 0) -> str:
    """Five key-value pairs per row, uniform schema (paper §V-B structured)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(rows):
            rec = {
                "review_id": f"r{i:09d}",
                "stars": int(rng.integers(1, 6)),
                "useful": int(rng.integers(0, 50)),
                "text": _text(rng),
                "date": f"2025-{int(rng.integers(1,13)):02d}-{int(rng.integers(1,29)):02d}",
            }
            f.write(json.dumps(rec) + "\n")
    return path


def write_mixed_tree(
    root: str,
    large_bytes: int = 1 << 30,
    n_medium: int = 10,
    medium_bytes: int = 100 << 20,
    n_small: int = 10000,
    small_bytes: int = 10 << 10,
    seed: int = 0,
) -> dict:
    """1 large + N medium + M small random files (paper §V-B unstructured)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)

    def blob(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    manifest = {"large": [], "medium": [], "small": []}
    p = os.path.join(root, "large_000.bin")
    with open(p, "wb") as f:
        left = large_bytes
        while left > 0:
            chunk = min(left, 8 << 20)
            f.write(blob(chunk))
            left -= chunk
    manifest["large"].append(p)
    for i in range(n_medium):
        p = os.path.join(root, f"medium_{i:03d}.bin")
        with open(p, "wb") as f:
            f.write(blob(medium_bytes))
        manifest["medium"].append(p)
    small_dir = os.path.join(root, "small")
    os.makedirs(small_dir, exist_ok=True)
    payload = blob(small_bytes)
    for i in range(n_small):
        p = os.path.join(small_dir, f"small_{i:05d}.dat")
        with open(p, "wb") as f:
            f.write(payload)
        manifest["small"].append(p)
    return manifest


def write_token_corpus(path: str, docs: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(docs):
            f.write(json.dumps({"doc_id": i, "text": _text(rng, 32, 256)}) + "\n")
    return path
