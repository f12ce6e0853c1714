"""Training data substrate: tokenizer, synthetic corpora, DACP pipeline."""

from repro_torch.data.pipeline import TOKENS_COLUMN, training_dag
from repro_torch.data.synthetic import write_mixed_tree, write_reviews_jsonl, write_token_corpus
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = [
    "TOKENS_COLUMN",
    "training_dag",
    "write_mixed_tree",
    "write_reviews_jsonl",
    "write_token_corpus",
    "ByteTokenizer",
]
