"""score_pad_share (%): the padded positions among every position the
scoring map's forwards ran in the traced window: 1 - real tokens / forwarded
tokens, from the port's counters (``repro_torch.models.score.STATS``)."""


def read(run):
    counts = run.facts.get("score_counts")
    if not counts or not counts.get("padded_tokens"):
        return None
    return 100.0 * (counts["padded_tokens"] - counts["real_tokens"]) / counts["padded_tokens"]
