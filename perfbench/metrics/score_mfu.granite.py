"""score_mfu.granite (%): the model FLOPs of the COOKs of the traced window
(``counts.granitemoehybrid.model_flops`` over a part's document lengths:
twice the multiply-adds of the matrix products, the top-10 experts' among
them, and causal attention at head dim 128, padding not counted) over the
device time of every kernel in that window (copies and fills left out) at
989 TFLOP/s, the H100 SXM's dense bf16 peak: the share of the whole step's
peak.  The window holds whole COOKs (the ``score_granite`` kind starts and
stops it between two)."""

from perfbench.counts.granitemoehybrid import PEAK_BF16_FLOPS, model_flops


def read(run):
    f, t = run.facts, run.trace
    if not f.get("traced_cooks") or "doc_lengths" not in f or "layer_types" not in f.get("conf", {}):
        return None
    seconds = sum(v for k, v in t.kernels.items() if not k.startswith(("Memcpy", "Memset")))
    if not seconds:
        return None
    return 100.0 * f["traced_cooks"] * model_flops(f["conf"], f["doc_lengths"]) / PEAK_BF16_FLOPS / seconds
