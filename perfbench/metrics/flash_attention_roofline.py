"""flash_attention_roofline (%): the causal FLOPs at the configuration's
head dim (224; the kernel runs it padded to 256, which shows here as a
lower share) of the traced ``flash_attention`` launches at 989 TFLOP/s
(H100 SXM dense bf16), over their device time.  A COOK's launches are the
applications of the shared blocks in each of its forwards (``forwards``:
(batch, padded length)), whose FLOPs are counted at the launched length;
the window's are its launches times their mean."""

from perfbench.counts.zamba2 import PEAK_BF16_FLOPS, attention_flops


def read(run):
    f, t = run.facts, run.trace
    launches = t.kernel_launches("flash_attn")
    seconds = t.kernel_seconds("flash_attn")
    if not launches or not seconds or "forwards" not in f:
        return None
    conf = f["conf"]
    per_cook = sum(attention_flops(conf, seq, batch) for batch, seq in f["forwards"])
    per_launch = per_cook / (len(conf["hybrid_layer_ids"]) * len(f["forwards"]))
    return 100.0 * launches * per_launch / PEAK_BF16_FLOPS / seconds
