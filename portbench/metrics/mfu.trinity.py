"""The window's prefills as a share of the bf16 peak, in %: each prompt's
forward FLOPs (``yardstick_afmoe.prefill_flops``: the projections and
gate, the dense MLPs, the router, 8 routed and 1 shared expert a token,
attention over the kept pairs, one position's unembedding) over the
window's seconds, over 989 TFLOP/s."""

from portbench import yardstick, yardstick_afmoe


def read(rec):
    f = rec.facts
    if not f.get("prompt_lengths") or "config" not in f:
        return None
    flops = sum(yardstick_afmoe.prefill_flops(f["config"], s)
                for s in f["prompt_lengths"])
    return 100.0 * flops / f["window_s"] / yardstick.PEAK_BF16_FLOPS
