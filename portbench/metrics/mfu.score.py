"""The window's prefills as a share of the bf16 peak, in %: each prompt's
forward FLOPs (2 a multiply-add over the block parameters per position,
attention over the causal pairs, the one sampled position's unembedding)
over the window's seconds, over 989 TFLOP/s."""

from portbench import yardstick


def read(rec):
    f = rec.facts
    if not f.get("prompt_lengths"):
        return None
    flops = sum(yardstick.prefill_model_flops(
        f["n_params"], f["embed_params"], f["unembed_params"], f["tied"],
        f["n_layers"], f["n_heads"], f["head_dim"], s)
        for s in f["prompt_lengths"])
    return 100.0 * flops / f["window_s"] / yardstick.PEAK_BF16_FLOPS
