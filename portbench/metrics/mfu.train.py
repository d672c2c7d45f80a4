"""The window's train steps as a share of the bf16 peak, in %: each step's
model FLOPs (6 N T over the multiplied parameters plus attention's causal
pairs, forward and backward; remat not counted) over the window's seconds,
over 989 TFLOP/s."""

from portbench import yardstick


def read(rec):
    f = rec.facts
    if not f.get("steps"):
        return None
    flops = f["steps"] * yardstick.train_model_flops(
        f["n_params"], f["embed_params"], f["tied"], f["n_layers"],
        f["n_heads"], f["head_dim"], f["batch"], f["seq"])
    return 100.0 * flops / f["window_s"] / yardstick.PEAK_BF16_FLOPS
