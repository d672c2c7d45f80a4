"""The causal flash forward and backward pair's share of its roofline, in
%: 12 FLOPs a kept pair per head dimension at the bf16 peak, at the cell's
microbatch shape, over the pair's time from CUDA events."""

from portbench import yardstick


def read(rec):
    s = rec.facts.get("flash_pair_s")
    if not s or rec.device_type != "cuda":
        return None
    f = rec.facts
    bound = yardstick.flash_pair_bound_s(f["batch"] // f["micro"],
                                         f["n_heads"], f["head_dim"],
                                         f["seq"])
    return 100.0 * bound / s
