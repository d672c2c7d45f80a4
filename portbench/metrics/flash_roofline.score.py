"""The flash kernel's share of its roofline in the traced prefills, in %:
each launch's bound (the larger of its bytes at 3.35 TB/s and its kept
pairs' FLOPs at 989 TFLOP/s) over the flash kernels' device time."""

from portbench import yardstick


def read(rec):
    tr, f = rec.trace, rec.facts
    if tr is None or not f.get("traced_prompts"):
        return None
    sec, launches = tr.device_s("flash_attention")
    if not sec:
        return None
    bound = sum(yardstick.flash_forward_bound_s(
        1, f["n_heads"], f["kv_heads"], f["head_dim"], s) * f["n_layers"]
        for s in f["traced_prompts"])
    return 100.0 * bound / sec
