"""The flash kernel's share of its roofline in the traced prefills of an
AfMoE cell, in %: each prompt's bound over its layers
(``yardstick_afmoe.flash_prompt_bound_s``: the larger of a layer's bytes
at 3.35 TB/s and its kept pairs' FLOPs at 989 TFLOP/s, the pairs within
the window on sliding layers) over the flash kernels' device time."""

from portbench import yardstick, yardstick_afmoe


def read(rec):
    tr, f = rec.trace, rec.facts
    if tr is None or not f.get("traced_prompts") or "config" not in f:
        return None
    sec, _ = tr.device_s("flash_attention")
    if not sec:
        return None
    bound = sum(yardstick_afmoe.flash_prompt_bound_s(
        f["config"], s, yardstick.PEAK_BF16_FLOPS, yardstick.HBM_BYTES_PER_S)
        for s in f["traced_prompts"])
    return 100.0 * bound / sec
