"""The routed experts' grouped products as a share of their roofline in
the traced steps, in %: each MoE layer call's bound
(``yardstick_afmoe.expert_call_bound_s``: 6 d d_e FLOPs a computed pair at
989 TFLOP/s, or every expert's weights and the pairs' rows at 3.35 TB/s,
whichever is larger; a prompt of S tokens is top_k S pairs in every MoE
layer) over the device time of the ``repro.moe.experts`` spans, which
cover the routed experts' products only (the shared expert has its own
span).  The pairs are the program's counter ``repro.moe.assignments``; None
when it disagrees with the traced prompts' pairs, without the spans, or
when the recorder dropped events."""

from portbench import yardstick, yardstick_afmoe


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    f = rec.facts
    tr = span_trace()
    if tr is None or tr.dropped or not f.get("traced_prompts"):
        return None
    cfg = f["config"]
    experts = [s.dev for s in tr.spans if s.label == "repro.moe.experts"]
    if not experts or None in experts:
        return None
    k = cfg["num_experts_per_tok"]
    calls = cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    if tr.counters.get("repro.moe.assignments") != \
            k * calls * sum(f["traced_prompts"]):
        return None
    bound = sum(calls * yardstick_afmoe.expert_call_bound_s(
        cfg, k * s, yardstick.PEAK_BF16_FLOPS, yardstick.HBM_BYTES_PER_S)
        for s in f["traced_prompts"])
    return 100.0 * bound / sum(d1 - d0 for d0, d1 in experts)
