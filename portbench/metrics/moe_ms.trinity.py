"""Device milliseconds a traced engine step spends in the MoE layers: the
device intervals of every ``repro.moe.*`` span (route, dispatch, experts,
combine, shared) inside the traced steps, summed, over the steps.  Read
from the program's spans (``repro_torch.obs.span_trace``); None without
them, without a device interval, or when the recorder dropped events."""


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    steps = sum(s.label == "repro.engine.step" for s in tr.spans)
    moe = [s.dev for s in tr.spans if s.label.startswith("repro.moe.")]
    if not steps or not moe or None in moe:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1 in moe) / steps
