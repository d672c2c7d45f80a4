"""Device milliseconds a train step spends in flash attention: the
device intervals of every ``repro.flash.fwd`` (remat's forwards too) and
``repro.flash.bwd`` inside the traced steps, summed, over the steps.
Read from the program's spans (``repro_torch.obs.span_trace``); None
without them, without a device interval, or when the recorder dropped
events."""

NAMES = ("repro.flash.fwd", "repro.flash.bwd")


def read(rec):
    try:
        from repro_torch.obs import span_trace
    except ImportError:                 # a program without spans
        return None
    tr = span_trace()
    if tr is None or tr.dropped:
        return None
    steps = sum(s.label == "repro.train.step" for s in tr.spans)
    flash = [s.dev for s in tr.spans if s.label in NAMES]
    if not steps or not flash or None in flash:
        return None
    return 1e3 * sum(d1 - d0 for d0, d1 in flash) / steps
